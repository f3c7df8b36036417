"""Testing harness (the port of ``apex1_tpu/testing``; reference
``apex/transformer/testing/``: ``commons.py``, ``distributed_test_base
.py``, ``standalone_gpt.py``, ``standalone_bert.py``, ``global_vars.py``)
and the drill fixtures: `chaos` (training, checkpoint and serving
faults, the toy decoder) and `fleetsim` (the virtual-clock fleet
simulator).

The framework-free helpers: `set_random_seed`, `assert_devices`,
`distributed_mesh` (the port's `parallel_state` over the default
process group, set up and torn down), `TestArgs` / `set_global_args` /
`get_args`, `standalone_gpt` / `standalone_bert` (the port's models at
O1) and `print_separator`.

The JAX package's ``force_virtual_cpu_devices``, its compilation-cache
helpers (``enable_persistent_compilation_cache``, ``child_cache_env``)
and ``honor_jax_platforms_env`` configure JAX's backends and its XLA
cache; PyTorch has no counterpart of either (the port's CPU tests run
several ranks as gloo processes, `parallel.launch`).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch


def set_random_seed(seed: int) -> torch.Generator:
    """``testing/commons.py :: set_random_seed``: seeds numpy's and
    torch's global generators and returns a fresh ``torch.Generator``
    seeded with ``seed`` (the JAX package returns a key)."""
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def assert_devices(n: int) -> list:
    """The first ``n`` CUDA devices; raises where fewer exist."""
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < n:
        raise RuntimeError(f"need {n} CUDA devices, have {have}")
    return [torch.device("cuda", i) for i in range(n)]


@contextlib.contextmanager
def distributed_mesh(dp: int = 1, tp: int = 1, pp: int = 1, cp: int = 1):
    """``DistributedTestBase``'s analog: `parallel_state`'s mesh over
    the default process group (``dp * tp * pp * cp`` ranks, one process
    each), torn down on exit. The group must exist
    (`parallel.init_distributed`, or a `parallel.launch` rank)."""
    import torch.distributed as dist

    from apex1_tpu_torch.transformer import parallel_state
    n = dp * tp * pp * cp
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("distributed_mesh needs the default process "
                           "group: call parallel.init_distributed first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"dp*tp*pp*cp = {n} but the process group "
                           f"has {dist.get_world_size()} ranks")
    if parallel_state.model_parallel_is_initialized():
        # never adopt leaked state: the postcondition (torn down on
        # exit) could not hold for state this context did not create
        raise RuntimeError(
            "parallel_state already initialized; a previous test leaked "
            "global state: call destroy_model_parallel() first")
    mesh = parallel_state.initialize_model_parallel(
        tensor_model_parallel_size=tp, pipeline_model_parallel_size=pp,
        context_parallel_size=cp)
    try:
        yield mesh
    finally:
        parallel_state.destroy_model_parallel()


@dataclasses.dataclass
class TestArgs:
    """``testing/global_vars.py`` + ``arguments.py``'s analog: the knobs
    the reference's standalone models read from Megatron's global
    args."""

    __test__ = False   # not a pytest test class

    micro_batch_size: int = 2
    global_batch_size: int = 8
    seq_length: int = 32
    padded_vocab_size: int = 256
    num_layers: int = 2
    hidden_size: int = 64
    num_attention_heads: int = 4
    seed: int = 1234


_GLOBAL_ARGS: Optional[TestArgs] = None


def set_global_args(args: TestArgs) -> None:
    global _GLOBAL_ARGS
    _GLOBAL_ARGS = args


def get_args() -> TestArgs:
    """``global_vars.py :: get_args``: the defaults if unset."""
    return _GLOBAL_ARGS if _GLOBAL_ARGS is not None else TestArgs()


def standalone_gpt(args: Optional[TestArgs] = None, *, device=None):
    """``testing/standalone_gpt.py``'s analog: ``(model, tokens, params,
    loss_fn)`` at test scale, GPT-2 at O1 on ``device`` (CUDA unless
    named), weights from `models.gpt2.init_params` at ``args.seed``."""
    from apex1_tpu_torch.core.policy import get_policy
    from apex1_tpu_torch.interop import gpt2_params_from_jax
    from apex1_tpu_torch.models.gpt2 import (GPT2Config, gpt2_loss_fn,
                                             init_params)
    from apex1_tpu_torch.ops._common import resolve_device

    a = args or get_args()
    dev = resolve_device(device)
    cfg = GPT2Config.tiny(
        vocab_size=a.padded_vocab_size, max_seq_len=a.seq_length,
        num_layers=a.num_layers, num_heads=a.num_attention_heads,
        hidden_size=a.hidden_size, policy=get_policy("O1"))
    model = gpt2_params_from_jax(init_params(cfg, a.seed), cfg, dev)
    rng = np.random.default_rng(a.seed)
    tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (a.micro_batch_size, a.seq_length))).to(dev)
    return model, tokens, dict(model.named_parameters()), gpt2_loss_fn(
        model)


def standalone_bert(args: Optional[TestArgs] = None, *, device=None):
    """``testing/standalone_bert.py``'s analog: ``(model, batch, params,
    loss_fn)``, BERT pretraining at O1 on ``device`` (CUDA unless
    named), weights from `models.bert.init_weights` at ``args.seed``;
    15 % of the tokens carry MLM labels (-1 elsewhere)."""
    from apex1_tpu_torch.core.policy import get_policy
    from apex1_tpu_torch.models.bert import (BertConfig, BertPretrain,
                                             bert_pretrain_loss_fn,
                                             init_weights)
    from apex1_tpu_torch.ops._common import resolve_device

    a = args or get_args()
    dev = resolve_device(device)
    cfg = BertConfig.tiny(
        vocab_size=a.padded_vocab_size, max_seq_len=a.seq_length,
        num_layers=a.num_layers, num_heads=a.num_attention_heads,
        hidden_size=a.hidden_size, policy=get_policy("O1"))
    model = init_weights(BertPretrain(cfg, device=dev), a.seed)
    rng = np.random.default_rng(a.seed)
    B, S = a.micro_batch_size, a.seq_length
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (B, S)),
        "mlm_labels": np.where(rng.random((B, S)) < 0.15,
                               rng.integers(0, cfg.vocab_size, (B, S)), -1),
        "nsp_labels": rng.integers(0, 2, (B,)),
    }
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    return model, batch, dict(model.named_parameters()), \
        bert_pretrain_loss_fn(model)


def print_separator(message: str) -> None:
    """``testing/commons.py :: print_separator``."""
    print(f"{' ' + message + ' ':-^72}")
