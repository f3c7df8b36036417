"""Sharding by spec in the port against the JAX package, on the CPU.

- `parallel.specs`: `PartitionSpec` equality and length as JAX's,
  `specs_from_rules` (first match wins, the default);
- each model's `param_specs` (GPT-2, Llama, BERT, T5; ResNet all
  whole) equal to JAX's per counterpart leaf: the port's ``nn.Linear``
  weights (GPT-2's and BERT's) are the flax kernels transposed, so a
  kernel's spec is reversed there; Llama's and T5's carry over;
- two gloo ranks (`apex1_tpu_torch.parallel.launch`, body in
  tests/torch_dist_ranks.py) at tp = 2: a tiny GPT-2, Llama, BERT and
  T5 with their parameters placed by `param_specs` (`core.mesh.place`,
  DTensors; the batch replicated), either head, the loss and every
  gradient within 1e-5 of JAX's unsharded loss and gradients
  (tests/test_models.py:186-270, tests/test_llama.py:65-95; JAX's XLA
  composite): DTensor propagation runs each model's plain path, and
  the fused head gathers its operands first;
- the layer modules' specs (tests/test_tensor_parallel.py:210-230),
  the column -> gelu -> row MLP placed at tp = 2 equal to JAX's dense
  gold within 1e-5, each rank holding its block of the kernel, and
  `VocabParallelEmbedding` with tokens from both ranks' rows: the
  lookup and the table's gradient equal the unsplit ones;
- a DTensor at a kernel wrapper's checks raises TypeError naming the
  kernel (the wrappers read ``data_ptr()``; on the card every launch
  passes these checks first);
- the port carries tests/test_api_surface.py's names of each module
  this slice ports.
"""

from concurrent.futures import ThreadPoolExecutor

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from apex1_tpu.core.policy import get_policy as jax_get_policy
from apex1_tpu.models import bert as jbert
from apex1_tpu.models import gpt2 as jgpt2
from apex1_tpu.models import llama as jllama
from apex1_tpu.models import t5 as jt5
from apex1_tpu.ops import _common as jax_common
from apex1_tpu.parallel.specs import specs_from_rules as jax_specs_from_rules
from apex1_tpu.transformer import tensor_parallel as jtp
from apex1_tpu_torch.interop import flax_from_named
from apex1_tpu_torch.models import bert, gpt2, llama, resnet, t5
from apex1_tpu_torch.parallel import launch
from apex1_tpu_torch.parallel.specs import P, PartitionSpec, specs_from_rules
from apex1_tpu_torch.transformer import tensor_parallel as tp

import torch_dist_ranks

N = 2
B, S = 2, 16
JAX = {"gpt2": (jgpt2.GPT2Config, jgpt2.GPT2, jgpt2.gpt2_loss_fn,
                jgpt2.param_specs),
       "llama": (jllama.LlamaConfig, jllama.Llama, jllama.llama_loss_fn,
                 jllama.param_specs),
       "bert": (jbert.BertConfig, jbert.BertPretrain,
                jbert.bert_pretrain_loss_fn, jbert.param_specs),
       "t5": (jt5.T5Config, jt5.T5, jt5.t5_loss_fn, jt5.param_specs)}
PORT = {"gpt2": gpt2, "llama": llama, "bert": bert, "t5": t5}


def test_partition_spec_and_rules():
    assert P(None, "fsdp") == P(None, "fsdp") == PartitionSpec(None, "fsdp")
    assert P() != P(None) and len(P(None, "tp")) == len(JP(None, "tp")) == 2
    assert tuple(P(("dp", "fsdp"))) == tuple(JP(("dp", "fsdp")))
    rules = ((r"a\.w$", P("tp", None)), (r"w$", P(None, "tp")))
    params = {"a.w": 0, "b.w": 0, "c": 0}
    got = specs_from_rules(params, rules, default=P("x"))
    assert got == {"a.w": P("tp", None), "b.w": P(None, "tp"), "c": P("x")}
    want = jax_specs_from_rules({"a": {"w": 0}, "b": {"w": 0}, "c": 0},
                                ((r"a/w$", JP("tp", None)),
                                 (r"w$", JP(None, "tp"))), default=JP("x"))
    assert tuple(want["a"]["w"]) == got["a.w"]
    assert tuple(want["b"]["w"]) == got["b.w"]


def _flax_path(name: str):
    parts = name.split(".")
    if parts[0] == "h":
        parts = [f"h{parts[1]}"] + parts[2:]
    transposed = parts[-1] == "weight"
    if transposed:
        parts[-1] = "kernel"
    return parts, transposed


def _leaf(tree, parts):
    for p in parts:
        tree = tree[p]
    return tree


def _trimmed(spec, ndim, transposed) -> tuple:
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    return tuple(reversed(spec)) if transposed else spec


def _batch(kind: str):
    rng = np.random.default_rng(90)
    tok = rng.integers(0, 256, (B, S)).astype(np.int32)
    if kind == "bert":
        mlm = np.where(rng.random((B, S)) < 0.3, tok, -1).astype(np.int32)
        return [{"tokens": tok, "mlm_labels": mlm,
                 "nsp_labels": np.array([0, 1], np.int32)}]
    if kind == "t5":
        return [tok[:, :12], tok[:, :9]]
    return [tok]


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind, (cfg_cls, model_cls, _, _) in JAX.items():
        cfg = cfg_cls.tiny(policy=jax_get_policy("O0"))
        batch = _batch(kind)
        tokens = batch[0]["tokens"] if kind == "bert" else batch[0]
        init_args = ((jnp.asarray(batch[0]), jnp.asarray(batch[1]))
                     if kind == "t5" else (jnp.asarray(tokens),))
        params = jax.tree_util.tree_map(np.asarray, jax.jit(
            model_cls(cfg).init)(jax.random.key(0), *init_args)["params"])
        out[kind] = dict(params=params, batch=batch, kw={}, cfg=cfg)
    return out


@pytest.mark.parametrize("kind", list(JAX))
def test_param_specs_match_jax(models, kind):
    from apex1_tpu_torch.parallel.distributed_optimizer import (
        fsdp_param_specs)
    m = models[kind]
    want = JAX[kind][3](m["params"])
    port = torch_dist_ranks._model_of(kind, m["params"], m["kw"])
    params = dict(port.named_parameters())
    got = PORT[kind].param_specs(params)
    assert set(got) == set(params)
    sharded = 0
    for name, t in params.items():
        parts, transposed = _flax_path(name)
        assert tuple(got[name]) + (None,) * (t.dim() - len(got[name])) == \
            _trimmed(_leaf(want, parts), t.dim(), transposed), name
        sharded += "tp" in got[name]
    assert sharded > 0
    assert set(fsdp_param_specs(params)) == set(params)


def test_resnet_specs_all_whole():
    m = resnet.ResNet(resnet.ResNetConfig.tiny(), device="cpu")
    specs = resnet.param_specs(dict(m.named_parameters()))
    assert set(specs.values()) == {P()}


def _jax_losses(models) -> dict:
    out = {}
    with jax_common.force_impl("xla"):
        for kind, m in models.items():
            cfg_cls, model_cls, loss_fn, _ = JAX[kind]
            batch = [jax.tree_util.tree_map(jnp.asarray, b)
                     for b in m["batch"]]
            loss, grads = jax.jit(jax.value_and_grad(
                loss_fn(model_cls(m["cfg"]))))(m["params"], *batch)
            out[kind] = (float(loss), jax.tree_util.tree_map(np.asarray,
                                                             grads))
    return out


def _jax_mlp():
    class MLP(nn.Module):
        @nn.compact
        def __call__(self, x):
            h = jtp.ColumnParallelLinear(64, name="fc1")(x)
            return jtp.RowParallelLinear(16, name="fc2")(nn.gelu(h))

    m = MLP()
    x = jnp.asarray(np.random.default_rng(91).standard_normal((8, 16)),
                    jnp.float32)
    boxed = m.init(jax.random.PRNGKey(0), x)
    specs = nn.get_partition_spec(boxed)["params"]
    params = jax.tree.map(lambda v: v.unbox() if hasattr(v, "unbox") else v,
                          boxed, is_leaf=lambda v: hasattr(v, "unbox"))
    gold = np.asarray(m.apply(params, x))
    p = jax.tree_util.tree_map(np.asarray, params["params"])
    return dict(x=np.asarray(x), gold=gold, specs=specs,
                fc1_kernel=p["fc1"]["kernel"], fc1_bias=p["fc1"]["bias"],
                fc2_kernel=p["fc2"]["kernel"], fc2_bias=p["fc2"]["bias"])


@pytest.fixture(scope="module")
def world(models):
    rng = np.random.default_rng(92)
    mlp = _jax_mlp()
    inputs = {"models": {k: dict(params=m["params"], batch=m["batch"],
                                 kw=m["kw"]) for k, m in models.items()},
              "mlp": {k: v for k, v in mlp.items() if k not in ("gold",
                                                                "specs")},
              "table": rng.standard_normal((10, 4)).astype(np.float32),
              "tokens": np.array([[0, 9, 4, 5, 2], [7, 3, 5, 6, 1]]),
              "ct_emb": rng.standard_normal((2, 5, 4)).astype(np.float32)}
    with ThreadPoolExecutor(1) as ex:
        port = ex.submit(launch, torch_dist_ranks.spec_cases, N, inputs, N,
                         backend="gloo")
        want = _jax_losses(models)
        return dict(port=port.result(), want=want, mlp=mlp, inputs=inputs)


@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "logits"])
@pytest.mark.parametrize("kind", list(JAX))
def test_placed_models_match_jax(world, kind, fuse):
    loss, grads = world["want"][kind]
    want = dict(jax.tree_util.tree_leaves_with_path(grads))
    for got in world["port"]:
        got = got[f"{kind}_{fuse}"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        got_g = dict(jax.tree_util.tree_leaves_with_path(
            flax_from_named(got["grads"])))
        assert got_g.keys() == want.keys()
        for k, w in want.items():
            np.testing.assert_allclose(got_g[k], w, rtol=1e-5, atol=1e-5,
                                       err_msg=str(k))


def test_layer_modules_placed_mlp_matches_dense_gold(world):
    mlp = world["mlp"]
    assert tuple(mlp["specs"]["fc1"]["kernel"]) == (None, "tp")
    assert tuple(mlp["specs"]["fc2"]["kernel"]) == ("tp", None)
    for r, got in enumerate(world["port"]):
        got = got["mlp"]
        assert [tuple(s) for s in got["specs"]] == [(None, "tp"),
                                                     ("tp", None)]
        np.testing.assert_allclose(got["y"], mlp["gold"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["local"], np.split(
            mlp["fc1_kernel"], N, axis=1)[r])
    col = tp.ColumnParallelLinear(16, 64, device="cpu")
    row = tp.RowParallelLinear(64, 16, use_bias=False, device="cpu")
    emb = tp.VocabParallelEmbedding(10, 4, device="cpu")
    assert col.partition_specs() == {"kernel": P(None, "tp"),
                                     "bias": P("tp")}
    assert row.partition_specs() == {"kernel": P("tp", None)}
    assert emb.partition_specs() == {"embedding": P("tp", None)}
    assert tp.set_tensor_model_parallel_attributes(col.partition_specs()) \
        == col.partition_specs()


def test_vocab_parallel_embedding_out_of_shard_tokens(world):
    i = world["inputs"]
    want = i["table"][i["tokens"]]
    dtable = np.zeros_like(i["table"])
    np.add.at(dtable, i["tokens"], i["ct_emb"])
    for r, got in enumerate(world["port"]):
        got = got["emb"]
        np.testing.assert_array_equal(got["y"], want)
        np.testing.assert_allclose(got["grad"], dtable, rtol=1e-6)
        np.testing.assert_array_equal(got["local"],
                                      np.split(i["table"], N)[r])


def _jax_surface() -> dict:
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "jax_api_surface", __file__.replace("test_torch_param_specs.py",
                                            "test_api_surface.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SURFACE


#: the JAX package's public modules this slice ports whole
SLICE = ("apex1_tpu.parallel", "apex1_tpu.parallel.distributed_optimizer",
         "apex1_tpu.parallel.halo", "apex1_tpu.contrib",
         "apex1_tpu.transformer.parallel_state",
         "apex1_tpu.transformer.tensor_parallel", "apex1_tpu.core.mesh",
         "apex1_tpu.models.resnet")


@pytest.mark.parametrize("module", SLICE)
def test_port_has_the_jax_surface(module):
    """tests/test_api_surface.py's names of each module, on the port's
    counterpart."""
    import importlib
    port = importlib.import_module(module.replace("apex1_tpu",
                                                  "apex1_tpu_torch", 1))
    missing = [n for n in _jax_surface()[module] if not hasattr(port, n)]
    assert not missing


def test_kernel_wrappers_refuse_a_dtensor(world):
    for got in world["port"]:
        ln, xent = got["refused"]
        assert ln.startswith("TypeError: layer_norm_fwd: got a DTensor")
        assert xent.startswith("TypeError: xent_fwd: got a DTensor")
