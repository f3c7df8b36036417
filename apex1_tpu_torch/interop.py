"""Parameters and training state between the JAX package and the port.

The JAX package keeps GPT-2's parameters as a flax tree: ``wte``,
``wpe``, ``h{i}/{ln1,ln2}_{scale,bias}``, ``h{i}/{qkv,proj,fc_in,
fc_out}/{kernel,bias}`` and ``lnf_*``. The port keeps a flat dict keyed
by ``named_parameters()`` names (``h.{i}.qkv.weight``, ...). Flax
``Dense.kernel`` is (in, out); ``nn.Linear.weight`` is (out, in), so
kernels are transposed on the way in and out. Everything crosses as
numpy arrays: this module imports no JAX.

- `gpt2_params_from_jax` / `gpt2_params_to_numpy`: a `GPT2` from a
  flax tree and back;
- `llama_params_from_jax` / `llama_params_to_numpy`: the same for a
  `Llama`, whose port names are the flax paths joined by dots
  (``layer{i}/wq`` -> ``layer{i}.wq``) and whose projections keep the
  flax (in, out) layout: a copy, no transpose;
- `bert_params_from_jax` / `bert_params_to_numpy`: the same for a
  `BertPretrain` (a tree with ``bert``) or a `Bert`, whose port names
  are the flax paths joined by dots with each Dense's ``kernel`` a
  transposed ``weight`` (``bert/layer0/qkv/kernel`` ->
  ``bert.layer0.qkv.weight``);
- `t5_params_from_jax` / `t5_params_to_numpy`: the same for a `T5`,
  whose port names are the flax paths joined by dots
  (``encoder/layer0/self_attn/wq`` -> ``encoder.layer0.self_attn.wq``)
  with the projections in the flax (in, out) layout: a copy;
- `quant_params_from_jax`: the JAX package's int8 decode tree
  (``{"q", "s"}`` leaves) as the port's, for `models.quant_decode`;
- `mha_params_from_jax`: a `SelfMultiheadAttn` or `EncdecMultiheadAttn`
  from its flax params (the same names, the same (in, out) layout);
- `named_from_flax` / `flax_from_named`: one flax-layout tree (params,
  grads, Adam moments) of any of these models to the port's dict and
  back;
- `amp_state_from_jax` / `amp_state_to_numpy`: the whole amp training
  state (params, fused-Adam m/v/step, loss-scale state).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from apex1_tpu_torch.amp import AmpState
from apex1_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                    SelfMultiheadAttn)
from apex1_tpu_torch.core.loss_scale import LossScaleState
from apex1_tpu_torch.models.bert import Bert, BertConfig, BertPretrain
from apex1_tpu_torch.models.gpt2 import GPT2, GPT2Config
from apex1_tpu_torch.models.llama import Llama, LlamaConfig
from apex1_tpu_torch.models.t5 import T5, T5Config
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import FusedAdamState

_DENSE = ("qkv", "proj", "fc_in", "fc_out")
_NORMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
_TOP = ("wte", "wpe", "lnf_scale", "lnf_bias")
_LS_FIELDS = ("scale", "growth_count", "overflow_count", "hysteresis_left")


def _is_llama(tree) -> bool:
    return "tok_embeddings" in tree


def _is_t5(tree) -> bool:
    return "shared_embedding" in tree


def _dotted(tree, prefix="") -> dict:
    """A nested flax tree as ``{"a.b.c": numpy array}``."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _nested(named: dict, np_) -> dict:
    """The inverse of `_dotted`."""
    out: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = out
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np_(t)
    return out


def _is_bert(tree) -> bool:
    return any(k == "bert" or k.startswith("bert.") or k == "word_embeddings"
               for k in tree)


def _bert_named(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping) and "kernel" in v:
            out[f"{prefix}{k}.weight"] = np.asarray(v["kernel"]).T
            out[f"{prefix}{k}.bias"] = np.asarray(v["bias"])
        elif isinstance(v, Mapping):
            out.update(_bert_named(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _bert_flax(named: dict, np_) -> dict:
    """The inverse of `_bert_named`: each ``weight`` back to a
    transposed ``kernel``."""
    flat = {}
    for name, t in named.items():
        if name.endswith(".weight"):
            flat[name[:-len("weight")] + "kernel"] = np_(t).T.copy()
        else:
            flat[name] = np_(t)
    return _nested(flat, lambda a: a)


def named_from_flax(tree) -> dict:
    """Flax-layout GPT-2, Llama, BERT or T5 tree -> ``{port name: numpy
    array}``."""
    if _is_t5(tree) or _is_llama(tree):
        return _dotted(tree)
    if _is_bert(tree):
        return _bert_named(tree)
    out = {k: np.asarray(tree[k]) for k in _TOP}
    i = 0
    while f"h{i}" in tree:
        p = tree[f"h{i}"]
        for name in _NORMS:
            out[f"h.{i}.{name}"] = np.asarray(p[name])
        for name in _DENSE:
            out[f"h.{i}.{name}.weight"] = np.asarray(p[name]["kernel"]).T
            out[f"h.{i}.{name}.bias"] = np.asarray(p[name]["bias"])
        i += 1
    return out


def flax_from_named(named: dict) -> dict:
    """``{port name: tensor or array}`` -> the flax-layout numpy tree
    (the inverse of `named_from_flax`; grads come back this way)."""
    def np_(t):
        if isinstance(t, torch.Tensor):
            t = t.detach().float().cpu().numpy()
        return np.asarray(t)

    if _is_t5(named) or _is_llama(named):
        return _nested(named, np_)
    if _is_bert(named):
        return _bert_flax(named, np_)
    out = {k: np_(named[k]) for k in _TOP}
    i = 0
    while f"h.{i}.qkv.weight" in named:
        p = {name: np_(named[f"h.{i}.{name}"]) for name in _NORMS}
        for name in _DENSE:
            p[name] = {"kernel": np_(named[f"h.{i}.{name}.weight"]).T.copy(),
                       "bias": np_(named[f"h.{i}.{name}.bias"])}
        out[f"h{i}"] = p
        i += 1
    return out


def _tensors(named: dict, device) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in named.items()}


def gpt2_params_from_jax(params, cfg: GPT2Config, device=None) -> GPT2:
    """A `GPT2` on ``device`` (CUDA unless named) holding ``params``."""
    return _load(GPT2(cfg, device=device), named_from_flax(params))


def gpt2_params_to_numpy(model: GPT2) -> dict:
    """The inverse of `gpt2_params_from_jax`: the flax-layout numpy
    tree of ``model``'s parameters."""
    return flax_from_named(dict(model.named_parameters()))


def _load(model, src: dict):
    with torch.no_grad():
        for name, p in model.named_parameters():
            if tuple(src[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {src[name].shape} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(src[name], np.float32)))
    return model


def llama_params_from_jax(params, cfg: LlamaConfig, device=None) -> Llama:
    """A `Llama` on ``device`` (CUDA unless named) holding ``params``
    (the JAX package's flax tree, numpy or JAX arrays)."""
    return _load(Llama(cfg, device=device), named_from_flax(params))


def llama_params_to_numpy(model: Llama) -> dict:
    """The inverse of `llama_params_from_jax`: the flax-layout numpy
    tree of ``model``'s parameters."""
    return flax_from_named(dict(model.named_parameters()))


def _leaf_tensor(a, device) -> torch.Tensor:
    """One array as a tensor on ``device``; numpy's bfloat16 (ml_dtypes,
    which torch does not read) crosses as its bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def quant_params_from_jax(qparams, device=None) -> dict:
    """The JAX package's int8 decode tree (`quantize_llama_params` /
    `quantize_gpt2_params` there: ``{"q": int8 (out, in), "s": fp32
    (out,)}`` leaves, embeddings in the compute dtype, norms and biases
    fp32; numpy or JAX arrays) as the port's, the same keys, tensors on
    ``device`` (CUDA unless named); pass it to
    `models.quant_decode.llama_quant_decoder(model, qparams)` (or the
    GPT-2 one) to serve a tree quantized in JAX unchanged."""
    dev = resolve_device(device)

    def walk(tree):
        return {k: (walk(v) if isinstance(v, Mapping)
                    else _leaf_tensor(v, dev)) for k, v in tree.items()}

    return walk(qparams)


def bert_params_from_jax(params, cfg: BertConfig, device=None):
    """A `BertPretrain` (``params`` holds ``bert``) or a `Bert` on
    ``device`` (CUDA unless named) holding the JAX package's flax
    ``params`` (numpy or JAX arrays)."""
    cls = BertPretrain if "bert" in params else Bert
    return _load(cls(cfg, device=device), named_from_flax(params))


def bert_params_to_numpy(model) -> dict:
    """The inverse of `bert_params_from_jax`: the flax-layout numpy tree
    of ``model``'s parameters."""
    return flax_from_named(dict(model.named_parameters()))


def t5_params_from_jax(params, cfg: T5Config, device=None) -> T5:
    """A `T5` on ``device`` (CUDA unless named) holding the JAX package's
    flax ``params`` (numpy or JAX arrays)."""
    return _load(T5(cfg, device=device), named_from_flax(params))


def t5_params_to_numpy(model: T5) -> dict:
    """The inverse of `t5_params_from_jax`: the flax-layout numpy tree
    of ``model``'s parameters."""
    return flax_from_named(dict(model.named_parameters()))


def mha_params_from_jax(params, module):
    """``module`` (a `SelfMultiheadAttn` or `EncdecMultiheadAttn` built
    with the flax module's options) holding the flax ``params``: the
    same names and (in, out) layouts. Returns ``module``."""
    if not isinstance(module, (SelfMultiheadAttn, EncdecMultiheadAttn)):
        raise TypeError(f"expected a multihead attention module, got "
                        f"{type(module).__name__}")
    named = _dotted(params)
    if set(named) != {n for n, _ in module.named_parameters()}:
        raise ValueError(f"params {sorted(named)} do not fit the module's "
                         f"{sorted(n for n, _ in module.named_parameters())}")
    return _load(module, named)


def amp_state_from_jax(state, device=None) -> AmpState:
    """The port's `AmpState` from a JAX ``apex1_tpu.amp.AmpState`` whose
    leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray,
    state)``), of a GPT-2, a Llama, a BERT or a T5, trained with
    ``fused_adam`` and one loss scaler: params and the Adam moments in
    fp32, the counters as 0-d device tensors."""
    dev = resolve_device(device)
    opt, ls = state.opt_state, state.loss_scale

    def scalar(x, dtype):
        return torch.tensor(np.asarray(x).item(), dtype=dtype, device=dev)

    return AmpState(
        step=scalar(state.step, torch.int32),
        params=_tensors(named_from_flax(state.params), dev),
        opt_state=FusedAdamState(
            step=scalar(opt.step, torch.int32),
            exp_avg=_tensors(named_from_flax(opt.exp_avg), dev),
            exp_avg_sq=_tensors(named_from_flax(opt.exp_avg_sq), dev)),
        loss_scale=LossScaleState(**{
            f: scalar(getattr(ls, f),
                      torch.float32 if f == "scale" else torch.int32)
            for f in _LS_FIELDS}))


def amp_state_to_numpy(state: AmpState) -> dict:
    """The port's `AmpState` as numpy in the JAX package's layout:
    ``{"step", "params", "opt_state": {"step", "exp_avg", "exp_avg_sq"},
    "loss_scale": {scale, growth_count, overflow_count,
    hysteresis_left}}``."""
    def np_(t):
        return t.detach().cpu().numpy()

    opt = state.opt_state
    return {
        "step": np_(state.step),
        "params": flax_from_named(state.params),
        "opt_state": {"step": np_(opt.step),
                      "exp_avg": flax_from_named(opt.exp_avg),
                      "exp_avg_sq": flax_from_named(opt.exp_avg_sq)},
        "loss_scale": {f: np_(getattr(state.loss_scale, f))
                       for f in _LS_FIELDS}}
