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
- `module_params_from_jax`: the same for the thin modules, whose port
  keeps the flax names and layouts: `ops.fused_dense`'s `FusedDense`,
  `FusedDenseGeluDense` and `MLP` (weights (out, in) in both),
  `contrib.group_norm.GroupNorm`, `reparameterization.WeightNormDense`
  and `rnn`'s `LSTM`, `GRU`, `RNNReLU` and `RNNTanh`;
- `named_from_flax` / `flax_from_named`: one flax-layout tree (params,
  grads, Adam moments) of any of these models to the port's dict and
  back;
- `resnet_params_from_jax` / `resnet_params_to_numpy`: a `ResNet` from
  its flax ``params`` and ``batch_stats`` and back: flax HWIO kernels
  are OIHW weights, the ``fc`` kernel transposed, the batch norms'
  ``scale``/``bias`` params and ``mean``/``var`` buffers carried as
  they are;
- `llama3d_state_from_jax`: the JAX package's `llama_3d` global trees
  ``{"chunk", "shared"}`` (and optionally its fused-Adam state) as this
  rank's train state of the port's `models.llama_3d`;
- `rnnt_params_from_jax`: the `rnnt_speech` example's `RNNT` from the
  JAX script's flax params (the two LSTMs through
  `module_params_from_jax`, the embedding and head as they are);
- `dcgan_params_from_jax`: the `dcgan_amp` example's `Generator` and
  `Discriminator` and their running statistics from the JAX script's
  flax variables (HWIO kernels, ``scale``/``bias`` params and
  ``mean``/``var`` statistics, as they are: the port's modules keep
  flax's names and layouts);
- `amp_state_from_jax` / `amp_state_to_numpy`: the whole amp training
  state (params; the optimizer state of fused Adam, SGD, LAMB,
  NovoGrad or Adagrad, LARC's step count, a ``chain`` of them as a
  tuple; the loss-scale state, a tuple of them with ``num_losses >
  1``).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from apex1_tpu_torch.amp import AmpState
from apex1_tpu_torch.contrib.group_norm import GroupNorm
from apex1_tpu_torch.contrib.multihead_attn import (EncdecMultiheadAttn,
                                                    SelfMultiheadAttn)
from apex1_tpu_torch.core.loss_scale import LossScaleState
from apex1_tpu_torch.models.bert import Bert, BertConfig, BertPretrain
from apex1_tpu_torch.models.gpt2 import GPT2, GPT2Config
from apex1_tpu_torch.models.llama import Llama, LlamaConfig
from apex1_tpu_torch.models.resnet import ResNet, ResNetConfig
from apex1_tpu_torch.models.t5 import T5, T5Config
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.ops.fused_dense import (MLP, FusedDense,
                                             FusedDenseGeluDense)
from apex1_tpu_torch.optim import (FusedAdagradState, FusedAdamState,
                                   FusedLAMBState, FusedNovoGradState,
                                   FusedSGDState)
from apex1_tpu_torch.reparameterization import WeightNormDense
from apex1_tpu_torch.rnn import GRU, LSTM, RNNReLU

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


def _is_resnet(tree) -> bool:
    return any(k == "stem_conv" or k.startswith("stem_conv.")
               or k == "stem_bn" or k.startswith("stem_bn.") for k in tree)


def _resnet_named(tree, prefix="") -> dict:
    """A flax ResNet tree (params, grads, optimizer moments or
    ``batch_stats``) as ``{port name: numpy array}``: each ``kernel`` a
    ``weight``, HWIO -> OIHW, (in, out) -> (out, in); per-tensor 0-d
    leaves (NovoGrad's second moment) as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_resnet_named(v, f"{prefix}{k}."))
            continue
        a = np.asarray(v)
        if k == "kernel":
            a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            k = "weight"
        out[f"{prefix}{k}"] = a
    return out


def _resnet_flax(named: dict, np_) -> dict:
    """The inverse of `_resnet_named`."""
    flat = {}
    for name, t in named.items():
        a = np_(t)
        if name.endswith(".weight"):
            a = (a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T).copy()
            name = name[:-len("weight")] + "kernel"
        flat[name] = a
    return _nested(flat, lambda a: a)


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
    """Flax-layout GPT-2, Llama, BERT, T5 or ResNet tree -> ``{port name: numpy
    array}``."""
    if _is_t5(tree) or _is_llama(tree):
        return _dotted(tree)
    if _is_resnet(tree):
        return _resnet_named(tree)
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
    if _is_resnet(named):
        return _resnet_flax(named, np_)
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
    """One array as a tensor on ``device`` (a tensor moves, copied only
    when it changes device); numpy's bfloat16 (ml_dtypes, which torch
    does not read) crosses as its bits."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
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


def _same_names(params, module):
    named = _dotted(params)
    if set(named) != {n for n, _ in module.named_parameters()}:
        raise ValueError(f"params {sorted(named)} do not fit the module's "
                         f"{sorted(n for n, _ in module.named_parameters())}")
    return _load(module, named)


def mha_params_from_jax(params, module):
    """``module`` (a `SelfMultiheadAttn` or `EncdecMultiheadAttn` built
    with the flax module's options) holding the flax ``params``: the
    same names and (in, out) layouts. Returns ``module``."""
    if not isinstance(module, (SelfMultiheadAttn, EncdecMultiheadAttn)):
        raise TypeError(f"expected a multihead attention module, got "
                        f"{type(module).__name__}")
    return _same_names(params, module)


#: the thin modules whose parameters keep the flax names and layouts
_THIN = (FusedDense, FusedDenseGeluDense, MLP, GroupNorm, WeightNormDense,
         LSTM, GRU, RNNReLU)


def module_params_from_jax(params, module):
    """``module`` (one of the thin modules, built with the flax module's
    options: `FusedDense`, `FusedDenseGeluDense`, `MLP`, `GroupNorm`,
    `WeightNormDense`, `LSTM`, `GRU`, `RNNReLU`, `RNNTanh`) holding the
    flax ``params`` as numpy: the same names and layouts. Returns
    ``module``."""
    if not isinstance(module, _THIN):
        raise TypeError(f"expected one of {[t.__name__ for t in _THIN]}, "
                        f"got {type(module).__name__}")
    return _same_names(params, module)


def resnet_params_from_jax(params, batch_stats, cfg: ResNetConfig,
                           device=None) -> ResNet:
    """A `ResNet` on ``device`` (CUDA unless named) holding the JAX
    package's flax ``params`` and ``batch_stats`` (numpy or JAX
    arrays)."""
    model = _load(ResNet(cfg, device=device), named_from_flax(params))
    stats = named_from_flax(batch_stats)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if tuple(stats[name].shape) != tuple(b.shape):
                raise ValueError(f"{name}: shape {stats[name].shape} vs "
                                 f"{tuple(b.shape)}")
            b.copy_(torch.from_numpy(np.array(stats[name], np.float32)))
    return model


def resnet_params_to_numpy(model: ResNet):
    """The inverse of `resnet_params_from_jax`: ``(params,
    batch_stats)`` as flax-layout numpy trees."""
    return (flax_from_named(dict(model.named_parameters())),
            flax_from_named(dict(model.named_buffers())))


def rnnt_params_from_jax(params, vocab: int, feat: int, hidden: int = 64,
                         device=None):
    """The `examples.rnnt_speech.RNNT` (``vocab``, ``feat``, ``hidden``)
    on ``device`` (CUDA unless named) holding the JAX script's flax
    ``params``: ``encoder`` and ``predictor`` (rnn.LSTM's own names),
    ``embed`` and ``head``."""
    from apex1_tpu_torch.examples.rnnt_speech import RNNT
    model = RNNT(vocab, feat, hidden, device=device)
    module_params_from_jax(params["encoder"], model.encoder)
    module_params_from_jax(params["predictor"], model.predictor)
    with torch.no_grad():
        for name in ("embed", "head"):
            getattr(model, name).copy_(torch.from_numpy(
                np.array(params[name], np.float32)))
    return model


def dcgan_params_from_jax(gvars, dvars, *, zdim: int = 100,
                          dtype=torch.bfloat16, device=None):
    """``(generator, discriminator, (g_stats, d_stats))``: the
    `examples.dcgan_amp` modules (compute ``dtype``) on ``device`` (CUDA
    unless named) holding the JAX script's flax variables ``gvars`` and
    ``dvars`` (``{"params", "batch_stats"}``), and their running
    statistics as the port's ``{"BatchNorm_i.mean" | ".var": tensor}``
    dicts. The names and layouts are flax's: a copy each."""
    from apex1_tpu_torch.examples.dcgan_amp import Discriminator, Generator
    dev = resolve_device(device)

    def stats(tree):
        return {k: torch.from_numpy(np.array(v, np.float32)).to(dev)
                for k, v in _dotted(tree).items()}

    gen = _load(Generator(zdim, dtype=dtype, device=dev),
                _dotted(gvars["params"]))
    disc = _load(Discriminator(dtype=dtype, device=dev),
                 _dotted(dvars["params"]))
    return gen, disc, (stats(gvars["batch_stats"]),
                       stats(dvars["batch_stats"]))


_OPT_STATES = {cls.__name__: cls for cls in (
    FusedAdamState, FusedSGDState, FusedLAMBState, FusedNovoGradState,
    FusedAdagradState)}


def _scalar(x, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x).item(), dtype=dtype, device=dev)


def _ls_from_jax(ls, dev) -> LossScaleState:
    return LossScaleState(**{
        f: _scalar(getattr(ls, f),
                   torch.float32 if f == "scale" else torch.int32, dev)
        for f in _LS_FIELDS})


def _opt_from_jax(opt, dev):
    """One JAX optimizer state (a NamedTuple of the JAX package's
    optimizers, a tuple of them from ``optax.chain``, or LARC's 0-d step
    count) as the port's."""
    name = type(opt).__name__
    if name in _OPT_STATES:
        return _OPT_STATES[name](**{
            f: (_scalar(getattr(opt, f), torch.int32, dev) if f == "step"
                else _tensors(named_from_flax(getattr(opt, f)), dev))
            for f in opt._fields})
    if isinstance(opt, (tuple, list)):
        return tuple(_opt_from_jax(o, dev) for o in opt)
    if np.ndim(opt) == 0:
        return _scalar(opt, torch.int32, dev)
    raise TypeError(f"no port counterpart for optimizer state {name}")


def amp_state_from_jax(state, device=None) -> AmpState:
    """The port's `AmpState` from a JAX ``apex1_tpu.amp.AmpState`` whose
    leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray,
    state)``), of a GPT-2, a Llama, a BERT, a T5 or a ResNet, trained
    with any optimizer of `optim` (or a ``chain`` of them) and one loss
    scaler or several: params and the moments in fp32, the counters as
    0-d device tensors."""
    dev = resolve_device(device)
    ls = state.loss_scale
    return AmpState(
        step=_scalar(state.step, torch.int32, dev),
        params=_tensors(named_from_flax(state.params), dev),
        opt_state=_opt_from_jax(state.opt_state, dev),
        loss_scale=(tuple(_ls_from_jax(s, dev) for s in ls)
                    if isinstance(ls, (tuple, list))
                    else _ls_from_jax(ls, dev)))


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def _opt_to_numpy(opt):
    if isinstance(opt, tuple):
        return [_opt_to_numpy(o) for o in opt]
    if isinstance(opt, torch.Tensor):
        return _np(opt)
    return {f.name: (_np(getattr(opt, f.name)) if f.name == "step"
                     else flax_from_named(getattr(opt, f.name)))
            for f in dataclasses.fields(opt)}


def amp_state_to_numpy(state: AmpState) -> dict:
    """The port's `AmpState` as numpy in the JAX package's layout:
    ``{"step", "params", "opt_state", "loss_scale"}``, the optimizer
    state as ``{field: value}`` (Adam: ``{"step", "exp_avg",
    "exp_avg_sq"}``; a chain a list of them; LARC's count an array), the
    loss scale as ``{scale, growth_count, overflow_count,
    hysteresis_left}`` (a list of them with ``num_losses > 1``)."""
    def ls_np(ls):
        return {f: _np(getattr(ls, f)) for f in _LS_FIELDS}

    ls = state.loss_scale
    return {
        "step": _np(state.step),
        "params": flax_from_named(state.params),
        "opt_state": _opt_to_numpy(state.opt_state),
        "loss_scale": ([ls_np(s) for s in ls] if isinstance(ls, tuple)
                       else ls_np(ls))}


def llama3d_state_from_jax(params, cfg, mesh=None, opt_state=None,
                           device=None) -> dict:
    """This rank's `models.llama_3d` train state from the JAX package's
    global ``{"chunk": {...}, "shared": {...}}`` params (numpy or JAX
    arrays; chunk leaves (num_chunks, pp, layers_per_stage, ...)) on
    ``device`` (CUDA unless named), sharded over ``mesh``
    (`parallel_state`'s by default) as `llama_3d.shard_params` shards.
    ``opt_state``: JAX's `FusedAdamState` (or a dict with ``step``,
    ``exp_avg``, ``exp_avg_sq`` trees shaped like ``params``), carried
    into the state's moments and step; else the moments start at zero.
    The leaves may be the port's tensors too (`llama_3d.local_state`).
    """
    from apex1_tpu_torch.models import llama_3d
    from apex1_tpu_torch.optim.fused_adam import FusedAdamState
    dev = resolve_device(device)

    def local(tree):
        chunk = {k: _leaf_tensor(v, dev) for k, v in tree["chunk"].items()}
        shared = {k: _leaf_tensor(v, dev)
                  for k, v in tree["shared"].items()}
        return llama_3d.shard_params(chunk, shared, cfg, mesh)

    state = llama_3d.state_template(cfg, local(params))
    if opt_state is not None:
        get = (opt_state.get if isinstance(opt_state, Mapping)
               else lambda k: getattr(opt_state, k))
        state["opt"] = FusedAdamState(
            step=_leaf_tensor(get("step"), dev).to(torch.int32),
            exp_avg=local(get("exp_avg")),
            exp_avg_sq=local(get("exp_avg_sq")))
        state["step"] = state["opt"].step.clone()
    return state
