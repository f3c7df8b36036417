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
- `named_from_flax` / `flax_from_named`: one flax-layout tree (params,
  grads, Adam moments) to the port's dict and back;
- `amp_state_from_jax` / `amp_state_to_numpy`: the whole amp training
  state (params, fused-Adam m/v/step, loss-scale state).
"""

from __future__ import annotations

import numpy as np
import torch

from apex1_tpu_torch.amp import AmpState
from apex1_tpu_torch.core.loss_scale import LossScaleState
from apex1_tpu_torch.models.gpt2 import GPT2, GPT2Config
from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.optim.fused_adam import FusedAdamState

_DENSE = ("qkv", "proj", "fc_in", "fc_out")
_NORMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
_TOP = ("wte", "wpe", "lnf_scale", "lnf_bias")
_LS_FIELDS = ("scale", "growth_count", "overflow_count", "hysteresis_left")


def named_from_flax(tree) -> dict:
    """Flax-layout GPT-2 tree -> ``{port name: numpy array}``."""
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
    model = GPT2(cfg, device=device)
    src = named_from_flax(params)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if tuple(src[name].shape) != tuple(p.shape):
                raise ValueError(f"{name}: shape {src[name].shape} vs "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(src[name], np.float32)))
    return model


def gpt2_params_to_numpy(model: GPT2) -> dict:
    """The inverse of `gpt2_params_from_jax`: the flax-layout numpy
    tree of ``model``'s parameters."""
    return flax_from_named(dict(model.named_parameters()))


def amp_state_from_jax(state, device=None) -> AmpState:
    """The port's `AmpState` from a JAX ``apex1_tpu.amp.AmpState`` whose
    leaves are numpy arrays (``jax.tree_util.tree_map(np.asarray,
    state)``), trained with ``fused_adam`` and one loss scaler: params
    and the Adam moments in fp32, the counters as 0-d device tensors."""
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
