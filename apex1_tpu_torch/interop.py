"""Parameters between the JAX package and the port.

`gpt2_params_from_jax` fills the port's `GPT2` from the flax parameter
tree of ``apex1_tpu.models.gpt2.GPT2``, handed over as numpy arrays
(this module imports no JAX): ``wte``, ``wpe``, ``h{i}/{ln1,ln2}_{scale,
bias}``, ``h{i}/{qkv,proj,fc_in,fc_out}/{kernel,bias}`` and ``lnf_*``.
Flax ``Dense.kernel`` is (in, out); ``nn.Linear.weight`` is (out, in),
so kernels are transposed on the way in and out.
"""

from __future__ import annotations

import numpy as np
import torch

from apex1_tpu_torch.models.gpt2 import GPT2, GPT2Config

_DENSE = ("qkv", "proj", "fc_in", "fc_out")
_NORMS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def _copy(dst: torch.Tensor, src) -> None:
    src = np.array(src, np.float32)     # a writable, contiguous copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {src.shape} vs "
                         f"{tuple(dst.shape)}")
    dst.copy_(torch.from_numpy(src))


def gpt2_params_from_jax(params, cfg: GPT2Config, device=None) -> GPT2:
    """A `GPT2` on ``device`` (CUDA unless named) holding ``params``."""
    model = GPT2(cfg, device=device)
    with torch.no_grad():
        _copy(model.wte, params["wte"])
        _copy(model.wpe, params["wpe"])
        _copy(model.lnf_scale, params["lnf_scale"])
        _copy(model.lnf_bias, params["lnf_bias"])
        for i, blk in enumerate(model.h):
            p = params[f"h{i}"]
            for name in _NORMS:
                _copy(getattr(blk, name), p[name])
            for name in _DENSE:
                lin = getattr(blk, name)
                _copy(lin.weight, np.asarray(p[name]["kernel"]).T)
                _copy(lin.bias, p[name]["bias"])
    return model


def gpt2_params_to_numpy(model: GPT2) -> dict:
    """The inverse of `gpt2_params_from_jax`: the flax-layout numpy
    tree of ``model``'s parameters."""
    def np_(t):
        return t.detach().float().cpu().numpy()

    out = {"wte": np_(model.wte), "wpe": np_(model.wpe),
           "lnf_scale": np_(model.lnf_scale),
           "lnf_bias": np_(model.lnf_bias)}
    for i, blk in enumerate(model.h):
        p = {name: np_(getattr(blk, name)) for name in _NORMS}
        for name in _DENSE:
            lin = getattr(blk, name)
            p[name] = {"kernel": np_(lin.weight).T.copy(),
                       "bias": np_(lin.bias)}
        out[f"h{i}"] = p
    return out
