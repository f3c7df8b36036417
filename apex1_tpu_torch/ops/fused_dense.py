"""Fused dense layers and the fused gated MLP (the port of
``apex1_tpu/ops/fused_dense.py``).

The thin modules, with no kernel of their own in the JAX package:
`fused_dense` (``y = x @ Wᵀ + b``, W (out, in) as ``apex.fused_dense``
stores it), `fused_dense_gelu_dense`, `FusedDense`,
`FusedDenseGeluDense` and `MLP` (``apex.mlp.MLP``). As in JAX
(``preferred_element_type=f32``) the product is summed in fp32, the
bias added in fp32 and the result rounded to x's dtype once: a half
``torch.matmul`` would round before the bias. The products are plain
fp32 ``torch.matmul`` (TF32 off, PyTorch's default); their backward is
autograd's.

``act(x @ w_gate) * (x @ w_up)``: Llama's SwiGLU (``silu``) or GeGLU
(tanh ``gelu``), the two products sharing one ``x``. One kernel,
``csrc/glu.cu`` (TPU row 13; bf16/fp16 on wgmma, both products from one
x tile, 128 x 128 or 128 x 64 output tiles: an explicit ``tile_n``,
else the tuning table's ``fused_swiglu`` entry, else the library's
``tile_n`` as `glu_tile` reports it; fp32 on the CUDA cores, 64 columns
only), beside its plain PyTorch version: both products summed
in fp32, the activation and the product in fp32, the result rounded to
x's dtype once (the TPU kernel's ``preferred_element_type=f32``
numbers).

The backward is the JAX package's recompute VJP (``_glu_bwd``): it saves
(x, Wg, Wu), recomputes g and u in fp32 and forms dx, dWg and dWu from
fp32 operands. Those products lie outside any TPU kernel, so they are
plain ``torch.matmul`` in fp32 (TF32 off, PyTorch's default).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from apex1_tpu_torch import tuning
from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import (DTYPE_CODES, check_cuda,
                                         resolve_device, use_kernel)

_LANES = 128
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: activation name -> (fp32 function, kernel code)
_GLU_ACTS = {"silu": (lambda g: g * torch.sigmoid(g), 0),
             "gelu": (lambda g: F.gelu(g, approximate="tanh"), 1)}


def check_glu_geometry(block_t: int, block_f: int) -> tuple[int, int]:
    """Validate a fused-glu tile as the JAX package does: ``block_t`` a
    multiple of 8 and ``block_f`` of 128, else ValueError. These are the
    TPU's tile names and size no CUDA launch: the kernel's own tile, its
    ``tile_n``, is priced by `vmem_model.fused_swiglu_check` (shared
    memory and registers a block, from the hidden size and element size)
    when the tuning table serves one (`glu_tile_n`)."""
    if block_t < 8 or block_t % 8:
        raise ValueError(
            f"fused_glu: block_t={block_t} must be a multiple of 8 "
            f"(sublane tiling)")
    if block_f < _LANES or block_f % _LANES:
        raise ValueError(
            f"fused_glu: block_f={block_f} must be a multiple of {_LANES}")
    return block_t, block_f


def glu_tile(T: int, F: int, dtype: torch.dtype) -> tuple:
    """The output tile (rows, columns) the kernel launches for a ``T x
    F`` output in ``dtype`` (it needs the built library, so the card)."""
    t = _build.library().apex1_glu_tile(T, F, DTYPE_CODES[dtype])
    return t // 1000, t % 1000


def glu_tile_n(T: int, H: int, dtype: torch.dtype, tile_n=None) -> int:
    """The output tile's columns `glu_fwd` asks of the library:
    ``tile_n`` (what the sweep passes) > the tuning table's
    ``fused_swiglu`` entry for the padded hidden and the token bucket >
    0, which leaves the library's ``tile_n`` choice (`glu_tile`)."""
    got, _src = tuning.resolve(
        "fused_swiglu", None if tile_n is None else {"tile_n": tile_n},
        lambda: {"Hp": tuning.padded_lanes(H), "Tb": tuning.token_bucket(T)},
        dtype, lambda: {"tile_n": 0})
    return int(got["tile_n"])


def _plain_glu(x2, wg, wu, activation):
    act = _GLU_ACTS[activation][0]
    xf = x2.float()
    return (act(xf @ wg.float()) * (xf @ wu.float())).to(x2.dtype)


def glu_fwd(x2: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            activation: str = "silu", *, tile_n=None) -> torch.Tensor:
    """``act(x2 @ wg) * (x2 @ wu)`` for (T, H) ``x2`` and (H, F) weights,
    (T, F) in x's dtype. CUDA tensors launch the kernel
    (``glu_fwd.launches``) at `glu_tile_n`'s tile; CPU tensors take the
    plain version."""
    if not use_kernel(x2):
        return _plain_glu(x2, wg, wu, activation)
    if x2.dtype not in _DTYPES or wg.dtype != x2.dtype or \
            wu.dtype != x2.dtype:
        raise ValueError(f"glu_fwd: x and the weights must share one of "
                         f"f32/bf16/f16, got {x2.dtype}, {wg.dtype}, "
                         f"{wu.dtype}")
    if x2.dim() != 2 or wg.shape != wu.shape or wg.shape[0] != x2.shape[1]:
        raise ValueError(f"glu_fwd: x {tuple(x2.shape)}, w_gate "
                         f"{tuple(wg.shape)} and w_up {tuple(wu.shape)} do "
                         f"not fit")
    x2, wg, wu = x2.contiguous(), wg.contiguous(), wu.contiguous()
    check_cuda("glu_fwd", x2, wg, wu)
    (T, H), Fo = x2.shape, wg.shape[1]
    out = torch.empty(T, Fo, dtype=x2.dtype, device=x2.device)
    epv = 16 // x2.element_size()
    vec = H % epv == 0 and Fo % epv == 0 and all(
        t.data_ptr() % 16 == 0 for t in (x2, wg, wu))
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    _build.launch("apex1_glu_fwd", x2.data_ptr(), wg.data_ptr(),
                  wu.data_ptr(), out.data_ptr(), T, H, Fo,
                  _GLU_ACTS[activation][1], int(vec), DTYPE_CODES[x2.dtype],
                  glu_tile_n(T, H, x2.dtype, tile_n), stream)
    glu_fwd.launches += 1
    return out


glu_fwd.launches = 0


def _glu_bwd(x2, wg, wu, dy, activation):
    """The JAX package's ``_glu_bwd``: fp32 recompute of g and u, then
    dx, dWg, dWu from fp32 operands, each rounded to its input's dtype."""
    act = _GLU_ACTS[activation][0]
    xf, wgf, wuf, dyf = x2.float(), wg.float(), wu.float(), dy.float()
    g = (xf @ wgf).requires_grad_()
    u = xf @ wuf
    with torch.enable_grad():
        a = act(g)
        dg, = torch.autograd.grad(a, g, dyf * u)
    du = dyf * a.detach()
    dx = dg @ wgf.t() + du @ wuf.t()
    return (dx.to(x2.dtype), (xf.t() @ dg).to(wg.dtype),
            (xf.t() @ du).to(wu.dtype))


class _GluFused(torch.autograd.Function):
    """The JAX package's ``_glu_fused`` custom VJP: the residuals are the
    operands, never the (T, F) activations."""

    @staticmethod
    def forward(ctx, x2, wg, wu, activation):
        ctx.save_for_backward(x2, wg, wu)
        ctx.activation = activation
        return glu_fwd(x2, wg, wu, activation)

    @staticmethod
    def backward(ctx, dy):
        x2, wg, wu = ctx.saved_tensors
        with torch.no_grad():
            dx, dwg, dwu = _glu_bwd(x2, wg, wu, dy, ctx.activation)
        return dx, dwg, dwu, None


def fused_glu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
              *, activation: str = "silu", block_t: Optional[int] = None,
              block_f: Optional[int] = None) -> torch.Tensor:
    """``act(x @ w_gate) * (x @ w_up)`` in one pass over ``x``.

    ``x`` (..., H); ``w_gate``/``w_up`` (H, F), the (in, out) layout the
    Llama model stores. ``activation``: "silu" (SwiGLU) or "gelu"
    (GeGLU, tanh approximation). Returns (..., F) in ``x.dtype``; the
    down projection stays an ordinary matmul. ``block_t``/``block_f``
    (the TPU's tile) are validated as the JAX package validates them and
    have no effect on the CUDA tiles. Differentiable through a recompute
    backward (the gate/up activations are never saved)."""
    if activation not in _GLU_ACTS:
        raise ValueError(f"fused_glu: activation must be one of "
                         f"{sorted(_GLU_ACTS)}, got {activation!r}")
    if block_t is not None or block_f is not None:
        check_glu_geometry(int(block_t or 128), int(block_f or 256))
    lead, H = x.shape[:-1], x.shape[-1]
    out = _GluFused.apply(x.reshape(-1, H), w_gate, w_up, activation)
    return out.reshape(*lead, w_gate.shape[1])


# ---- the thin modules (no kernel) ---------------------------------------


def fused_dense(x: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``y = x @ weightᵀ + bias`` for a (out, in) ``weight``: summed in
    fp32, the bias added in fp32, rounded to x's dtype once."""
    y = torch.matmul(x.float(), weight.float().t())
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def fused_dense_gelu_dense(x, w1, b1, w2, b2) -> torch.Tensor:
    """Linear + bias + GELU (tanh) + Linear + bias (``apex.fused_dense``'s
    ``FusedDenseGeluDenseFunc``); each dense rounds to x's dtype once."""
    h = F.gelu(fused_dense(x, w1, b1), approximate="tanh")
    return fused_dense(h, w2, b2)


def lecun_normal_(p: torch.Tensor, fan_in: int) -> torch.Tensor:
    """flax's ``lecun_normal`` in place: a normal truncated at two
    standard deviations, of variance 1 / fan_in (the draws are not
    JAX's: carry its params with `interop.module_params_from_jax`)."""
    with torch.no_grad():
        nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0)
        return p.mul_(math.sqrt(1.0 / fan_in) / .87962566103423978)


def _dense_params(mod: nn.Module, wname: str, bname: str, bias: bool,
                  fan_in: int, fan_out: int, device):
    """A (fan_out, fan_in) lecun-normal weight and a zero bias (None
    without ``bias``), fp32 on ``device``."""
    mod.register_parameter(wname, nn.Parameter(lecun_normal_(
        torch.empty(fan_out, fan_in, device=device), fan_in)))
    mod.register_parameter(bname, nn.Parameter(
        torch.zeros(fan_out, device=device)) if bias else None)


def _cast(t: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    return None if t is None else t.to(dtype)


class FusedDense(nn.Module):
    """``apex.fused_dense.FusedDense(in_features, out_features, bias)``:
    fp32 ``weight`` (out, in) and ``bias`` (out,) on ``device`` (CUDA
    unless the caller names another), cast to x's dtype at the call."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, device=None):
        super().__init__()
        _dense_params(self, "weight", "bias", bias, in_features,
                      out_features, resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense(x, self.weight.to(x.dtype),
                           _cast(self.bias, x.dtype))


class FusedDenseGeluDense(nn.Module):
    """``apex.fused_dense.FusedDenseGeluDense(in_features,
    intermediate_features, out_features, bias)``: ``weight1``,
    ``bias1``, ``weight2``, ``bias2``."""

    def __init__(self, in_features: int, intermediate_features: int,
                 out_features: int, bias: bool = True, device=None):
        super().__init__()
        dev = resolve_device(device)
        _dense_params(self, "weight1", "bias1", bias, in_features,
                      intermediate_features, dev)
        _dense_params(self, "weight2", "bias2", bias, intermediate_features,
                      out_features, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_dense_gelu_dense(
            x, self.weight1.to(x.dtype), _cast(self.bias1, x.dtype),
            self.weight2.to(x.dtype), _cast(self.bias2, x.dtype))


_ACTIVATIONS = {"none": None, "relu": F.relu, "sigmoid": torch.sigmoid}


class MLP(nn.Module):
    """``apex.mlp.MLP(mlp_sizes, bias, activation)``: Linear(+bias) layers
    ``weight_{i}`` (out, in) and ``bias_{i}``, ``activation`` ("none",
    "relu" or "sigmoid") between them and none after the last."""

    def __init__(self, mlp_sizes: Sequence[int], bias: bool = True,
                 activation: str = "relu", device=None):
        super().__init__()
        if len(mlp_sizes) < 2:
            raise ValueError("mlp_sizes needs >= 2 entries")
        self.act = _ACTIVATIONS[activation]
        self.num_layers = len(mlp_sizes) - 1
        dev = resolve_device(device)
        for i, (fan_in, fan_out) in enumerate(zip(mlp_sizes[:-1],
                                                  mlp_sizes[1:])):
            _dense_params(self, f"weight_{i}", f"bias_{i}", bias, fan_in,
                          fan_out, dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.num_layers):
            h = fused_dense(h, getattr(self, f"weight_{i}").to(h.dtype),
                            _cast(getattr(self, f"bias_{i}"), h.dtype))
            if self.act is not None and i < self.num_layers - 1:
                h = self.act(h)
        return h
