"""Fused gated MLP (the port of ``fused_glu`` and ``check_glu_geometry``
in ``apex1_tpu/ops/fused_dense.py``).

``act(x @ w_gate) * (x @ w_up)``: Llama's SwiGLU (``silu``) or GeGLU
(tanh ``gelu``), the two products sharing one ``x``. One kernel,
``csrc/glu.cu`` (TPU row 13; bf16/fp16 on wgmma, both products from one
x tile, 128 x 128 or 128 x 64 output tiles as `glu_tile` says; fp32 on
the CUDA cores), beside its plain PyTorch version: both products summed
in fp32, the activation and the product in fp32, the result rounded to
x's dtype once (the TPU kernel's ``preferred_element_type=f32``
numbers).

The backward is the JAX package's recompute VJP (``_glu_bwd``): it saves
(x, Wg, Wu), recomputes g and u in fp32 and forms dx, dWg and dWu from
fp32 operands. Those products lie outside any TPU kernel, so they are
plain ``torch.matmul`` in fp32 (TF32 off, PyTorch's default).

The thin ``fused_dense``, ``FusedDense``, ``FusedDenseGeluDense`` and
``MLP`` modules (no kernel of their own) are not ported yet
(ROADMAP.md queue A item 9).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import DTYPE_CODES, check_cuda, use_kernel

_LANES = 128
_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: activation name -> (fp32 function, kernel code)
_GLU_ACTS = {"silu": (lambda g: g * torch.sigmoid(g), 0),
             "gelu": (lambda g: F.gelu(g, approximate="tanh"), 1)}


def check_glu_geometry(block_t: int, block_f: int) -> tuple[int, int]:
    """Validate a fused-glu tile as the JAX package does: ``block_t`` a
    multiple of 8 and ``block_f`` of 128, else ValueError. The TPU's
    VMEM pricing of the tile (its budget check, which also takes the
    hidden size and element size) waits for the port's shared-memory
    budget model (ROADMAP.md queue A item 11); the CUDA kernel's tiles
    are its own."""
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


def _plain_glu(x2, wg, wu, activation):
    act = _GLU_ACTS[activation][0]
    xf = x2.float()
    return (act(xf @ wg.float()) * (xf @ wu.float())).to(x2.dtype)


def glu_fwd(x2: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
            activation: str = "silu") -> torch.Tensor:
    """``act(x2 @ wg) * (x2 @ wu)`` for (T, H) ``x2`` and (H, F) weights,
    (T, F) in x's dtype. CUDA tensors launch the kernel
    (``glu_fwd.launches``); CPU tensors take the plain version."""
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
                  stream)
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
