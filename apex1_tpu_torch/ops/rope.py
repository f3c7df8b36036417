"""Rotary positional embedding (the port of ``apex1_tpu/ops/rope.py``).

Both rotation conventions: ``interleaved=False`` (NeoX/Llama halves:
x1 = x[..., :d/2], x2 = x[..., d/2:]) and ``interleaved=True`` (GPT-J
even/odd lanes). out = [x1·cos − x2·sin, x2·cos + x1·sin] in fp32,
rounded to x's dtype. The backward is the rotation by −θ: the same
kernel with sin negated, through a ``torch.autograd.Function`` that
saves only the tables.

One kernel, ``csrc/rope.cu`` (TPU row 12), beside its plain PyTorch
version (the JAX package's fp32 composite). The TPU kernel runs only
where ``head_dim / 2`` is a multiple of 128 (a lane rule); the CUDA
kernel has none and launches for any even head_dim on a CUDA tensor.
It reads x in place in its (..., seq, heads, head_dim) layout and
indexes the tables by position, with no broadcast copies.
"""

from __future__ import annotations

from typing import Optional

import torch

from apex1_tpu_torch.ops import _build
from apex1_tpu_torch.ops._common import DTYPE_CODES, check_cuda, use_kernel

_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def rope_tables(positions, head_dim: int, *, base: float = 10000.0,
                dtype=torch.float32):
    """cos/sin tables: (len(positions), head_dim/2), on ``positions``'
    device."""
    positions = torch.as_tensor(positions)
    half = head_dim // 2
    inv_freq = 1.0 / (base ** (torch.arange(
        0, half, dtype=torch.float32, device=positions.device) / half))
    angles = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _infer_seq_axis(x, seq_len: int) -> int:
    """Pick the sequence axis: prefer -3 ("seq, heads, head_dim" layout),
    then -2 ("seq, head_dim"); both must match the table length."""
    for ax in (x.dim() - 3, x.dim() - 2):
        if ax >= 0 and x.shape[ax] == seq_len:
            return ax
    raise ValueError(
        f"cannot infer sequence axis: no axis of {tuple(x.shape)} at -3/-2 "
        f"matches the cos/sin table length {seq_len}; pass seq_axis "
        f"explicitly")


def _geometry(x, cos, seq_axis):
    """(P, S, I, pre): rows before the sequence axis, positions, rows
    after it (before head_dim), and the rows between the batch axis and
    the sequence axis (a per-row table's batch row of prefix row p is
    p // pre)."""
    shape = x.shape
    P = 1
    for n in shape[:seq_axis]:
        P *= n
    I = 1
    for n in shape[seq_axis + 1:-1]:
        I *= n
    pre = P // shape[0] if cos.dim() == 3 else 1
    return P, shape[seq_axis], I, pre


def _plain_rope(x, cos, sin, interleaved, seq_axis):
    """The JAX package's fp32 composite (``_apply``'s XLA branch)."""
    shape = x.shape
    half = shape[-1] // 2
    P, S, I, pre = _geometry(x, cos, seq_axis)
    xv = x.reshape(P, S, I, 2 * half)
    if interleaved:
        x1, x2 = xv[..., 0::2], xv[..., 1::2]
    else:
        x1, x2 = xv[..., :half], xv[..., half:]
    if cos.dim() == 3:
        def table(t):
            return t.float().repeat_interleave(pre, dim=0)[:, :, None]
    else:
        def table(t):
            return t.float()[None, :, None]
    c, s = table(cos), table(sin)
    x1f, x2f = x1.float(), x2.float()
    o1 = (x1f * c - x2f * s).to(x.dtype)
    o2 = (x2f * c + x1f * s).to(x.dtype)
    if interleaved:
        out = torch.stack([o1, o2], dim=-1).reshape(P, S, I, 2 * half)
    else:
        out = torch.cat([o1, o2], dim=-1)
    return out.reshape(shape)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *,
           interleaved: bool, seq_axis: int, sign: float = 1.0):
    """Rotate ``x`` by the tables' angles (``sign`` -1: by their
    negatives, the backward). CUDA tensors launch the kernel
    (``rotate.launches`` counts both directions); CPU tensors take the
    plain version."""
    if not use_kernel(x):
        return _plain_rope(x, cos, sign * sin, interleaved, seq_axis)
    if x.dtype not in _DTYPES:
        raise ValueError(f"rope: unsupported dtype {x.dtype}")
    P, S, I, pre = _geometry(x, cos, seq_axis)
    half = x.shape[-1] // 2
    x = x.contiguous()
    c, s = cos.float().contiguous(), sin.float().contiguous()
    check_cuda("rope", x, c, s)
    out = torch.empty_like(x)
    vec = half % 4 == 0 and all(t.data_ptr() % 32 == 0
                                for t in (x, out, c, s))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _build.launch("apex1_rope", x.data_ptr(), c.data_ptr(), s.data_ptr(),
                  out.data_ptr(), P, S, I, half, pre, int(cos.dim() == 3),
                  int(interleaved), float(sign), int(vec),
                  DTYPE_CODES[x.dtype], stream)
    rotate.launches += 1
    return out


rotate.launches = 0


class _Rope(torch.autograd.Function):
    """The JAX package's ``_rope`` custom VJP: residuals are the tables,
    the backward is the rotation by −θ."""

    @staticmethod
    def forward(ctx, x, cos, sin, interleaved, seq_axis):
        ctx.save_for_backward(cos, sin)
        ctx.args = (interleaved, seq_axis)
        return rotate(x, cos, sin, interleaved=interleaved, seq_axis=seq_axis)

    @staticmethod
    def backward(ctx, dy):
        cos, sin = ctx.saved_tensors
        interleaved, seq_axis = ctx.args
        dx = rotate(dy, cos, sin, interleaved=interleaved,
                    seq_axis=seq_axis, sign=-1.0)
        return dx, None, None, None, None


def apply_rotary_pos_emb(x: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor, *, interleaved: bool = False,
                         seq_axis: Optional[int] = None,
                         block_rows: Optional[int] = None) -> torch.Tensor:
    """Apply RoPE. ``x``: (..., seq, heads, head_dim) or (..., seq,
    head_dim); ``cos/sin``: (seq, head_dim/2) from `rope_tables`, or
    (B, seq, head_dim/2) per-row tables for packed batches (positions
    restarting per segment). The sequence axis is inferred from the
    table length (prefer -3, then -2); pass ``seq_axis`` when ambiguous.
    ``block_rows`` (the TPU's rows per grid step) is accepted and has no
    effect on the CUDA grid."""
    if x.shape[-1] % 2:
        raise ValueError("head_dim must be even for RoPE")
    if cos.dim() == 3 and cos.shape[0] != x.shape[0]:
        raise ValueError(
            f"per-row tables {tuple(cos.shape)} need leading dim == batch "
            f"{x.shape[0]}")
    seq_len = cos.shape[1] if cos.dim() == 3 else cos.shape[0]
    if seq_axis is None:
        seq_axis = _infer_seq_axis(x, seq_len)
    else:
        seq_axis = seq_axis % x.dim()
    if cos.dim() == 3 and seq_axis == 0:
        raise ValueError("per-row tables need the batch axis before the "
                         "sequence axis")
    return _Rope.apply(x, cos, sin, bool(interleaved), seq_axis)
