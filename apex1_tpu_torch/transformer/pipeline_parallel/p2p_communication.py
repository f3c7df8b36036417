"""Point-to-point boundary communication between pipeline stages (the
port of ``apex1_tpu/transformer/pipeline_parallel/p2p_communication.py``;
reference ``apex/transformer/pipeline_parallel/p2p_communication.py ::
send_forward, recv_forward, send_backward, recv_backward``).

In JAX these are ring ``ppermute``s over the pp axis. Here each is one
ring shift over the pipeline group: every stage posts its send to the
next stage (or the previous one) and its receive from the other side in
one ``dist.batch_isend_irecv`` (`tensor_parallel.mappings.Hop`), so no
rank blocks on an unmatched send. As an autograd function the shift's
backward is the reverse shift, the transpose of ``ppermute`` in JAX. At
one stage the shift is the identity and nothing is sent (a send to
oneself would hang under NCCL).

The pairing contract is the JAX module's: the one shift in
``send_forward`` both sends and delivers, so its RETURN VALUE is the
received activation and ``recv_forward`` is an identity shim; the
supported paired form is the chained one,
``x = recv_forward(send_forward(out))``. The ring wraps: stage 0
receives stage P − 1's tensor (the reference's first stage receives
None); the schedules inject the fresh microbatch there.
"""

from __future__ import annotations

import torch

from apex1_tpu_torch.core.mesh import AXIS_PP
from apex1_tpu_torch.transformer.parallel_state import (group_size_rank,
                                                        resolve_group)


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """``x`` sent to group index i + shift, the tensor of i − shift
    received (no autograd); ``x`` itself on a group of one."""
    if group_size_rank(group)[0] == 1:
        return x
    from apex1_tpu_torch.transformer.tensor_parallel.mappings import Hop
    return Hop([x], group, shift=shift).wait()[0]


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.args = (group, shift)
        return ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        group, shift = ctx.args
        return ring_shift(g.contiguous(), group, -shift), None, None


def send_forward_recv_forward(x, *, axis_name=AXIS_PP):
    """Send the activation to the next stage; receive the previous
    stage's (one ring shift)."""
    return _Shift.apply(x, resolve_group(axis_name), 1)


def send_backward_recv_backward(g, *, axis_name=AXIS_PP):
    """Send the gradient to the previous stage; receive the next
    stage's."""
    return _Shift.apply(g, resolve_group(axis_name), -1)


# the shift lives in send_*; recv_* are identity shims, so the
# reference's paired send-then-recv pattern performs exactly ONE shift
send_forward = send_forward_recv_forward
send_backward = send_backward_recv_backward


def recv_forward(x, *, axis_name=AXIS_PP):
    """Identity shim: pass it ``send_forward``'s return value."""
    del axis_name
    return x


def recv_backward(g, *, axis_name=AXIS_PP):
    """Identity shim: pass it ``send_backward``'s return value."""
    del axis_name
    return g
