"""Pipeline parallelism (the port of
``apex1_tpu/transformer/pipeline_parallel``; reference
``apex/transformer/pipeline_parallel``)."""

from apex1_tpu_torch.transformer.pipeline_parallel import (  # noqa: F401
    p2p_communication)
from apex1_tpu_torch.transformer.pipeline_parallel.schedules import (
    allreduce_embedding_grads, forward_backward_no_pipelining,
    forward_backward_pipelining_with_interleaving,
    forward_backward_pipelining_without_interleaving,
    get_forward_backward_func, one_f_one_b, pipeline_apply,
    pipeline_tied_apply, pipelined_loss_fn)

__all__ = ["allreduce_embedding_grads", "forward_backward_no_pipelining",
           "forward_backward_pipelining_with_interleaving",
           "forward_backward_pipelining_without_interleaving",
           "get_forward_backward_func", "one_f_one_b", "pipeline_apply",
           "pipeline_tied_apply", "pipelined_loss_fn", "p2p_communication"]
