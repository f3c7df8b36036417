"""Transformer building blocks (the port of ``apex1_tpu/transformer``):
the parallel topology state, tensor and pipeline parallelism, the
Mixture-of-Experts layer, the microbatch calculators, the enums and the
logging knob."""

from apex1_tpu_torch.transformer import enums  # noqa: F401
from apex1_tpu_torch.transformer import log_util  # noqa: F401
from apex1_tpu_torch.transformer import moe  # noqa: F401
from apex1_tpu_torch.transformer import parallel_state  # noqa: F401
from apex1_tpu_torch.transformer import pipeline_parallel  # noqa: F401
from apex1_tpu_torch.transformer import tensor_parallel  # noqa: F401
from apex1_tpu_torch.transformer.enums import (  # noqa: F401
    AttnMaskType, AttnType, ModelType)
from apex1_tpu_torch.transformer.log_util import (  # noqa: F401
    set_logging_level)
from apex1_tpu_torch.transformer.microbatches import (  # noqa: F401
    build_num_microbatches_calculator)
