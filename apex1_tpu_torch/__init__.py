"""apex1_tpu_torch — the PyTorch and CUDA port of `apex1_tpu`.

It imports torch, numpy and the standard library, never JAX or the JAX
package. Entry points run on CUDA unless the caller passes
``device="cpu"``; every kernel wrapper launches its Hopper kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.
"""

from apex1_tpu_torch import ops
from apex1_tpu_torch.amp import Amp, AmpState
from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.interop import gpt2_params_from_jax
from apex1_tpu_torch.models import (GPT2, GPT2Config, gpt2_decoder,
                                    gpt2_loss_fn)
from apex1_tpu_torch.ops import force_impl
from apex1_tpu_torch.optim import fused_adam
from apex1_tpu_torch.serving import Engine, EngineConfig

__all__ = ["Amp", "AmpState", "PrecisionPolicy", "get_policy",
           "gpt2_params_from_jax", "GPT2", "GPT2Config", "gpt2_decoder",
           "gpt2_loss_fn", "force_impl", "fused_adam", "Engine",
           "EngineConfig", "ops"]
