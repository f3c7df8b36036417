"""apex1_tpu_torch — the PyTorch and CUDA port of `apex1_tpu`.

It imports torch, numpy and the standard library, never JAX or the JAX
package. Entry points run on CUDA unless the caller passes
``device="cpu"``; every kernel wrapper launches its Hopper kernel on a
CUDA tensor and runs its plain PyTorch version on a CPU tensor.
"""

from apex1_tpu_torch import fp16_utils, ops
from apex1_tpu_torch.amp import Amp, AmpState
from apex1_tpu_torch.contrib import EncdecMultiheadAttn, SelfMultiheadAttn
from apex1_tpu_torch.core.mesh import MeshConfig, make_hybrid_mesh, make_mesh
from apex1_tpu_torch.core.policy import PrecisionPolicy, get_policy
from apex1_tpu_torch.interop import (bert_params_from_jax,
                                     gpt2_params_from_jax,
                                     llama3d_state_from_jax,
                                     llama_params_from_jax,
                                     quant_params_from_jax,
                                     resnet_params_from_jax,
                                     t5_params_from_jax)
from apex1_tpu_torch.models.llama_3d import Llama3DConfig
from apex1_tpu_torch.models import (GPT2, BertConfig, BertPretrain,
                                    GPT2Config, Llama, LlamaConfig, T5,
                                    T5Config, bert_pretrain_loss_fn,
                                    gpt2_decoder, gpt2_loss_fn,
                                    gpt2_quant_decoder, llama_decoder,
                                    llama_loss_fn, llama_quant_decoder,
                                    ResNet, ResNetConfig, resnet_loss_fn,
                                    t5_loss_fn)
from apex1_tpu_torch.ops import force_impl
from apex1_tpu_torch.optim import (FusedAdagrad, FusedAdam, FusedLAMB,
                                   FusedNovoGrad, FusedSGD, Optimizer,
                                   fused_adagrad, fused_adam, fused_lamb,
                                   fused_novograd, fused_sgd, larc)
from apex1_tpu_torch.parallel.sync_batchnorm import (SyncBatchNorm,
                                                     convert_syncbn_model)
from apex1_tpu_torch.serving import (DisaggFrontend, Engine, EngineConfig,
                                     FrontendConfig, ServingFrontend)

__all__ = ["Amp", "AmpState", "MeshConfig", "make_hybrid_mesh", "make_mesh",
           "PrecisionPolicy",
           "get_policy",
           "bert_params_from_jax", "BertConfig", "BertPretrain",
           "bert_pretrain_loss_fn", "gpt2_params_from_jax",
           "llama_params_from_jax", "llama3d_state_from_jax",
           "quant_params_from_jax", "Llama3DConfig",
           "t5_params_from_jax", "GPT2",
           "GPT2Config", "Llama", "LlamaConfig", "T5", "T5Config",
           "gpt2_decoder", "gpt2_loss_fn", "gpt2_quant_decoder",
           "llama_decoder", "llama_loss_fn", "llama_quant_decoder",
           "t5_loss_fn", "EncdecMultiheadAttn", "SelfMultiheadAttn",
           "force_impl", "fused_adam", "Engine", "EngineConfig", "ops",
           "fp16_utils", "resnet_params_from_jax", "ResNet",
           "ResNetConfig", "resnet_loss_fn", "FusedAdagrad", "FusedAdam",
           "FusedLAMB", "FusedNovoGrad", "FusedSGD", "Optimizer",
           "fused_adagrad", "fused_lamb", "fused_novograd", "fused_sgd",
           "larc", "SyncBatchNorm", "convert_syncbn_model",
           "DisaggFrontend", "FrontendConfig", "ServingFrontend"]
