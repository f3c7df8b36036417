from apex1_tpu_torch.models.bert import (Bert, BertConfig, BertLayer,
                                         BertPretrain, bert_pretrain_loss_fn)
from apex1_tpu_torch.models.generate import (beam_search, cached_attention,
                                             generate, gpt2_decoder,
                                             init_cache, last_real_logits,
                                             llama_decoder, t5_generate)
from apex1_tpu_torch.models.gpt2 import (GPT2, GPT2Config, gpt2_loss_fn,
                                         init_params)
from apex1_tpu_torch.models.llama import (Llama, LlamaBlock, LlamaConfig,
                                          init_weights, is_moe_layer,
                                          llama_loss_fn)
from apex1_tpu_torch.models import llama_3d  # noqa: F401
from apex1_tpu_torch.models.quant_decode import (gpt2_quant_decoder,
                                                 llama_quant_decoder,
                                                 quantize_gpt2_params,
                                                 quantize_llama_params)
from apex1_tpu_torch.models.resnet import (Bottleneck, ResNet,
                                           ResNetConfig, resnet_loss_fn)
from apex1_tpu_torch.models.t5 import (T5, RelPosBias, T5Config,
                                       relative_position_bucket, t5_loss_fn)

__all__ = ["Bert", "BertConfig", "BertLayer", "BertPretrain",
           "bert_pretrain_loss_fn", "GPT2", "GPT2Config", "gpt2_loss_fn", "init_params",
           "beam_search", "cached_attention", "generate", "t5_generate",
           "gpt2_decoder", "init_cache",
           "last_real_logits", "llama_decoder", "Llama", "LlamaBlock",
           "LlamaConfig", "init_weights", "is_moe_layer", "llama_loss_fn",
           "gpt2_quant_decoder", "llama_quant_decoder",
           "quantize_gpt2_params", "quantize_llama_params",
           "Bottleneck", "ResNet", "ResNetConfig", "resnet_loss_fn",
           "T5", "RelPosBias", "T5Config", "relative_position_bucket",
           "t5_loss_fn"]
