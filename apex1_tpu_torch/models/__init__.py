from apex1_tpu_torch.models.generate import (cached_attention, gpt2_decoder,
                                             init_cache, last_real_logits)
from apex1_tpu_torch.models.gpt2 import (GPT2, GPT2Config, gpt2_loss_fn,
                                         init_params)

__all__ = ["GPT2", "GPT2Config", "gpt2_loss_fn", "init_params",
           "cached_attention", "gpt2_decoder", "init_cache",
           "last_real_logits"]
