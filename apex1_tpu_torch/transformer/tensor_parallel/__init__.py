"""Tensor-parallel helpers (the port of part of
``apex1_tpu/transformer/tensor_parallel``): only the activation-
checkpoint policies of `random` so far."""
