"""Transformer building blocks (the port of part of ``apex1_tpu/transformer``)."""
