"""Transformer enums (the port of ``apex1_tpu/transformer/enums.py``;
reference ``apex/transformer/enums.py :: ModelType, AttnType,
AttnMaskType``)."""

from __future__ import annotations

import enum


class ModelType(enum.Enum):
    encoder_or_decoder = 1
    encoder_and_decoder = 2


class AttnType(enum.Enum):
    self_attn = 1
    cross_attn = 2


class AttnMaskType(enum.Enum):
    padding = 1
    causal = 2
