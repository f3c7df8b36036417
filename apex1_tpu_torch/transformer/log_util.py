"""Logging knob (the port of ``apex1_tpu/transformer/log_util.py``;
reference ``apex/transformer/log_util.py :: set_logging_level,
get_transformer_logger``)."""

from __future__ import annotations

import logging

_LOGGER_NAME = "apex1_tpu_torch.transformer"


def get_transformer_logger(name: str | None = None) -> logging.Logger:
    return logging.getLogger(
        f"{_LOGGER_NAME}.{name}" if name else _LOGGER_NAME)


def set_logging_level(verbosity) -> None:
    """Set the transformer subsystem's log level (int or name)."""
    if isinstance(verbosity, str):
        verbosity = getattr(logging, verbosity.upper())
    get_transformer_logger().setLevel(verbosity)
