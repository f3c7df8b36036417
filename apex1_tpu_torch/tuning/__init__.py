"""Shape-keyed launch tuning (the port of ``apex1_tpu/tuning``):
persisted tables and the sweep that fills them.

The JAX package answers per-generation block sizes with measured
tables keyed on kernel x TPU generation x dtype x padded dims; the port
keys the same tables on the GPU generation (``"h100"``) and tunes the
CUDA launch parameters that have a choice (`registry`). Selection at
each launcher:

    explicit parameter          (what the sweep passes)
    > tuning-table winner       (this package)
    > today's heuristic         (``quantized._tile``/``_split_k``,
                                 ``paged_decode.sample_splits`` and
                                 ``paged_geometry``, ``lora_rows``,
                                 ``glu.cu``'s ``tile_n``, ``chunk_matmul.
                                 cu``'s ``tile_of``, ``chunked_loss.
                                 _auto_chunk``)

With no table on disk every launch is today's, bit for bit (pinned by
``tests/test_torch_tuning.py``). The JAX package's
``APEX1_ATTN_BLOCK_Q/K`` step and its ``tuned_row_block`` have no
counterpart: flash and the row kernels have fixed CUDA tiles.

The sweep (`sweep`, ``python -m apex1_tpu_torch.tuning.sweep``) times
every candidate on the card in one process with CUDA events, holds its
output against the plain version, records the winner and checks that a
fresh `lookup` returns it. A launcher resolves its parameters at every
call, so a new table is seen after `clear_cache` with nothing to
recompile.
"""

from __future__ import annotations

from apex1_tpu_torch.tuning.registry import SPECS, KernelSpec  # noqa: F401
from apex1_tpu_torch.tuning.table import (canonical_dtype,  # noqa: F401
                                          canonical_generation, clear_cache,
                                          default_tuning_dir, has_table,
                                          itemsize, load_problems, lookup,
                                          make_key, parse_key, record, save,
                                          validate_tables)


def padded_lanes(lanes: int) -> int:
    """Last-dim size padded to the 128-lane multiple (the JAX package's
    key padding, kept so both packages key one shape alike)."""
    return max(128, ((lanes + 127) // 128) * 128)


def seq_bucket(seq: int) -> int:
    """Power-of-two bucket (>= 128) for sequence-keyed dims: a winner is
    served only in the bucket it was measured at."""
    b = 128
    while b < seq:
        b *= 2
    return b


def token_bucket(tokens: int) -> int:
    """Power-of-two bucket (>= 8) of a product's token rows (``Tb``): a
    decode step's 8 rows and a prefill's 8192 never share a winner."""
    b = 8
    while b < tokens:
        b *= 2
    return b


def resolve(kernel: str, explicit, dims, dtype, heuristic):
    """One launcher's parameters: ``explicit`` (a dict, or None) > the
    table's entry for ``dims()`` and ``dtype`` > ``heuristic()``.
    Returns ``(params, source)`` with source ``"explicit"``, ``"table"``
    or ``"heuristic"``. ``dims`` is a callable: with no table for
    ``kernel`` (the launchers call this on every launch) nothing is
    computed but one dictionary lookup."""
    if explicit is not None:
        return dict(explicit), "explicit"
    if not has_table(kernel):
        return heuristic(), "heuristic"
    got = lookup(kernel, dims(), dtype)
    if got is not None:
        return got, "table"
    return heuristic(), "heuristic"
