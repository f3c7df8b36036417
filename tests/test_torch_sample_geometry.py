"""The grids of the sampler and of the LoRA delta, checked on the CPU.

`sample_splits` splits each logits row over the grid of
``csrc/fused_sample.cu``: every column lies in exactly one split, no
split is empty, every split but the last is a multiple of 4 columns (a
split starts on a 16-byte load), and the count is a pure function of
the rows, the vocab and the SM count. `lora_tiles` cuts the vocab of
``csrc/lora_delta.cu``'s stream kernel into `LORA_TILE`-column tiles.
The counts at the engine's shapes are pinned, and the constants are
read back from the CUDA sources, so they match what the kernels
launch."""

import inspect
import re
from pathlib import Path

import pytest

from apex1_tpu_torch.ops.lora_epilogue import (_SMEM_LIMIT,
                                               LORA_BLOCKS_PER_SM,
                                               LORA_MAX_ROWS, LORA_TILE,
                                               lora_rows, lora_tiles)
from apex1_tpu_torch.ops.paged_decode import (_SAMPLE_COUNTERS,
                                              SAMPLE_BLOCKS_PER_SM,
                                              SAMPLE_MIN_COLUMNS,
                                              sample_splits)

CSRC = Path(__file__).resolve().parent.parent / "apex1_tpu_torch" / "csrc"

#: (rows, vocab, SMs): the engine's prefill row, decode batch and
#: `serve-lora`'s verify rows at GPT-2's and Llama's vocab, the card
#: tests' vocabs (1, 3, 4097), a batch that fills the card alone, a
#: vocab off 4 and a card of another SM count
_SHAPES = [
    (1, 50304, 132), (8, 50304, 132), (40, 32000, 132), (1, 32000, 132),
    (8, 32000, 132), (40, 50304, 132), (1, 1, 132), (8, 1, 132),
    (1, 3, 132), (40, 3, 132), (1, 4097, 132), (8, 4097, 132),
    (40, 4097, 132), (264, 50304, 132), (1000, 50304, 132),
    (3, 50257, 132), (8, 50304, 114), (1, 129, 132), (2, 128, 132),
]
_IDS = ["x".join(map(str, s)) for s in _SHAPES]


@pytest.mark.parametrize("shape", _SHAPES, ids=_IDS)
def test_every_column_in_one_split(shape):
    rows, V, sms = shape
    splits, per = sample_splits(rows, V, sms)
    assert splits >= 1 and per >= 1
    # the kernel's own check of its arguments
    assert (splits - 1) * per < V <= splits * per
    owner = [None] * V
    for i in range(splits):
        cols = range(i * per, min(V, (i + 1) * per))
        assert len(cols) > 0  # no split is empty
        for c in cols:
            assert owner[c] is None
            owner[c] = i
    assert None not in owner


@pytest.mark.parametrize("shape", _SHAPES, ids=_IDS)
def test_splits_start_on_16_byte_loads(shape):
    rows, V, sms = shape
    splits, per = sample_splits(rows, V, sms)
    assert per % 4 == 0
    widths = [min(V, (i + 1) * per) - i * per for i in range(splits)]
    assert all(w % 4 == 0 for w in widths[:-1])
    assert all(w == per for w in widths[:-1])


def _ceil(a, b):
    return -(-a // b)


def _busiest(rows, V, sms, want):
    """Columns on the busiest SM when about ``want`` splits (rounded to
    4 columns) spread a (splits, rows) grid evenly over ``sms`` SMs."""
    per = _ceil(_ceil(V, want), 4) * 4
    return _ceil(_ceil(V, per) * rows, sms) * per


@pytest.mark.parametrize("shape", _SHAPES, ids=_IDS)
def test_grid_aims_at_two_blocks_an_sm(shape):
    """At least `SAMPLE_BLOCKS_PER_SM` blocks an SM where the vocab has
    `SAMPLE_MIN_COLUMNS` columns for them, at most four times that; the
    busiest SM within 2 % of the best balance any count there gives."""
    rows, V, sms = shape
    splits, per = sample_splits(rows, V, sms)
    most = max(1, _ceil(V, SAMPLE_MIN_COLUMNS))
    aim = min(most, _ceil(SAMPLE_BLOCKS_PER_SM * sms, rows))
    # rounding a split up to 4 columns (of 64 or more) drops at most 5 %
    assert 0.95 * aim <= splits <= min(most, 4 * aim)
    got = _ceil(splits * rows, sms) * per
    for want in range(aim, min(most, 4 * aim) + 1):
        assert got <= 1.02 * _busiest(rows, V, sms, want)


def test_engine_shapes():
    """The counts the kernel launches at the engine's shapes: GPT-2's
    prefill row (one row a chunk) and decode batch of 8 over 50304
    columns, `serve-lora`'s verify (8 slots x 5) and decode over 32000."""
    assert sample_splits(1, 50304, 132) == (262, 192)
    assert sample_splits(8, 50304, 132) == (33, 1528)
    # 13 splits: 520 blocks, four on the busiest SM (7 would put 280,
    # three on some SMs and two on others)
    assert sample_splits(40, 32000, 132) == (13, 2464)
    assert sample_splits(8, 32000, 132) == (33, 972)
    assert sample_splits(1, 32000, 132) == (250, 128)
    assert sample_splits(1, 1, 132) == (1, 4)
    assert sample_splits(1, 3, 132) == (1, 4)
    assert sample_splits(1, 4097, 132) == (33, 128)
    # the prefill row fills the card: 132 blocks or more
    assert sample_splits(1, 50304, 132)[0] >= 132


def test_split_reads_no_logits():
    """The split is a function of shapes alone: nothing is read back, so
    a decode step stays capturable in a CUDA graph; the same shapes give
    the same split."""
    assert list(inspect.signature(sample_splits).parameters) == [
        "rows", "vocab", "sms"]
    assert sample_splits(8, 50304, 132) == sample_splits(8, 50304, 132)


def test_sampler_constants_match_the_kernel():
    """A launch takes at most gridDim.y's 65535 rows, one ticket counter
    each: the wrapper allocates that many counters."""
    src = (CSRC / "fused_sample.cu").read_text()
    rows = int(re.search(r"kMaxRows = (\d+);", src).group(1))
    assert rows == _SAMPLE_COUNTERS == 65535
    assert "per % 4 != 0" in src


@pytest.mark.parametrize("V", [1, 3, 4, 511, 512, 513, 1001, 4096, 31999,
                               32000, 50304])
def test_lora_tiles_cover_the_vocab(V):
    tiles = lora_tiles(V)
    assert tiles >= 1
    assert (tiles - 1) * LORA_TILE < V <= tiles * LORA_TILE
    seen = [0] * V
    for i in range(tiles):
        cols = range(i * LORA_TILE, min(V, (i + 1) * LORA_TILE))
        assert len(cols) > 0
        for c in cols:
            seen[c] += 1
    assert seen == [1] * V


def test_lora_grid_at_the_engine_shapes():
    """`serve-lora`'s head (vocab 32000, rank 16): 63 tiles a row, so 504
    blocks of one row at a decode step of 8 rows and 63 at the prefill
    row; a verify of 8 x 5 rows takes four rows a block, 630 blocks."""
    assert lora_tiles(32000) == 63
    assert lora_rows(8, 32000, 16, 132) == 1
    assert lora_rows(1, 32000, 16, 132) == 1
    assert lora_rows(40, 32000, 16, 132) == 4
    assert 63 * _ceil(40, 4) == 630


@pytest.mark.parametrize("n", [1, 2, 8, 40, 80, 512, 4096])
@pytest.mark.parametrize("V,rank", [(32000, 16), (1001, 3), (8192, 64),
                                    (130, 1), (50304, 8192)])
def test_lora_rows(n, V, rank):
    """One row a block until the grid holds `LORA_BLOCKS_PER_SM` blocks an
    SM; then as many rows as keep it there, at most `LORA_MAX_ROWS`, and
    the rows' page ids and coefficients within the block's shared memory;
    the row groups cover the rows once."""
    rows = lora_rows(n, V, rank, 132)
    assert 1 <= rows <= LORA_MAX_ROWS
    assert rows * 8 * rank <= _SMEM_LIMIT
    blocks = lora_tiles(V) * _ceil(n, rows)
    if rows > 1:
        assert blocks >= LORA_BLOCKS_PER_SM * 132 * 0.5
    if n * lora_tiles(V) < 2 * LORA_BLOCKS_PER_SM * 132:
        assert rows == 1
    starts = range(0, n, rows)
    assert sum(min(rows, n - s) for s in starts) == n


def test_lora_tile_matches_the_kernel():
    src = (CSRC / "lora_delta.cu").read_text()
    threads = int(re.search(r"constexpr int kThreads = (\d+);", src).group(1))
    assert re.search(r"constexpr int kVT = 4 \* kThreads;", src)
    assert LORA_TILE == 4 * threads
