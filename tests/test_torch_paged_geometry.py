"""The page split of the paged attention kernel (`paged_geometry`): a pure
function of the shapes, checked on the CPU. Every position 0 .. T·P - 1
lies in exactly one split, no split starts at or past T·P, the
workspace holds (m, l, D accumulators) a row and a split where there is
more than one, and the count never depends on the row lengths."""

import inspect
import itertools

import pytest

from apex1_tpu_torch.ops.paged_decode import (PAGED_BLOCKS, PAGED_KEYS,
                                              paged_geometry)

#: (N, Hq, Hkv, S, D, P, T): the engine's decode and chunk shapes (GPT-2,
#: Llama 32/8), its own prefill chunk (pages of 16), the card tests'
#: geometries, long contexts and one page
_SHAPES = [
    (8, 12, 12, 1, 64, 64, 17), (8, 12, 12, 64, 64, 64, 17),
    (8, 32, 8, 1, 128, 64, 17), (8, 32, 8, 64, 128, 64, 17),
    (1, 12, 12, 16, 64, 16, 64), (1, 32, 8, 16, 128, 16, 64),
    (4, 12, 4, 5, 64, 48, 5), (64, 12, 12, 1, 64, 16, 8),
    (4, 4, 2, 64, 20, 16, 6), (1, 32, 8, 1, 128, 16, 8192),
    (2, 8, 1, 1, 64, 256, 3), (1, 1, 1, 1, 64, 1, 1),
    (3, 6, 2, 7, 128, 100, 9),
]


@pytest.mark.parametrize("shape", _SHAPES,
                         ids=["x".join(map(str, s)) for s in _SHAPES])
def test_every_position_in_one_split(shape):
    N, Hq, Hkv, S, D, P, T = shape
    splits, per, ws = paged_geometry(*shape)
    nkb = -(-T * P // PAGED_KEYS)
    assert 1 <= splits <= nkb and per >= 1
    # the kernel's own check: the runs cover the key blocks, none empty
    assert (splits - 1) * per < nkb <= splits * per
    starts = [i * per * PAGED_KEYS for i in range(splits)]
    assert all(st < T * P for st in starts)  # no split starts past T·P
    owner = [None] * (T * P)
    for i, st in enumerate(starts):
        for pos in range(st, min(st + per * PAGED_KEYS, T * P)):
            assert owner[pos] is None
            owner[pos] = i
    assert None not in owner


@pytest.mark.parametrize("shape", _SHAPES,
                         ids=["x".join(map(str, s)) for s in _SHAPES])
def test_workspace_size(shape):
    N, Hq, Hkv, S, D, P, T = shape
    splits, _, ws = paged_geometry(*shape)
    assert ws == (0 if splits == 1 else N * Hq * S * splits * (D + 2))


def test_decode_fills_the_card():
    """GPT-2's decode batch (96 rows of kv heads) and the Llama 32/8 one
    (64) split into several blocks each, toward `PAGED_BLOCKS`; chunks
    of 64 rows count a block per 64 query rows of a kv head; a grid that
    fills it alone, or one page, keeps one split."""
    assert paged_geometry(8, 12, 12, 1, 64, 64, 17)[:2] == (6, 3)
    assert paged_geometry(8, 32, 8, 1, 128, 64, 17)[:2] == (9, 2)
    assert paged_geometry(8, 12, 12, 64, 64, 64, 17)[:2] == (6, 3)
    assert paged_geometry(8, 32, 8, 64, 128, 64, 17)[:2] == (3, 6)
    assert paged_geometry(1, 12, 12, 16, 64, 16, 64)[:2] == (16, 1)
    assert paged_geometry(64, 12, 12, 1, 64, 16, 8)[0] == 1
    assert paged_geometry(1, 1, 1, 1, 64, 1, 1)[0] == 1
    for N, Hkv in itertools.product((1, 2, 8, 32), (1, 8, 12)):
        splits, _, _ = paged_geometry(N, Hkv, Hkv, 1, 64, 64, 64)
        want = min(64, -(-PAGED_BLOCKS // (N * Hkv)))
        assert want / 2 < splits <= want


def test_split_reads_no_lengths():
    """The split is a function of shapes alone: no lengths to read back,
    so a decode step stays capturable in a CUDA graph."""
    assert list(inspect.signature(paged_geometry).parameters) == [
        "N", "Hq", "Hkv", "S", "D", "P", "T"]
    assert paged_geometry(8, 12, 12, 1, 64, 64, 17) == paged_geometry(
        8, 12, 12, 1, 64, 64, 17)
