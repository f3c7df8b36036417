"""Counter-based RNG keys (the port of ``apex1_tpu/core/random.py``;
reference ``apex/transformer/tensor_parallel/random.py``).

A key is jax's threefry key data: a pair of uint32 values ``(k1, k2)``
held as Python ints. The threefry-2x32 block is re-derived in integer
ops (uint32 arithmetic in int64 tensors masked to 32 bits: torch's
uint32 lacks some operators), so `prng_key`, `fold_in` and `split`
give the bits of ``jax.random.PRNGKey``, ``fold_in`` and ``split``.
The sampler (`ops.paged_decode`) and the generate loops draw from the
same block.

`domain_key`, `model_parallel_key` and `RNGKeychain` keep the JAX
module's named domains: a fixed salt folded into the key (``default``
0, ``model-parallel-rng`` 2718, the reference's model-parallel seed
offset, ``data-parallel-rng`` 1042, any other name its crc32, stable
across processes), and the tensor-parallel rank folded in after the
model-parallel salt.
"""

from __future__ import annotations

import zlib

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

_DOMAIN_SALT = {
    "default": 0,
    "model-parallel-rng": 2718,
    "data-parallel-rng": 1042,
}


def u32(x, device=None) -> torch.Tensor:
    """``x`` as an int64 tensor of uint32 values."""
    return torch.as_tensor(x, dtype=torch.int64, device=device) & M32


def threefry2x32(k1, k2, x0, x1):
    """The 20-round threefry-2x32 block over int64 tensors holding
    uint32 values — jax's ``threefry2x32`` op for op (key schedule,
    rotation constants, round-group injections)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """``jax.random.PRNGKey(seed)``'s key data: the seed's high and low
    32 bits (a negative seed is a 32-bit one, as jax takes it without
    64-bit mode: ``(0, seed mod 2^32)``)."""
    seed = int(seed)
    return ((seed >> 32) & M32 if seed >= 0 else 0, seed & M32)


def fold_in(key, data: int) -> tuple:
    """``jax.random.fold_in``: one threefry block of the counter
    ``(0, data)`` under ``key``."""
    k1, k2 = (u32(k) for k in key)
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(k1), u32(data))
    return int(y0), int(y1)


def split(key, num: int = 2, *, partitionable: bool = True) -> list:
    """``jax.random.split`` of the threefry key data ``key = (k1, k2)``:
    ``num`` new keys, each a pair of Python ints (uint32 values).

    - partitionable: key i is the threefry block of the counter (0, i);
    - original: the counters iota(2·num) split in halves, x0 = [0, num)
      and x1 = [num, 2·num); the block's two outputs concatenated and
      read as (num, 2) rows."""
    k1, k2 = (u32(k) for k in key)
    idx = torch.arange(num, dtype=torch.int64)
    if partitionable:
        y0, y1 = threefry2x32(k1, k2, torch.zeros_like(idx), idx)
        pairs = torch.stack([y0, y1], dim=1)
    else:
        y0, y1 = threefry2x32(k1, k2, idx, idx + num)
        pairs = torch.cat([y0, y1]).reshape(num, 2)
    return [(int(a), int(b)) for a, b in pairs.tolist()]


def domain_key(key, domain: str = "default") -> tuple:
    """``key`` with the named domain's salt folded in."""
    salt = _DOMAIN_SALT.get(domain)
    if salt is None:
        salt = zlib.crc32(domain.encode()) & 0x7FFFFFFF
    return fold_in(key, salt)


def model_parallel_key(key, rank=None) -> tuple:
    """The per-tensor-parallel-rank dropout key (``seed + 2718 +
    tp_rank`` in the reference): the model-parallel domain with the
    rank folded in. ``rank`` defaults to this process's rank in
    `parallel_state`'s tensor-parallel group, where JAX reads the
    ``tp`` axis index."""
    if rank is None:
        from apex1_tpu_torch.transformer import parallel_state
        rank = parallel_state.get_tensor_model_parallel_rank()
    return fold_in(domain_key(key, "model-parallel-rng"), rank)


class RNGKeychain:
    """A root seed split into named, step-folded keys::

        chain = RNGKeychain(seed)
        dropout_key = chain.key("dropout", step)
    """

    def __init__(self, seed: int):
        self._root = prng_key(seed)

    def key(self, name: str, step: int = 0) -> tuple:
        return fold_in(domain_key(self._root, name), int(step) & M32)
