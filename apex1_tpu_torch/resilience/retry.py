"""Bounded exponential backoff with deterministic jitter (the port of
``apex1_tpu/resilience/retry.py``): the one retry policy of the port,
shared by the resilient checkpointer's callers and
`runtime.RequestFeeder`'s backpressure, and the home of `_mix32`, the
32-bit avalanche the serving engine's request seeds and the chaos
harness's picks hash with.

Standard library only: retry decisions run on the host control plane.
Jitter is seeded (a hash of (seed, attempt)), not ``random.random()``,
so two runs with one seed retry on one schedule, the JAX package's to
the bit.
"""

from __future__ import annotations

import time
from typing import Callable, Iterator, Optional, Sequence, Type


class TransientError(Exception):
    """A failure worth retrying (backend unreachable, a storage blip).
    The chaos harness raises exactly this class to verify retry paths."""


def _mix32(x: int) -> int:
    """Deterministic 32-bit avalanche (xorshift-multiply)."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x846CA68B) & 0xFFFFFFFF
    x ^= x >> 16
    return x


def backoff_delays(retries: int, *, base_s: float = 0.01,
                   cap_s: float = 2.0, factor: float = 2.0,
                   jitter: float = 0.5, seed: int = 0
                   ) -> Iterator[float]:
    """Yield ``retries`` sleep durations: ``base * factor**i`` capped at
    ``cap_s``, each scaled by a deterministic jitter in
    ``[1 - jitter, 1]`` keyed on ``(seed, attempt)``. ``jitter=0`` gives
    the exact exponential schedule."""
    if retries < 0:
        raise ValueError("retries must be >= 0")
    if not 0.0 <= jitter <= 1.0:
        raise ValueError("jitter must be in [0, 1]")
    for i in range(retries):
        d = min(float(cap_s), float(base_s) * float(factor) ** i)
        if jitter:
            u = _mix32(seed ^ _mix32(i + 1)) / 0xFFFFFFFF
            d *= 1.0 - jitter * u
        yield d


def retry_call(fn: Callable, *, retries: int = 5, base_s: float = 0.01,
               cap_s: float = 2.0, jitter: float = 0.5, seed: int = 0,
               deadline_s: Optional[float] = None,
               retry_on: Sequence[Type[BaseException]] = (TransientError,),
               sleep: Callable[[float], None] = time.sleep,
               on_retry: Optional[Callable[[int, BaseException], None]]
               = None):
    """Call ``fn()``; on an exception in ``retry_on``, back off and retry
    up to ``retries`` times. ``deadline_s`` bounds the total time spent:
    once the next sleep would pass it, the pending exception is
    re-raised even with retries left (an overloaded queue sheds load).
    ``on_retry(attempt, exc)`` is the metrics hook. Exceptions outside
    ``retry_on`` propagate at once."""
    t0 = time.monotonic()
    delays = backoff_delays(retries, base_s=base_s, cap_s=cap_s,
                            jitter=jitter, seed=seed)
    attempt = 0
    while True:
        try:
            return fn()
        except tuple(retry_on) as e:
            attempt += 1
            try:
                d = next(delays)
            except StopIteration:
                raise e
            if deadline_s is not None and (
                    time.monotonic() - t0 + d) > deadline_s:
                raise e
            if on_retry is not None:
                on_retry(attempt, e)
            sleep(d)
