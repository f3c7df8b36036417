"""Deterministic serving-fault injection (the serving part of
``apex1_tpu/testing/chaos.py``): hooks `serving.replica.ReplicaSupervisor`
and `serving.disagg.DisaggFrontend` call at their submit / step /
handoff boundaries, so "kill a replica mid-stream, every token
bit-identical" is an assertable property, not a flaky one.

- `ReplicaKill` (crash at an exact step), `ReplicaHang` (stall past the
  watchdog), `SlowReplica` (a straggler's per-step delay), `PoisonPill`
  (a marked request whose ADMISSION kills the replica, every time, on
  every replica), `HandoffWindowKill` and `HandoffCorruption` (the
  disaggregated handoff window), composed by `ChaosSchedule`;
  `kill_schedule` derives a (replica, step) pick from a seed.
- `toy_decoder`: a deterministic history-dependent cached decoder with
  the `models.generate` decoder contract and the JAX package's logits,
  cheap enough that multi-replica drills pay supervision, not model,
  cost.

The checkpoint and training faults of the JAX module are not ported
here.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.serving.engine import _mix32

__all__ = [
    "ServingFault", "ChaosSchedule", "ReplicaKill", "ReplicaHang",
    "SlowReplica", "PoisonPill", "HandoffWindowKill",
    "HandoffCorruption", "kill_schedule", "toy_decoder",
]


class ServingFault:
    """Hook surface `serving.replica.ReplicaSupervisor` calls at its
    two fault boundaries. The base class is a no-op; subclasses raise
    or sleep at EXACT (replica, step) coordinates — deterministic, so
    "kill a replica mid-stream, every token bit-identical" is an
    assertable property, not a flaky one."""

    def on_step(self, replica_id: int, step: int) -> None:
        """Called once per serve iteration, before the engine step."""

    def on_submit(self, replica_id: int, sub) -> None:
        """Called just before a submission is admitted to the engine
        (``sub`` is a `serving.replica.Submission`)."""

    def on_handoff(self, replica_id: int, req_id: int, page) -> None:
        """Called by `serving.disagg.DisaggFrontend` in the handoff
        window — after a prefill replica extracted a KV page for
        ``req_id`` but BEFORE the decode pool acknowledged it
        (``page`` is a `serving.disagg.kv_transfer.KVPage`, mutable
        host copy). Raising `ReplicaKilled` here models the source
        dying mid-transfer; mutating ``page.lane`` models a torn/
        corrupt transfer the arrival re-digest must catch."""


class ChaosSchedule(ServingFault):
    """Compose several faults; each sees every hook."""

    def __init__(self, faults: Sequence[ServingFault]):
        self.faults = list(faults)

    def on_step(self, replica_id, step):
        for f in self.faults:
            f.on_step(replica_id, step)

    def on_submit(self, replica_id, sub):
        for f in self.faults:
            f.on_submit(replica_id, sub)

    def on_handoff(self, replica_id, req_id, page):
        for f in self.faults:
            f.on_handoff(replica_id, req_id, page)


class ReplicaKill(ServingFault):
    """Crash replica ``replica`` at its serve step ``at_step`` — once
    (the restarted generation starts its step count fresh but the
    fault has already fired; ``repeat=True`` kills every generation,
    the crash-loop fixture)."""

    def __init__(self, replica: int, at_step: int, *,
                 repeat: bool = False):
        self.replica = int(replica)
        self.at_step = int(at_step)
        self.repeat = bool(repeat)
        self.fired = 0

    def on_step(self, replica_id, step):
        if replica_id != self.replica or step != self.at_step:
            return
        if self.fired and not self.repeat:
            return
        self.fired += 1
        from apex1_tpu_torch.serving.replica import ReplicaKilled
        raise ReplicaKilled(
            f"chaos: killed replica {replica_id} at step {step}")


class ReplicaHang(ServingFault):
    """Stall replica ``replica`` at step ``at_step`` for ``hang_s``
    (once) — the watchdog-path fixture: the step eventually returns,
    but past the supervision deadline, which is exactly the signature
    of a wedged-then-recovered decode the supervisor must NOT trust."""

    def __init__(self, replica: int, at_step: int, *,
                 hang_s: float = 0.2):
        self.replica = int(replica)
        self.at_step = int(at_step)
        self.hang_s = float(hang_s)
        self.fired = 0

    def on_step(self, replica_id, step):
        if (replica_id == self.replica and step == self.at_step
                and not self.fired):
            self.fired += 1
            time.sleep(self.hang_s)


class SlowReplica(ServingFault):
    """Straggler model: ``delay_s`` injected into every step of
    ``replica`` in ``[from_step, to_step)`` — below the watchdog
    threshold, so the replica stays 'healthy' while its latency blows
    hedging budgets (the hedged-dispatch fixture)."""

    def __init__(self, replica: int, *, delay_s: float = 0.02,
                 from_step: int = 0, to_step: Optional[int] = None):
        self.replica = int(replica)
        self.delay_s = float(delay_s)
        self.from_step = int(from_step)
        self.to_step = to_step

    def on_step(self, replica_id, step):
        if replica_id != self.replica or step < self.from_step:
            return
        if self.to_step is not None and step >= self.to_step:
            return
        time.sleep(self.delay_s)


class PoisonPill(ServingFault):
    """A request whose ADMISSION deterministically kills the replica —
    every admission, every replica, every restart: the fixture for the
    supervisor's quarantine ladder (resubmit -> kill again -> evicted
    as poisoned instead of crash-looping forever). Marked by a token:
    any request whose prompt contains ``poison_token`` is the pill."""

    def __init__(self, poison_token: int):
        self.poison_token = int(poison_token)
        self.fired = 0

    def on_submit(self, replica_id, sub):
        if self.poison_token in np.asarray(sub.tokens).tolist():
            self.fired += 1
            from apex1_tpu_torch.serving.replica import PoisonedRequest
            raise PoisonedRequest(
                f"chaos: poison token {self.poison_token} in request "
                f"{sub.req_id}", req_id=sub.req_id)


class HandoffWindowKill(ServingFault):
    """Kill the SOURCE prefill replica in the handoff window — after
    its prefill completed but before the decode pool acknowledged the
    KV page (the request must be re-routed, never stranded). Fires on the ``at_handoff``-th handoff
    overall (0 = the first); ``repeat=True`` kills every handoff from
    then on (the crash-loop form — bounded by the frontend's
    ``max_handoff_attempts``)."""

    def __init__(self, at_handoff: int = 0, *, repeat: bool = False):
        self.at_handoff = int(at_handoff)
        self.repeat = bool(repeat)
        self.seen = 0
        self.fired = 0

    def on_handoff(self, replica_id, req_id, page):
        k = self.seen
        self.seen += 1
        if k < self.at_handoff or (self.fired and not self.repeat):
            return
        self.fired += 1
        from apex1_tpu_torch.serving.replica import ReplicaKilled
        raise ReplicaKilled(
            f"chaos: killed replica {replica_id} in the handoff window "
            f"of request {req_id} (handoff #{k})")


class HandoffCorruption(ServingFault):
    """Flip one byte of a transferred KV page AFTER its departure
    digests were taken (the torn/bit-rot transfer model) — the decode
    pool's arrival re-digest must surface a typed `HandoffError`, never
    silently garbage tokens. Fires on the ``at_handoff``-th handoff
    overall, once."""

    def __init__(self, at_handoff: int = 0):
        self.at_handoff = int(at_handoff)
        self.seen = 0
        self.fired = 0

    def on_handoff(self, replica_id, req_id, page):
        k = self.seen
        self.seen += 1
        if k != self.at_handoff or self.fired:
            return
        for entry in page.lane.values():
            for kv, leaf in entry.items():
                if leaf.numel():
                    # a real copy is the writable "wire buffer" the
                    # flipped bit lands in
                    arr = leaf.clone()
                    arr.reshape(-1).view(torch.uint8)[0] ^= 0xFF
                    entry[kv] = arr
                    self.fired += 1
                    return
def kill_schedule(seed: int, *, n_replicas: int, lo: int, hi: int
                  ) -> ReplicaKill:
    """Seed-derived `ReplicaKill`: replica and step picked by the same
    avalanche hash the rest of the chaos harness uses, so a bench's
    ``--chaos`` run is reproducible from its seed alone."""
    if hi <= lo:
        raise ValueError(f"need hi > lo, got [{lo}, {hi})")
    replica = _mix32(seed ^ 0xC0FFEE) % int(n_replicas)
    step = lo + _mix32(seed ^ 0xDEAD10C) % (hi - lo)
    return ReplicaKill(replica, step)


def toy_decoder(vocab_size: int = 61, device=None):
    """A deterministic cached toy decoder ``(apply_fn, make_cache)`` with
    the `models.generate` decoder contract and the JAX package's
    ``toy_decoder`` logits (an avalanche hash of the causal prefix sum
    of token + 1), so stale-cache and lost-stream bugs change tokens.
    The cache stores one small integer per position, so the int8
    ``cache_dtype`` profile is exact (values < 128). ``cache_index`` is
    a scalar or per-row (B,); the new values are written IN PLACE into
    the cache tensor it is given (the dense serving pool's lane or
    pool), as `models.generate.DenseCache` entries are. Its tensors live
    on ``device`` (CUDA unless named); it serves through
    ``EngineConfig(paged=False)``, as the JAX one does."""
    dev = resolve_device(device)
    m32 = 0xFFFFFFFF

    def make_cache(batch: int, max_len: int, dtype=None):
        dt = torch.float32 if dtype is None else dtype
        return {"toy": {"h": torch.zeros((batch, 1, max_len, 1), dtype=dt,
                                         device=dev)}}

    def apply_fn(tokens, cache, cache_index, positions=None,
                 chunk_decode=False):
        h = cache["toy"]["h"]                       # (B, 1, Smax, 1)
        B, S = tokens.shape
        smax = h.shape[2]
        idx = torch.as_tensor(cache_index, dtype=torch.int64,
                              device=h.device).reshape(-1).expand(B)
        ar = torch.arange(S, device=h.device)
        # dynamic_update_slice's clamped start
        col = idx.clamp(0, smax - S)[:, None] + ar
        rows = torch.arange(B, device=h.device)[:, None]
        h[rows, 0, col, 0] = (tokens.to(h.device).long() + 1).to(h.dtype)
        # causal-prefix sum per query: positions <= idx + j over the
        # updated cache, so each query sees itself
        pos = torch.arange(smax, device=h.device)
        keep = pos[None, None, :] <= (idx[:, None] + ar)[:, :, None]
        s = (h[:, 0, :, 0].float()[:, None, :] * keep).sum(-1)  # (B, S)
        su = s.to(torch.int64) & m32
        v = torch.arange(vocab_size, device=h.device, dtype=torch.int64)
        mixed = ((su[..., None] * 2654435761) & m32) + (v + 1) * 40499
        logits = -((mixed & m32) % 977).to(torch.float32)
        return logits, cache

    return apply_fn, make_cache
