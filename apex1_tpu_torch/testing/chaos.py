"""Deterministic chaos injection (the port of
``apex1_tpu/testing/chaos.py``): every recovery path of
`apex1_tpu_torch.resilience` and of the serving fleet is exercised on
the CPU, seed-keyed, so "SIGTERM mid-run, resume, bit-identical to
uninterrupted" is an assertable property.

Training and checkpoint faults:

- `poison_at_steps` / `poison_tree_at_steps` (on the device): a loss or
  a tree of grads becomes NaN (or Inf) exactly at the listed steps,
  which drives the sentinel's skip, rollback and abort ladder;
- `truncate_checkpoint` / `bitflip_checkpoint` (host): a deterministic
  payload-file pick from the checkpoint's own manifest and a
  deterministic byte (the JAX package's pick and offset: both
  packages damage one directory alike), so `find_restorable`'s
  backward scan meets real on-disk damage;
- `sigterm_self_at` (host): SIGTERM to this process at a step boundary,
  for `PreemptionHandler` and the resumable exit;
- `Flaky`: a callable that raises `resilience.TransientError` for its
  first N calls, for the retry and backoff policy;
- `shrink_schedule`: a seed-keyed (kill step, survivors) pick for an
  elastic drill.

Serving faults: hooks `serving.replica.ReplicaSupervisor` and
`serving.disagg.DisaggFrontend` call at their submit / step / handoff
boundaries:

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

``python -m apex1_tpu_torch.testing.chaos --smoke`` runs the two
headline training recoveries on the CPU (an injected-NaN rollback and
the fallback scan past a truncated and a bit-flipped checkpoint).
"""

from __future__ import annotations

import os
import signal
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from apex1_tpu_torch.ops._common import resolve_device
from apex1_tpu_torch.resilience.manifest import read_manifest
from apex1_tpu_torch.resilience.retry import TransientError, _mix32

__all__ = [
    "poison_at_steps", "poison_tree_at_steps", "truncate_checkpoint",
    "bitflip_checkpoint", "sigterm_self_at", "Flaky", "TransientError",
    "ServingFault", "ChaosSchedule", "ReplicaKill", "ReplicaHang",
    "SlowReplica", "PoisonPill", "HandoffWindowKill",
    "HandoffCorruption", "kill_schedule", "shrink_schedule",
    "toy_decoder",
]


# -- on-device injection -----------------------------------------------------

def poison_at_steps(value, step, steps: Sequence[int], *,
                    poison: float = float("nan")):
    """``value`` except at the listed ``steps``, where every element
    becomes ``poison`` (NaN by default; ``float('inf')`` for Inf).
    ``step`` may be a 0-d tensor (the train state's step counter): the
    pick is a device-side select, no host sync. The identity when
    ``steps`` is empty."""
    if not len(steps):
        return value
    v = torch.as_tensor(value)
    step = torch.as_tensor(step, device=v.device)
    hit = (torch.tensor(list(steps), dtype=torch.int64, device=v.device)
           == step.long()).any()
    return torch.where(hit, torch.full_like(v, poison), v)


def poison_tree_at_steps(tree, step, steps: Sequence[int], *,
                         poison: float = float("nan")):
    """`poison_at_steps` over every floating tensor of a tree (poisoned
    grads, not only a poisoned loss)."""
    from apex1_tpu_torch.core.pytree import tree_map_with_path

    def leaf(_p, x):
        if not (isinstance(x, torch.Tensor) and torch.is_floating_point(x)):
            return x
        return poison_at_steps(x, step, steps, poison=poison)

    return tree_map_with_path(leaf, tree)


# -- on-disk corruption -------------------------------------------------------

def _pick_payload_file(ckpt_dir: str, seed: int) -> str:
    """Deterministic payload-file pick from the checkpoint's own
    manifest: the largest file (ties broken by path), rotated by seed,
    so the damage lands on bytes the manifest covers."""
    m = read_manifest(ckpt_dir)
    files = sorted(m.files, key=lambda e: (-e["bytes"], e["path"]))
    if not files:
        raise ValueError(f"{ckpt_dir}: no payload files to corrupt")
    biggest = [e for e in files if e["bytes"] == files[0]["bytes"]]
    pick = biggest[_mix32(seed) % len(biggest)]
    return os.path.join(ckpt_dir, pick["path"])


def truncate_checkpoint(ckpt_dir: str | os.PathLike, *, seed: int = 0,
                        keep_fraction: float = 0.5) -> str:
    """Truncate a manifest-covered payload file to ``keep_fraction`` of
    its size (a killed writer, a torn copy). Returns the damaged path."""
    path = _pick_payload_file(os.fspath(ckpt_dir), seed)
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(int(size * keep_fraction))
    return path


def bitflip_checkpoint(ckpt_dir: str | os.PathLike, *, seed: int = 0
                       ) -> str:
    """XOR one deterministic byte of a payload file (bit rot). The size
    is unchanged: only the content digest catches it. Returns the
    damaged path."""
    path = _pick_payload_file(os.fspath(ckpt_dir), seed)
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"{path}: empty file, nothing to flip")
    off = _mix32(seed ^ 0xB17F11B) % size
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


# -- preemption and transient faults ----------------------------------------

def sigterm_self_at(step: int, at_step: Optional[int],
                    *, signum: int = signal.SIGTERM) -> bool:
    """Deliver ``signum`` to this process when ``step == at_step`` (the
    simulated mid-run preemption). Returns True when fired; a no-op
    (False) when ``at_step`` is None."""
    if at_step is None or int(step) != int(at_step):
        return False
    os.kill(os.getpid(), signum)
    return True


class Flaky:
    """Wrap ``fn`` to raise `TransientError` on its first ``fails``
    calls, then pass through. ``attempts`` and ``failures`` are what
    retry tests assert."""

    def __init__(self, fn: Callable, *, fails: int = 2,
                 exc: type = TransientError):
        self.fn = fn
        self.fails = int(fails)
        self.exc = exc
        self.attempts = 0
        self.failures = 0

    def __call__(self, *args, **kwargs):
        self.attempts += 1
        if self.attempts <= self.fails:
            self.failures += 1
            raise self.exc(
                f"injected transient failure {self.failures}/{self.fails}")
        return self.fn(*args, **kwargs)


def shrink_schedule(seed: int, *, n_devices: int, lo: int, hi: int,
                    survivors: Optional[int] = None) -> tuple:
    """Seed-keyed mid-run fleet shrink for an elastic drill:
    ``(kill_step, n_survivors)``; survivors default to the largest
    proper divisor of ``n_devices``. The JAX package's pick."""
    if hi <= lo:
        raise ValueError(f"need hi > lo, got [{lo}, {hi})")
    step = lo + _mix32(seed ^ 0xE1A57C) % (hi - lo)
    if survivors is None:
        divs = [d for d in range(1, n_devices) if n_devices % d == 0]
        if not divs:
            raise ValueError(
                f"n_devices={n_devices} has no proper divisor to "
                "shrink onto")
        survivors = max(divs)
    if not 1 <= survivors < n_devices:
        raise ValueError(
            f"survivors={survivors} must be in [1, {n_devices})")
    return step, int(survivors)


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


# -- smoke entry point ---------------------------------------------------------

def _smoke() -> int:
    """The two headline training recoveries on the CPU, tiny: (1)
    NaN-poisoned losses at steps 3 and 4: a device-side skip, then a
    rollback to the last good checkpoint with a banked diagnostic; (2)
    the newest checkpoint truncated and the one before bit-flipped:
    `find_restorable` picks the older valid one and it restores."""
    import tempfile

    from apex1_tpu_torch.amp import Amp
    from apex1_tpu_torch.optim import fused_sgd
    from apex1_tpu_torch.resilience import (ResilientCheckpointer,
                                            Sentinel, find_restorable,
                                            sentinel_init)

    amp = Amp(fused_sgd(0.1), opt_level="O0")
    state = amp.init({"w": torch.ones((8,), dtype=torch.float32)})

    def loss_fn(p, x, step):
        loss = torch.sum(torch.square(p["w"])) * x
        return poison_at_steps(loss, step, (3, 4))

    one = torch.tensor(1.0)
    with tempfile.TemporaryDirectory() as d:
        ck = ResilientCheckpointer(d, keep=4)
        sent = Sentinel(ck, check_every=1, rollback_after=2)
        guarded = sent.guard(amp.make_train_step(loss_fn))
        carry = (state, sentinel_init("cpu"))
        rolled_back = False
        i = 0
        while i < 6 and not rolled_back:
            carry, _m = guarded(carry, one, carry[0].step)
            ck.save_sync(int(carry[0].step), carry[0],
                         meta={"data_step": i + 1})
            if sent.poll(carry[1]) == "rollback":
                good, manifest, s0 = sent.rollback(template=carry[0])
                carry = (good, s0)
                rolled_back = True
            i += 1
        assert rolled_back, "NaN injection never escalated to rollback"
        assert sent.records[-1]["action"] == "rollback"
        assert torch.isfinite(carry[0].params["w"]).all()
        print(f"chaos smoke [1/2] OK: NaN@step3,4 -> skip -> rollback to "
              f"step {manifest.step}, diagnostic banked "
              f"({sent.records[-1].get('path', '<memory>')})")

        dirs = sorted(p for p in os.listdir(d) if p.startswith("step_"))
        assert len(dirs) >= 3
        truncate_checkpoint(os.path.join(d, dirs[-1]))
        bitflip_checkpoint(os.path.join(d, dirs[-2]))
        best = find_restorable(d)
        assert best is not None and os.path.basename(best) == dirs[-3], \
            f"expected fallback to {dirs[-3]}, got {best}"
        restored, man = ck.restore(template=carry[0], path=best)
        assert int(man.step) == int(restored.step)
        ck.close()
        print(f"chaos smoke [2/2] OK: truncated {dirs[-1]} + bit-flipped "
              f"{dirs[-2]} -> find_restorable fell back to {dirs[-3]}")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run the two headline training recovery paths "
                         "(CPU)")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    ap.print_help()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
