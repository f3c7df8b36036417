"""Probes that pin the communication/compute OVERLAP property (the port
of ``apex1_tpu/testing/hlo_probe.py``).

The overlap layer (`parallel.ring_attention`'s double-buffered ring,
`parallel.halo.exchange_overlap`) claims that each ring step's hop is in
flight while the step computes: the hop's sends and receives are posted
before the step's attend and waited on after it. The JAX package pins
that claim on the compiled program's HLO text; PyTorch runs eagerly and
has no program text, so the port reads the order of events in a
``torch.profiler`` trace (Chrome-trace JSON, as
``utils.observability.trace`` writes it). Two modes, by what the trace
holds:

- **dependence mode** (the CPU over gloo: the tier-1 form). The ring and
  the exchange name their spans (`mappings.OVERLAP_SPANS`): a body
  (``overlap.body:ring.fwd``, ``ring.bwd``, ``halo``), each hop's
  posting and wait (``overlap.hop.post#<id>``, ``overlap.hop.wait#<id>``)
  and each step's compute (``overlap.compute``). A body passes when
  every compute step but its last runs with a hop in flight: some hop
  posted before the step starts and waited on after it ends, on the
  same thread. The host issues work in that order, so a step that runs
  inside its hop does not wait on the data the hop brings. The
  serialized ring (`ring_attention_serial`, ``:228``) hops first and
  attends the shard just received: it FAILS.
- **async mode** (the card, NCCL). An NCCL kernel's device interval must
  bracket compute kernels on another stream. This needs two GPUs: at
  world 1 every ring is one product with no NCCL kernel. So async mode
  is held here only on hand-built trace events; its run on NCCL ranks
  waits for a machine with two cards.

Entry points: `check_collective_overlap` (a report),
`assert_collective_overlap` (raises: the test and gate form) and
`count_collectives` (one kind's calls in a trace, held against
`mappings.COLLECTIVES`). ``python -m apex1_tpu_torch.testing.hlo_probe``
runs the CPU self-check: the overlapped ring, forward and forward +
backward, must PASS and the serialized ring must FAIL, on two gloo
ranks launched through `parallel.launch`.
"""

from __future__ import annotations

import dataclasses
import os
import re

from apex1_tpu_torch.transformer.tensor_parallel.mappings import \
    OVERLAP_SPANS

#: the c10d ops each `mappings.COLLECTIVES` kind issues (their
#: ``torch.profiler`` names); send_recv counts the sends, one a tensor
#: of a hop, as ``COLLECTIVES["send_recv"]`` does
COLLECTIVE_OPS = {
    "all_reduce": r"c10d::allreduce_",
    "all_gather": r"c10d::(_allgather_base_|allgather_|"
                  r"allgather_into_tensor_coalesced_)",
    "reduce_scatter": r"c10d::(_reduce_scatter_base_|reduce_scatter_)",
    "all_to_all": r"c10d::alltoall(_base)?_",
    "broadcast": r"c10d::broadcast_",
    "send_recv": r"c10d::send",
}

_NCCL = re.compile(r"nccl", re.I)


@dataclasses.dataclass
class BodyReport:
    """Verdict for one ring or exchange (or, in async mode, the
    trace's device timeline)."""

    body: str
    mode: str            # "async" | "dependence"
    ok: bool
    n_permutes: int      # hops (async: collective kernels)
    n_compute: int       # compute steps (async: compute kernels)
    detail: str


@dataclasses.dataclass
class ProbeReport:
    """Aggregate verdict: every applicable body must pass."""

    mode: str
    ok: bool
    bodies: list
    detail: str


def trace_events(trace) -> list:
    """The events of ``trace``: a list of Chrome-trace events, a trace
    document, a path to a trace (``.json``/``.json.gz``) or a directory
    of them."""
    from apex1_tpu_torch.obs import xspace
    if isinstance(trace, dict):
        return list(trace.get("traceEvents", []))
    if isinstance(trace, (list, tuple)):
        return list(trace)
    path = os.fspath(trace)
    if os.path.isdir(path):
        events = []
        for p in xspace.find_trace_files(path):
            events += xspace.parse_trace(p)
        return events
    return xspace.parse_trace(path)


def _spans(events):
    return [e for e in events if e.get("ph") == "X" and "ts" in e
            and isinstance(e.get("name"), str)]


def _end(e) -> float:
    return float(e["ts"]) + float(e.get("dur", 0))


def _inside(e, body) -> bool:
    return (e.get("tid") == body.get("tid") and e.get("pid") == body.get("pid")
            and float(e["ts"]) >= float(body["ts"]) and _end(e) <= _end(body))


def _check_body(body, spans) -> BodyReport:
    """Dependence mode for one body span."""
    name = body["name"].split(":", 1)[-1]
    inner = [e for e in spans if e is not body and _inside(e, body)]
    posts, waits = {}, {}
    for e in inner:
        kind, _, hid = e["name"].partition("#")
        if kind == OVERLAP_SPANS["post"]:
            posts[hid] = e
        elif kind == OVERLAP_SPANS["wait"]:
            waits[hid] = e
    hops = [(posts[h], waits[h]) for h in posts if h in waits]
    steps = sorted((e for e in inner if e["name"] == OVERLAP_SPANS["compute"]),
                   key=lambda e: float(e["ts"]))
    hidden = [any(_end(p) <= float(c["ts"]) and float(w["ts"]) >= _end(c)
                  for p, w in hops) for c in steps]
    bare = [i for i, h in enumerate(hidden[:-1]) if not h]
    ok = bool(hops) and not bare
    if ok:
        detail = (f"{sum(hidden)} of {len(steps)} steps ran with a hop in "
                  f"flight (the last needs none)")
    else:
        detail = (f"step(s) {bare} ran with no hop in flight: the transfers "
                  f"are serialized against the compute")
    return BodyReport(body=name, mode="dependence", ok=ok,
                      n_permutes=len(hops), n_compute=len(steps),
                      detail=detail)


def _check_async(events) -> BodyReport:
    """Async mode: some NCCL kernel's interval brackets a compute kernel
    on another stream."""
    kernels = [e for e in _spans(events) if e.get("cat") == "kernel"]
    comms = [e for e in kernels if _NCCL.search(e["name"])]
    compute = [e for e in kernels if not _NCCL.search(e["name"])]
    pairs = [(c, k) for c in comms for k in compute
             if k.get("tid") != c.get("tid")
             and float(c["ts"]) <= float(k["ts"]) and _end(k) <= _end(c)]
    ok = bool(pairs)
    detail = (f"{len(pairs)} compute kernel(s) ran inside an NCCL kernel on "
              f"another stream" if ok else
              f"no NCCL kernel of {len(comms)} brackets a compute kernel on "
              f"another stream: the transfers are serialized")
    return BodyReport(body="device", mode="async", ok=ok,
                      n_permutes=len(comms), n_compute=len(compute),
                      detail=detail)


def check_collective_overlap(trace) -> ProbeReport:
    """Probe every body of ``trace`` that holds both hops and compute
    steps (dependence mode), or the device timeline where the trace has
    NCCL kernels (async mode). ``ok`` iff at least one body applies and
    every one exhibits the overlap property."""
    events = trace_events(trace)
    spans = _spans(events)
    if any(e.get("cat") == "kernel" and _NCCL.search(e["name"])
           for e in spans):
        rep = _check_async(events)
        return ProbeReport(mode="async", ok=rep.ok, bodies=[rep],
                           detail=f"device: {rep.detail}")
    prefix = OVERLAP_SPANS["body"] + ":"
    reports = [r for r in (_check_body(b, spans) for b in spans
                           if b["name"].startswith(prefix))
               if r.n_permutes and r.n_compute]
    if not reports:
        return ProbeReport(
            mode="dependence", ok=False, bodies=[],
            detail="no ring or exchange with both hops and compute steps "
                   "found: nothing to probe (wrong trace, or one rank)")
    ok = all(r.ok for r in reports)
    detail = "; ".join(f"{r.body}: {'OK' if r.ok else 'FAIL'} "
                       f"({r.n_permutes} hops, {r.n_compute} steps) "
                       f"{r.detail}" for r in reports)
    return ProbeReport(mode="dependence", ok=ok, bodies=reports,
                       detail=detail)


def assert_collective_overlap(trace, *, expect_mode=None) -> ProbeReport:
    """Raise ``AssertionError`` unless every applicable body of
    ``trace`` overlaps its transfers with compute; ``expect_mode`` pins
    the mode ("dependence" on the CPU, "async" on NCCL ranks)."""
    rep = check_collective_overlap(trace)
    if expect_mode is not None and rep.mode != expect_mode:
        raise AssertionError(
            f"hlo_probe ran in {rep.mode!r} mode, expected {expect_mode!r} "
            f"(wrong backend for this gate?)")
    if not rep.ok:
        raise AssertionError(f"collective overlap probe FAILED "
                             f"[{rep.mode}]: {rep.detail}")
    return rep


def count_collectives(trace, kinds=("all_reduce",)) -> int:
    """Calls of the `COLLECTIVE_OPS` ``kinds`` in ``trace`` (the c10d ops
    the host issued; a hop's sends count one a tensor): the structural
    pin, held against `mappings.COLLECTIVES` over the same step."""
    pats = [re.compile(r"^(" + COLLECTIVE_OPS[k] + r")$") for k in kinds]
    return sum(1 for e in _spans(trace_events(trace))
               if e.get("cat") == "cpu_op"
               and any(p.match(e["name"]) for p in pats))


def ring_case(which: str, rank_seed: int = 0) -> dict:
    """A rank body (for `parallel.launch`): ``which`` of "fwd", "bwd"
    (forward and backward) or "serial" over the world group, B 1, H 2,
    S 64 a rank, D 16, causal, under ``torch.profiler``. Returns the
    probe's spans and the c10d ops of the trace, and the send_recv
    count `mappings.COLLECTIVES` saw."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from apex1_tpu_torch.parallel.ring_attention import (
        ring_attention, ring_attention_serial)
    from apex1_tpu_torch.transformer.tensor_parallel import mappings
    from apex1_tpu_torch.utils.observability import trace

    n, r = dist.get_world_size(), dist.get_rank()
    rng = np.random.default_rng(rank_seed)
    B, H, S, D = 1, 2, 64, 16
    full = [rng.standard_normal((B, H, S * n, D)).astype(np.float32)
            for _ in range(3)]
    q, k, v = (torch.from_numpy(a[:, :, r * S:(r + 1) * S].copy())
               .requires_grad_(which == "bwd") for a in full)
    fn = ring_attention_serial if which == "serial" else ring_attention
    mappings.reset_collectives()
    with tempfile.TemporaryDirectory(prefix="hlo_probe_") as tmp:
        with trace(tmp) as prof:
            out = fn(q, k, v, dist.group.WORLD, causal=True)
            if which == "bwd":
                (out.float() ** 2).sum().backward()
        keep = [e for e in trace_events(prof.trace_path)
                if e.get("ph") == "X" and isinstance(e.get("name"), str)
                and (e["name"].startswith("overlap.")
                     or e["name"].startswith("c10d::"))]
    return {"events": keep,
            "send_recv": mappings.COLLECTIVES["send_recv"]}


def _self_check() -> int:
    """The CPU gate: the overlapped ring forward and forward + backward
    must PASS and the serialized ring must FAIL, on 2 gloo ranks."""
    from apex1_tpu_torch.parallel import launch

    failed = False
    for which, want in (("fwd", True), ("bwd", True), ("serial", False)):
        got = launch(ring_case, 2, which, backend="gloo")
        for r, res in enumerate(got):
            rep = check_collective_overlap(res["events"])
            sends = count_collectives(res["events"], ("send_recv",))
            good = (rep.ok == want and bool(rep.bodies)
                    and sends == res["send_recv"])
            failed |= not good
            print(f"  {'OK  ' if good else 'FAIL'} ring {which:6s} rank {r} "
                  f"[{rep.mode}] {'passes' if rep.ok else 'fails'} "
                  f"(want {'pass' if want else 'fail'}), {len(rep.bodies)} "
                  f"bodies, sends {sends} = COLLECTIVES "
                  f"{res['send_recv']}: {rep.detail}", flush=True)
    print("hlo_probe self-check " + ("FAILED" if failed else "PASSED"),
          flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(_self_check())
