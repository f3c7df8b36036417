"""``python -m apex1_tpu_torch.obs --smoke [--device cpu]``: the
measurement flywheel end to end (the port of ``apex1_tpu/obs/
__main__.py``).

1. spine: open a run in a temporary directory, emit a span, a counter
   and an event, read the file back through `read_events`: the schema's
   round trip.
2. trace -> report: a real ``utils.observability.trace`` of one tiny
   GPT-2 O2 training step (on the card unless ``--device cpu``), then
   `xspace`'s per-op report, persisted beside the trace; it must
   attribute ops (``plane_class`` ``"device"`` on the card, where the
   port's kernels land in the ``kernel`` bucket; ``"host-proxy"`` on
   the CPU).
3. calibrate: fit factors from the port's own corpus
   (``perf_results_torch/``). With that directory empty the fit is
   empty and the planner's prices must read ``uncalibrated``: the JAX
   package's TPU ``perf_results/calibration.json`` is never borrowed.

A failed stage exits non-zero and names the stage.
"""

import argparse
import json
import os
import sys
import tempfile


def _spine(tmp: str) -> str:
    from apex1_tpu_torch.obs import spine
    with spine.ObsRun(dir=tmp, component="obs_smoke") as run:
        with run.span("smoke.step", iters=1):
            pass
        run.counter("smoke.count", 2)
        run.event("smoke.note", detail="hello")
        path = run.path
    events = spine.read_events(path)
    kinds = [e["kind"] for e in events]
    if kinds != ["run", "span", "counter", "event"] \
            or events[0]["schema"] != spine.SCHEMA:
        raise AssertionError(f"events read back as {kinds}")
    return f"{len(events)} events round-tripped"


def _trace(tmp: str, device) -> str:
    import torch

    from apex1_tpu_torch import Amp, fused_adam, get_policy
    from apex1_tpu_torch.interop import gpt2_params_from_jax
    from apex1_tpu_torch.models.gpt2 import (GPT2Config, gpt2_loss_fn,
                                             init_params)
    from apex1_tpu_torch.obs import xspace
    from apex1_tpu_torch.ops._common import resolve_device
    from apex1_tpu_torch.utils.observability import trace

    dev = resolve_device(device)
    cfg = GPT2Config.tiny(policy=get_policy("O2"), use_flash=True)
    model = gpt2_params_from_jax(init_params(cfg, 0), cfg, dev)
    amp = Amp(fused_adam(1e-3), opt_level="O2")
    state = amp.init(dict(model.named_parameters()))
    step = amp.make_train_step(gpt2_loss_fn(model))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(0)).to(dev)
    state, _ = step(state, tokens)          # first-call work outside
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tdir = os.path.join(tmp, "trace")
    with trace(tdir):
        state, m = step(state, tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize()
    report = xspace.build_report(tdir, steps=1)
    with open(xspace.write_report(tdir, report=report)) as f:
        banked = json.load(f)
    want = "device" if dev.type == "cuda" else "host-proxy"
    if banked["schema"] != xspace.REPORT_SCHEMA or banked["n_ops"] <= 0 \
            or banked["total_op_ms"] <= 0 \
            or set(banked["buckets"]) != set(xspace.BUCKETS) \
            or banked["plane_class"] != want:
        raise AssertionError(f"report {banked['plane_class']}, "
                             f"{banked['n_ops']} ops, want {want}")
    if want == "device" and banked["buckets"]["kernel"]["ms"] <= 0:
        raise AssertionError("no op of the port's kernels in the report")
    split = " ".join(f"{b} {v['share']:.3f}"
                     for b, v in banked["buckets"].items())
    return (f"{banked['n_ops']} ops attributed ({banked['plane_class']}, "
            f"{banked['per_step_ms']:.3f} ms a step; {split})")


def _calibrate() -> str:
    from apex1_tpu_torch.obs import calibrate
    from apex1_tpu_torch.planner import BANKED_SHAPES
    from apex1_tpu_torch.planner.cost import calibration_factor

    doc = calibrate.build_calibration()
    n_factors = len(doc["factors"]) + len(doc["proxy_factors"])
    price = calibration_factor(BANKED_SHAPES["gpt2"])
    if doc["n_pairs"] == 0 or n_factors == 0:
        if not price["source"].startswith("uncalibrated"):
            raise AssertionError(f"an empty corpus priced as "
                                 f"{price['source']!r}")
    return (f"{doc['n_pairs']} pairs -> {len(doc['factors'])} "
            f"{doc['generation']} + {len(doc['proxy_factors'])} cpu-proxy "
            f"factors; gpt2 priced x{price['slowdown']:.2f} "
            f"[{price['source']}]")


def smoke(device=None) -> int:
    with tempfile.TemporaryDirectory(prefix="obs_smoke_") as tmp:
        for stage, fn in (("spine", lambda: _spine(tmp)),
                          ("trace", lambda: _trace(tmp, device)),
                          ("calibrate", _calibrate)):
            try:
                detail = fn()
            except Exception as e:  # a stage's failure, named
                print(f"FAIL stage {stage}: {type(e).__name__}: {e}",
                      flush=True)
                return 1
            print(f"{stage} OK: {detail}", flush=True)
    print("OBS SMOKE OK", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m apex1_tpu_torch.obs")
    ap.add_argument("--smoke", action="store_true",
                    help="run the flywheel smoke")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(args.device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
