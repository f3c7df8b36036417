"""Calibration (the port of ``apex1_tpu/obs/calibrate.py``): fit
(predicted -> measured) correction factors from banked measurements and
hand them to the planner's prices.

- **pairs**: each banked measurement joined to its own prediction:
  bench log records (``<results>/bench_*.log``) against the newest
  ``predicted_*.json`` step rows, and tuning-table entries that bank
  the analytic ``predicted.ms`` beside their ``time_ms``.
- **factors**: per key (``step:<config>`` / ``kernel:<name>``), the
  geometric-mean SLOWDOWN ``predicted_rate / measured_rate`` (> 1 =
  slower than the roofline). Factors fitted on the row's own silicon
  (records tagged ``[gpu]`` for a GPU row) land in ``factors``;
  interpret or CPU-proxy pairs land in ``proxy_factors`` and are NEVER
  applied.
- **lookup**: `step_slowdown` / `kernel_slowdown`, and the planner's
  `planner.cost.calibration_factor`.

A table is fitted for ONE generation (its ``"generation"`` field), and a
price at another generation refuses it (`table_for`): a TPU's
correction is not a GPU's, so a table the JAX package banked for
``"v5e"`` never scales an H100 price, even where a caller passes the
JAX package's ``perf_results/`` directory.

The port's results directory is its own (`default_results_dir`,
``perf_results_torch/`` at the repo root), never the JAX package's
``perf_results/``; until the port's benchmark banks records there every
price on the card is labelled ``uncalibrated``.

CLI::

    python -m apex1_tpu_torch.obs.calibrate [--results DIR]
        [--out DIR/calibration.json] [--generation h100] [--dry-run]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os
import time
from typing import Optional

from apex1_tpu_torch.core.capability import (default_generation,
                                             get_capability)

SCHEMA = "apex1-calibration-v1"
CAL_NAME = "calibration.json"

#: step configs whose analytic prediction is structurally meaningless,
#: excluded from fitting WITH the reason banked in the table
EXCLUDED_STEP_CONFIGS = {
    "decode": "scanned-loop blind spot: cost model counts streamed "
              "weights once, not per decode step (predict_perf.py)",
    "decode_int8": "scanned-loop blind spot (see decode)",
}

#: bench log filename -> bench config (the JAX package's table, the
#: results directory's schema)
LOG_TO_CONFIG = {
    "bench_bert.log": "bert",
    "bench_bert_drop.log": "bert_dropout",
    "bench_bert_lg.log": "bert_large",
    "bench_decode.log": "decode",
    "bench_dec_int8.log": "decode_int8",
    "bench_gpt2.log": "gpt2",
    "bench_gpt2_b24.log": "gpt2",
    "bench_gpt2_fp16.log": "gpt2_fp16",
    # the planner-driven 3D config joins no single-card prediction row
    # (the planner prices it): its records land in `excluded`
    "bench_llama3d.log": "llama_3d",
    "bench_llama_blk.log": "llama_block",
    "bench_llama16k.log": "llama_longctx",
    "bench_resnet.log": "resnet",
    "bench_t5.log": "t5",
}


def default_results_dir() -> str:
    """``perf_results_torch/`` beside the package: the port's own."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), "perf_results_torch")


def roofline_ms(flops: float, nbytes: float,
                generation: Optional[str] = None) -> float:
    """Analytic roofline milliseconds of one kernel call at a row."""
    cap = get_capability(generation)
    t = max(flops / (cap.bf16_tflops * 1e12),
            nbytes / (cap.hbm_gbps * 1e9))
    return t * 1e3


# -- prediction-table resolution (the newest-by-mtime rule) -----------------

def newest_prediction_path(results_dir: Optional[str] = None
                           ) -> Optional[str]:
    """Newest banked ``predicted_*.json`` by mtime (lexicographic order
    breaks at r10 vs r9)."""
    d = results_dir or default_results_dir()
    paths = glob.glob(os.path.join(d, "predicted_*.json"))
    if not paths:
        return None
    return max(paths, key=os.path.getmtime)


def newest_prediction(results_dir: Optional[str] = None) -> Optional[dict]:
    path = newest_prediction_path(results_dir)
    if path is None:
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    doc["_path"] = path
    return doc


def predicted_step_rate(row: dict, generation: Optional[str] = None
                        ) -> Optional[float]:
    """Roofline units/sec of one prediction-step row at a row of the
    capability table (default: the detected card), the exposed link
    term included."""
    try:
        cap = get_capability(generation)
        t = max(row["flops"] / (cap.bf16_tflops * 1e12),
                row["bytes"] / (cap.hbm_gbps * 1e9))
        # the prediction table's key, shared with the JAX package
        exposed = row.get("ici_exposed_bytes", 0.0)
        if exposed and cap.link_gbps:
            t += exposed / (cap.link_gbps * 1e9)
        if t <= 0:
            return None
        return row["units_per_step"] / t
    except (KeyError, TypeError, ValueError):
        return None


# -- pair collection ---------------------------------------------------------

@dataclasses.dataclass
class Pair:
    """One joinable (predicted, measured) observation."""

    key: str          # "step:<config>" | "kernel:<name>"
    predicted: float  # step: units/sec; kernel: ms
    measured: float   # same unit as predicted
    slowdown: float   # predicted_rate/measured_rate == meas_t/pred_t
    backend: str      # the row's platform ("gpu") | "cpu-proxy"
    source: str       # log / table file the measurement came from
    detail: dict      # free-form provenance

    def to_json(self) -> dict:
        return {"key": self.key, "predicted": self.predicted,
                "measured": self.measured,
                "slowdown": round(self.slowdown, 4),
                "backend": self.backend, "source": self.source,
                **({"detail": self.detail} if self.detail else {})}


def json_lines(path: str) -> list[dict]:
    """Every parseable one-line ``{...}`` object of a bench log, in
    order; an unreadable file gives []."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not (line.startswith("{") and line.endswith("}")):
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def collect_step_pairs(results_dir: Optional[str] = None,
                       generation: Optional[str] = None
                       ) -> tuple[list[Pair], list[dict]]:
    """Bench records measured on the row's platform (metric tagged
    ``[gpu]`` for a GPU row) joined against the newest prediction
    table. Returns ``(pairs, excluded)``; excluded rows carry their
    reason. The join is rate-based (units/sec), which tolerates a batch
    override to first order."""
    d = results_dir or default_results_dir()
    platform = get_capability(generation).platform
    pred = newest_prediction(d)
    rows = ({r.get("name"): r for r in pred.get("steps", [])
             if isinstance(r, dict) and "flops" in r} if pred else {})
    pairs: list[Pair] = []
    excluded: list[dict] = []
    for logname, config in sorted(LOG_TO_CONFIG.items()):
        path = os.path.join(d, logname)
        if not os.path.exists(path):
            continue
        for rec in json_lines(path):
            val = rec.get("value")
            if isinstance(val, bool) or not isinstance(val, (int, float)) \
                    or not math.isfinite(val) or val <= 0:
                continue
            if f"[{platform}]" not in rec.get("metric", ""):
                continue   # another platform's or a CPU smoke record:
                # not a measurement of this row, not an exclusion
            if config in EXCLUDED_STEP_CONFIGS:
                excluded.append({
                    "key": f"step:{config}", "source": logname,
                    "reason": EXCLUDED_STEP_CONFIGS[config]})
                continue
            row = rows.get(config)
            if row is None:
                excluded.append({
                    "key": f"step:{config}", "source": logname,
                    "reason": "no prediction row in newest "
                              "predicted_*.json"})
                continue
            rate = predicted_step_rate(row, generation)
            if not rate:
                excluded.append({
                    "key": f"step:{config}", "source": logname,
                    "reason": "prediction row unpriceable"})
                continue
            pairs.append(Pair(
                key=f"step:{config}", predicted=round(rate, 1),
                measured=float(val), slowdown=rate / float(val),
                backend=platform, source=logname,
                detail={k: rec[k] for k in ("batch", "step_ms")
                        if k in rec}))
    return pairs, excluded


def collect_kernel_pairs(tuning_dir: Optional[str] = None,
                         generation: Optional[str] = None) -> list[Pair]:
    """Tuning-table winners that bank both ``time_ms`` and the analytic
    ``predicted.ms``. Entries timed ``"measured"`` are the row's
    platform; the rest become cpu-proxy pairs (fitted, never applied).
    ``tuning_dir`` defaults to ``tuning/`` in `default_results_dir`."""
    if tuning_dir is None:
        tuning_dir = os.path.join(default_results_dir(), "tuning")
    platform = get_capability(generation).platform
    pairs: list[Pair] = []
    if not os.path.isdir(tuning_dir):
        return pairs
    for name in sorted(os.listdir(tuning_dir)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(tuning_dir, name)
        try:
            with open(path) as f:
                doc = json.load(f)
            kernel = doc.get("kernel") or name[:-5]
            entries = doc.get("entries") or {}
        except (OSError, json.JSONDecodeError, AttributeError):
            continue
        if not isinstance(entries, dict):
            continue
        for key, entry in sorted(entries.items()):
            if not isinstance(entry, dict):
                continue
            t = entry.get("time_ms")
            p = (entry.get("predicted") or {}).get("ms") \
                if isinstance(entry.get("predicted"), dict) else None
            if not isinstance(t, (int, float)) or isinstance(t, bool) \
                    or not isinstance(p, (int, float)) \
                    or isinstance(p, bool) or t <= 0 or p <= 0:
                continue
            backend = (platform if entry.get("timing") == "measured"
                       else "cpu-proxy")
            pairs.append(Pair(
                key=f"kernel:{kernel}", predicted=float(p),
                measured=float(t), slowdown=float(t) / float(p),
                backend=backend, source=os.path.join("tuning", name),
                detail={"entry": key, "blocks": entry.get("blocks")}))
    return pairs


def collect_pairs(results_dir: Optional[str] = None,
                  generation: Optional[str] = None,
                  tuning_dir: Optional[str] = None
                  ) -> tuple[list[Pair], list[dict]]:
    d = results_dir or default_results_dir()
    if tuning_dir is None:
        # the tuning corpus lives beside the bench logs (a foreign
        # corpus never leaks in); APEX1_TUNING_DIR overrides
        env = os.environ.get("APEX1_TUNING_DIR", "").strip()
        tuning_dir = env or os.path.join(d, "tuning")
    step_pairs, excluded = collect_step_pairs(d, generation)
    return (step_pairs + collect_kernel_pairs(tuning_dir, generation),
            excluded)


# -- fitting -----------------------------------------------------------------

def _geomean(xs: list[float]) -> float:
    return math.exp(sum(math.log(x) for x in xs) / len(xs))


def fit(pairs: list[Pair]) -> tuple[dict, dict]:
    """Per-key geometric-mean slowdown. Returns ``(factors,
    proxy_factors)``: silicon keys in the first (the appliable ones),
    cpu-proxy-only evidence in the second."""
    by: dict[tuple, list[Pair]] = {}
    for p in pairs:
        by.setdefault((p.key, p.backend), []).append(p)
    factors: dict[str, dict] = {}
    proxy: dict[str, dict] = {}
    for (key, backend), ps in sorted(by.items()):
        geo = _geomean([p.slowdown for p in ps])
        residuals = [p.slowdown / geo for p in ps]
        doc = {"slowdown": round(geo, 4), "n": len(ps),
               "backend": backend,
               "residual_spread": [round(min(residuals), 4),
                                   round(max(residuals), 4)],
               "sources": sorted({p.source for p in ps})}
        (proxy if backend == "cpu-proxy" else factors)[key] = doc
    return factors, proxy


def build_calibration(results_dir: Optional[str] = None,
                      generation: Optional[str] = None,
                      tuning_dir: Optional[str] = None) -> dict:
    gen = generation or default_generation()
    pairs, excluded = collect_pairs(results_dir, gen, tuning_dir)
    factors, proxy = fit(pairs)
    pred_path = newest_prediction_path(results_dir)
    return {"schema": SCHEMA,
            "generation": gen,
            "generated_unix": round(time.time(), 1),
            "prediction_table": (os.path.basename(pred_path)
                                 if pred_path else None),
            "n_pairs": len(pairs),
            "factors": factors,
            "proxy_factors": proxy,
            "excluded": excluded,
            "pairs": [p.to_json() for p in pairs]}


def save_calibration(doc: dict, path: Optional[str] = None,
                     results_dir: Optional[str] = None) -> str:
    from apex1_tpu_torch.resilience.manifest import atomic_write_json

    if path is None:
        path = os.path.join(results_dir or default_results_dir(),
                            CAL_NAME)
    atomic_write_json(path, doc)
    return path


# -- lookup (the consumer API) -----------------------------------------------

def load_calibration(results_dir: Optional[str] = None,
                     path: Optional[str] = None) -> Optional[dict]:
    """The banked table, or None: a corrupt or foreign-schema file is a
    miss, never an exception."""
    if path is None:
        path = os.path.join(results_dir or default_results_dir(),
                            CAL_NAME)
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    if not isinstance(doc, dict) or doc.get("schema") != SCHEMA:
        return None
    return doc


def table_for(generation: Optional[str] = None,
              results_dir: Optional[str] = None
              ) -> tuple[Optional[dict], Optional[str]]:
    """``(table, refusal)``: the banked table when it was fitted for
    ``generation`` (default: the detected card), else ``(None, why)``
    (``why`` None when no table is banked at all)."""
    doc = load_calibration(results_dir)
    if doc is None:
        return None, None
    gen = generation or default_generation()
    if doc.get("generation") != gen:
        return None, f"table is for {doc.get('generation')}"
    return doc, None


def _slowdown(key: str, results_dir: Optional[str] = None,
              generation: Optional[str] = None) -> Optional[dict]:
    doc, _why = table_for(generation, results_dir)
    if doc is None:
        return None
    f = doc.get("factors", {}).get(key)
    if not isinstance(f, dict):
        return None
    s = f.get("slowdown")
    if not isinstance(s, (int, float)) or isinstance(s, bool) or s <= 0:
        return None
    return f


def step_slowdown(config: str, results_dir: Optional[str] = None,
                  generation: Optional[str] = None) -> Optional[dict]:
    """The silicon factor doc of a bench config at ``generation``, or
    None. cpu-proxy factors are unreachable here."""
    return _slowdown(f"step:{config}", results_dir, generation)


def kernel_slowdown(kernel: str, results_dir: Optional[str] = None,
                    generation: Optional[str] = None) -> Optional[dict]:
    return _slowdown(f"kernel:{kernel}", results_dir, generation)


# -- CLI ---------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", default=None,
                    help="results dir (default: perf_results_torch/)")
    ap.add_argument("--out", default=None,
                    help=f"output path (default <results>/{CAL_NAME})")
    ap.add_argument("--generation", default=None,
                    help="capability row the banked records came from "
                         "(default: the detected card, h100 without one)")
    ap.add_argument("--dry-run", action="store_true",
                    help="print the fit; don't write the table")
    args = ap.parse_args(argv)

    doc = build_calibration(args.results, args.generation)
    print(f"calibration ({doc['generation']}): {doc['n_pairs']} pairs -> "
          f"{len(doc['factors'])} silicon factor(s), "
          f"{len(doc['proxy_factors'])} cpu-proxy factor(s), "
          f"{len(doc['excluded'])} excluded "
          f"(prediction table: {doc['prediction_table']})", flush=True)
    for label, fs in (("silicon", doc["factors"]),
                      ("cpu-proxy", doc["proxy_factors"])):
        for key, f in sorted(fs.items()):
            lo, hi = f["residual_spread"]
            print(f"  [{label}] {key:28s} slowdown {f['slowdown']:8.3f}  "
                  f"n={f['n']}  residual x{lo:.2f}..x{hi:.2f}")
    for e in doc["excluded"]:
        print(f"  [excluded] {e['key']:25s} {e['reason'][:80]}")
    if not args.dry_run:
        path = save_calibration(doc, args.out, args.results)
        print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
