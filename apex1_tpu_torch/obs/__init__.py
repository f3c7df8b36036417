"""Observability (the port of ``apex1_tpu/obs``): the measurement
flywheel.

- `spine` — one run-scoped telemetry schema (spans, counters, gauges,
  events) banked as JSONL. The training loops (through
  `utils.observability.MetricsLogger`), the serving metrics, the
  sentinel, the elastic resume and the tuning sweep emit through it;
  activated by ``APEX1_OBS_DIR``, inert otherwise.
- `xspace` — the per-op report of a ``torch.profiler`` Chrome trace
  (``utils.observability.trace``): device time by kernel, bucketed into
  the port's own kernels, collectives and the library's kernels.
- `calibrate` — fits the planner's correction factors from the port's
  banked measurements (``perf_results_torch/``).

``python -m apex1_tpu_torch.obs --smoke`` drives the three."""

from apex1_tpu_torch.obs import calibrate, spine, xspace  # noqa: F401
from apex1_tpu_torch.obs.spine import (ObsRun, StopWatch,  # noqa: F401
                                       default_run, emit, read_events,
                                       set_default_run)
from apex1_tpu_torch.obs.xspace import (TraceError,  # noqa: F401
                                        build_report, parse_trace,
                                        write_report)
