"""Observability (the port of ``apex1_tpu/obs``): `spine`, one
run-scoped telemetry schema (spans, counters, gauges, events) banked as
JSONL. The training loops (through `utils.observability.MetricsLogger`),
the serving metrics, the sentinel and the elastic resume emit through
it; activated by ``APEX1_OBS_DIR``, inert otherwise. `calibrate` fits
the planner's correction factors from banked measurements. The JAX
package's ``xspace`` trace parser waits on a torch.profiler reader
(ROADMAP.md queue A item 11)."""

from apex1_tpu_torch.obs import spine  # noqa: F401
from apex1_tpu_torch.obs.spine import (ObsRun, StopWatch,  # noqa: F401
                                       default_run, emit, read_events,
                                       set_default_run)
