"""Resilient training runtime (the port of ``apex1_tpu/resilience``):

- `ResilientCheckpointer` / `find_restorable` (`.checkpointer`): async
  double-buffered snapshots with per-leaf integrity manifests, atomic
  ``latest`` promotion, a ring keep policy with milestone pins, and a
  backward scan past corrupt checkpoints to the newest valid one.
- `Sentinel` / `guard_train_step` (`.sentinel`): a device-side finite
  and divergence guard for every dtype with a skip, rollback, abort
  ladder and banked diagnostics.
- `PreemptionHandler` / `EXIT_RESUMABLE` (`.preemption`): SIGTERM
  grace hook, a final synchronous checkpoint, the re-queue exit code.
- `retry_call` / `backoff_delays` / `TransientError` (`.retry`): the one
  bounded-exponential-backoff policy, shared with
  `runtime.RequestFeeder`.
- `reshard_state` / `reshard_checkpoint` / `LayoutMismatch`
  (`.reshard`) and `elastic_resume` / `ElasticDecision` (`.elastic`):
  plan-carrying checkpoints remapped onto another layout,
  manifest-verified end to end; on a changed device count
  `elastic_resume` re-plans with `planner.make_plan` and reshards
  (`elastic.drill` is the acceptance drill).

The chaos harness (`apex1_tpu_torch.testing.chaos`) exercises every
recovery path on the CPU: injected NaNs, truncated and bit-flipped
checkpoints, a simulated SIGTERM, transient errors.
"""

from apex1_tpu_torch.resilience.checkpointer import (ResilientCheckpointer,
                                                     find_restorable,
                                                     is_valid_checkpoint,
                                                     step_dir_name)
from apex1_tpu_torch.resilience.elastic import (ElasticDecision,
                                                elastic_resume)
from apex1_tpu_torch.resilience.manifest import (IntegrityError, Manifest,
                                                 read_manifest, verify_files,
                                                 verify_tree,
                                                 write_manifest)
from apex1_tpu_torch.resilience.preemption import (EXIT_RESUMABLE,
                                                   PreemptionHandler)
from apex1_tpu_torch.resilience.reshard import (LayoutMismatch, read_plan,
                                                reshard_checkpoint,
                                                reshard_state)
from apex1_tpu_torch.resilience.retry import (TransientError,
                                              backoff_delays, retry_call)
from apex1_tpu_torch.resilience.sentinel import (DivergenceError, Sentinel,
                                                 SentinelState,
                                                 guard_train_step,
                                                 health_flag, refold_key,
                                                 refold_seed, sentinel_init)

__all__ = [
    "ResilientCheckpointer", "find_restorable", "is_valid_checkpoint",
    "step_dir_name",
    "IntegrityError", "Manifest", "read_manifest", "verify_files",
    "verify_tree", "write_manifest",
    "EXIT_RESUMABLE", "PreemptionHandler",
    "ElasticDecision", "LayoutMismatch", "elastic_resume", "read_plan",
    "reshard_checkpoint", "reshard_state",
    "TransientError", "backoff_delays", "retry_call",
    "DivergenceError", "Sentinel", "SentinelState", "guard_train_step",
    "health_flag", "refold_key", "refold_seed", "sentinel_init",
]
