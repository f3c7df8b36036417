"""Preemption-safe shutdown (the port of
``apex1_tpu/resilience/preemption.py``): SIGTERM becomes a banked
checkpoint and a machine-readable "re-queue me" exit code.

- `PreemptionHandler` installs SIGTERM/SIGINT handlers (main thread
  only, a Python signal-handler restriction) that set a flag; the
  training loop checks ``handler.triggered`` at step boundaries, writes
  one final synchronous checkpoint and calls ``exit_resumable()``.
- A second delivery of any installed signal (the impatient scheduler's
  double tap, typically while the final checkpoint is still in flight)
  escalates to an immediate ``os._exit(75)``: immediate because the
  scheduler is done waiting, resumable because the last committed
  checkpoint is still valid by the manifest and ring design. The
  escalation is cross-signal (SIGINT then SIGTERM escalates too).
- `EXIT_RESUMABLE` (75, BSD ``EX_TEMPFAIL``) is the exit-code half of
  the contract: a job queue re-queues an entry that exits 75 instead of
  recording a failure, and the relaunch resumes from
  `find_restorable`.

Standard library only.
"""

from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import Optional, Sequence

# BSD EX_TEMPFAIL: "temporary failure, retry later" — distinct from 0
# (done), 1 (real failure), and 124/137 (timeout kills), and stable
# across shells.
EXIT_RESUMABLE = 75


class PreemptionHandler:
    """Grace-period SIGTERM/SIGINT hook for training loops.

    ::

        with PreemptionHandler() as pre:
            for step in range(start, total):
                state, metrics = train_step(state, batch_at(step))
                if pre.triggered:
                    ckptr.save_sync(step, state, meta={"data_step": step})
                    pre.exit_resumable(f"preempted at step {step}")

    ``grace_s`` documents the window the loop has to reach the next step
    boundary; ``deadline_exceeded()`` lets long steps bail early (skip
    the final checkpoint rather than be SIGKILLed mid-write — the
    previous async checkpoint is still valid, which is the point of the
    manifest/ring design).
    """

    def __init__(self, signals: Sequence[int] = (signal.SIGTERM,
                                                 signal.SIGINT),
                 *, grace_s: float = 30.0):
        self.signals = tuple(signals)
        self.grace_s = float(grace_s)
        self._event = threading.Event()
        self._signum: Optional[int] = None
        self._t_signal: Optional[float] = None
        self._old = {}

    # -- install/uninstall -------------------------------------------------

    def install(self) -> "PreemptionHandler":
        for s in self.signals:
            self._old[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, old in self._old.items():
            signal.signal(s, old)
        self._old.clear()

    def __enter__(self) -> "PreemptionHandler":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def _on_signal(self, signum, frame):
        if self._event.is_set():
            # double-tap while the drain/final checkpoint is in
            # flight: exit NOW (the scheduler stopped waiting), but
            # RESUMABLY — the previous committed checkpoint is valid,
            # so 75 re-queues the job where 128+signum would record a
            # failure and a swallowed flag would hang the drain.
            # os.write, not print: a signal handler must not re-enter
            # buffered I/O the interrupted frame may hold.
            os.write(2, b"[preemption] second signal during drain: "
                        b"immediate resumable exit (75)\n")
            os._exit(EXIT_RESUMABLE)
        self._signum = signum
        self._t_signal = time.monotonic()
        self._event.set()

    # -- loop-facing state -------------------------------------------------

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    @property
    def signum(self) -> Optional[int]:
        return self._signum

    def deadline_exceeded(self) -> bool:
        """True once more than ``grace_s`` elapsed since the signal."""
        return (self._t_signal is not None
                and time.monotonic() - self._t_signal > self.grace_s)

    def exit_resumable(self, msg: str = "preempted; checkpoint banked"
                       ) -> None:
        """Exit with `EXIT_RESUMABLE` after flushing the message."""
        print(f"[preemption] {msg} (exit {EXIT_RESUMABLE}: resumable)",
              flush=True)
        sys.exit(EXIT_RESUMABLE)
