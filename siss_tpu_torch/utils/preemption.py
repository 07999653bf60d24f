"""Preemption-safe training: port of ``siss_tpu/utils/preemption.py``.

A SIGTERM/SIGINT hook requests a graceful stop: the train loop checks
``should_stop`` once per step, saves a full ``state`` bundle and exits, so
``resume_from_checkpoint`` continues the run. A second signal falls through
to the previous handler.
"""

from __future__ import annotations

import signal
import threading

# Process-wide stop flag: a preemption signal concerns the whole process,
# whichever guard instance was installed when it arrived.
_STOP = threading.Event()


class PreemptionGuard:
    def __init__(self):
        self._stop = _STOP
        self._installed = False
        self._prev = {}

    def install(self):
        """Idempotent; only from the main thread (the signal module's rule)."""
        if self._installed or threading.current_thread() is not threading.main_thread():
            return self
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):
                pass
        self._installed = True
        return self

    def _handler(self, signum, frame):
        print(f"[preemption] signal {signum} received; will checkpoint and stop")
        self._stop.set()
        try:
            signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
        except (ValueError, OSError):
            pass

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def reset(self):
        """Clear the process-wide flag (tests, deliberate multi-runs)."""
        self._stop.clear()
        return self
