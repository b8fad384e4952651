"""Error tracker: a ring of error events with rolling rates.

A copy of ``ErrorTracker`` and ``ERROR_TRACKER`` from
``wavecap_tpu/utils/observability.py`` (the capture engine's health
monitor records into it); the reference module's profiler, system
metrics and log streaming stay with the server's port.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass


@dataclass
class ErrorEvent:
    time: float
    kind: str  # iq_overflow | audio_drop | device_retry | pipeline_error | ...
    source: str
    message: str = ""


class ErrorTracker:
    RING = 1000

    def __init__(self):
        self._events: deque = deque(maxlen=self.RING)
        self._lock = threading.Lock()

    def record(self, kind: str, source: str, message: str = "") -> None:
        with self._lock:
            self._events.append(ErrorEvent(time.time(), kind, source, message))

    def recent(self, limit: int = 100) -> list[ErrorEvent]:
        with self._lock:
            return list(self._events)[-limit:]

    def rates(self) -> dict:
        """Events/sec over the last 1 s and 60 s, per kind."""
        now = time.time()
        with self._lock:
            events = list(self._events)
        out: dict[str, dict[str, float]] = {}
        for kind in {e.kind for e in events}:
            k_events = [e for e in events if e.kind == kind]
            out[kind] = {
                "rate1s": sum(1 for e in k_events if now - e.time <= 1.0),
                "rate1m": sum(1 for e in k_events if now - e.time <= 60.0) / 60.0,
                "total": len(k_events),
            }
        return out


ERROR_TRACKER = ErrorTracker()
