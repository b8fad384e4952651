"""Call-event bookkeeping: dedup windows and staleness tracking.

Behavioral port of reference ``trunking/duplicate_detector.py`` (grant
signature dedup window) and ``trunking/event_tracker.py`` (call event
state machine with staleness).

The port's copy of ``wavecap_tpu/trunking/events.py``, with the same public names.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass(frozen=True)
class CallSignature:
    tgid: int
    frequency_hz: float
    source_id: int = 0


class DuplicateDetector:
    """Suppress repeated grants within a time window (reference :334)."""

    def __init__(self, window_s: float = 5.0):
        self.window_s = window_s
        self._seen: dict[CallSignature, float] = {}
        self.suppressed = 0

    def is_duplicate(self, sig: CallSignature, now: float | None = None) -> bool:
        now = time.time() if now is None else now
        self._seen = {
            k: t for k, t in self._seen.items() if now - t < self.window_s
        }
        if sig in self._seen:
            self._seen[sig] = now
            self.suppressed += 1
            return True
        self._seen[sig] = now
        return False


@dataclass
class CallEvent:
    tgid: int
    frequency_hz: float
    source_id: int = 0
    start_time: float = field(default_factory=time.time)
    last_update: float = field(default_factory=time.time)
    state: str = "active"  # active | stale | ended
    updates: int = 0


class CallEventTracker:
    """Track call lifecycles with staleness (reference event_tracker.py)."""

    def __init__(self, stale_after_s: float = 5.0, end_after_s: float = 15.0):
        self.stale_after_s = stale_after_s
        self.end_after_s = end_after_s
        self.events: dict[int, CallEvent] = {}  # by tgid
        self.ended: list[CallEvent] = []

    def update(
        self, tgid: int, frequency_hz: float, source_id: int = 0,
        now: float | None = None,
    ) -> CallEvent:
        now = time.time() if now is None else now
        evt = self.events.get(tgid)
        if evt is None or evt.state == "ended":
            evt = CallEvent(tgid=tgid, frequency_hz=frequency_hz,
                            source_id=source_id, start_time=now, last_update=now)
            self.events[tgid] = evt
        else:
            evt.last_update = now
            evt.updates += 1
            evt.state = "active"
            if source_id:
                evt.source_id = source_id
        return evt

    def sweep(self, now: float | None = None) -> list[CallEvent]:
        """Advance staleness; returns newly-ended events."""
        now = time.time() if now is None else now
        ended = []
        for tgid, evt in list(self.events.items()):
            age = now - evt.last_update
            if evt.state == "active" and age > self.stale_after_s:
                evt.state = "stale"
            if evt.state == "stale" and age > self.end_after_s:
                evt.state = "ended"
                ended.append(evt)
                self.ended.append(evt)
                del self.events[tgid]
        return ended
