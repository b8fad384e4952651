"""Observability: error tracker, profiler, system metrics, log streaming,
state broadcasting.

Reference parity (SURVEY §5): ``error_tracker.py`` (ring of events with
1 s/1 m rolling rates), ``utils/profiler.py`` (ns-resolution section
accumulators), ``system_metrics.py`` (host CPU/mem + per-capture perf),
``log_streamer.py`` (in-memory tail ring), ``state_broadcaster.py``
(entity-change pub/sub).

The port's copy of ``wavecap_tpu/utils/observability.py``, with the same
public names (the capture engine's health monitor records into
``ERROR_TRACKER``).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Any, Callable


# ---------------------------------------------------------------------------
# Error tracker (reference error_tracker.py)
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Section profiler (reference utils/profiler.py)
# ---------------------------------------------------------------------------


class Profiler:
    def __init__(self, name: str = "", enabled: bool = True):
        self.name = name
        self.enabled = enabled
        self._acc: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    class _Section:
        def __init__(self, prof: "Profiler", section: str):
            self.prof = prof
            self.section = section

        def __enter__(self):
            self.t0 = time.perf_counter_ns()
            return self

        def __exit__(self, *exc):
            dt = time.perf_counter_ns() - self.t0
            with self.prof._lock:
                self.prof._acc[self.section] += dt
                self.prof._count[self.section] += 1
            return False

    class _NullSection:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    _NULL = _NullSection()

    def measure(self, section: str):
        if not self.enabled:
            return self._NULL
        return self._Section(self, section)

    def report(self, reset: bool = False) -> dict:
        with self._lock:
            out = {
                s: {
                    "totalMs": self._acc[s] / 1e6,
                    "count": self._count[s],
                    "avgMs": self._acc[s] / 1e6 / max(self._count[s], 1),
                }
                for s in self._acc
            }
            if reset:
                self._acc.clear()
                self._count.clear()
        return out


# ---------------------------------------------------------------------------
# System metrics (reference system_metrics.py; psutil optional)
# ---------------------------------------------------------------------------


def system_metrics() -> dict:
    out: dict[str, Any] = {"time": time.time()}
    try:
        la = os.getloadavg()
        out["loadavg"] = {"1m": la[0], "5m": la[1], "15m": la[2]}
    except OSError:  # pragma: no cover
        pass
    try:
        import psutil  # type: ignore

        out["cpuPercent"] = psutil.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        out["memory"] = {"percent": vm.percent, "usedMb": vm.used / 1e6}
    except ImportError:
        try:
            with open("/proc/meminfo") as f:
                info = dict(
                    line.split(":", 1) for line in f.read().splitlines() if ":" in line
                )
            total = float(info["MemTotal"].split()[0])
            avail = float(info["MemAvailable"].split()[0])
            out["memory"] = {"percent": round(100 * (1 - avail / total), 1)}
        except (OSError, KeyError):  # pragma: no cover
            pass
    return out


# ---------------------------------------------------------------------------
# Log ring (reference log_streamer.py)
# ---------------------------------------------------------------------------


class LogRing(logging.Handler):
    def __init__(self, capacity: int = 2000):
        super().__init__()
        self.ring: deque = deque(maxlen=capacity)
        self.subscribers: set = set()
        self._lock = threading.Lock()

    def emit(self, record: logging.LogRecord) -> None:
        entry = {
            "time": record.created,
            "level": record.levelname,
            "logger": record.name,
            "message": record.getMessage(),
        }
        with self._lock:
            self.ring.append(entry)
            subs = list(self.subscribers)
        for cb in subs:
            try:
                cb(entry)
            except Exception:
                pass

    def tail(self, limit: int = 200) -> list[dict]:
        with self._lock:
            return list(self.ring)[-limit:]

    def subscribe(self, cb: Callable[[dict], None]) -> Callable[[], None]:
        with self._lock:
            self.subscribers.add(cb)

        def cancel():
            with self._lock:
                self.subscribers.discard(cb)

        return cancel


LOG_RING = LogRing()


class RateLimitFilter(logging.Filter):
    """Per-logger rate limiting for hot paths (reference LogSamplingFilter)."""

    def __init__(self, min_interval_s: float = 1.0):
        super().__init__()
        self.min_interval_s = min_interval_s
        self._last: dict[str, float] = {}

    def filter(self, record: logging.LogRecord) -> bool:
        key = f"{record.name}:{record.lineno}"
        now = time.monotonic()
        if now - self._last.get(key, 0.0) < self.min_interval_s:
            return False
        self._last[key] = now
        return True


# ---------------------------------------------------------------------------
# State broadcaster (reference state_broadcaster.py)
# ---------------------------------------------------------------------------


class StateBroadcaster:
    """Entity-change pub/sub feeding the /stream/state WebSocket."""

    def __init__(self):
        self.subscribers: set = set()
        self._lock = threading.Lock()

    def publish(self, entity: str, entity_id: str, change: str, data: dict | None = None):
        evt = {
            "time": time.time(),
            "entity": entity,
            "id": entity_id,
            "change": change,  # created | updated | deleted
            "data": data or {},
        }
        with self._lock:
            subs = list(self.subscribers)
        for cb in subs:
            try:
                cb(evt)
            except Exception:
                pass

    def subscribe(self, cb: Callable[[dict], None]) -> Callable[[], None]:
        with self._lock:
            self.subscribers.add(cb)

        def cancel():
            with self._lock:
                self.subscribers.discard(cb)

        return cancel


STATE_BROADCASTER = StateBroadcaster()
