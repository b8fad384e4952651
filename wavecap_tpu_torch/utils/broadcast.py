"""Thread-safe fan-out with bounded drop-oldest queues.

A copy of ``wavecap_tpu/utils/broadcast.py`` (``Subscription`` and
``FanOut``): per-subscriber bounded queues, the oldest item dropped on
overrun, counters for observability.
"""

from __future__ import annotations

import queue
import threading
from typing import Any


class Subscription:
    def __init__(self, fanout: "FanOut", maxsize: int):
        self._fanout = fanout
        self.queue: queue.Queue = queue.Queue(maxsize=maxsize)
        self.dropped = 0

    def get(self, timeout: float | None = None) -> Any:
        return self.queue.get(timeout=timeout)

    def get_nowait(self) -> Any | None:
        try:
            return self.queue.get_nowait()
        except queue.Empty:
            return None

    def close(self) -> None:
        self._fanout.unsubscribe(self)


class FanOut:
    def __init__(self, maxsize: int = 32):
        self.maxsize = maxsize
        self._subs: set[Subscription] = set()
        self._lock = threading.Lock()

    @property
    def active(self) -> bool:
        return bool(self._subs)

    @property
    def count(self) -> int:
        return len(self._subs)

    def subscribe(self, maxsize: int | None = None) -> Subscription:
        sub = Subscription(self, maxsize or self.maxsize)
        with self._lock:
            self._subs.add(sub)
        return sub

    def unsubscribe(self, sub: Subscription) -> None:
        with self._lock:
            self._subs.discard(sub)

    def publish(self, item: Any) -> None:
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            try:
                sub.queue.put_nowait(item)
            except queue.Full:
                try:
                    sub.queue.get_nowait()  # drop oldest
                    sub.dropped += 1
                    sub.queue.put_nowait(item)
                except (queue.Empty, queue.Full):
                    sub.dropped += 1
