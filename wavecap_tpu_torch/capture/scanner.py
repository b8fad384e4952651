"""Frequency scanner service (reference ``scanner.py:61`` behavioral port).

Retunes a channel through a frequency list with dwell/lockout and
squelch-pause, in sequential / priority / activity modes, driven by a
background thread against the capture engine's retune API (which never
recompiles).

The port's copy of ``wavecap_tpu/capture/scanner.py``, with the same public names.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from enum import Enum

logger = logging.getLogger(__name__)


class ScanMode(str, Enum):
    SEQUENTIAL = "sequential"
    PRIORITY = "priority"
    ACTIVITY = "activity"


@dataclass
class ScanEntry:
    frequency_hz: float
    name: str = ""
    priority: int = 5
    locked_out: bool = False


@dataclass
class ScannerConfig:
    entries: list = field(default_factory=list)
    mode: ScanMode = ScanMode.SEQUENTIAL
    dwell_s: float = 0.5  # time on each frequency
    hold_s: float = 2.0  # hold after activity stops
    squelch_db: float = -60.0


class ScannerService:
    _ids = itertools.count(1)

    def __init__(self, capture, channel_id: str, config: ScannerConfig):
        self.id = f"scan{next(self._ids)}"
        self.capture = capture
        self.channel_id = channel_id
        self.config = config
        self.state = "stopped"  # stopped|scanning|holding|paused|locked
        self.current_index = 0
        self.hits: dict[float, int] = {}
        self._stop = threading.Event()
        self._hold = threading.Event()  # pause/lock: suspend retuning
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self.state != "stopped":
            return
        self._stop.clear()
        self._hold.clear()  # a pause/lock must not survive a restart
        self._thread = threading.Thread(
            target=self._run, name=f"Scanner-{self.id}", daemon=True
        )
        self._thread.start()
        self.state = "scanning"

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        self.state = "stopped"

    def lockout(self, frequency_hz: float, locked: bool = True) -> None:
        for e in self.config.entries:
            if abs(e.frequency_hz - frequency_hz) < 1.0:
                e.locked_out = locked

    def clear_lockouts(self) -> None:
        for e in self.config.entries:
            e.locked_out = False

    def pause(self) -> None:
        """Suspend retuning, stay on the current frequency (reference
        POST /scanners/{sid}/pause)."""
        if self.state != "stopped":
            self._hold.set()
            self.state = "paused"

    def resume(self) -> None:
        if self.state in ("paused", "locked"):
            self._hold.clear()
            self.state = "scanning"

    def lock(self) -> None:
        """Hold the current channel while the operator listens (reference
        POST /scanners/{sid}/lock); unlock resumes the scan."""
        if self.state != "stopped":
            self._hold.set()
            self.state = "locked"

    def unlock(self) -> None:
        self.resume()

    def _order(self) -> list:
        entries = [e for e in self.config.entries if not e.locked_out]
        if self.config.mode == ScanMode.PRIORITY:
            return sorted(entries, key=lambda e: e.priority)
        if self.config.mode == ScanMode.ACTIVITY:
            return sorted(
                entries, key=lambda e: -self.hits.get(e.frequency_hz, 0)
            )
        return entries

    def _run(self) -> None:
        while not self._stop.is_set():
            entries = self._order()
            if not entries:
                time.sleep(0.5)
                continue
            for entry in entries:
                if self._stop.is_set():
                    return
                while self._hold.is_set() and not self._stop.is_set():
                    time.sleep(0.1)
                try:
                    self.capture.update_channel(
                        self.channel_id, frequency_hz=entry.frequency_hz
                    )
                except KeyError:
                    self.state = "stopped"
                    return
                self.current_index = self.config.entries.index(entry)
                deadline = time.time() + self.config.dwell_s
                while time.time() < deadline and not self._stop.is_set():
                    time.sleep(0.05)
                    ch = self.capture.channels.get(self.channel_id)
                    if ch is not None and ch.rssi_db > self.config.squelch_db:
                        # activity: hold until quiet for hold_s.  An operator
                        # pause/lock during the hold must stick: never
                        # overwrite their state, and honor _hold on exit.
                        if not self._hold.is_set():
                            self.state = "holding"
                        self.hits[entry.frequency_hz] = (
                            self.hits.get(entry.frequency_hz, 0) + 1
                        )
                        quiet_since = None
                        while not self._stop.is_set():
                            time.sleep(0.1)
                            ch = self.capture.channels.get(self.channel_id)
                            if ch is None:
                                return
                            if ch.rssi_db > self.config.squelch_db:
                                quiet_since = None
                            elif quiet_since is None:
                                quiet_since = time.time()
                            elif time.time() - quiet_since > self.config.hold_s:
                                break
                        if not self._hold.is_set():
                            self.state = "scanning"
                        break

    def status(self) -> dict:
        entries = self.config.entries
        cur = entries[self.current_index] if entries else None
        return {
            "id": self.id,
            "state": self.state,
            "mode": self.config.mode.value,
            "channelId": self.channel_id,
            "dwellS": self.config.dwell_s,
            "holdS": self.config.hold_s,
            "squelchDb": self.config.squelch_db,
            "currentFrequencyHz": cur.frequency_hz if cur else None,
            "entries": [
                {
                    "frequencyHz": e.frequency_hz,
                    "name": e.name,
                    "priority": e.priority,
                    "lockedOut": e.locked_out,
                    "hits": self.hits.get(e.frequency_hz, 0),
                }
                for e in entries
            ],
        }
