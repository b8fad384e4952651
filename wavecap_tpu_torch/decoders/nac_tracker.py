"""Dominant-NAC tracking for P25 NID recovery (reference
``decoders/nac_tracker.py``, itself modeled on SDRTrunk's NACTracker).

A channel carries one NAC.  When the NID's BCH(63,16,23) decode fails
(more than t=11 bit errors), substituting the dominant recently-observed
NAC for the 12 NAC bits removes up to 12 of those errors and lets the
BCH correct the rest — recovering frames at SNRs where a cold decode
cannot.  ``decode_nid(..., assist_nac=...)`` performs the retry; this
module supplies the dominant value.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class NacTracker:
    """Counts recently observed NACs; exposes the dominant one."""

    max_tracked: int = 3  # distinct NACs kept (a channel has one; margin)
    min_observations: int = 3  # before a NAC counts as dominant
    ttl_s: float = 60.0  # observations older than this expire
    _seen: dict = field(default_factory=dict)  # nac -> [count, last_ts]

    def observe(self, nac: int, now: float | None = None) -> None:
        now = time.monotonic() if now is None else now
        self._expire(now)
        ent = self._seen.get(nac)
        if ent is not None:
            ent[0] += 1
            ent[1] = now
            return
        if len(self._seen) >= self.max_tracked:
            # evict the weakest (lowest count, then oldest)
            weakest = min(self._seen, key=lambda k: tuple(self._seen[k]))
            del self._seen[weakest]
        self._seen[nac] = [1, now]

    def dominant(self, now: float | None = None) -> int | None:
        now = time.monotonic() if now is None else now
        self._expire(now)
        if not self._seen:
            return None
        nac, (count, _) = max(self._seen.items(), key=lambda kv: kv[1][0])
        return nac if count >= self.min_observations else None

    def reset(self) -> None:
        self._seen.clear()

    def _expire(self, now: float) -> None:
        dead = [k for k, (_, ts) in self._seen.items() if now - ts > self.ttl_s]
        for k in dead:
            del self._seen[k]
