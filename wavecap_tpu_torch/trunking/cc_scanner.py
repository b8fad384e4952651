"""Control-channel scanner: power/SNR + sync-verified candidate scoring.

Behavioral port of reference ``trunking/cc_scanner.py`` (``ChannelMeasurement``
:43, ``ControlChannelScanner`` :65) redesigned for the TPU capture: instead of
buffering wideband IQ on the host and decimating per candidate with scipy, we
score candidates from

  (a) the capture's on-device spectrum (per-candidate power + SNR against the
      frame's median noise floor) — free, computed every block anyway, and
  (b) short demodulated **probe windows** through an idle ``p25`` voice slot:
      the channelizer demodulates every slot each block regardless, so sync
      verification (frame sync presence + TSBK CRC) costs no extra compute —
      only a slot retune.

The reference's selection policy is preserved: a channel with verified P25
sync always outranks a sync-less carrier no matter how loud (reference
``cc_scanner.py:231-252`` sorts sync-verified first), and while locked the
system roams when a verified candidate is ``roam_margin_db`` stronger
(reference ``system.py:1670-1733``, +6 dB, re-checked every 30 s).

The port's copy of ``wavecap_tpu/trunking/cc_scanner.py``, with the same public names.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from .control import ControlChannelMonitor

logger = logging.getLogger(__name__)


@dataclass
class CCMeasurement:
    """Score for one control-channel candidate (reference ``cc_scanner.py:43``)."""

    frequency_hz: float
    power_db: float = -999.0
    snr_db: float = 0.0
    sync_detected: bool = False
    frames: int = 0
    crc_ok: int = 0
    time: float = 0.0

    def to_dict(self) -> dict:
        return {
            "frequencyHz": self.frequency_hz,
            "powerDb": round(self.power_db, 1),
            "snrDb": round(self.snr_db, 1),
            "syncDetected": self.sync_detected,
            "frames": self.frames,
            "crcOk": self.crc_ok,
            "time": self.time,
        }

    def rank_key(self) -> tuple:
        """Sync-verified beats any sync-less power (reference sorts sync first)."""
        return (1 if self.sync_detected else 0, self.crc_ok, self.snr_db, self.power_db)


@dataclass
class _Probe:
    frequency_hz: float
    channel_id: str
    started: float
    monitor: ControlChannelMonitor = field(default_factory=ControlChannelMonitor)
    # Window anchoring: the measurement window starts at the first symbol
    # batch actually FED, not at start_probe — a probe started while the
    # capture is still compiling (or otherwise stalled) must wait for data
    # instead of recording a false "verified: no sync" for a real CC.
    skipped: int = 0  # stale in-flight batches (pre-retune) dropped
    fed: int = 0  # batches counted toward the window
    first_fed: float = 0.0


class CCScanner:
    """Candidate bookkeeping + probe state machine driven by TrunkingSystem.

    The system calls, from its worker loop:
      * ``update_spectrum(frame, fs, center, candidates, now)`` per spectrum
        fan-out frame,
      * ``feed(channel_id, soft, now)`` for symbol batches of the slot a probe
        currently owns,
      * ``poll(now)`` to harvest a finished probe window.
    """

    def __init__(
        self,
        probe_window_s: float = 1.5,
        roam_interval_s: float = 30.0,
        roam_margin_db: float = 6.0,
        power_ema: float = 0.5,
    ):
        self.probe_window_s = probe_window_s
        self.roam_interval_s = roam_interval_s
        self.roam_margin_db = roam_margin_db
        self.power_ema = power_ema
        # stale in-flight batches to drop after the probe slot retunes
        self.settle_batches = 1
        # give up waiting for first data after this long (first compile of a
        # fresh capture program can stall symbol flow for minutes)
        self.probe_timeout_s = max(15.0, 10.0 * probe_window_s)
        self.measurements: dict[float, CCMeasurement] = {}
        self.probe: _Probe | None = None
        self.last_roam_check = 0.0
        self._roam_rr = 0  # round-robin cursor over roam candidates

    # -- spectrum-based power/SNR (no probe needed) ------------------------

    def update_spectrum(
        self,
        frame: np.ndarray,
        sample_rate: float,
        center_hz: float,
        candidates: list[float],
        now: float,
    ) -> None:
        """Per-candidate power + SNR from one spectrum frame (dB bins).

        Reference measures band power and a noise floor per candidate on
        buffered IQ (``cc_scanner.py:150-214``); here the capture already
        produced a dB spectrum on-device, so we take the max over the
        candidate's ~5-bin neighbourhood and the frame median as floor.
        """
        frame = np.asarray(frame)
        if frame.ndim == 2:
            frame = frame[-1]
        nfft = len(frame)
        if nfft < 8:
            return
        floor = float(np.median(frame))
        for f in candidates:
            b = int(round((f - center_hz) / (sample_rate / nfft))) + nfft // 2
            if not (2 <= b < nfft - 2):
                continue
            p = float(np.max(frame[b - 2 : b + 3]))
            m = self.measurements.setdefault(f, CCMeasurement(frequency_hz=f))
            if m.power_db <= -999.0:
                m.power_db = p
            else:
                a = self.power_ema
                m.power_db = a * p + (1 - a) * m.power_db
            m.snr_db = m.power_db - floor

    # -- probe lifecycle ---------------------------------------------------

    def start_probe(self, frequency_hz: float, channel_id: str, now: float) -> None:
        self.probe = _Probe(frequency_hz=frequency_hz, channel_id=channel_id, started=now)

    def abort_probe(self) -> None:
        self.probe = None

    def feed(self, channel_id: str, soft: np.ndarray, now: float) -> None:
        """Route a probe slot's symbol batch into the probe monitor."""
        p = self.probe
        if p is None or p.channel_id != channel_id:
            return
        if p.skipped < self.settle_batches:
            # batches dispatched before the retune took effect carry the
            # slot's OLD frequency; counting them could sync-verify the
            # wrong candidate
            p.skipped += 1
            return
        if p.fed == 0:
            p.first_fed = now
        p.fed += 1
        p.monitor.process_symbols(soft, now=now)

    def poll(self, now: float) -> CCMeasurement | None:
        """Finish the probe once its window (anchored at first data) has
        elapsed; returns the result.  A probe that never receives symbol
        batches (capture compiling/stalled) is aborted WITHOUT recording,
        leaving the candidate unverified for a later retry."""
        p = self.probe
        if p is None:
            return None
        if p.fed == 0:
            if now - p.started > self.probe_timeout_s:
                logger.info(
                    "cc probe %.4f MHz: no symbol batches within %.1f s, aborting",
                    p.frequency_hz / 1e6,
                    self.probe_timeout_s,
                )
                self.probe = None
            return None
        if now - p.first_fed < self.probe_window_s:
            return None
        st = p.monitor.stats
        m = self.measurements.setdefault(
            p.frequency_hz, CCMeasurement(frequency_hz=p.frequency_hz)
        )
        m.sync_detected = st.frames > 0
        m.frames = st.frames
        m.crc_ok = st.tsbk_crc_ok
        m.time = now
        self.probe = None
        logger.info(
            "cc probe %.4f MHz: frames=%d crc_ok=%d power=%.1f dB",
            p.frequency_hz / 1e6, m.frames, m.crc_ok, m.power_db,
        )
        return m

    # -- selection ---------------------------------------------------------

    def best(self, candidates: list[float]) -> float | None:
        """Best candidate: sync-verified first, then CRC count, SNR, power."""
        scored = [self.measurements.get(f) or CCMeasurement(frequency_hz=f) for f in candidates]
        if not scored:
            return None
        return max(scored, key=CCMeasurement.rank_key).frequency_hz

    def unverified(self, candidates: list[float], max_age_s: float = 120.0, now: float = 0.0) -> list[float]:
        """Candidates with no (fresh) probe result yet — the scan-all queue."""
        out = []
        for f in candidates:
            m = self.measurements.get(f)
            if m is None or m.time <= 0.0 or (now - m.time) > max_age_s:
                out.append(f)
        return out

    def next_roam_candidate(self, candidates: list[float], current: float | None) -> float | None:
        others = [f for f in candidates if f != current]
        if not others:
            return None
        f = others[self._roam_rr % len(others)]
        self._roam_rr += 1
        return f

    def should_roam(self, current: float | None, now: float) -> float | None:
        """A sync-verified candidate ``roam_margin_db`` above the locked CC
        (reference ``system.py:1670-1733``)."""
        if current is None:
            return None
        cur = self.measurements.get(current)
        cur_power = cur.power_db if cur is not None else -999.0
        best_f, best_p = None, cur_power + self.roam_margin_db
        for f, m in self.measurements.items():
            if f == current or not m.sync_detected:
                continue
            if now - m.time > 3 * self.roam_interval_s:
                continue  # stale verification
            if m.power_db >= best_p:
                best_f, best_p = f, m.power_db
        return best_f

    def status(self) -> list[dict]:
        return [m.to_dict() for m in self.measurements.values()]
