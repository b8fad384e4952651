"""P25 Phase 2 TDMA framing: superframe fragments and timeslot bursts.

Behavioral rebuild of reference ``decoders/p25_phase2.py``: 720-dibit
superframe fragments at 6000 baud H-DQPSK, with the 20-dibit sync
``0x575D57F7FF`` at fragment positions 360 and 540; four 180-dibit
timeslot bursts per fragment, alternating TDMA slots 0/1.  Phase
rotation errors (±90°, 180° — a CQPSK lock ambiguity) are detected from
which rotated sync pattern matches.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)

SYNC_PATTERN = 0x575D57F7FF
SYNC_DIBITS = np.array(
    [(SYNC_PATTERN >> (38 - 2 * i)) & 3 for i in range(20)], np.uint8
)
DIBIT_SYMBOLS = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
SYNC_SYMBOLS = DIBIT_SYMBOLS[SYNC_DIBITS]

FRAGMENT_DIBITS = 720
SYNC_POSITIONS = (360, 540)
BURST_DIBITS = 180

# Rotating every dibit's phase step by +90° maps through the constellation:
# +1(+45°)->+3(+135°)->-1(... i.e. dibit map under rotation
_ROT90 = {0: 1, 1: 3, 3: 2, 2: 0}


def rotate_dibits(dibits: np.ndarray, times: int) -> np.ndarray:
    out = np.asarray(dibits, np.uint8).copy()
    for _ in range(times % 4):
        out = np.vectorize(_ROT90.get, otypes=[np.uint8])(out)
    return out


@dataclass
class SuperFrameFragment:
    dibits: np.ndarray  # 720 on-air dibits
    soft: np.ndarray
    sync_quality: float
    rotation: int  # 0/90/180/270 degrees of CQPSK lock ambiguity

    def bursts(self) -> list[tuple[int, np.ndarray]]:
        """Four (timeslot, 180-dibit burst) tuples; slots alternate 0,1."""
        out = []
        for i in range(4):
            out.append((i % 2, self.dibits[i * BURST_DIBITS : (i + 1) * BURST_DIBITS]))
        return out


class P25P2SuperFrameDetector:
    """Streaming soft-symbol -> superframe fragment assembler."""

    def __init__(self, sync_threshold: float = 0.7):
        self.sync_threshold = sync_threshold
        self._buf = np.zeros(0, np.float32)
        self.fragments_found = 0
        self.sync_count = 0
        # correlate against all four lock rotations of the sync
        self._sync_sets = [
            DIBIT_SYMBOLS[rotate_dibits(SYNC_DIBITS, r)] for r in range(4)
        ]

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def process(self, soft: np.ndarray) -> list[SuperFrameFragment]:
        self._buf = np.concatenate([self._buf, np.asarray(soft, np.float32)])
        out: list[SuperFrameFragment] = []
        sync = SYNC_SYMBOLS
        s_energy = float(np.dot(sync, sync))
        while True:
            n = len(self._buf)
            if n < len(sync) + 1:
                break
            win = np.lib.stride_tricks.sliding_window_view(self._buf, len(sync))
            energies = np.einsum("ij,ij->i", win, win)
            # best correlation across the four lock rotations at each offset
            ncorrs = np.stack(
                [
                    (win @ s) / np.sqrt(np.maximum(energies * s_energy, 1e-12))
                    for s in self._sync_sets
                ]
            )
            best_rot_idx = np.argmax(np.abs(ncorrs), axis=0)
            ncorr = ncorrs[best_rot_idx, np.arange(ncorrs.shape[1])]
            dots = ncorr * np.sqrt(np.maximum(energies * s_energy, 1e-12))
            hits = np.nonzero(np.abs(ncorr) > self.sync_threshold)[0]
            if len(hits) == 0:
                keep = FRAGMENT_DIBITS + len(sync)
                if n > keep:
                    self._buf = self._buf[-keep:]
                break
            # Fragment syncs come in pairs 180 dibits apart (positions 360
            # and 540).  Prefer a pair-verified hit: a lone spurious
            # correlation inside voice payload must not misalign (or, worse,
            # consume) the real fragment behind it.
            hit_set = {int(h) for h in hits}
            off = -1
            frag_start = -1
            for h in sorted(hit_set):
                if h + 180 in hit_set and h - SYNC_POSITIONS[0] >= 0:
                    off, frag_start = h, h - SYNC_POSITIONS[0]
                    break
            if off < 0:
                # no verified pair: fall back to the first hit with enough
                # history (stream may start mid-fragment)
                for h in sorted(hit_set):
                    fs = (
                        h - SYNC_POSITIONS[0]
                        if h >= SYNC_POSITIONS[0]
                        else h - SYNC_POSITIONS[1]
                    )
                    if fs >= 0:
                        off, frag_start = h, fs
                        break
            if off < 0:
                # every sync belongs to a fragment that began before the
                # buffer: wait for the next fragment, bounded
                keep = FRAGMENT_DIBITS + len(sync)
                if n > keep:
                    self._buf = self._buf[-keep:]
                break
            self.sync_count += 1
            if n - frag_start < FRAGMENT_DIBITS:
                self._buf = self._buf[frag_start:]
                break
            amp = dots[off] / s_energy
            scale = 1.0 / amp if abs(amp) > 1e-3 else 1.0
            soft_frag = self._buf[frag_start : frag_start + FRAGMENT_DIBITS] * scale
            dibits = self._slice(soft_frag)
            rotation = self._detect_rotation(dibits)
            if rotation:
                dibits = rotate_dibits(dibits, (4 - rotation // 90) % 4)
            out.append(
                SuperFrameFragment(
                    dibits=dibits,
                    soft=soft_frag,
                    sync_quality=float(abs(ncorr[off])),
                    rotation=rotation,
                )
            )
            self.fragments_found += 1
            self._buf = self._buf[frag_start + FRAGMENT_DIBITS :]
        return out

    @staticmethod
    def _slice(soft: np.ndarray) -> np.ndarray:
        pos = soft >= 0
        outer = np.abs(soft) >= 2.0
        return np.where(pos, np.where(outer, 1, 0), np.where(outer, 3, 2)).astype(
            np.uint8
        )

    @staticmethod
    def _detect_rotation(dibits: np.ndarray) -> int:
        """Which rotation of the sync pattern matches best at position 360."""
        window = dibits[SYNC_POSITIONS[0] : SYNC_POSITIONS[0] + 20]
        best_rot, best_err = 0, 99
        for rot in (0, 90, 180, 270):
            cand = rotate_dibits(SYNC_DIBITS, rot // 90)
            err = int(np.sum(window != cand))
            if err < best_err:
                best_rot, best_err = rot, err
        return best_rot if best_err <= 4 else 0


def build_test_fragment(payload_dibits: np.ndarray | None = None) -> np.ndarray:
    """Synthesize one 720-dibit fragment with syncs at 360/540 (tests)."""
    rng = np.random.default_rng(1)
    frag = (
        payload_dibits.copy()
        if payload_dibits is not None
        else rng.integers(0, 4, FRAGMENT_DIBITS).astype(np.uint8)
    )
    assert len(frag) == FRAGMENT_DIBITS
    for pos in SYNC_POSITIONS:
        frag[pos : pos + 20] = SYNC_DIBITS
    return frag


# ---------------------------------------------------------------------------
# Voice bursts (4V): AMBE+2 frame transport within a timeslot burst.
#
# TIA-102.BBAC interleaves ESS/ISCH fields around the four voice frames of
# a 4V burst; the reference never parses voice bursts at all (bursts
# persist raw).  This codec uses a documented in-framework layout — the
# four 72-bit frames packed contiguously after the optional in-fragment
# sync — so Phase 2 calls synthesize audio end-to-end through the native
# half-rate vocoder (decoders/ambe_vocoder.py) and tests can round-trip
# fragments.  Off-air DVSI bursts would additionally need the spec's
# exact field interleave.
# ---------------------------------------------------------------------------

AMBE_FRAME_BITS = 72
VOICE_FRAMES_PER_BURST = 4
_VOICE_DIBITS = VOICE_FRAMES_PER_BURST * AMBE_FRAME_BITS // 2  # 144


def _burst_has_sync(dibits: np.ndarray) -> bool:
    d = np.asarray(dibits, np.uint8)
    return len(d) >= 20 and int(np.sum(d[:20] == SYNC_DIBITS)) >= 16


def _dibits_to_bits(d: np.ndarray) -> np.ndarray:
    d = np.asarray(d, np.uint8)
    out = np.empty(2 * len(d), np.uint8)
    out[0::2] = (d >> 1) & 1
    out[1::2] = d & 1
    return out


def _bits_to_dibits(b: np.ndarray) -> np.ndarray:
    b = np.asarray(b, np.uint8)
    return (b[0::2] << 1) | b[1::2]


def extract_voice_frames(burst_dibits: np.ndarray) -> np.ndarray:
    """(4, 72) AMBE+2 frame bits from one 180-dibit timeslot burst; the
    in-fragment sync (bursts at fragment positions 2/3) is auto-detected
    and skipped."""
    d = np.asarray(burst_dibits, np.uint8)
    start = 20 if _burst_has_sync(d) else 0
    bits = _dibits_to_bits(d[start : start + _VOICE_DIBITS])
    return bits.reshape(VOICE_FRAMES_PER_BURST, AMBE_FRAME_BITS)


def build_voice_burst(
    frames: np.ndarray, with_sync: bool = False, rng=None
) -> np.ndarray:
    """(4, 72) frame bits -> 180-dibit timeslot burst (tests/harness)."""
    rng = rng or np.random.default_rng(0)
    frames = np.asarray(frames, np.uint8)
    assert frames.shape == (VOICE_FRAMES_PER_BURST, AMBE_FRAME_BITS)
    body = _bits_to_dibits(frames.reshape(-1))
    d = rng.integers(0, 4, BURST_DIBITS).astype(np.uint8)
    start = 20 if with_sync else 0
    if with_sync:
        d[:20] = SYNC_DIBITS
    d[start : start + _VOICE_DIBITS] = body
    return d
