"""Streaming P25 Phase 1 framer: soft symbols -> synchronized frames.

Host-side equivalent of the reference's message assembler
(reference ``decoders/p25_framer.py:125-363``): consumes the fixed-size
soft-symbol batches the P25 banks emit per block, finds frame
sync by correlation, and emits complete frames (dibits + soft) keyed by
DUID.  Handles polarity inversion (discriminator sign flips) by
correlating both signs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from .p25_frames import (
    DUID,
    FRAME_BODY_DIBITS,
    NID_LEN,
    SYNC_LEN,
    SYNC_SYMBOLS,
    decode_nid,
    decode_pdu_header,
    pdu_body_onair_dibits,
    remove_status_dibits,
)


@dataclass
class P25Frame:
    duid: DUID
    nac: int
    nid_errors: int
    dibits: np.ndarray  # full frame from sync start (on-air, incl. statuses)
    soft: np.ndarray
    sync_quality: float
    inverted: bool


class P25Framer:
    """Accumulates soft symbols; yields frames via ``process(soft)``."""

    MAX_FRAME = SYNC_LEN + NID_LEN + max(FRAME_BODY_DIBITS.values())

    def __init__(self, sync_threshold: float = 0.70):
        from .nac_tracker import NacTracker

        self.sync_threshold = sync_threshold
        self._buf = np.zeros(0, np.float32)
        self.sync_count = 0
        self.frame_count = 0
        self.nid_fail_count = 0
        self.nid_assist_count = 0  # NIDs recovered via dominant-NAC retry
        self.nac_tracker = NacTracker()

    def reset(self) -> None:
        self._buf = np.zeros(0, np.float32)

    def process(self, soft: np.ndarray) -> list[P25Frame]:
        """Feed a batch of soft symbols; returns completed frames."""
        self._buf = np.concatenate([self._buf, np.asarray(soft, np.float32)])
        frames: list[P25Frame] = []
        sync = SYNC_SYMBOLS
        sync_energy = float(np.dot(sync, sync))

        while True:
            n = len(self._buf)
            if n < SYNC_LEN + NID_LEN:
                break
            windows = np.lib.stride_tricks.sliding_window_view(self._buf, SYNC_LEN)
            dots = windows @ sync
            # scale-invariant detection: cosine similarity with the sync shape
            energies = np.einsum("ij,ij->i", windows, windows)
            ncorr = dots / np.sqrt(np.maximum(energies * sync_energy, 1e-12))
            hits = np.nonzero(np.abs(ncorr) > self.sync_threshold)[0]
            if len(hits) == 0:
                # keep a tail in case a sync straddles the boundary
                keep = SYNC_LEN + NID_LEN
                if n > keep:
                    self._buf = self._buf[-keep:]
                break
            off = int(hits[0])
            # amplitude (signed) from the sync itself: per-frame gain reference
            amp = dots[off] / sync_energy
            inverted = bool(amp < 0)
            if abs(amp) < 1e-3:
                self._buf = self._buf[off + 1 :]
                continue
            # need the NID to know the frame length
            if n - off < SYNC_LEN + NID_LEN:
                self._buf = self._buf[off:]
                break
            self.sync_count += 1
            scale = 1.0 / amp  # normalizes symbols to ±1/±3 and fixes polarity
            nid_soft = self._buf[off + SYNC_LEN : off + SYNC_LEN + NID_LEN] * scale
            nid = decode_nid(
                self._soft_to_dibits(nid_soft),
                has_status=True,
                assist_nac=self.nac_tracker.dominant(),
            )
            if nid is None or nid.errors >= 99:
                self.nid_fail_count += 1
                # false sync or hopeless NID: skip past this sync
                self._buf = self._buf[off + 1 :]
                continue
            self.nac_tracker.observe(nid.nac)
            if nid.assisted:
                self.nid_assist_count += 1
            body = FRAME_BODY_DIBITS.get(nid.duid, 0)
            if nid.duid == DUID.PDU:
                # variable length: decode the trellis-coded header inline to
                # learn blocks_to_follow (header = first 98 payload dibits)
                hdr_body = pdu_body_onair_dibits(0)
                if n - off < SYNC_LEN + NID_LEN + hdr_body:
                    self._buf = self._buf[off:]
                    break
                hdr_soft = remove_status_dibits(
                    self._buf[off + 57 : off + 57 + hdr_body] * scale, 57
                )
                hdr = decode_pdu_header(
                    self._soft_to_dibits(hdr_soft), hdr_soft
                )
                if hdr.crc_valid:
                    body = pdu_body_onair_dibits(hdr.blocks_to_follow)
                else:
                    body = hdr_body  # header-only; downstream sees bad CRC
            total = SYNC_LEN + NID_LEN + body
            if n - off < total:
                self._buf = self._buf[off:]
                break
            soft_frame = self._buf[off : off + total] * scale
            frames.append(
                P25Frame(
                    duid=nid.duid,
                    nac=nid.nac,
                    nid_errors=nid.errors,
                    dibits=self._soft_to_dibits(soft_frame),
                    soft=soft_frame,
                    sync_quality=float(abs(ncorr[off])),
                    inverted=inverted,
                )
            )
            self.frame_count += 1
            self._buf = self._buf[off + total :]
        return frames

    @staticmethod
    def _soft_to_dibits(soft: np.ndarray) -> np.ndarray:
        pos = soft >= 0
        outer = np.abs(soft) >= 2.0
        return np.where(pos, np.where(outer, 1, 0), np.where(outer, 3, 2)).astype(
            np.uint8
        )
