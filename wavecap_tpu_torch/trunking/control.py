"""Control-channel monitor: P25 symbol stream -> parsed TSBKs + sync state.

Behavioral port of reference ``trunking/control_channel.py:62``
(``ControlChannelMonitor``), consuming the TPU capture's per-block soft
symbols (a ``p25`` channel's ``symbols`` fan-out) instead of raw IQ — the
demod already ran on-device.

The port's copy of ``wavecap_tpu/trunking/control.py``, with the same public names.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from wavecap_tpu_torch.decoders import p25_frames as pf
from wavecap_tpu_torch.decoders import p25_tsbk as tsbk_mod
from wavecap_tpu_torch.decoders.framer import P25Framer

logger = logging.getLogger(__name__)


#: TSBK CRC passes before the monitor declares acquisition complete and
#: starts the steady-state counters (reference anchors its 90.7 % CRC
#: figure on an offline golden recording, ``trunking/system.py:1300``;
#: a live receiver's first blocks — filter tails, timing/gain
#: acquisition — are charged only to the lifetime rate here).
STEADY_MIN_OK = 8


@dataclass
class ControlChannelStats:
    frames: int = 0
    tsdu_frames: int = 0
    tsbk_total: int = 0
    tsbk_crc_ok: int = 0
    tsbk_total_steady: int = 0
    tsbk_crc_ok_steady: int = 0
    last_frame_time: float = 0.0
    nac: int | None = None

    @property
    def crc_rate(self) -> float:
        return self.tsbk_crc_ok / self.tsbk_total if self.tsbk_total else 0.0

    @property
    def crc_rate_steady(self) -> float:
        """CRC pass rate counted only after acquisition (STEADY_MIN_OK
        passing blocks seen); ~1.0 on a clean channel."""
        if not self.tsbk_total_steady:
            return 0.0
        return self.tsbk_crc_ok_steady / self.tsbk_total_steady


class ControlChannelMonitor:
    """Feed ``process_symbols(soft)``; emits parsed TSBK dicts via callback.

    Callbacks:
      on_tsbk(parsed: dict, block: TSBKBlock)
      on_sync_acquired() / on_sync_lost()  (reference system.py:1363-1383)
    """

    SYNC_LOSS_S = 2.0

    def __init__(
        self,
        on_tsbk: Callable[[dict, Any], None] | None = None,
        on_sync_acquired: Callable[[], None] | None = None,
        on_sync_lost: Callable[[], None] | None = None,
        nac_filter: int | None = None,
    ):
        self.framer = P25Framer()
        self.on_tsbk = on_tsbk
        self.on_sync_acquired = on_sync_acquired
        self.on_sync_lost = on_sync_lost
        self.nac_filter = nac_filter
        self.stats = ControlChannelStats()
        self.synced = False

    def reset(self) -> None:
        self.framer.reset()

    def process_symbols(self, soft: np.ndarray, now: float | None = None) -> list[dict]:
        now = time.time() if now is None else now
        parsed_out: list[dict] = []
        for frame in self.framer.process(soft):
            self.stats.frames += 1
            self.stats.last_frame_time = now
            if self.nac_filter is not None and frame.nac != self.nac_filter:
                continue
            self.stats.nac = frame.nac
            if not self.synced:
                self.synced = True
                if self.on_sync_acquired:
                    self.on_sync_acquired()
            if frame.duid != pf.DUID.TSDU:
                continue
            self.stats.tsdu_frames += 1
            payload = pf.remove_status_dibits(frame.dibits[57:], 57)
            soft_payload = pf.remove_status_dibits(frame.soft[57:], 57)
            for block in pf.decode_tsbk_payload(payload, soft_payload):
                steady = self.stats.tsbk_crc_ok >= STEADY_MIN_OK
                self.stats.tsbk_total += 1
                if steady:
                    self.stats.tsbk_total_steady += 1
                if not block.crc_valid:
                    continue
                self.stats.tsbk_crc_ok += 1
                if steady:
                    self.stats.tsbk_crc_ok_steady += 1
                parsed = tsbk_mod.parse_tsbk(block.opcode, block.mfid, block.data)
                parsed["nac"] = frame.nac
                parsed_out.append(parsed)
                if self.on_tsbk:
                    self.on_tsbk(parsed, block)
        if (
            self.synced
            and now - self.stats.last_frame_time > self.SYNC_LOSS_S
        ):
            self.synced = False
            if self.on_sync_lost:
                self.on_sync_lost()
        return parsed_out

    def check_timeout(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        if self.synced and now - self.stats.last_frame_time > self.SYNC_LOSS_S:
            self.synced = False
            if self.on_sync_lost:
                self.on_sync_lost()


class DmrControlMonitor:
    """DMR Tier III control channel: burst stream -> parsed CSBK dicts.

    Same interface as :class:`ControlChannelMonitor` so the trunking
    system can drive either protocol (the reference has no DMR trunking
    at all — its DMR decoder stops at burst sync).  DMR and P25 C4FM are
    both 4800-baud 4FSK, so the capture's p25 demod bank supplies the
    soft symbols unchanged.
    """

    SYNC_LOSS_S = 2.0

    def __init__(
        self,
        on_tsbk: Callable[[dict, Any], None] | None = None,
        on_sync_acquired: Callable[[], None] | None = None,
        on_sync_lost: Callable[[], None] | None = None,
        nac_filter: int | None = None,  # accepted for interface parity
    ):
        from wavecap_tpu_torch.decoders.dmr import DMRDecoder

        self.decoder = DMRDecoder()
        self.on_tsbk = on_tsbk
        self.on_sync_acquired = on_sync_acquired
        self.on_sync_lost = on_sync_lost
        self.stats = ControlChannelStats()
        self.synced = False

    def reset(self) -> None:
        from wavecap_tpu_torch.decoders.dmr import DMRDecoder

        self.decoder = DMRDecoder()

    def process_symbols(
        self, soft: np.ndarray, now: float | None = None
    ) -> list[dict]:
        from wavecap_tpu_torch.decoders import dmr

        now = time.time() if now is None else now
        parsed_out: list[dict] = []
        for burst in self.decoder.process(soft):
            self.stats.frames += 1
            self.stats.last_frame_time = now
            if not self.synced:
                self.synced = True
                if self.on_sync_acquired:
                    self.on_sync_acquired()
            parsed = dmr.decode_burst(burst)
            if parsed is None or "opcode" not in parsed:
                continue
            steady = self.stats.tsbk_crc_ok >= STEADY_MIN_OK
            self.stats.tsbk_total += 1
            self.stats.tsbk_crc_ok += 1  # parse_csbk already CRC-gated
            if steady:
                self.stats.tsbk_total_steady += 1
                self.stats.tsbk_crc_ok_steady += 1
            parsed_out.append(parsed)
            if self.on_tsbk:
                self.on_tsbk(parsed, None)
        if self.synced and now - self.stats.last_frame_time > self.SYNC_LOSS_S:
            self.synced = False
            if self.on_sync_lost:
                self.on_sync_lost()
        return parsed_out

    def check_timeout(self, now: float | None = None) -> None:
        now = time.time() if now is None else now
        if self.synced and now - self.stats.last_frame_time > self.SYNC_LOSS_S:
            self.synced = False
            if self.on_sync_lost:
                self.on_sync_lost()
