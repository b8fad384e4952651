"""Voice recorders: granted-call capture on dynamically tuned P25 slots.

Behavioral port of reference ``trunking/system.py:267`` (``VoiceRecorder``)
and ``trunking/voice_channel.py:55``: a pool of recorder slots, each bound
to a ``p25`` channel slot in the trunking capture.  On a grant the slot is
retuned to the voice frequency; LDU frames are assembled from the symbol
stream, IMBE codewords extracted and (if a vocoder backend is available)
synthesized to PCM; recordings are written as WAV + JSON metadata.

Without a vocoder the raw IMBE codewords are still written (``.imbe``
binary, DSD-compatible framing) so audio can be recovered offline —
the same degradation the reference has without mbelib/DSD-FME.

The port's copy of ``wavecap_tpu/trunking/recorder.py``, with the same public names.
"""

from __future__ import annotations

import json
import logging
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

import numpy as np

from wavecap_tpu_torch.decoders import p25_frames as pf
from wavecap_tpu_torch.decoders.framer import P25Framer
from wavecap_tpu_torch.decoders.voice import VoiceDecoder, vocoder_backend
from wavecap_tpu_torch.utils.wavio import write_audio_wav
from wavecap_tpu_torch.utils.broadcast import FanOut

logger = logging.getLogger(__name__)


@dataclass
class CallInfo:
    tgid: int
    source_id: int
    frequency_hz: float
    start_time: float
    system_id: str = ""
    talkgroup_name: str = ""
    emergency: bool = False
    encrypted: bool = False
    end_time: float | None = None
    imbe_frames: int = 0
    audio_seconds: float = 0.0
    source_location: dict | None = None  # LRRP GPS (reference trunking/system.py:3112)
    tdma_slot: int = 0  # Phase 2 timeslot (0 for FDMA)
    algid: int | None = None  # encryption algorithm (MAC_PTT / ESS)
    keyid: int | None = None


class VoiceRecorder:
    """One recorder slot.  States: idle -> recording -> idle."""

    def __init__(
        self,
        recorder_id: int,
        channel_id: str,
        protocol: str = "p25_phase1",
        dmr_stride: int = 1,
    ):
        self.id = recorder_id
        self.channel_id = channel_id  # p25 channel in the trunking capture
        self.protocol = protocol
        # DMR Tier III: 2 on a repeater TDMA stream (this call's voice
        # bursts alternate with the other timeslot's), 1 for single-slot
        self.dmr_stride = max(1, int(dmr_stride))
        self.state = "idle"
        self.call: CallInfo | None = None
        self.framer = P25Framer()
        self._p2 = None  # lazy Phase 2 superframe detector
        self._ambe_vocoder = None  # lazy AMBE+2 half-rate vocoder
        self._dmr_voice = None  # lazy DMR voice superframe tracker
        self._dmr_data = None  # lazy DMR data-burst decoder
        self._ambe_bursts: list[np.ndarray] = []
        self.decoder = VoiceDecoder()
        self.audio = FanOut(maxsize=32)  # live PCM subscribers
        self._imbe: list[np.ndarray] = []
        self._pcm: list[np.ndarray] = []
        self.last_activity = 0.0
        self.on_location = None  # Callable[[RadioLocation], None]

    @property
    def recording(self) -> bool:
        return self.state == "recording"

    def assign(self, call: CallInfo) -> None:
        self.call = call
        self.state = "recording"
        self.framer.reset()
        if self._p2 is not None:
            self._p2.reset()
        self._ambe_vocoder = None  # fresh vocoder state per call
        self._dmr_voice = None
        self._dmr_data = None
        self._imbe = []
        self._pcm = []
        self._ambe_bursts = []
        self.last_activity = call.start_time

    def process_symbols(self, soft: np.ndarray, now: float | None = None) -> None:
        if not self.recording:
            return
        now = time.time() if now is None else now
        if self.protocol == "p25_phase2":
            self._process_phase2(soft, now)
            return
        if self.protocol == "dmr_tier3":
            self._process_dmr(soft, now)
            return
        for frame in self.framer.process(soft):
            if frame.duid in (pf.DUID.LDU1, pf.DUID.LDU2):
                ldu = pf.decode_ldu(frame.dibits)
                if ldu is None:
                    continue
                self.last_activity = now
                self._handle_metadata(frame.duid, ldu)
                for cw in ldu.imbe_codewords:
                    self._imbe.append(np.asarray(cw, np.uint8))
                    if self.call:
                        self.call.imbe_frames += 1
                pcm = self.decoder.decode_codewords(ldu.imbe_codewords)
                if pcm is not None and len(pcm):
                    self._pcm.append(pcm)
                    self.audio.publish(pcm)
            elif frame.duid == pf.DUID.PDU:
                self._handle_pdu(frame)
            elif frame.duid in (pf.DUID.TDU, pf.DUID.TDULC):
                self.last_activity = 0.0  # terminator: end promptly

    def _process_phase2(self, soft: np.ndarray, now: float) -> None:
        """Phase 2 TDMA voice: superframe fragments -> this call's timeslot
        bursts.  SACCH/FACCH bursts are MAC-decoded (PTT metadata /
        encryption detect, END_PTT prompt call end — beyond the reference,
        which never parses xCCH); voice bursts synthesize PCM through the
        native AMBE+2 half-rate vocoder (decoders/ambe_vocoder.py — the
        reference selects VocoderType.AMBE2 at system.py:437 but needs an
        external binary to act on it) and also persist as raw dibits."""
        from wavecap_tpu_torch.decoders import p25_mac
        from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeDecoder
        from wavecap_tpu_torch.decoders.p25_phase2 import (
            P25P2SuperFrameDetector,
            extract_voice_frames,
        )

        if self._p2 is None:
            self._p2 = P25P2SuperFrameDetector()
        if self._ambe_vocoder is None:
            self._ambe_vocoder = AmbeDecoder()
        slot = self.call.tdma_slot if self.call else 0
        for frag in self._p2.process(soft):
            self.last_activity = now
            for ts, burst in frag.bursts():
                if ts != slot:
                    continue
                mac = p25_mac.decode_burst(burst)
                if mac is not None and mac[0] in (
                    p25_mac.BURST_SACCH,
                    p25_mac.BURST_FACCH,
                ):
                    self._handle_mac(p25_mac.parse_mac_pdu(mac[1]))
                    continue
                self._ambe_bursts.append(np.asarray(burst, np.uint8))
                if self.call:
                    self.call.imbe_frames += 1  # burst count for phase2
                pcm = self._ambe_vocoder.decode_frames(
                    extract_voice_frames(burst)
                )
                if pcm is not None and len(pcm):
                    self._pcm.append(pcm)
                    self.audio.publish(pcm)

    def _process_dmr(self, soft: np.ndarray, now: float) -> None:
        """DMR Tier III voice: superframe tracking -> AMBE+2 frames ->
        native half-rate synthesis (the reference has no DMR voice path).
        Terminator bursts (TERMINATOR_WITH_LC) end the call promptly."""
        from wavecap_tpu_torch.decoders import dmr
        from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeDecoder
        from wavecap_tpu_torch.decoders.dmr import DMRDecoder, DMRVoiceTracker

        if self._dmr_voice is None:
            # On a dual-slot repeater carrier, route voice by the anchor
            # burst's CACH TC bit so two recorders on ONE carrier each
            # follow their own call (round 5; previously a second grant on
            # a busy carrier had to be skipped)
            slot = (
                self.call.tdma_slot
                if self.dmr_stride >= 2 and self.call is not None
                else None
            )
            self._dmr_voice = DMRVoiceTracker(
                stride_bursts=self.dmr_stride, tdma_slot=slot
            )
            self._dmr_data = DMRDecoder()
        if self._ambe_vocoder is None:
            self._ambe_vocoder = AmbeDecoder()
        for sf in self._dmr_voice.process(soft):
            self.last_activity = now
            self._ambe_bursts.append(np.packbits(sf.ambe_bits.reshape(-1)))
            if self.call:
                self.call.imbe_frames += int(sf.ambe_bits.shape[0])
            pcm = self._ambe_vocoder.decode_frames(sf.ambe_bits)
            if pcm is not None and len(pcm):
                self._pcm.append(pcm)
                self.audio.publish(pcm)
        for burst in self._dmr_data.process(soft):
            parsed = dmr.decode_burst(burst)
            if parsed is None:
                continue
            # the full LC carries RS(12,9) parity we don't verify, and the
            # Golay slot type can miscorrect random payloads — so gate call
            # control on clean BPTC + clean slot type + matching talkgroup
            # (a repeater stream also interleaves the OTHER timeslot's
            # bursts, whose terminators must not end this call)
            trusted = (
                parsed.get("bptcClean")
                and parsed.get("slotTypeErrors", 99) <= 1
                and parsed.get("rsOk") is not False  # RS(12,9) LC parity
                and self.call is not None
                and parsed.get("dst_id") == self.call.tgid
            )
            # CACH slot routing: a decodable TC bit naming the OTHER
            # timeslot disqualifies the burst for this call's control
            if (
                trusted
                and self.dmr_stride >= 2
                and parsed.get("cachSlot") is not None
                and parsed["cachSlot"] != self.call.tdma_slot
            ):
                trusted = False
            name = parsed.get("dataTypeName")
            if name == "TERMINATOR_WITH_LC" and trusted:
                self.last_activity = 0.0  # end promptly
            elif name == "VOICE_LC_HEADER" and trusted:
                src = parsed.get("src_id")
                if src:
                    self.call.source_id = src

    def _handle_mac(self, pdu: dict | None) -> None:
        """Phase 2 MAC PDU -> call metadata / lifecycle."""
        if pdu is None or self.call is None:
            return
        kind = pdu.get("mac")
        if kind == "PTT":
            self.call.source_id = pdu.get("source_id") or self.call.source_id
            if pdu.get("encrypted"):
                self.call.encrypted = True
                self.call.algid = pdu.get("algid")
                self.call.keyid = pdu.get("keyid")
        elif kind in ("END_PTT", "IDLE"):
            self.last_activity = 0.0  # terminator: end promptly

    def _handle_pdu(self, frame) -> None:
        """LRRP GPS reports ride in PDU data frames on the voice channel
        (reference ``trunking/system.py:3112-3120``)."""
        from dataclasses import asdict

        from wavecap_tpu_torch.decoders.lrrp import parse_lrrp

        payload = pf.remove_status_dibits(frame.dibits[57:], 57)
        soft = pf.remove_status_dibits(frame.soft[57:], 57)
        pdu = pf.decode_pdu(payload, soft)
        if pdu is None or not pdu.header.crc_valid or not pdu.data:
            return
        loc = parse_lrrp(pdu.data, radio_id=pdu.header.llid)
        if loc is None:
            return
        if self.call is not None:
            self.call.source_location = asdict(loc)
        if self.on_location:
            self.on_location(loc)

    def _handle_metadata(self, duid, ldu) -> None:
        """LDU1 link control / LDU2 encryption sync -> call metadata."""
        from wavecap_tpu_torch.decoders.p25_voice import (
            decode_ess_hexbits,
            decode_lc_hexbits,
        )

        if self.call is None:
            return
        if duid == pf.DUID.LDU1 and len(ldu.lc_bits) >= 240:
            lc = decode_lc_hexbits(ldu.lc_bits)
            if lc is not None and lc.errors < 20:
                if lc.source_id:
                    self.call.source_id = lc.source_id
                if lc.lcf == 0x00 and lc.tgid:
                    self.call.tgid = lc.tgid
                if lc.emergency:
                    self.call.emergency = True
        elif duid == pf.DUID.LDU2 and len(ldu.lc_bits) >= 240:
            ess = decode_ess_hexbits(ldu.lc_bits)
            if ess is not None and ess.errors < 20 and ess.encrypted:
                self.call.encrypted = True

    def finalize(
        self, recording_dir: Path | None, min_duration_s: float, now: float
    ) -> CallInfo | None:
        """End the call; write artifacts; return the finished CallInfo."""
        call = self.call
        self.state = "idle"
        self.call = None
        if call is None:
            return None
        call.end_time = now
        call.audio_seconds = sum(len(p) for p in self._pcm) / 8000.0
        duration = call.end_time - call.start_time
        if recording_dir is not None and duration >= min_duration_s and (
            self._imbe or self._pcm or self._ambe_bursts
        ):
            recording_dir.mkdir(parents=True, exist_ok=True)
            stamp = time.strftime("%Y%m%d_%H%M%S", time.localtime(call.start_time))
            base = recording_dir / f"{stamp}_tg{call.tgid}_src{call.source_id}"
            if self._pcm:
                write_audio_wav(str(base) + ".wav", np.concatenate(self._pcm), 8000)
            if self._imbe:
                packed = np.concatenate([np.packbits(f) for f in self._imbe])
                (Path(str(base) + ".imbe")).write_bytes(packed.tobytes())
            if self._ambe_bursts:
                # raw Phase 2 timeslot bursts (dibits) for offline AMBE decode
                (Path(str(base) + ".ambe")).write_bytes(
                    np.concatenate(self._ambe_bursts).tobytes()
                )
            meta = {
                "tgid": call.tgid,
                "talkgroup": call.talkgroup_name,
                "sourceId": call.source_id,
                "frequencyHz": call.frequency_hz,
                "startTime": call.start_time,
                "endTime": call.end_time,
                "imbeFrames": call.imbe_frames,
                "tdmaSlot": call.tdma_slot,
                "protocol": self.protocol,
                "audioSeconds": call.audio_seconds,
                "emergency": call.emergency,
                "encrypted": call.encrypted,
                "vocoder": vocoder_backend(),
            }
            (Path(str(base) + ".json")).write_text(json.dumps(meta, indent=2))
        self._imbe = []
        self._pcm = []
        return call


class RecorderPool:
    """Fixed pool of recorders mapped to p25 slots (reference :354)."""

    def __init__(
        self,
        channel_ids: list[str],
        protocol: str = "p25_phase1",
        dmr_stride: int = 1,
    ):
        self.recorders = [
            VoiceRecorder(i, cid, protocol, dmr_stride=dmr_stride)
            for i, cid in enumerate(channel_ids)
        ]

    def available(self) -> VoiceRecorder | None:
        for r in self.recorders:
            if not r.recording:
                return r
        return None

    def recording(self) -> list[VoiceRecorder]:
        return [r for r in self.recorders if r.recording]

    def by_channel(self, channel_id: str) -> VoiceRecorder | None:
        for r in self.recorders:
            if r.channel_id == channel_id:
                return r
        return None

    def for_tgid(self, tgid: int) -> VoiceRecorder | None:
        for r in self.recorders:
            if r.recording and r.call and r.call.tgid == tgid:
                return r
        return None
