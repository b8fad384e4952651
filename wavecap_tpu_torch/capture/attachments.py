"""Channel post-processors: RDS / POCSAG / FLEX consumers on live channels.

The reference runs these inside the capture hot loop
(reference ``capture.py:2871-2916``: RDS from pre-MPX baseband, POCSAG on
demod audio); here they are host-side subscribers on a channel's audio
fan-out, each in a small worker thread, publishing decoded messages to a
ring the API serves.

The port's copy of ``wavecap_tpu/capture/attachments.py``, with the same
public names.  Beyond the reference, each attachment counts the chunks its
thread has taken (``batches``) and the chunks whose decode raised
(``errors``; the reference only logs them), so that a caller can wait for
a drained subscription and fail on a decoder fault.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass

import numpy as np

logger = logging.getLogger(__name__)


class ChannelAttachment:
    """Base: subscribes to a channel's audio and decodes in a thread."""

    kind = "base"

    def __init__(self, channel, audio_rate: int = 48_000):
        self.channel = channel
        self.audio_rate = audio_rate
        self.messages: deque = deque(maxlen=500)
        self.batches = 0
        self.errors = 0
        self._sub = channel.audio.subscribe(maxsize=64)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name=f"{self.kind}-{channel.id}", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.is_set():
            chunk = self._sub.get_nowait()
            if chunk is None:
                time.sleep(0.05)
                continue
            try:
                payload = (
                    chunk if isinstance(chunk, dict) else np.asarray(chunk, np.float32)
                )
                for msg in self.process(payload):
                    self.messages.append(msg)
            except Exception:  # pragma: no cover
                self.errors += 1
                logger.exception("%s attachment error", self.kind)
            self.batches += 1

    def process(self, audio: np.ndarray) -> list:
        raise NotImplementedError

    def stop(self) -> None:
        self._stop.set()
        self._sub.close()
        self._thread.join(timeout=5)

    def status(self) -> dict:
        return {
            "kind": self.kind,
            "channelId": self.channel.id,
            "messageCount": len(self.messages),
        }


class PocsagAttachment(ChannelAttachment):
    kind = "pocsag"

    def __init__(self, channel, audio_rate: int = 48_000, bauds=(512, 1200, 2400)):
        from wavecap_tpu_torch.decoders.pocsag import POCSAGDecoder

        self.decoder = POCSAGDecoder(audio_rate, bauds)
        super().__init__(channel, audio_rate)

    def process(self, audio: np.ndarray) -> list:
        return [
            {
                "time": m.time,
                "address": m.address,
                "function": m.function,
                "content": m.content,
                "kind": m.kind,
                "baud": m.baud,
            }
            for m in self.decoder.process_audio(audio)
        ]


class FlexAttachment(ChannelAttachment):
    kind = "flex"

    def __init__(self, channel, audio_rate: int = 48_000):
        from wavecap_tpu_torch.decoders.flex import FlexDecoder

        self.decoder = FlexDecoder(audio_rate)
        super().__init__(channel, audio_rate)

    def process(self, audio: np.ndarray) -> list:
        return [
            {
                "time": m.time,
                "capcode": m.capcode,
                "content": m.content,
                "kind": m.kind,
                "baud": m.baud,
            }
            for m in self.decoder.process_audio(audio)
        ]


class RdsAttachment(ChannelAttachment):
    """RDS decodes from the pre-MPX FM discriminator baseband: the 57 kHz
    subcarrier cannot survive the 48 kHz audio path, so this attachment
    subscribes to the wide slot's 240 kHz ``baseband`` fan-out (exported
    by the capture pipeline when enabled — reference taps the equivalent
    point in its capture loop, capture.py:2871-2894).

    A divergence from the JAX package: given the ``capture``, the decoder
    runs at the wide slots' true IF rate, ``sample_rate // (sample_rate //
    WIDE_RATE)``; the reference assumes ``WIDE_RATE``, which is the IF rate
    only where it divides the capture's rate (at 10 Msps the IF is
    243,902 Hz, and the decoder's fixed bit clock, 1.6 % off, finds no
    group)."""

    kind = "rds"

    def __init__(self, channel, audio_rate: int = 48_000, capture=None):
        from wavecap_tpu_torch.capture.pipeline import WIDE_RATE, WideSlotConfig
        from wavecap_tpu_torch.decoders.rds import RDSDecoder

        rate = WIDE_RATE
        if capture is not None and hasattr(capture, "config"):
            rate = WideSlotConfig(sample_rate=int(capture.config.sample_rate)).if_rate
        self.decoder = RDSDecoder(rate)
        if capture is not None and hasattr(capture, "enable_wide_baseband"):
            capture.enable_wide_baseband()
        super().__init__(channel, rate)
        # swap the default audio subscription for the baseband fan-out
        self._sub.close()
        self._sub = channel.baseband.subscribe(maxsize=64)

    def process(self, audio: np.ndarray) -> list:
        data = self.decoder.process_baseband(audio)
        if data.pi is None:
            return []
        return [
            {
                "pi": data.pi,
                "ps": data.ps,
                "radiotext": data.radiotext,
                "pty": data.pty,
                "blocksOk": data.blocks_ok,
            }
        ]

    def status(self) -> dict:
        s = super().status()
        d = self.decoder.data
        s.update({"pi": d.pi, "ps": d.ps, "radiotext": d.radiotext})
        return s


class P25Attachment(ChannelAttachment):
    """Conventional (non-trunked) P25 on a ``p25``-mode channel: consumes
    the channel's soft-symbol fan-out, frames and decodes NID/TSBK/LC,
    and — when a vocoder library is present — pushes decoded voice PCM to
    the channel's audio fan-out so ``/stream/channels/{id}`` plays it
    (reference decodes conventional P25 inside the channel path,
    ``decoders/p25.py:1763``)."""

    kind = "p25"

    def __init__(self, channel, audio_rate: int = 48_000):
        from wavecap_tpu_torch.decoders.framer import P25Framer
        from wavecap_tpu_torch.decoders.voice import VoiceDecoder

        self.framer = P25Framer()
        self.voice = VoiceDecoder()
        self.frame_counts: dict = {}
        super().__init__(channel, audio_rate)
        # symbols, not audio
        self._sub.close()
        self._sub = channel.symbols.subscribe(maxsize=64)

    def process(self, payload) -> list:
        from wavecap_tpu_torch.decoders import p25_frames as pf
        from wavecap_tpu_torch.decoders import p25_tsbk as tsbk_mod

        if isinstance(payload, dict):
            soft = np.asarray(payload.get("soft"), np.float32)
        else:
            soft = np.asarray(payload, np.float32)
        out = []
        for frame in self.framer.process(soft):
            name = frame.duid.name
            self.frame_counts[name] = self.frame_counts.get(name, 0) + 1
            if frame.duid == pf.DUID.TSDU:
                payload_d = pf.remove_status_dibits(frame.dibits[57:], 57)
                payload_s = pf.remove_status_dibits(frame.soft[57:], 57)
                for b in pf.decode_tsbk_payload(payload_d, payload_s):
                    if not b.crc_valid:
                        continue
                    parsed = tsbk_mod.parse_tsbk(b.opcode, b.mfid, b.data)
                    out.append({"time": time.time(), "nac": frame.nac, **parsed})
            elif frame.duid in (pf.DUID.LDU1, pf.DUID.LDU2):
                ldu = pf.decode_ldu(frame.dibits)
                if ldu is None:
                    continue
                pcm = self.voice.decode_codewords(ldu.imbe_codewords)
                if pcm is not None and len(pcm):
                    self.channel.audio.publish(pcm)
        return out

    def status(self) -> dict:
        s = super().status()
        s.update(
            {
                "syncCount": self.framer.sync_count,
                "frames": dict(self.frame_counts),
                "vocoder": self.voice.lib is not None,
            }
        )
        return s


class DmrAttachment(ChannelAttachment):
    """DMR on a ``p25``-mode channel's soft symbols (both are 4800-baud
    4FSK; the demod bank's symbol recovery serves either).  Decodes data
    bursts (CSBK / voice LC headers / terminators via BPTC+Golay), tracks
    voice superframes, and synthesizes their AMBE+2 frames to 8 kHz PCM on
    the channel audio stream via the native half-rate vocoder (raw frames
    also kept for export) — the reference's DMR path never decodes burst
    content and needs DSD-FME for any audio."""

    kind = "dmr"

    def __init__(self, channel, audio_rate: int = 48_000):
        from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeDecoder
        from wavecap_tpu_torch.decoders.dmr import DMRDecoder, DMRVoiceTracker

        self.decoder = DMRDecoder()
        self.voice = DMRVoiceTracker()
        self.vocoder = AmbeDecoder()
        self.ambe_frames: deque = deque(maxlen=2000)  # (18,72) bit arrays
        super().__init__(channel, audio_rate)
        self._sub.close()
        self._sub = channel.symbols.subscribe(maxsize=64)

    def process(self, payload) -> list:
        from wavecap_tpu_torch.decoders import dmr

        if isinstance(payload, dict):
            soft = np.asarray(payload.get("soft"), np.float32)
        else:
            soft = np.asarray(payload, np.float32)
        out = []
        for burst in self.decoder.process(soft):
            parsed = dmr.decode_burst(burst)
            if parsed is None:
                continue
            interesting = "opcode" in parsed or parsed.get("dataTypeName") in (
                "VOICE_LC_HEADER",
                "TERMINATOR_WITH_LC",
            )
            if interesting:
                out.append({"time": time.time(), **parsed})
        for sf in self.voice.process(soft):
            self.ambe_frames.append(sf.ambe_bits)
            # half-rate synthesis: 18 frames -> 360 ms of 8 kHz PCM on the
            # channel's audio stream (the reference needs DSD-FME for this)
            pcm = self.vocoder.decode_frames(sf.ambe_bits)
            if pcm is not None and len(pcm):
                self.channel.audio.publish(pcm)
            out.append(
                {
                    "time": time.time(),
                    "type": "VOICE_SUPERFRAME",
                    "kind": sf.kind,
                    "ambeFrames": int(sf.ambe_bits.shape[0]),
                    "syncQuality": round(sf.sync_quality, 3),
                    "audioSeconds": round(len(pcm) / 8000.0, 3) if pcm is not None else 0.0,
                }
            )
        return out

    def status(self) -> dict:
        s = super().status()
        s.update(
            {
                "burstsFound": self.decoder.bursts_found,
                "voiceSuperframes": self.voice.superframes_found,
                "ambeFramesHeld": sum(a.shape[0] for a in self.ambe_frames),
                "ambeFramesDecoded": self.vocoder.frames_decoded,
                "ambeFramesFailed": self.vocoder.frames_failed,
            }
        )
        return s


ATTACHMENT_KINDS = {
    "pocsag": PocsagAttachment,
    "flex": FlexAttachment,
    "rds": RdsAttachment,
    "p25": P25Attachment,
    "dmr": DmrAttachment,
}
