"""POCSAG pager decoder: NBFM audio -> numeric/alpha messages.

Behavioral rebuild of reference ``dsp/pocsag.py:121``: 512/1200/2400 baud
FSK slicing from demodulated NBFM audio, preamble + frame-sync detection,
BCH(31,21) checked codewords, numeric and 7-bit alpha payloads.

The port's copy of ``wavecap_tpu/decoders/pocsag.py``, with the same public names.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)

FRAME_SYNC = 0x7CD215D8
IDLE_WORD = 0x7A89C197
BCH_POLY = 0b11101101001  # x^10+x^9+x^8+x^6+x^5+x^3+1 (BCH 31,21)

NUMERIC_MAP = "0123456789*U -)("


def bch3121_syndrome(cw: int) -> int:
    reg = cw >> 1  # exclude parity bit
    for i in range(30, 9, -1):
        if reg & (1 << i):
            reg ^= BCH_POLY << (i - 10)
    return reg & 0x3FF


def bch3121_check(cw: int) -> bool:
    if bch3121_syndrome(cw) != 0:
        return False
    return bin(cw).count("1") % 2 == 0  # even parity


def bch3121_encode(data21: int) -> int:
    reg = data21 << 10
    r = reg
    for i in range(30, 9, -1):
        if r & (1 << i):
            r ^= BCH_POLY << (i - 10)
    cw = (reg | (r & 0x3FF)) << 1
    if bin(cw).count("1") % 2:
        cw |= 1
    return cw


@dataclass
class PocsagMessage:
    address: int
    function: int
    content: str
    kind: str  # numeric | alpha
    baud: int
    time: float = field(default_factory=time.time)


class POCSAGDecoder:
    """Feed demodulated FM audio blocks; collects messages."""

    def __init__(self, audio_rate: int = 48_000, bauds=(512, 1200, 2400)):
        self.audio_rate = audio_rate
        self.bauds = bauds
        self.messages: list[PocsagMessage] = []
        self._tail = np.zeros(0, np.float32)

    def process_audio(self, audio: np.ndarray) -> list[PocsagMessage]:
        x = np.concatenate([self._tail, np.asarray(audio, np.float32)])
        new: list[PocsagMessage] = []
        for baud in self.bauds:
            new += self._decode_baud(x, baud)
        keep = int(self.audio_rate * 1.2)  # > one 512-baud batch
        self._tail = x[-keep:] if len(x) > keep else x
        self.messages += new
        return new

    def _decode_baud(self, x: np.ndarray, baud: int) -> list[PocsagMessage]:
        spb = self.audio_rate / baud
        n_bits = int(len(x) / spb)
        if n_bits < 600:
            return []
        idx = (np.arange(n_bits) * spb + spb / 2).astype(int)
        idx = idx[idx < len(x)]
        # POCSAG: high tone = 0, low = 1 (inverted); try both polarities
        for pol in (1.0, -1.0):
            bits = ((x[idx] * pol) < 0).astype(np.uint8)
            msgs = self._decode_bits(bits, baud)
            if msgs:
                return msgs
        return []

    def _decode_bits(self, bits: np.ndarray, baud: int) -> list[PocsagMessage]:
        # find frame sync word
        if len(bits) < 32 + 16 * 32:
            return []
        windows = np.lib.stride_tricks.sliding_window_view(bits.astype(np.int64), 32)
        words = windows @ (2 ** np.arange(32)[::-1])
        sync_pos = np.nonzero(words.astype(np.uint32) == FRAME_SYNC)[0]
        out: list[PocsagMessage] = []
        for pos in sync_pos[:8]:
            batch_start = pos + 32
            codewords = []
            p = batch_start
            while p + 32 <= len(bits) and len(codewords) < 16:
                cw = int(words[p]) & 0xFFFFFFFF
                codewords.append(cw)
                p += 32
            out += self._parse_batch(codewords, baud)
        return out

    def _parse_batch(self, codewords: list[int], baud: int) -> list[PocsagMessage]:
        msgs: list[PocsagMessage] = []
        current: dict | None = None
        for i, cw in enumerate(codewords):
            if not bch3121_check(cw):
                continue
            if cw == IDLE_WORD:
                if current:
                    msgs.append(self._finish(current, baud))
                    current = None
                continue
            is_address = not (cw & 0x80000000)
            payload = (cw >> 11) & 0xFFFFF
            if is_address:
                if current:
                    msgs.append(self._finish(current, baud))
                addr = ((cw >> 13) & 0x3FFFF) << 3 | (i // 2)
                current = {"address": addr, "function": (cw >> 11) & 0x3, "bits": []}
            elif current is not None:
                for b in range(19, -1, -1):
                    current["bits"].append((payload >> b) & 1)
        if current:
            msgs.append(self._finish(current, baud))
        return msgs

    def _finish(self, msg: dict, baud: int) -> PocsagMessage:
        bits = msg["bits"]
        func = msg["function"]
        if func == 0:  # numeric: 4-bit BCD, reversed nibble bit order
            chars = []
            for i in range(0, len(bits) - 3, 4):
                nib = bits[i] | (bits[i + 1] << 1) | (bits[i + 2] << 2) | (bits[i + 3] << 3)
                chars.append(NUMERIC_MAP[nib])
            content, kind = "".join(chars).rstrip(" "), "numeric"
        else:  # alpha: 7-bit ASCII LSB-first
            chars = []
            for i in range(0, len(bits) - 6, 7):
                c = 0
                for j in range(7):
                    c |= bits[i + j] << j
                if c == 0:
                    break
                chars.append(chr(c))
            content, kind = "".join(chars), "alpha"
        return PocsagMessage(
            address=msg["address"], function=func, content=content, kind=kind, baud=baud
        )


# ---------------------------------------------------------------------------
# Synthesis (tests)
# ---------------------------------------------------------------------------


def encode_message(
    address: int, content: str, function: int = 3, numeric: bool = False
) -> np.ndarray:
    """Build POCSAG bits: preamble + sync + one batch (for round trips)."""
    bits: list[int] = [1, 0] * 288  # preamble
    frame = address & 0x7

    def w2b(w):
        return [(w >> (31 - i)) & 1 for i in range(32)]

    bits += w2b(FRAME_SYNC)
    batch: list[int] = []
    addr_cw = bch3121_encode(((address >> 3) << 2) | (function if not numeric else 0))
    payload_bits: list[int] = []
    if numeric:
        for ch in content:
            nib = NUMERIC_MAP.index(ch)
            payload_bits += [(nib >> b) & 1 for b in range(4)]
    else:
        for ch in content:
            payload_bits += [(ord(ch) >> b) & 1 for b in range(7)]
    if numeric:
        while len(payload_bits) % 20:
            # pad with BCD "space" nibbles (0xC), LSB-first
            payload_bits += [(0xC >> b) & 1 for b in range(4)]
        payload_bits = payload_bits[: len(payload_bits) - len(payload_bits) % 20]
    while len(payload_bits) % 20:
        payload_bits.append(0)

    slot = 0
    for f in range(8):
        for half in range(2):
            if f == frame and half == 0:
                batch += w2b(addr_cw)
            elif payload_bits and f >= frame:
                chunk = payload_bits[:20]
                payload_bits = payload_bits[20:]
                v = 0
                for b in chunk:
                    v = (v << 1) | b
                batch += w2b(bch3121_encode((1 << 20) | v) | 0x80000000)
            else:
                batch += w2b(IDLE_WORD)
    bits += batch
    bits += w2b(IDLE_WORD) * 4
    return np.array(bits, np.uint8)


def modulate_pocsag(bits: np.ndarray, audio_rate: int = 48_000, baud: int = 1200):
    """Bits -> audio-rate FSK-slicer-compatible waveform (1 = negative)."""
    spb = audio_rate / baud
    n = int(len(bits) * spb)
    t_idx = (np.arange(n) / spb).astype(int)
    levels = np.where(np.asarray(bits)[np.minimum(t_idx, len(bits) - 1)] > 0, -0.8, 0.8)
    return levels.astype(np.float32)
