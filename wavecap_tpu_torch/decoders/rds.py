"""RDS decoder: 57 kHz subcarrier from FM baseband -> PI/PS/RT.

Behavioral rebuild of reference ``dsp/rds.py:158`` (``RDSDecoder``): input
is the pre-MPX FM baseband (discriminator output at the capture's IF
rate, reference feed at ``capture.py:2871``); the signal path (57 kHz
mix-down, decimation, matched filter) runs through scipy; carrier/
clock recovery and block-syndrome sync run at 1187.5 bps on the host.

RDS block structure (IEC 62106): 26-bit blocks (16 data + 10 check), 4
blocks per group, offset words A/B/C/C'/D; groups 0A/0B carry PS, 2A/2B
carry RadioText.

The port's copy of ``wavecap_tpu/decoders/rds.py``, with the same public names.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

logger = logging.getLogger(__name__)

RDS_CARRIER = 57_000.0
RDS_BITRATE = 1187.5

# G(x) = x^10 + x^8 + x^7 + x^5 + x^4 + x^3 + 1
_POLY = 0x5B9
OFFSET_WORDS = {"A": 0x0FC, "B": 0x198, "C": 0x168, "Cp": 0x350, "D": 0x1B4}


def _crc10(data16: int) -> int:
    reg = data16 << 10
    for i in range(25, 9, -1):
        if reg & (1 << i):
            reg ^= _POLY << (i - 10)
    return reg & 0x3FF


def block_syndrome(block26: int) -> int:
    """Nonzero unless the block matches some offset word (returns the
    check-XOR so callers can identify which)."""
    data = (block26 >> 10) & 0xFFFF
    check = block26 & 0x3FF
    return _crc10(data) ^ check


@dataclass
class RDSData:
    pi: int | None = None
    pty: int | None = None
    ps: str = ""
    radiotext: str = ""
    tp: bool = False
    ta: bool = False
    group_counts: dict = field(default_factory=dict)
    blocks_ok: int = 0
    blocks_bad: int = 0


class RDSDecoder:
    """Feed FM baseband blocks; accumulates decoded RDS state."""

    def __init__(self, sample_rate: float):
        self.sample_rate = float(sample_rate)
        self.data = RDSData()
        self._ps = [" "] * 8
        self._rt = [" "] * 64
        self._bits = np.zeros(0, np.uint8)
        self._phase = 0.0
        self._sync_offset: int | None = None

    def process_baseband(self, fm_baseband: np.ndarray) -> RDSData:
        """Demodulate one block of FM baseband into RDS bits + groups."""
        bits = self._demod_bits(np.asarray(fm_baseband, np.float32))
        if len(bits):
            self._bits = np.concatenate([self._bits, bits])
            self._decode_groups()
        return self.data

    # -- physical layer ----------------------------------------------------

    def _demod_bits(self, x: np.ndarray) -> np.ndarray:
        from scipy import signal as sps

        fs = self.sample_rate
        n = len(x)
        if n < 4096:
            return np.zeros(0, np.uint8)
        t = np.arange(n) / fs
        # coherent carrier from the 19 kHz pilot (x3)
        sos_p = sps.butter(4, [18_500 / (fs / 2), 19_500 / (fs / 2)], "band", output="sos")
        pilot = sps.sosfilt(sos_p, x)
        analytic = sps.hilbert(pilot)
        carrier57 = np.exp(3j * np.unwrap(np.angle(analytic)))
        # mix RDS band to baseband with the regenerated carrier
        sos_r = sps.butter(4, [54_500 / (fs / 2), 59_500 / (fs / 2)], "band", output="sos")
        rds_band = sps.sosfilt(sos_r, x)
        bb = rds_band * np.conj(carrier57)
        # decimate to ~8 samples/bit and matched-filter
        decim = max(1, int(fs / (RDS_BITRATE * 8)))
        sos_l = sps.butter(4, 2400 / (fs / 2), "low", output="sos")
        bb = sps.sosfilt(sos_l, bb)[::decim]
        fs2 = fs / decim
        sps_bit = fs2 / RDS_BITRATE
        # biphase symbol: integrate half-bits; sample at bit rate
        n_bits = int(len(bb) / sps_bit) - 2
        if n_bits <= 0:
            return np.zeros(0, np.uint8)
        idx = (np.arange(n_bits) * sps_bit + self._phase).astype(int)
        half = int(sps_bit / 2)
        first = bb.real[idx]
        second = bb.real[np.minimum(idx + half, len(bb) - 1)]
        symbols = first - second  # biphase: bit encoded as +/- transition
        raw = (symbols > 0).astype(np.uint8)
        return (raw[1:] ^ raw[:-1]).astype(np.uint8)  # differential decode

    # -- data-link layer ---------------------------------------------------

    def _decode_groups(self) -> None:
        bits = self._bits
        # find sync: 4 consecutive blocks matching offsets A,B,C|C',D
        i = 0
        while len(bits) - i >= 104:
            if self._try_group(bits, i):
                i += 104
                self._sync_offset = i
            else:
                i += 1
        self._bits = bits[max(i - 103, 0):] if i else bits[-103:] if len(bits) > 103 else bits

    def _try_group(self, bits: np.ndarray, i: int) -> bool:
        def block(k):
            v = 0
            for b in bits[i + 26 * k : i + 26 * (k + 1)]:
                v = (v << 1) | int(b)
            return v

        blocks = [block(k) for k in range(4)]
        syn = [block_syndrome(b) for b in blocks]
        expect = [
            OFFSET_WORDS["A"],
            OFFSET_WORDS["B"],
            None,  # C or C'
            OFFSET_WORDS["D"],
        ]
        if syn[0] != expect[0] or syn[1] != expect[1] or syn[3] != expect[3]:
            self.data.blocks_bad += 1
            return False
        if syn[2] not in (OFFSET_WORDS["C"], OFFSET_WORDS["Cp"]):
            self.data.blocks_bad += 1
            return False
        self.data.blocks_ok += 4
        self._handle_group(
            [(b >> 10) & 0xFFFF for b in blocks], syn[2] == OFFSET_WORDS["Cp"]
        )
        return True

    def _handle_group(self, words: list[int], c_prime: bool) -> None:
        a, b, c, d = words
        self.data.pi = a
        group_type = (b >> 12) & 0xF
        version_b = bool(b & 0x0800)
        self.data.pty = (b >> 5) & 0x1F
        self.data.tp = bool(b & 0x0400)
        key = f"{group_type}{'B' if version_b else 'A'}"
        self.data.group_counts[key] = self.data.group_counts.get(key, 0) + 1
        if group_type == 0:
            seg = b & 0x3
            self.data.ta = bool(b & 0x10)
            chars = d
            self._ps[2 * seg] = chr((chars >> 8) & 0x7F) or " "
            self._ps[2 * seg + 1] = chr(chars & 0x7F) or " "
            self.data.ps = "".join(self._ps)
        elif group_type == 2 and not version_b:
            seg = b & 0xF
            for j, w in enumerate((c, d)):
                self._rt[4 * seg + 2 * j] = chr((w >> 8) & 0x7F)
                self._rt[4 * seg + 2 * j + 1] = chr(w & 0x7F)
            self.data.radiotext = "".join(self._rt).rstrip()


# ---------------------------------------------------------------------------
# Synthesis (tests)
# ---------------------------------------------------------------------------


def encode_group(pi: int, group_type: int, b_low: int, c: int, d: int) -> np.ndarray:
    """Build one 104-bit RDS group with offset words (for round-trip tests)."""
    words = [
        (pi, OFFSET_WORDS["A"]),
        ((group_type << 12) | b_low, OFFSET_WORDS["B"]),
        (c, OFFSET_WORDS["C"]),
        (d, OFFSET_WORDS["D"]),
    ]
    bits = []
    for data, offset in words:
        check = _crc10(data) ^ offset
        v = (data << 10) | check
        bits += [(v >> (25 - i)) & 1 for i in range(26)]
    return np.array(bits, np.uint8)


def modulate_rds(bits: np.ndarray, sample_rate: float, amplitude: float = 0.06):
    """Bits -> 57 kHz biphase BPSK on an FM-baseband-like signal (with
    19 kHz pilot) for decoder tests."""
    fs = float(sample_rate)
    sps_bit = fs / RDS_BITRATE
    # differential encode
    enc = np.cumsum(np.asarray(bits, np.uint8)) % 2
    n = int(len(bits) * sps_bit)
    t = np.arange(n) / fs
    sym = np.zeros(n, np.float64)
    for i, bit in enumerate(enc):
        i0 = int(i * sps_bit)
        i1 = int((i + 0.5) * sps_bit)
        i2 = int((i + 1) * sps_bit)
        level = 1.0 if bit else -1.0
        sym[i0:i1] = level
        sym[i1:i2] = -level
    pilot = 0.09 * np.sin(2 * np.pi * 19_000 * t)
    rds = amplitude * sym * np.sin(2 * np.pi * RDS_CARRIER * t)
    return (pilot + rds).astype(np.float32)
