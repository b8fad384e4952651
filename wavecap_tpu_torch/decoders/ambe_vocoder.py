"""Native AMBE+2 half-rate vocoder (DMR / P25 Phase 2 voice, 3600x2450).

The reference produces no DMR or Phase 2 audio at all: its DMR decoder
stops at burst sync and Phase 2 bursts are persisted raw; voice would
require an external DSD-FME binary or libmbe (``decoders/mbelib_neo.py``),
neither of which ships.  This module gives the half-rate path the same
treatment :mod:`imbe_vocoder` gives full-rate P25: a complete in-framework
codec so DMR superframes and Phase 2 calls synthesize audible PCM with no
external dependency.

Structure of one 72-bit / 20 ms frame (the public 3600 bps = 2450 bps
voice + 1150 bps FEC split used by DMR and NXDN):

  * C0: Golay(24,12) over the 12 perceptually-critical bits (pitch +
    gain MSBs);
  * C1: Golay(23,12) over the next 12, XOR-scrambled by the same
    173x+13849 PN generator the full-rate codec uses, seeded from the C0
    data so a C0 failure can't silently corrupt C1;
  * C2: 11 unprotected bits;  C3: 14 unprotected bits;
  * 6x12 block interleave on air (bit i of the serial frame is
    transmitted at position ``(i % 6) * 12 + i // 6``).

The 49-bit b-vector decodes through the shared MBE model layer of
:mod:`imbe_vocoder` (fundamental / voicing bands / gain / DCT-compressed
log2 spectral amplitudes with rho=0.7 prediction), re-budgeted for 49
bits.  As with the full-rate codec, the *structure* follows the spec but
DVSI's proprietary quantization tables are replaced by deterministic
water-filling + uniform quantizers of matching bit budget (see the
fidelity note in ``imbe_vocoder``): encode/decode inside this framework
are exactly consistent, and off-air DVSI streams decode to structurally
correct rather than bit-exact speech.
"""

from __future__ import annotations

import numpy as np

from wavecap_tpu_torch.decoders.fec import golay
from wavecap_tpu_torch.decoders.imbe_vocoder import (
    ImbeAnalyzer,
    ImbeParams,
    ImbeSynthesizer,
    _read,
    _write,
    bands_for,
    bit_allocation_for,
    fundamental_from_b0,
    harmonics_for,
    read_spectral,
    read_voicing,
    spectral_to_bits,
)
from wavecap_tpu_torch.decoders.voice import (
    _pn_sequence,
    golay23_decode,
    golay23_encode,
)

FRAME_BITS = 72
B_BITS = 49  # 7 pitch + 6 gain + K voicing + shape


# ---------------------------------------------------------------------------
# FEC layer: 49-bit b-vector <-> 72-bit frame
# ---------------------------------------------------------------------------

# 6x12 block interleave: serial bit i transmits at (i % 6) * 12 + i // 6
_ILV = np.array([(i % 6) * 12 + i // 6 for i in range(FRAME_BITS)])


def _interleave(serial: np.ndarray) -> np.ndarray:
    out = np.empty(FRAME_BITS, np.uint8)
    out[_ILV] = serial
    return out


def _deinterleave(bits: np.ndarray) -> np.ndarray:
    return bits[_ILV]


def _bits_to_int(bits: np.ndarray) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


def ambe_fec_encode(b_bits: np.ndarray) -> np.ndarray:
    """49 data bits -> 72-bit interleaved frame."""
    b = np.asarray(b_bits, np.uint8)
    assert b.size == B_BITS
    c0_data = _bits_to_int(b[:12])
    c0 = golay.encode(c0_data)
    c1_plain = golay23_encode(_bits_to_int(b[12:24]))
    pn = _pn_sequence(c0_data)
    c1 = np.array(
        [((c1_plain >> (22 - i)) & 1) ^ pn[i] for i in range(23)], np.uint8
    )
    serial = np.concatenate([c0, c1, b[24:35], b[35:49]])
    return _interleave(serial)


def ambe_fec_decode(frame_bits: np.ndarray) -> tuple[np.ndarray, int] | None:
    """72-bit interleaved frame -> (49 data bits, corrected-error count).

    Returns None when C0 is uncorrectable (>3 errors in the Golay(24,12)
    word) — without C0 the PN seed and pitch are unknown, so the frame is
    unrecoverable, matching the full-rate facade's frame-drop contract."""
    bits = np.asarray(frame_bits, np.uint8)
    if bits.size < FRAME_BITS:
        return None
    serial = _deinterleave(bits[:FRAME_BITS])
    c0_data, e0 = golay.decode(serial[:24])
    if e0 < 0:
        return None
    pn = _pn_sequence(c0_data)
    c1_scrambled = serial[24:47]
    c1_word = 0
    for i in range(23):
        c1_word = (c1_word << 1) | (int(c1_scrambled[i]) ^ pn[i])
    c1_data, e1 = golay23_decode(c1_word)
    errors = e0 + (e1 if e1 >= 0 else 6)
    b = np.concatenate(
        [
            _int_to_bits(c0_data, 12),
            _int_to_bits(c1_data, 12),
            serial[47:58],
            serial[58:72],
        ]
    )
    return b, errors


# ---------------------------------------------------------------------------
# b-vector <-> MBE model parameters (49-bit budget)
# ---------------------------------------------------------------------------


def bit_allocation49(L: int, K: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Half-rate allocation: 49 - 7 pitch - 6 gain - K voicing (same
    water-filling as the full-rate table, shallower budget)."""
    return bit_allocation_for(L, K, B_BITS - 7 - 6 - K)


def decode_params_h(
    b_bits: np.ndarray, prev: ImbeParams, errors: int = 0
) -> ImbeParams:
    """Dequantize a 49-bit half-rate frame into MBE model parameters."""
    bits = np.asarray(b_bits, np.uint8)
    pos = 0
    b0, pos = _read(bits, pos, 7)
    # half the resolution of the full-rate 8-bit pitch over the same range
    w0 = fundamental_from_b0(2 * b0)
    L = harmonics_for(w0)
    K = bands_for(L)
    gain_idx, pos = _read(bits, pos, 6)
    voiced, pos = read_voicing(bits, pos, L, K)
    g_bits, hoc_bits = bit_allocation49(L, K)
    log2M = read_spectral(bits, pos, gain_idx, L, w0, g_bits, hoc_bits, prev)
    return ImbeParams(w0=w0, L=L, K=K, voiced=voiced, log2M=log2M, errors=errors)


def encode_params_h(p: ImbeParams, prev: ImbeParams) -> np.ndarray:
    """Quantize MBE model parameters into 49 bits (inverse of
    :func:`decode_params_h` up to quantizer resolution)."""
    b0 = int(np.clip(round((4.0 * np.pi / p.w0 - 39.5) / 2.0), 0, 127))
    w0 = fundamental_from_b0(2 * b0)
    L = harmonics_for(w0)
    K = bands_for(L)
    voiced = np.zeros(L, bool)
    n = min(L, p.L)
    voiced[:n] = p.voiced[:n]
    log2M = np.full(L, -8.0)
    log2M[:n] = p.log2M[:n]
    g_bits, hoc_bits = bit_allocation49(L, K)
    b1, gain_idx, writes = spectral_to_bits(
        voiced, log2M, L, K, w0, prev, g_bits, hoc_bits
    )
    bits = np.zeros(B_BITS, np.uint8)
    pos = _write(bits, 0, b0, 7)
    pos = _write(bits, pos, gain_idx, 6)
    pos = _write(bits, pos, b1, K)
    for val, width in writes:
        pos = _write(bits, pos, val, width)
    return bits


# ---------------------------------------------------------------------------
# codec facades
# ---------------------------------------------------------------------------


class AmbeDecoder:
    """72-bit AMBE+2 frames in, 8 kHz PCM out (one 160-sample frame each).

    Frames whose C0 fails or whose corrected-error total exceeds the trust
    threshold are concealed with decayed frame repeats, matching the
    full-rate facade's policy."""

    ERROR_LIMIT = 8

    def __init__(self):
        self.prev = ImbeParams.initial()
        self.synth = ImbeSynthesizer()
        self.frames_decoded = 0
        self.frames_failed = 0

    def decode_frame(self, frame_bits: np.ndarray | None) -> np.ndarray:
        if frame_bits is None:
            return self.synth.synth(None)
        dec = ambe_fec_decode(frame_bits)
        if dec is None or dec[1] > self.ERROR_LIMIT:
            self.frames_failed += 1
            return self.synth.synth(None)
        b, errors = dec
        p = decode_params_h(b, self.prev, errors)
        self.prev = p
        self.frames_decoded += 1
        return self.synth.synth(p)

    def decode_frames(self, frames: np.ndarray) -> np.ndarray | None:
        """(N, 72) frame bits -> concatenated soft-clipped PCM."""
        frames = np.asarray(frames)
        if frames.ndim != 2 or not frames.shape[0]:
            return None
        pcm = [self.decode_frame(f) for f in frames]
        return np.tanh(np.concatenate(pcm).astype(np.float32))


class AmbeEncoder:
    """8 kHz PCM in, (N, 72) AMBE+2 frame bits out (test/harness path)."""

    def __init__(self):
        self.analyzer = ImbeAnalyzer()
        self.prev = ImbeParams.initial()

    def encode(self, audio: np.ndarray) -> np.ndarray:
        frames = []
        for p in self.analyzer.analyze(audio):
            b = encode_params_h(p, self.prev)
            # track DECODED params so encoder prediction matches the decoder
            self.prev = decode_params_h(b, self.prev)
            frames.append(ambe_fec_encode(b))
        if not frames:
            return np.zeros((0, FRAME_BITS), np.uint8)
        return np.stack(frames)
