"""Native IMBE 7200x4400 vocoder (P25 Phase 1 full-rate voice).

The reference cannot produce voice PCM without external binaries: it shells
out to DSD-FME (``decoders/imbe.py:30``) or binds mbelib-neo via ctypes
(``decoders/mbelib_neo.py:15``), and with neither installed trunked calls
yield no audio.  This module implements the Multi-Band Excitation vocoder
itself so the framework synthesizes speech with no external dependency:

  * model-parameter decode (fundamental, voicing bands, gain, spectral
    amplitudes) from the FEC-corrected 88-bit frame per the structure of
    TIA-102.BABA section 6: b0 fundamental split 6+2 bits, L harmonics
    derived from b0, K voicing bands, 6-block DCT of log2-amplitude
    prediction residuals with a 6-point DCT across the block averages
    (gain vector), prediction coefficient rho=0.7;
  * spectral-amplitude enhancement (section 6.5 shape: RM0/RM1 weighting
    with [0.5, 1.2] limits and energy renormalization);
  * MBE synthesis (section 7): phase-continuous voiced harmonic bank with
    linear amplitude/frequency interpolation + band-limited noise for
    unvoiced bands via triangular-window overlap-add;
  * the inverse (analyzer + quantizer) so tests and the harness can turn
    real audio into valid frames and round-trip the whole stack.

Fidelity note: the *structure* above follows the spec, but the adaptive
bit-allocation and step-size tables of the TIA annex are not reproducible
here; a deterministic water-filling allocation and uniform quantizers of
matching bit budget are used instead (documented in ``bit_allocation``).
Encode/decode within this framework are exactly consistent; decoding a
DVSI-encoded off-air stream through these approximate tables degrades to
level-warped but structurally correct speech rather than bit-exact output.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

FRAME_SAMPLES = 160  # 20 ms @ 8 kHz
U_WIDTHS = (12, 12, 12, 12, 11, 11, 11, 7)  # u0..u7
RHO = 0.7  # spectral-amplitude prediction coefficient

# ---------------------------------------------------------------------------
# model parameters
# ---------------------------------------------------------------------------


def fundamental_from_b0(b0: int) -> float:
    """omega0 (rad/sample) = 4*pi / (b0 + 39.5); b0 in [0, 207]."""
    return 4.0 * np.pi / (float(b0) + 39.5)


def b0_from_period(period_samples: float) -> int:
    # omega0 = 2*pi/period  =>  b0 = 2*period - 39.5
    return int(np.clip(round(2.0 * period_samples - 39.5), 0, 207))


def harmonics_for(w0: float) -> int:
    """L = floor(0.9254 * floor(pi/w0 + 0.25)), clamped to [9, 56]."""
    return int(np.clip(int(0.9254 * int(np.pi / w0 + 0.25)), 9, 56))


def bands_for(L: int) -> int:
    """K voicing bands: 12 when L > 36 else floor((L+2)/3)."""
    return 12 if L > 36 else (L + 2) // 3


def band_of(l: int, K: int) -> int:
    """Voicing band for harmonic l (1-based): groups of 3, capped at K-1."""
    return min((l - 1) // 3, K - 1)


@dataclass
class ImbeParams:
    """One frame of decoded IMBE model parameters."""

    w0: float
    L: int
    K: int
    voiced: np.ndarray  # bool, length L (index 0 == harmonic 1)
    log2M: np.ndarray  # float, length L
    errors: int = 0

    @property
    def M(self) -> np.ndarray:
        return np.exp2(self.log2M)

    @staticmethod
    def initial() -> "ImbeParams":
        w0 = fundamental_from_b0(92)  # ~190 Hz nominal startup pitch
        L = harmonics_for(w0)
        return ImbeParams(
            w0=w0,
            L=L,
            K=bands_for(L),
            voiced=np.zeros(L, bool),
            log2M=np.full(L, -8.0),
        )


# ---------------------------------------------------------------------------
# bit allocation + quantizers
# ---------------------------------------------------------------------------


def block_lengths(L: int) -> list[int]:
    """Six DCT blocks covering the L residuals, lower blocks get extras."""
    base, extra = divmod(L, 6)
    return [base + (1 if i < extra else 0) for i in range(6)]


@lru_cache(maxsize=128)
def bit_allocation_for(
    L: int, K: int, total: int
) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Bits for the 5 gain-vector coefficients G2..G6 and the L-6 higher
    order DCT coefficients (block-major, C2..C_J within each block), for
    any frame bit budget — the full-rate (88-bit) and half-rate (49-bit)
    codecs differ only here.

    Deterministic water-filling over priority weights standing in for the
    TIA annex tables: the budget is spent exactly, gains get the most
    bits, early in-block coefficients more than late ones.
    """
    prios: list[float] = [6.0, 5.2, 4.6, 4.1, 3.7]  # G2..G6
    for ji in block_lengths(L):
        for k in range(2, ji + 1):
            prios.append(max(3.2 - 0.55 * (k - 2), 0.0))
    bits = [0] * len(prios)
    for _ in range(max(total, 0)):
        best, best_v = -1, -1e9
        for i, p in enumerate(prios):
            if bits[i] >= 10:
                continue
            v = p - bits[i]
            if v > best_v:
                best, best_v = i, v
        if best < 0:
            break
        bits[best] += 1
    return tuple(bits[:5]), tuple(bits[5:])


def bit_allocation(L: int, K: int) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Full-rate allocation: 88 - 8 pitch - 6 gain - K voicing."""
    return bit_allocation_for(L, K, 88 - 8 - 6 - K)


# nominal standard deviations for the uniform quantizers
_SIGMA_G = (4.5, 3.8, 3.2, 2.8, 2.5)
# the stored gain is the DC of the PRBA DCT divided by sqrt(L), i.e. the
# frame's mean log2 amplitude — speech at [-1, 1] spans roughly [-12, 4];
# the floor reaches low enough that digital silence decodes inaudibly
_GAIN_MIN, _GAIN_MAX = -16.0, 4.0


def _sigma_hoc(k: int) -> float:
    return max(1.8 * 0.8 ** (k - 2), 0.6)


def _uq_encode(x: float, bits: int, sigma: float) -> int:
    if bits <= 0:
        return 0
    step = 5.6 * sigma / (1 << bits)
    return int(np.clip(np.floor(x / step) + (1 << (bits - 1)), 0, (1 << bits) - 1))


def _uq_decode(idx: int, bits: int, sigma: float) -> float:
    if bits <= 0:
        return 0.0
    step = 5.6 * sigma / (1 << bits)
    return (idx - (1 << (bits - 1)) + 0.5) * step


def _gain_encode(g: float) -> int:
    t = (g - _GAIN_MIN) / (_GAIN_MAX - _GAIN_MIN)
    return int(np.clip(np.floor(t * 64.0), 0, 63))


def _gain_decode(idx: int) -> float:
    return _GAIN_MIN + (idx + 0.5) * (_GAIN_MAX - _GAIN_MIN) / 64.0


@lru_cache(maxsize=16)
def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix (rows = coefficients)."""
    j = np.arange(n)
    k = np.arange(n)[:, None]
    m = np.cos(np.pi * k * (j + 0.5) / n) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m


# ---------------------------------------------------------------------------
# frame <-> bits
# ---------------------------------------------------------------------------


def _us_to_bits(u: list[int]) -> np.ndarray:
    bits = np.empty(88, np.uint8)
    pos = 0
    for val, w in zip(u, U_WIDTHS):
        for i in range(w - 1, -1, -1):
            bits[pos] = (val >> i) & 1
            pos += 1
    return bits


def _bits_to_us(bits: np.ndarray) -> list[int]:
    us, pos = [], 0
    for w in U_WIDTHS:
        v = 0
        for _ in range(w):
            v = (v << 1) | int(bits[pos])
            pos += 1
        us.append(v)
    return us


def _read(bits: np.ndarray, pos: int, n: int) -> tuple[int, int]:
    v = 0
    for i in range(n):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + n


def _write(bits: np.ndarray, pos: int, val: int, n: int) -> int:
    for i in range(n):
        bits[pos + i] = (val >> (n - 1 - i)) & 1
    return pos + n


def _prediction(L: int, w0: float, prev: ImbeParams) -> np.ndarray:
    """Interpolated previous-frame log2 amplitudes at this frame's harmonics
    (log2 M-bar at k_l = l * w0 / w0_prev, with M-bar_0 = 1 and values
    beyond L_prev held at the last amplitude)."""
    prev_log = np.concatenate(([0.0], prev.log2M))  # index 0 = harmonic 0
    k = np.arange(1, L + 1) * (w0 / prev.w0)
    k0 = np.clip(np.floor(k).astype(int), 0, prev.L)
    k1 = np.clip(k0 + 1, 0, prev.L)
    d = np.clip(k - np.floor(k), 0.0, 1.0)
    return (1.0 - d) * prev_log[k0] + d * prev_log[k1]


def read_voicing(bits: np.ndarray, pos: int, L: int, K: int):
    """K band-vote bits -> per-harmonic voiced flags (shared rate codec)."""
    b1, pos = _read(bits, pos, K)
    voiced = np.array(
        [(b1 >> (K - 1 - band_of(l, K))) & 1 == 1 for l in range(1, L + 1)], bool
    )
    return voiced, pos


def read_spectral(
    bits: np.ndarray,
    pos: int,
    gain_idx: int,
    L: int,
    w0: float,
    g_bits,
    hoc_bits,
    prev: ImbeParams,
) -> np.ndarray:
    """Gain vector + higher-order DCT coefficients -> log2 amplitudes.

    Shared by the full-rate (88-bit) and half-rate (49-bit) codecs; only
    the bit allocation differs."""
    G = np.zeros(6)
    G[0] = _gain_decode(gain_idx) * np.sqrt(L)
    for i in range(5):
        idx, pos = _read(bits, pos, g_bits[i])
        G[i + 1] = _uq_decode(idx, g_bits[i], _SIGMA_G[i])
    lens = block_lengths(L)
    hoc: list[float] = []
    hi = 0
    for ji in lens:
        for k in range(2, ji + 1):
            idx, pos = _read(bits, pos, hoc_bits[hi])
            hoc.append(_uq_decode(idx, hoc_bits[hi], _sigma_hoc(k)))
            hi += 1
    # gain vector -> block DC coefficients; blocks -> residuals
    dc = _dct_matrix(6).T @ G
    T = np.empty(L)
    off = hoff = 0
    for bi, ji in enumerate(lens):
        coef = np.zeros(ji)
        coef[0] = dc[bi]
        coef[1:] = hoc[hoff : hoff + ji - 1]
        T[off : off + ji] = _dct_matrix(ji).T @ coef
        off += ji
        hoff += ji - 1
    P = _prediction(L, w0, prev)
    log2M = T + RHO * P - (RHO / L) * float(np.sum(P))
    # bit errors can decode to absurd levels; full scale is ~0 (amp 1.0)
    return np.minimum(log2M, 2.0)


def spectral_to_bits(
    p_voiced: np.ndarray,
    log2M: np.ndarray,
    L: int,
    K: int,
    w0: float,
    prev: ImbeParams,
    g_bits,
    hoc_bits,
):
    """Inverse of :func:`read_spectral` + voicing vote: returns
    (b1 voicing word, gain index, [(value, bits, sigma)...] write list)."""
    b1 = 0
    for k in range(K):
        ls = [l for l in range(1, L + 1) if band_of(l, K) == k]
        v = 1 if np.mean([p_voiced[l - 1] for l in ls]) >= 0.5 else 0
        b1 = (b1 << 1) | v
    P = _prediction(L, w0, prev)
    T = log2M - RHO * P + (RHO / L) * float(np.sum(P))
    lens = block_lengths(L)
    dc = np.empty(6)
    hoc_true: list[float] = []
    off = 0
    for bi, ji in enumerate(lens):
        coef = _dct_matrix(ji) @ T[off : off + ji]
        dc[bi] = coef[0]
        hoc_true.extend(coef[1:])
        off += ji
    G = _dct_matrix(6) @ dc
    writes = [
        (_uq_encode(G[i + 1], g_bits[i], _SIGMA_G[i]), g_bits[i])
        for i in range(5)
    ]
    hi = 0
    for ji in lens:
        for k in range(2, ji + 1):
            writes.append(
                (_uq_encode(hoc_true[hi], hoc_bits[hi], _sigma_hoc(k)),
                 hoc_bits[hi])
            )
            hi += 1
    return b1, _gain_encode(G[0] / np.sqrt(L)), writes


def decode_params(
    u: list[int], prev: ImbeParams, errors: int = 0
) -> ImbeParams | None:
    """Dequantize an FEC-corrected frame (u0..u7) into model parameters."""
    bits = _us_to_bits(u)
    b0 = 0
    for i in range(6):
        b0 = (b0 << 1) | int(bits[i])
    b0 = (b0 << 2) | (int(bits[86]) << 1) | int(bits[87])
    w0 = fundamental_from_b0(b0)
    L = harmonics_for(w0)
    K = bands_for(L)
    pos = 6
    gain_idx, pos = _read(bits, pos, 6)
    voiced, pos = read_voicing(bits, pos, L, K)
    g_bits, hoc_bits = bit_allocation(L, K)
    log2M = read_spectral(bits, pos, gain_idx, L, w0, g_bits, hoc_bits, prev)
    return ImbeParams(w0=w0, L=L, K=K, voiced=voiced, log2M=log2M, errors=errors)


def encode_params(p: ImbeParams, prev: ImbeParams) -> list[int]:
    """Quantize model parameters to a frame (u0..u7) — exact inverse of
    :func:`decode_params` up to quantizer resolution.  The encoder must
    thread the same prev state the decoder will have (decoded params)."""
    b0 = int(np.clip(round(4.0 * np.pi / p.w0 - 39.5), 0, 207))
    w0 = fundamental_from_b0(b0)
    L = harmonics_for(w0)
    K = bands_for(L)
    voiced = np.zeros(L, bool)
    n = min(L, p.L)
    voiced[:n] = p.voiced[:n]
    log2M = np.full(L, -8.0)
    log2M[:n] = p.log2M[:n]
    g_bits, hoc_bits = bit_allocation(L, K)
    b1, gain_idx, writes = spectral_to_bits(
        voiced, log2M, L, K, w0, prev, g_bits, hoc_bits
    )
    bits = np.zeros(88, np.uint8)
    pos = _write(bits, 0, b0 >> 2, 6)
    pos = _write(bits, pos, gain_idx, 6)
    pos = _write(bits, pos, b1, K)
    for val, width in writes:
        pos = _write(bits, pos, val, width)
    _write(bits, 86, b0 & 0x3, 2)
    return _bits_to_us(bits)


# ---------------------------------------------------------------------------
# spectral amplitude enhancement (TIA-102.BABA 6.5 shape)
# ---------------------------------------------------------------------------


def enhance_amplitudes(p: ImbeParams) -> np.ndarray:
    M = p.M
    l = np.arange(1, p.L + 1)
    rm0 = float(np.sum(M * M))
    rm1 = float(np.sum(M * M * np.cos(p.w0 * l)))
    if rm0 <= 1e-12 or rm0 * rm0 - rm1 * rm1 <= 1e-12:
        return M
    k1 = 0.96 * np.pi / (p.w0 * rm0 * (rm0 * rm0 - rm1 * rm1))
    k2 = rm0 * rm0 + rm1 * rm1
    with np.errstate(invalid="ignore"):
        w = np.sqrt(M) * np.power(
            np.maximum(k1 * (k2 - 2.0 * rm0 * rm1 * np.cos(p.w0 * l)), 0.0), 0.25
        )
    out = M * np.clip(w, 0.5, 1.2)
    out[8 * l <= p.L] = M[8 * l <= p.L]  # low harmonics unchanged
    e = float(np.sum(out * out))
    if e > 1e-12:
        out *= np.sqrt(rm0 / e)
    return out


# ---------------------------------------------------------------------------
# synthesis
# ---------------------------------------------------------------------------

MAX_HARM = 57


class ImbeSynthesizer:
    """Stateful frame-by-frame MBE synthesizer: 1 frame -> 160 samples.

    Voiced harmonics run through per-harmonic phase accumulators with
    linear amplitude and frequency interpolation between frames; unvoiced
    bands are synthesized as spectrally shaped noise via a 320-sample
    triangular-window overlap-add (exact COLA at hop 160).
    """

    def __init__(self, seed: int = 0x1234):
        self.prev = ImbeParams.initial()
        self.phase = np.zeros(MAX_HARM)
        self.rng = np.random.default_rng(seed)
        self._uv_tail = np.zeros(FRAME_SAMPLES)
        self._tri = 1.0 - np.abs(np.arange(2 * FRAME_SAMPLES) - (FRAME_SAMPLES - 0.5)) / FRAME_SAMPLES
        self._tri = np.clip(self._tri, 0.0, None)

    def reset(self) -> None:
        self.prev = ImbeParams.initial()
        self.phase[:] = 0.0
        self._uv_tail[:] = 0.0

    def synth(self, cur: ImbeParams | None) -> np.ndarray:
        """Synthesize one 20 ms frame; None repeats the last frame decayed
        (frame-repeat concealment for FEC failures)."""
        if cur is None:
            cur = ImbeParams(
                w0=self.prev.w0,
                L=self.prev.L,
                K=self.prev.K,
                voiced=self.prev.voiced.copy(),
                log2M=self.prev.log2M - 0.5,  # ~ -3 dB per repeat
            )
        N = FRAME_SAMPLES
        prev = self.prev
        Mc = enhance_amplitudes(cur)
        Mp = prev.M
        Lmax = max(prev.L, cur.L)
        ls = np.arange(1, Lmax + 1)
        a0 = np.zeros(Lmax)
        a1 = np.zeros(Lmax)
        vp = np.zeros(Lmax, bool)
        vc = np.zeros(Lmax, bool)
        vp[: prev.L] = prev.voiced
        vc[: cur.L] = cur.voiced
        a0[: prev.L] = np.where(prev.voiced, Mp, 0.0)
        a1[: cur.L] = np.where(cur.voiced, Mc, 0.0)
        act = (a0 > 0) | (a1 > 0)
        out = np.zeros(N)
        if np.any(act):
            li = ls[act]
            w_start = np.where(vp[act], li * prev.w0, li * cur.w0)
            w_end = np.where(vc[act], li * cur.w0, li * prev.w0)
            # onset harmonics get a random phase so the bank doesn't buzz
            onset = (a0[act] == 0) & (a1[act] > 0)
            if np.any(onset):
                idx = li[onset]
                self.phase[idx - 1] = self.rng.uniform(0, 2 * np.pi, idx.size)
            t = (np.arange(N) + 0.5) / N
            w = w_start[:, None] + (w_end - w_start)[:, None] * t
            ph = self.phase[li - 1][:, None] + np.cumsum(w, axis=1)
            amp = a0[act][:, None] + (a1 - a0)[act][:, None] * t
            out += np.sum(amp * np.cos(ph), axis=0)
            self.phase[li - 1] = np.mod(ph[:, -1], 2 * np.pi)
        out += self._unvoiced(cur, Mc)
        self.prev = ImbeParams(
            w0=cur.w0, L=cur.L, K=cur.K, voiced=cur.voiced, log2M=np.log2(np.maximum(Mc, 1e-9))
        )
        return out

    def _unvoiced(self, cur: ImbeParams, Mc: np.ndarray) -> np.ndarray:
        N = FRAME_SAMPLES
        nfft = 2 * N
        uv = ~cur.voiced
        seg = np.zeros(N)
        if np.any(uv):
            spec = np.zeros(N + 1, complex)
            bin_per_rad = nfft / (2 * np.pi)
            for l in np.flatnonzero(uv) + 1:
                c = l * cur.w0 * bin_per_rad
                half = 0.5 * cur.w0 * bin_per_rad
                lo = max(1, int(np.ceil(c - half)))
                hi = min(N, int(np.floor(c + half)))
                if hi < lo:
                    lo = hi = int(np.clip(round(c), 1, N))
                m = hi - lo + 1
                # band power matches a voiced harmonic of the same amplitude;
                # sqrt(1.5) compensates the triangular-WOLA power loss
                # (E[w1^2 + w2^2] = 2/3 across the overlap)
                target = np.sqrt(1.5) * nfft * Mc[l - 1] / (2.0 * np.sqrt(m))
                z = self.rng.standard_normal(m) + 1j * self.rng.standard_normal(m)
                spec[lo : hi + 1] = target * z / np.sqrt(2.0)
            block = np.fft.irfft(spec, nfft) * self._tri
            seg = self._uv_tail + block[:N]
            self._uv_tail = block[N:]
        else:
            seg = self._uv_tail.copy()
            self._uv_tail = np.zeros(N)
        return seg


# ---------------------------------------------------------------------------
# analysis (encoder front end, used by tests/harness to make real frames)
# ---------------------------------------------------------------------------


class ImbeAnalyzer:
    """Turn 8 kHz speech into IMBE model parameters, one frame per 160
    samples.  Windowed autocorrelation pitch + harmonic band energies;
    good enough to produce intelligible round-trip material for tests."""

    NFFT = 512
    WIN = 320

    def __init__(self):
        self._tail = np.zeros(0)
        self._win = np.hanning(self.WIN)
        self._wsum2 = float(np.sum(self._win**2))

    def analyze(self, audio: np.ndarray) -> list[ImbeParams]:
        x = np.concatenate([self._tail, np.asarray(audio, np.float64)])
        frames = []
        pos = 0
        while pos + self.WIN <= len(x):
            frames.append(self._frame(x[pos : pos + self.WIN]))
            pos += FRAME_SAMPLES
        self._tail = x[pos:]
        return frames

    def _frame(self, seg: np.ndarray) -> ImbeParams:
        w = seg * self._win
        # pitch via normalized autocorrelation over the valid lag range
        ac = np.correlate(w, w, "full")[self.WIN - 1 :]
        e0 = ac[0] + 1e-12
        lags = np.arange(20, 124)
        r = ac[lags] / e0
        best = int(lags[np.argmax(r)])
        voiced_global = float(np.max(r)) > 0.25
        b0 = b0_from_period(float(best))
        w0 = fundamental_from_b0(b0)
        L = harmonics_for(w0)
        K = bands_for(L)
        X = np.fft.rfft(w, self.NFFT)
        mag2 = np.abs(X) ** 2
        bin_per_rad = self.NFFT / (2 * np.pi)
        # Parseval: a windowed cos of amplitude A puts Nfft*A^2*sum(w^2)/4
        # of |X|^2 energy on the positive-frequency side -> M = A needs 4/..
        cal = 4.0 / (self.NFFT * self._wsum2)
        log2M = np.full(L, -8.0)
        peaky = np.zeros(L)
        for l in range(1, L + 1):
            c = l * w0 * bin_per_rad
            half = 0.5 * w0 * bin_per_rad
            lo = max(0, int(np.ceil(c - half)))
            hi = min(len(mag2) - 1, int(np.floor(c + half)))
            if hi < lo:
                lo = hi = int(np.clip(round(c), 0, len(mag2) - 1))
            band = mag2[lo : hi + 1]
            ml = np.sqrt(max(float(np.sum(band)) * cal, 1e-16))
            log2M[l - 1] = np.log2(ml)
            ci = int(np.clip(round(c), lo, hi))
            core = mag2[max(ci - 1, lo) : min(ci + 2, hi + 1)]
            peaky[l - 1] = float(np.sum(core)) / (float(np.sum(band)) + 1e-16)
        voiced = np.zeros(L, bool)
        if voiced_global:
            M2 = np.exp2(2.0 * log2M)
            for k in range(K):
                ls = [l for l in range(1, L + 1) if band_of(l, K) == k]
                # energy-weighted vote: a band dominated by one strong
                # harmonic (e.g. a pure tone) must not be out-voted by the
                # peakiness of its empty neighbors
                e = np.array([M2[l - 1] for l in ls])
                w = e / max(float(np.sum(e)), 1e-30)
                score = float(np.sum(w * [peaky[l - 1] for l in ls]))
                if score > 0.55:
                    for l in ls:
                        voiced[l - 1] = True
        # limit in-frame dynamic range to ~36 dB below the loudest harmonic:
        # keeps the residual DCT coefficients inside the quantizer ranges
        # without touching anything audible
        log2M = np.maximum(log2M, float(np.max(log2M)) - 6.0)
        return ImbeParams(w0=w0, L=L, K=K, voiced=voiced, log2M=log2M)


# ---------------------------------------------------------------------------
# codec facades
# ---------------------------------------------------------------------------


class ImbeDecoder:
    """u-vectors in, PCM out; threads prediction + synthesis state."""

    def __init__(self):
        self.prev = ImbeParams.initial()
        self.synth = ImbeSynthesizer()

    def decode_frame(self, u: list[int] | None, errors: int = 0) -> np.ndarray:
        if u is None:
            return self.synth.synth(None)
        p = decode_params(u, self.prev, errors)
        if p is None:
            return self.synth.synth(None)
        self.prev = p
        return self.synth.synth(p)


class ImbeEncoder:
    """PCM in, u-vectors out (test/harness path)."""

    def __init__(self):
        self.analyzer = ImbeAnalyzer()
        self.prev = ImbeParams.initial()

    def encode(self, audio: np.ndarray) -> list[list[int]]:
        out = []
        for p in self.analyzer.analyze(audio):
            u = encode_params(p, self.prev)
            # track the DECODED params so encoder prediction matches decoder
            self.prev = decode_params(u, self.prev) or self.prev
            out.append(u)
        return out
