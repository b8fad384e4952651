"""P25 C4FM modem: 4800-baud 4-level FSK demodulator + test modulator.

Counterpart of ``wavecap_tpu/models/p25/c4fm.py``.  Per block and slot:
the optional simulcast equalizer on the raw IQ (K14 fit, K7 per-slot
complex FIR), the baseband low-pass (K7), the FM discriminator, the RRC
matched filter (K7), then block timing recovery (K12): an Oerder-Meyr
|x|^2 line at the symbol rate for the clock error, lock and a coarse
phase, two Newton steps on a block-averaged Gardner discriminant, and
one gather of every symbol along the corrected ramp.  With
``timing_impl="scan"`` (``WAVECAP_P25_TIMING=scan``) the per-symbol
Gardner loop takes its place (K12s).  Block continuity is explicit state
(filter tails, discriminator carry, a tail of filtered samples, the
fractional timing position).

The demod is batched over a leading slot axis: ``iq`` is ``(R, n)`` and
every state leaf has a leading ``R`` (one row, ``(n,)`` with unbatched
state, also works).

Deviation map (TIA-102.BAAA): dibit 01 -> +3 (+1800 Hz), 00 -> +1
(+600 Hz), 10 -> -1, 11 -> -3.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from math import gcd
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sps

from ... import ops
from ...kernels import launch
from ...utils.torchenv import DeviceLike, resolve_device
from . import equalizer as eqz

SYMBOL_RATE = 4800.0
DEVIATION_HZ = 1800.0  # +/-1800 Hz for the outer symbols (+/-3)
INTERP_TAIL = 64  # samples of filtered signal carried across blocks

# symbol values of dibits 0..3: the port's copy of
# wavecap_tpu/decoders/p25_frames.py:DIBIT_SYMBOLS
DIBIT_SYMBOLS = np.array([1.0, 3.0, -1.0, -3.0], np.float32)

# f32 constants as the reference's traced arithmetic rounds them
_TWO_PI = float(np.float32(2.0 * np.pi))
_NEG_TWO_PI = float(np.float32(-2.0 * np.pi))
_SMEM_LIMIT = 200 * 1024  # bytes of shared memory K12 and K13 ask for, at most
_K12_MAX_CLUSTER = 8  # CTAs (one cluster) a row
_K12_CLUSTER = 4  # CTAs a row where the launch has rows enough to fill the card
_K12_SMS = 132  # SMs of the H100
_K12_MIN_SYMBOLS = 64  # symbols a CTA, at least
_K12_THREADS = 256
_K12S_SMEM = 227 * 1024  # K12s / K13s: a CTA's dynamic shared memory at most
_K12S_SLOTS = 8  # chunks of the row in the ring
_K12S_CHUNK = 1024  # samples a chunk, at least
_K12S_GROUP = 128  # steps between the walker's waits and progress stores, at most
_K12S_FIRST = 32  # the first group's end, at most
_K12S_SYM_RING = 1024  # symbols between the walker and the helper warp


# ---------------------------------------------------------------------------
# Filter designs (host-side)
# ---------------------------------------------------------------------------


@lru_cache(maxsize=8)
def design_rrc(sample_rate: float, alpha: float = 0.2, span_symbols: int = 8) -> np.ndarray:
    """Root-raised-cosine filter, unit DC gain."""
    sps = sample_rate / SYMBOL_RATE
    n = int(span_symbols * sps) | 1
    t = (np.arange(n) - n // 2) / sps
    h = np.zeros(n)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            h[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * ti) - 1.0) < 1e-9:
            h[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))
            )
        else:
            h[i] = (
                np.sin(np.pi * ti * (1 - alpha))
                + 4 * alpha * ti * np.cos(np.pi * ti * (1 + alpha))
            ) / (np.pi * ti * (1 - (4 * alpha * ti) ** 2))
    return (h / h.sum()).astype(np.float32)


@lru_cache(maxsize=8)
def design_baseband_lpf(sample_rate: float) -> np.ndarray:
    """Anti-noise lowpass ahead of the discriminator (remez ~5.2/6.5 kHz)."""
    numtaps = 63
    h = _sps.remez(
        numtaps, [0, 5200, 6500, sample_rate / 2], [1, 0], fs=sample_rate
    )
    return h.astype(np.float32)


@lru_cache(maxsize=16)
def _filters_on(sample_rate: float, alpha: float, device: torch.device) -> tuple:
    return (torch.from_numpy(design_baseband_lpf(sample_rate)).to(device),
            torch.from_numpy(design_rrc(sample_rate, alpha)).to(device))


# ---------------------------------------------------------------------------
# Demodulator
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class C4fmConfig:
    sample_rate: int = 48_000  # input channel rate
    rrc_alpha: float = 0.2
    loop_bandwidth: float = 0.005  # fraction of symbol rate
    max_clock_ppm: float = 2000.0
    timing_impl: str = "block"  # "block" (K12) or "scan" (the per-symbol loop, K12s)
    # simulcast echo-fit MMSE equalizer on the raw IQ (equalizer.py); 0 disables
    equalizer_taps: int = 0
    eq_lambda: float = 0.01
    eq_max_delay: int = 16
    # runtime guard + engagement hysteresis (see CqpskConfig)
    eq_max_fine_offset_hz: float = 3000.0
    eq_engage_blocks: int = 2

    @property
    def sps(self) -> float:
        return self.sample_rate / SYMBOL_RATE


class C4fmState(NamedTuple):
    lpf_tail: torch.Tensor  # complex
    disc_prev: torch.Tensor
    rrc_tail: torch.Tensor  # real
    interp_tail: torch.Tensor  # trailing filtered samples for next block
    pos: torch.Tensor  # next symbol center within interp_tail ++ new block
    freq: torch.Tensor  # samples per symbol estimate
    integrator: torch.Tensor
    gain: torch.Tensor  # EMA of |soft| at symbol instants (~2.0 when locked)
    dc: torch.Tensor  # EMA of DC offset (carrier error)
    prev_soft: torch.Tensor
    eq_taps: torch.Tensor  # (T,) complex equalizer taps (T=0 when off)
    eq_tail: torch.Tensor  # (T-1,) streaming-conv carry
    eq_acf: torch.Tensor  # EMA'd autocorrelation lags for the echo fit
    eq_hits: torch.Tensor  # consecutive decisive fits (int32)


@lru_cache(maxsize=8)
def _c4fm_eq_candidates(sample_rate: int, max_delay: int) -> tuple:
    """C4FM candidate grid: empirical clean-waveform acf template.

    The template waveform is C4FM-modulated random dibits at 48 kHz,
    resampled to ``sample_rate``.  Noise at this point (raw channelized
    IQ, ahead of the baseband LPF) is modeled as white: a lag-0 delta."""
    rng = np.random.default_rng(12345)
    ref = modulate_c4fm(rng.integers(0, 4, 40_000).astype(np.uint8), 48_000.0)
    if int(sample_rate) != 48_000:
        g = gcd(int(sample_rate), 48_000)
        ref = _sps.resample_poly(ref, int(sample_rate) // g, 48_000 // g)
    ref = ref / np.sqrt(np.mean(np.abs(ref) ** 2))
    n_tau = max_delay + 12
    n_ext = n_tau + max_delay
    r_ref = np.array(
        [np.mean(ref[t:] * np.conj(ref[: len(ref) - t])) for t in range(n_ext + 1)]
    )
    r_ref = (r_ref / r_ref[0].real).astype(np.complex64)
    noise = np.zeros(n_tau + 1, np.float64)
    noise[0] = 1.0
    return eqz.build_candidates(r_ref, noise, max_delay)


@lru_cache(maxsize=8)
def _c4fm_eq_grid(sample_rate: int, max_delay: int, device: torch.device) -> eqz.EchoGrid:
    return eqz.grid_on(_c4fm_eq_candidates(sample_rate, max_delay), device)


def c4fm_init(cfg: C4fmConfig, device: DeviceLike = None) -> C4fmState:
    dev = resolve_device(device)
    lpf = design_baseband_lpf(float(cfg.sample_rate))
    rrc = design_rrc(float(cfg.sample_rate), cfg.rrc_alpha)

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    return C4fmState(
        lpf_tail=ops.fir_init(len(lpf), torch.complex64, device=dev),
        disc_prev=scalar(0.0, torch.complex64),
        rrc_tail=ops.fir_init(len(rrc), torch.float32, device=dev),
        interp_tail=torch.zeros(INTERP_TAIL, dtype=torch.float32, device=dev),
        pos=scalar(float(INTERP_TAIL)),
        freq=scalar(48_000.0 / SYMBOL_RATE),
        integrator=scalar(0.0),
        gain=scalar(0.0),  # 0 = "estimate from first block"
        dc=scalar(0.0),
        prev_soft=scalar(0.0),
        eq_taps=_eq_init(cfg, dev),
        eq_tail=torch.zeros(max(cfg.equalizer_taps - 1, 0), dtype=torch.complex64, device=dev),
        eq_acf=torch.zeros((int(cfg.eq_max_delay) + 13) if cfg.equalizer_taps > 0 else 0,
                           dtype=torch.complex64, device=dev),
        eq_hits=scalar(0, torch.int32),
    )


def _eq_init(cfg: C4fmConfig, device: DeviceLike = None) -> torch.Tensor:
    t = max(cfg.equalizer_taps, 0)
    if t != 0 and t % 2 != 1:
        raise ValueError("equalizer_taps must be odd (or 0 = off)")
    return eqz.init_taps(t, device)


def n_symbols_per_block(cfg: C4fmConfig, block_len: int) -> int:
    """Symbols per block: consumption must equal production on average so
    the timing position neither starves nor overruns the carry tail."""
    return int(round(block_len / cfg.sps))


def _one_row(demod, iq, state, cfg, eq_enable):
    """Run a demod written for ``(R, n)`` rows on one unbatched row."""
    st = type(state)(*(leaf[None] for leaf in state))
    en = None if eq_enable is None else torch.as_tensor(eq_enable).reshape(1)
    soft, dibits, st = demod(iq[None], st, cfg, en)
    return soft[0], dibits[0], type(state)(*(leaf[0] for leaf in st))


def c4fm_demodulate(iq: torch.Tensor, state: C4fmState, cfg: C4fmConfig, eq_enable=None):
    """Demodulate one IQ block per row -> ``(soft_symbols, dibits, state)``.

    ``soft_symbols`` are in units of the 4-level constellation (~+-1, +-3),
    ``n_symbols_per_block(cfg, n)`` per row.  ``eq_enable`` ``(R,)`` bool
    is the equalizer's runtime guard (False holds identity taps and
    restarts the echo fit); None means unguarded."""
    if iq.dim() == 1:
        return _one_row(c4fm_demodulate, iq, state, cfg, eq_enable)
    fs = float(cfg.sample_rate)
    dev = iq.device
    lpf, rrc = _filters_on(fs, cfg.rrc_alpha, dev)

    if cfg.equalizer_taps > 0:
        # simulcast equalizer on the raw IQ (the discriminator is the
        # nonlinearity: the linear channel is inverted before it)
        grid = _c4fm_eq_grid(int(cfg.sample_rate), int(cfg.eq_max_delay), dev)
        allowed = torch.ones(iq.shape[0], dtype=torch.bool, device=dev)
        if eq_enable is not None:
            allowed = eq_enable.to(device=dev, dtype=torch.bool)
        est, eq_acf, sig = eqz.fit_and_invert(iq, state.eq_acf, grid, cfg.equalizer_taps,
                                              cfg.eq_lambda, enable=allowed)
        eq_hits, eq_taps = _engage(est, sig, allowed, state.eq_hits, cfg)
        iq, eq_tail = ops.fir_filter(iq, eq_taps, state.eq_tail)
    else:
        eq_taps, eq_tail, eq_acf = state.eq_taps, state.eq_tail, state.eq_acf
        eq_hits = state.eq_hits

    x, lpf_tail = ops.fir_filter(iq, lpf, state.lpf_tail)
    # discriminator scaled so +/-1800 Hz -> +/-3.0
    fm, disc_prev = ops.quadrature_demod(x, fs, state.disc_prev, max_deviation_hz=DEVIATION_HZ / 3.0)
    filt, rrc_tail = ops.fir_filter(fm, rrc, state.rrc_tail)
    buf = torch.cat([state.interp_tail, filt], dim=-1)
    n_sym = n_symbols_per_block(cfg, iq.shape[-1])
    timing = c4fm_timing if cfg.timing_impl == "block" else c4fm_scan
    soft, dibits, out = timing(buf, _timing_state(state), n_sym, cfg)
    pos, freq, integ, gain, dc, prev = out
    new_state = C4fmState(
        lpf_tail=lpf_tail, disc_prev=disc_prev, rrc_tail=rrc_tail,
        interp_tail=buf[:, -INTERP_TAIL:], pos=pos, freq=freq, integrator=integ, gain=gain,
        dc=dc, prev_soft=prev, eq_taps=eq_taps, eq_tail=eq_tail, eq_acf=eq_acf, eq_hits=eq_hits,
    )
    return soft, dibits, new_state


def _engage(est, sig, allowed, hits, cfg):
    """Engagement hysteresis: the fit must be decisive for
    ``eq_engage_blocks`` consecutive blocks before the inverse applies.
    Returns ``(eq_hits, eq_taps)``."""
    eq_hits = torch.where(allowed & sig, torch.clamp_max(hits + 1, 1_000_000),
                          torch.zeros_like(hits))
    engaged = eq_hits >= cfg.eq_engage_blocks
    ident = eqz._identity(cfg.equalizer_taps, est.device)
    return eq_hits, torch.where((allowed & engaged)[:, None], est, ident[None, :])


def _timing_state(state: C4fmState) -> torch.Tensor:
    """K12's and K12s' carried scalars, ``(6, R)`` f32: pos, freq,
    integrator, gain, dc and the last raw symbol (which only the scan reads)."""
    return torch.stack([state.pos, state.freq, state.integrator, state.gain, state.dc,
                        state.prev_soft])


# ---------------------------------------------------------------------------
# K12: block timing
# ---------------------------------------------------------------------------


class TimingConsts(NamedTuple):
    """The block timing's constants, each as the reference rounds it to f32."""

    sps: float
    fmin: float
    fmax: float
    integ_lo: float  # fmin - sps
    integ_hi: float  # fmax - sps
    half: float  # sps / 2
    recenter_hi: float  # INTERP_TAIL + sps
    lock: float  # dead-air gate on the O&M line


def timing_consts(sps: float, max_clock_ppm: float, lock: float) -> TimingConsts:
    fmin = sps * (1 - max_clock_ppm * 1e-6)
    fmax = sps * (1 + max_clock_ppm * 1e-6)
    vals = (sps, fmin, fmax, fmin - sps, fmax - sps, sps / 2.0, INTERP_TAIL + sps, lock)
    return TimingConsts(*(float(np.float32(v)) for v in vals))


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as an IEEE f32 division on every device, as the reference
    divides (on CUDA torch multiplies by the reciprocal of a Python
    scalar, an ulp off, which a phase of ~7,500 rad does not forgive)."""
    return x / torch.full_like(x, s)


def _sample(buf, p, hi: float):
    """Linear interpolation of each row at positions ``p`` (clipped)."""
    p = p.clamp(0.0, hi)
    i0 = torch.floor(p).to(torch.int64)
    fr = p - i0.to(torch.float32)
    return buf.gather(1, i0) * (1.0 - fr) + buf.gather(1, i0 + 1) * fr


def om_line(u, lock_den, pos, c: TimingConsts):
    """Oerder-Meyr: the |x|^2 line at the symbol rate over the two block
    halves gives ``(lock, slope, delta_om)`` per row: the lock measure,
    the clock error, and the line's symbol phase against the tracked
    position (mod one symbol)."""
    n = u.shape[-1]
    half = n // 2
    idx = torch.arange(n, dtype=torch.float32, device=u.device)
    ang = _div(idx * _NEG_TWO_PI, c.sps)
    uw_re, uw_im = u * torch.cos(ang), u * torch.sin(ang)
    a1 = torch.complex(uw_re[:, :half].sum(-1), uw_im[:, :half].sum(-1))
    a2 = torch.complex(uw_re[:, half:].sum(-1), uw_im[:, half:].sum(-1))
    lock = torch.abs(a1 + a2) / lock_den.clamp_min(1e-9)
    dphi = torch.angle(a2 * torch.conj(a1))
    slope = (_div(dphi, _TWO_PI) * c.sps) * float(np.float32(c.sps) / np.float32(max(half, 1)))
    slope = slope.clamp(-0.005, 0.005)
    tau_om = _div(-torch.angle(a1 + a2), _TWO_PI) * c.sps
    pos_mod = torch.remainder(pos - float(INTERP_TAIL), c.sps)
    delta_om = torch.remainder(tau_om - pos_mod + c.half, c.sps) - c.half
    return lock, slope, delta_om


def newton_phase(gardner, delta_om, c: TimingConsts):
    """Two Newton steps on the Gardner S-curve from the O&M phase (taken
    when the tracked position disagrees by more than 3/4 sample)."""
    d0 = torch.where(delta_om.abs() > 0.75, delta_om, torch.zeros_like(delta_om))
    g0 = gardner(d0)
    g1 = gardner(d0 + 0.5)
    k = (g1 - g0) / 0.5
    ok = k.abs() > 1e-3
    delta = torch.where(ok, d0 - g0 / k, d0).clamp(-c.half, c.half)
    g2 = gardner(delta)
    return torch.where(ok, delta - g2 / k, delta).clamp(-c.half, c.half)


def loop_update(integ, slope, delta, n_sym: int, c: TimingConsts):
    """The block-rate PI update: ``(integrator, freq)``."""
    integ = (integ + 0.5 * slope + 0.05 * _div(delta, max(n_sym, 1))).clamp(c.integ_lo, c.integ_hi)
    return integ, (c.sps + integ).clamp(c.fmin, c.fmax)


def recenter(pos, c: TimingConsts):
    """Slip one whole symbol when the position walks out of the carry."""
    pos = torch.where(pos < 4.0, pos + c.sps, pos)
    return torch.where(pos > c.recenter_hi, pos - c.sps, pos)


def c4fm_timing_plain(buf, st, n_sym: int, cfg: C4fmConfig):
    """Plain version of K12 over rows ``buf = interp_tail ++ filt``
    ``(R, 64 + n)`` and the carried scalars ``st`` ``(6, R)`` (pos, freq,
    integrator, gain, dc).  Returns ``(soft, dibits, out)`` with ``out``
    ``(6, R)``: pos, freq, integrator, gain, dc and the last raw symbol."""
    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005)
    pos, freq_in, integ_in, gain_in, dc_in = st[0], st[1], st[2], st[3], st[4]
    freq = torch.where(freq_in < 1.0, torch.full_like(freq_in, c.sps), freq_in).clamp(c.fmin, c.fmax)
    filt = buf[:, INTERP_TAIL:]
    dc0 = dc_in * 0.9 + filt.mean(-1) * 0.1
    u = (filt - dc0[:, None]) ** 2
    lock, slope, delta_om = om_line(u, u.abs().sum(-1), pos, c)

    m = torch.arange(n_sym, dtype=torch.float32, device=buf.device)
    base = pos[:, None] + m * freq[:, None]
    hi = float(buf.shape[-1] - 2)

    def sample(p):
        return _sample(buf, p, hi) - dc0[:, None]

    def gardner(off):
        p = base + off[:, None]
        y = sample(p)
        ym = sample(p - (freq * 0.5)[:, None])
        g = ((y[:, :-1] - y[:, 1:]) * ym[:, 1:]).mean(-1)
        return g / (y * y).mean(-1).clamp_min(1e-6)

    delta = newton_phase(gardner, delta_om, c)
    sig = lock > c.lock  # dead-air gate: no spectral line -> freeze timing
    delta = torch.where(sig, delta, torch.zeros_like(delta))
    slope = torch.where(sig, slope, torch.zeros_like(slope))
    integ, freq_next = loop_update(integ_in, slope, delta, n_sym, c)

    raw = sample(base + (delta[:, None] + slope[:, None] * (m - 0.5 * n_sym)))
    block_scale = 2.0 / raw.abs().mean(-1).clamp_min(0.05)
    gain = torch.where(gain_in < 0.01, block_scale, 0.95 * gain_in + 0.05 * block_scale)
    gain = gain.clamp(0.05, 40.0)
    soft = raw * gain[:, None]
    pos_next = recenter(pos + delta + n_sym * freq_next - float(buf.shape[-1] - INTERP_TAIL), c)
    out = torch.stack([pos_next, freq_next, integ, gain, dc0, raw[:, -1]])
    return soft, soft_to_dibits(soft), out


class K12Plan(NamedTuple):
    """How K12 and K13's block timing run: ``cluster`` CTAs a row (one
    thread-block cluster) of ``threads`` threads, ``mseg`` symbols a CTA
    (the last may have fewer), each CTA staging a window of at most ``cap``
    samples (0: the windows read the row from global memory); ``ctas`` CTAs
    in all."""

    mseg: int
    cluster: int
    threads: int
    cap: int
    ctas: int


def k12_window_room(mseg: int, n_sym: int, c: TimingConsts) -> int:
    """Samples a CTA's window can span while the carried position is in
    [0, 64 + sps] and the clock in [fmin, fmax]: its symbols and the one
    before them at ``fmax``, the gathers' reach past them each side
    (``sps/2 + 0.5`` of phase, ``0.005 n_sym / 2`` of ramp, 2 of margin,
    as the kernel bounds them), the row passes' samples before the first
    symbol (64) and after the last (the clock's slack over the block)."""
    extra = c.half + 0.5 + 2.0 + 0.0025 * n_sym
    slack = (n_sym + 1) * (c.sps - c.fmin)
    return int(np.ceil((mseg + 1) * c.fmax + 2 * extra + INTERP_TAIL + 2 * c.sps + slack)) + 8


def k12_plan(rows: int, n_sym: int, c: TimingConsts, item: int, forced: tuple | None = None) -> K12Plan:
    """The block timing's launch plan, the one the kernel runs: 4 CTAs a
    row of 256 threads (8 where 4 a row leave half the card's SMs idle),
    each at least 64 symbols; a window staged where
    :func:`k12_window_room` samples of ``item`` bytes fit in shared memory.
    Each step's exchange waits on the cluster's slowest CTA, so more CTAs a
    row lose at the programs' shapes (scripts/k4_k12_variants.py).
    ``forced``: ``(cluster, threads)`` in its place."""
    if forced is not None:
        cluster, threads = forced
    else:
        wanted = _K12_CLUSTER if rows * _K12_CLUSTER >= _K12_SMS // 2 else _K12_MAX_CLUSTER
        cluster = min(wanted, max(1, n_sym // _K12_MIN_SYMBOLS))
        threads = _K12_THREADS
    mseg = -(-n_sym // cluster)
    cluster = -(-n_sym // mseg)
    cap = k12_window_room(mseg, n_sym, c)
    if cap * item + 16 > _SMEM_LIMIT:
        cap = 0
    return K12Plan(mseg, cluster, threads, cap, rows * cluster)


@lru_cache(maxsize=16)
def _om_table(n: int, sps: float, device: torch.device) -> torch.Tensor:
    """``(n, 2)`` f32: the cos and sin of the O&M line's angle ``-2 pi i /
    sps`` for ``i < n``, computed as :func:`om_line` computes them on
    ``device``, so K12 and K13 weigh each sample exactly as the plain
    version does.  The table has been written when it returns: the mesh's
    shards read it from streams of their own, with no wait on the one that
    built it."""
    ang = _div(torch.arange(n, dtype=torch.float32, device=device) * _NEG_TWO_PI, sps)
    tab = torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1).contiguous()
    if tab.is_cuda:
        torch.cuda.current_stream(tab.device).synchronize()
    return tab


def launch_timing(name: str, buf, st, n_sym: int, c: TimingConsts):
    """K12 or K13's block timing on the card: a cluster of CTAs a row
    (:func:`k12_plan`), each staging only the window its symbols read;
    rows of any length."""
    dev = buf.device
    if buf.dim() != 2 or buf.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"{name} takes float32 or complex64 rows of shape (R, L)")
    rows, length = buf.shape
    if n_sym < 2 or length < 2:
        raise NotImplementedError(f"{name} takes rows of at least 2 samples and 2 symbols")
    if st.shape != (6, rows):
        raise ValueError(f"{name}'s carried state must be (6, {rows})")
    plan = k12_plan(rows, n_sym, c, buf.element_size())
    soft = torch.empty((rows, n_sym), dtype=torch.float32, device=dev)
    dibits = torch.empty((rows, n_sym), dtype=torch.uint8, device=dev)
    out = torch.empty((6, rows), dtype=torch.float32, device=dev)
    launch(name, dev, buf.contiguous(), st.to(device=dev, dtype=torch.float32).contiguous(),
           _om_table(length - INTERP_TAIL, c.sps, dev), soft, dibits, out, rows, length, n_sym, *c,
           plan.mseg, plan.cluster, plan.threads, plan.cap)
    return soft, dibits, out


def c4fm_timing(buf, st, n_sym: int, cfg: C4fmConfig):
    """K12: see :func:`c4fm_timing_plain`.  Only a CPU tensor takes the
    plain version."""
    if buf.device.type == "cpu":
        return c4fm_timing_plain(buf, st, n_sym, cfg)
    return launch_timing("K12_c4fm_timing", buf, st, n_sym,
                         timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005))


def _loop_gains(cfg):
    # standard 2nd-order PI loop, damping 0.707
    bw = cfg.loop_bandwidth
    zeta = 0.707
    denom = 1 + 2 * zeta * bw + bw * bw
    alpha = 4 * zeta * bw / denom
    beta = 4 * bw * bw / denom
    return float(alpha), float(beta)


# ---------------------------------------------------------------------------
# K12s: the per-symbol Gardner scan
# ---------------------------------------------------------------------------


def interp_clamped(buf, p):
    """Linear interpolation of each row at ``p`` as the reference's scan
    reads it: ``dynamic_slice(buf, (i0,), (2,))`` clamps the start to
    ``[0, len - 2]`` while the fraction uses the unclamped ``i0`` (the
    block branch clips ``p`` instead)."""
    f = torch.floor(p)
    fr = p - f
    i0 = f.clamp(0.0, float(buf.shape[-1] - 2)).to(torch.int64)[:, None]
    return (buf.gather(1, i0) * (1.0 - fr)[:, None] + buf.gather(1, i0 + 1) * fr[:, None])[:, 0]


def scan_loop(sample, pos, freq, integ, prev, n_sym: int, c: TimingConsts, gains, error):
    """The reference's ``lax.scan`` of Gardner steps, one Python iteration
    a symbol over every row at once: ``sample(p)`` reads the rows at ``p``,
    ``error(y, y_mid, prev)`` is the clipped timing error, and the PI loop
    moves ``integ``, ``freq`` and ``pos``.  Returns ``(syms (R, n_sym),
    pos, freq, integ, prev)``."""
    alpha, beta = gains
    syms = []
    for _ in range(n_sym):
        y = sample(pos)
        err = error(y, sample(pos - freq * 0.5), prev)
        integ = (integ + beta * err).clamp(c.integ_lo, c.integ_hi)
        freq = (c.sps + integ).clamp(c.fmin, c.fmax)
        pos = (pos + freq) + alpha * err
        prev = y
        syms.append(y)
    return torch.stack(syms, -1), pos, freq, integ, prev


def c4fm_scan_plain(buf, st, n_sym: int, cfg: C4fmConfig):
    """Plain version of K12s, the per-symbol timing of
    ``timing_impl="scan"``, over rows ``buf = interp_tail ++ filt`` and the
    carried scalars ``st`` ``(6, R)`` (pos, freq, integrator, gain, dc,
    the last raw symbol).  Returns ``(soft, dibits, out)``, ``out`` as
    :func:`c4fm_timing_plain`'s."""
    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005)
    pos, freq, integ, gain_in, _, prev = (st[k] for k in range(6))
    dc0 = _scan_dc(buf, st)
    # the previous block's amplitude: gain is a soft-output multiplier
    amp_prev = torch.where(gain_in < 0.01, torch.full_like(gain_in, 2.0),
                           2.0 / gain_in.clamp_min(0.05))
    den = amp_prev * amp_prev

    def sample(p):
        return interp_clamped(buf, p) - dc0

    def error(y, y_mid, prev):
        # Gardner's timing error on the 4-level waveform
        return ((prev - y) * y_mid / den).clamp(-2.0, 2.0)

    raw, pos, freq, integ, _ = scan_loop(sample, pos, freq, integ, prev, n_sym, c,
                                         _loop_gains(cfg), error)
    block_scale = 2.0 / raw.abs().mean(-1).clamp_min(0.05)
    gain = torch.where(gain_in < 0.01, block_scale, 0.95 * gain_in + 0.05 * block_scale)
    gain = gain.clamp(0.05, 40.0)
    soft = raw * gain[:, None]
    pos_next = recenter(pos - float(buf.shape[-1] - INTERP_TAIL), c)
    out = torch.stack([pos_next, freq, integ, gain, dc0, raw[:, -1]])
    return soft, soft_to_dibits(soft), out


def _scan_dc(buf, st):
    """The scan's DC estimate, ``dc 0.9 + mean(filt) 0.1``, in torch for the
    kernel and the plain version alike: every symbol reads it, so one ulp
    from another summation order would walk the loop apart."""
    return st[4] * 0.9 + buf[:, INTERP_TAIL:].mean(-1) * 0.1


class K12sPlan(NamedTuple):
    """How K12s and K13s run a row, as the kernel takes it: one CTA of four
    warps; the row streams through a ring of ``slots`` chunks of ``chunk``
    samples in shared memory, the symbols through a ring of ``sym_ring``;
    the walker waits for chunks and publishes symbols once every ``group``
    steps (the first group ends at symbol ``first``); ``narrow``: each
    step's windows loaded a step ahead hold its reads, so the steps away
    from the row's ends may run unchecked (else every step is checked);
    ``smem`` bytes of dynamic shared memory a CTA."""

    chunk: int
    slots: int
    group: int
    first: int
    sym_ring: int
    narrow: bool
    smem: int


def k12s_reach(c: TimingConsts, group: int) -> int:
    """Samples between the lowest read still to come and the highest the
    walker waits for before a group of ``group`` steps (each step's windows
    a step ahead): the group's steps and one more at fmax + 1 (a step
    advances by at most fmax + 2 alpha, alpha < 1/4), 3 of margin, and the
    mid point's fmax / 2 + 1 below the position."""
    return int(np.ceil((group + 1) * (c.fmax + 1.0) + 3 + c.fmax / 2 + 1))


def k12s_narrow(c: TimingConsts, alpha: float) -> bool:
    """Whether the windows loaded a step ahead hold the next step's reads:
    from pos, the next position lies in [RN(RN(pos + fmin) - 2 alpha),
    pos + fmax + 2 alpha] and its mid point spreads by (fmax - fmin) / 2
    more, so each read lies within a sample of its window's lower end while
    1.5 (fmax - fmin) + 4 alpha, with six roundings of half an ulp below
    2^21 (1/16 each), stays below 1."""
    return 1.5 * (c.fmax - c.fmin) + 4.0 * float(np.float32(alpha)) + 6 * 0.0625 < 1.0


def k12s_plan(c: TimingConsts, alpha: float, item: int) -> K12sPlan:
    """The scans' launch plan for a loop of constants ``c`` and gain
    ``alpha`` over samples of ``item`` bytes, whatever the row's length:
    a ring of 8 chunks whose (slots - 2) chunks hold ``k12s_reach`` (the
    walker publishes a low mark a chunk behind its lowest read, so a slot
    is refilled only when the ring still holds every sample a group of
    steps reads): chunks of 1,024 samples (the walk consumes one in ~100
    symbols at the programs' 10 samples a symbol) doubled while shared
    memory allows, then groups shortened from 128 steps where the symbol
    is longer still.  Raises NotImplementedError for a loop whose steps
    may not advance (alpha >= 1/4 or fmin < 1) or whose group of one
    step does not fit."""
    a2 = 2.0 * float(np.float32(alpha))
    if not (a2 < 0.5 and c.fmin >= 1.0):
        raise NotImplementedError(f"K12s / K13s take loops of alpha < 1/4 and fmin >= 1 (alpha {alpha}, "
                                  f"fmin {c.fmin})")
    slots, sym_ring, group = _K12S_SLOTS, _K12S_SYM_RING, _K12S_GROUP
    while group >= 1:
        chunk = _K12S_CHUNK
        smem = item * (chunk * slots + sym_ring + 4) + 8 * slots
        while smem <= _K12S_SMEM:
            if k12s_reach(c, group) <= (slots - 2) * chunk:
                return K12sPlan(chunk, slots, group, min(_K12S_FIRST, group), sym_ring,
                                k12s_narrow(c, alpha), smem)
            chunk *= 2
            smem = item * (chunk * slots + sym_ring + 4) + 8 * slots
        group //= 2
    raise NotImplementedError(f"K12s / K13s: a step of {c.fmax} samples does not fit their ring")


def launch_scan(name: str, buf, st, n_sym: int, c: TimingConsts, gains, dc0=None):
    """K12s or K13s on the card: one CTA per row (:func:`k12s_plan`), the
    row streamed through shared memory; rows of any length.  ``dc0``
    ``(R,)`` is C4FM's DC estimate (None for CQPSK)."""
    dev = buf.device
    if buf.dim() != 2 or buf.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"{name} takes float32 or complex64 rows of shape (R, L)")
    rows, length = buf.shape
    if n_sym < 1 or length < 2 + INTERP_TAIL:
        raise ValueError(f"{name} needs rows of more than {INTERP_TAIL + 1} samples and a symbol")
    if st.shape != (6, rows):
        raise ValueError(f"{name}'s carried state must be (6, {rows})")
    plan = k12s_plan(c, gains[0], buf.element_size())
    soft = torch.empty((rows, n_sym), dtype=torch.float32, device=dev)
    dibits = torch.empty((rows, n_sym), dtype=torch.uint8, device=dev)
    out = torch.empty((6, rows), dtype=torch.float32, device=dev)
    alpha, beta = (float(np.float32(g)) for g in gains)
    launch(name, dev, buf.contiguous(), st.to(device=dev, dtype=torch.float32).contiguous(),
           None if dc0 is None else dc0.contiguous(), soft, dibits, out, rows, length, n_sym, *plan, *c,
           alpha, beta)
    return soft, dibits, out


def c4fm_scan(buf, st, n_sym: int, cfg: C4fmConfig):
    """K12s: see :func:`c4fm_scan_plain`.  Only a CPU tensor takes the
    plain version."""
    if buf.device.type == "cpu":
        return c4fm_scan_plain(buf, st, n_sym, cfg)
    return launch_scan("K12s_c4fm_scan", buf, st, n_sym,
                       timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005), _loop_gains(cfg),
                       _scan_dc(buf, st))


def soft_to_dibits(soft: torch.Tensor) -> torch.Tensor:
    """Map soft symbols to dibits: +3->1, +1->0, -1->2, -3->3."""
    outer = soft.abs() >= 2.0
    return torch.where(soft >= 0, torch.where(outer, 1, 0), torch.where(outer, 3, 2)).to(torch.uint8)


# ---------------------------------------------------------------------------
# Modulator (host-side; test-signal synthesis)
# ---------------------------------------------------------------------------


def modulate_c4fm(
    dibits: np.ndarray,
    sample_rate: float = 48_000.0,
    amplitude: float = 1.0,
    deviation_hz: float | None = None,
) -> np.ndarray:
    """Dibits -> C4FM complex IQ at ``sample_rate`` (RRC-shaped 4FSK).

    ``deviation_hz`` overrides the outer-symbol deviation (default P25's
    +-1800 Hz)."""
    dev = DEVIATION_HZ if deviation_hz is None else float(deviation_hz)
    sps = sample_rate / SYMBOL_RATE
    if abs(sps - round(sps)) >= 1e-9:
        raise ValueError("integer sps required for synthesis")
    sps = int(round(sps))
    symbols = DIBIT_SYMBOLS[np.asarray(dibits, np.uint8)]
    impulses = np.zeros(len(symbols) * sps, np.float32)
    impulses[::sps] = symbols * sps  # impulse-train gain compensation
    h = design_rrc(sample_rate)
    shaped = _sps.lfilter(h, 1.0, impulses)
    freq_hz = shaped * (dev / 3.0)
    phase = 2 * np.pi * np.cumsum(freq_hz) / sample_rate
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)


def modulate_c4fm_cyclic(
    dibits: np.ndarray,
    sample_rate: float = 48_000.0,
    amplitude: float = 1.0,
) -> np.ndarray:
    """Dibits -> seamlessly *loopable* C4FM IQ: the RRC shaping is a
    circular convolution over the loop, and the accumulated FM phase is
    closed to a multiple of 2 pi with a uniform sub-Hz frequency trim."""
    sps = sample_rate / SYMBOL_RATE
    if abs(sps - round(sps)) >= 1e-9:
        raise ValueError("integer sps required for synthesis")
    sps = int(round(sps))
    symbols = DIBIT_SYMBOLS[np.asarray(dibits, np.uint8)]
    n = len(symbols) * sps
    impulses = np.zeros(n, np.float64)
    impulses[::sps] = symbols * sps
    h = design_rrc(sample_rate).astype(np.float64)
    h_pad = np.zeros(n, np.float64)
    h_pad[: len(h)] = h
    # center the pulse so the shaped waveform is not delayed by the span
    h_pad = np.roll(h_pad, -(len(h) // 2))
    shaped = np.fft.irfft(np.fft.rfft(impulses) * np.fft.rfft(h_pad), n)
    freq_hz = shaped * (DEVIATION_HZ / 3.0)
    total_cycles = np.sum(freq_hz) / sample_rate
    trim_hz = (total_cycles - round(total_cycles)) * sample_rate / n
    phase = 2 * np.pi * np.cumsum(freq_hz - trim_hz) / sample_rate
    return (amplitude * np.exp(1j * phase)).astype(np.complex64)
