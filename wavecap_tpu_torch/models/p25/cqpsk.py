"""CQPSK / LSM demodulator: pi/4-DQPSK -> C4FM-compatible soft symbols.

Counterpart of ``wavecap_tpu/models/p25/cqpsk.py``.  Per block and slot:
the carried carrier-offset de-rotation (exact uint32 NCO) and the RRC
matched filter (K7), a block AGC, the 4th-power CFO search (K13
``cfo_power``, cuFFT, K13 ``cfo_lines``), the optional simulcast
equalizer (K14 fit with the alias resolution, K7 per-slot complex FIR),
then K13 ``cqpsk_timing``:
the block timing of the C4FM path on the complex envelope (O&M line on
|y|^2, complex Gardner), differential detection ``y[k] conj(y[k-1])``
and the slow bias tracker; with ``timing_impl="scan"`` the per-symbol
complex Gardner loop (K13s) takes the block timing's place before the
same detector.

Output soft symbols use the C4FM scale (delta-phase / (pi/4) in
{+-1, +-3}).  Phase 1 LSM (4800 baud) and Phase 2 H-DQPSK (6000 baud)
via ``symbol_rate``.  Batched over a leading slot axis like
``c4fm_demodulate``.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sps

from ... import ops
from ...kernels import launch
from ...ops.nco import _next_phase, tuning_word
from ...utils.torchenv import DeviceLike, resolve_device
from . import equalizer as eqz
from .c4fm import (
    DIBIT_SYMBOLS,
    INTERP_TAIL,
    TimingConsts,
    _div,
    _engage,
    _loop_gains,
    _one_row,
    _sample,
    interp_clamped,
    launch_scan,
    launch_timing,
    loop_update,
    newton_phase,
    om_line,
    recenter,
    scan_loop,
    soft_to_dibits,
    timing_consts,
)

_QUARTER_PI = float(np.float32(np.pi / 4))
EQ_NFFT = eqz.EQ_NFFT  # the echo fit's spectrum grid; INTERP_TAIL comes from c4fm


@lru_cache(maxsize=8)
def design_rrc_cqpsk(
    sample_rate: float, symbol_rate: float, alpha: float
) -> np.ndarray:
    sps = sample_rate / symbol_rate
    n = int(8 * sps) | 1
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
    return (h / np.sqrt(np.sum(h**2))).astype(np.float32)


@lru_cache(maxsize=16)
def _rrc_on(sample_rate: float, symbol_rate: float, alpha: float, device: torch.device):
    return torch.from_numpy(design_rrc_cqpsk(sample_rate, symbol_rate, alpha)).to(device)


@dataclass(frozen=True)
class CqpskConfig:
    sample_rate: int = 48_000
    symbol_rate: float = 4800.0  # 6000 for Phase 2 TDMA
    rrc_alpha: float = 0.2  # the reference uses 1.0 for Phase 2
    loop_bandwidth: float = 0.005
    max_clock_ppm: float = 2000.0
    timing_impl: str = "block"  # "block" (K13) or "scan" (the per-symbol loop, K13s)
    # coarse CFO acquisition from the 4th-power spectrum; -1 = auto
    # (0.23 * symbol_rate), 0.0 disables
    cfo_max_hz: float = -1.0
    # simulcast equalizer (equalizer.py): 0 disables; 41 taps spans
    # +-420 us at the 48-50 kHz channel rate
    equalizer_taps: int = 0
    eq_lambda: float = 0.01  # MMSE regularization (1/SNR-ish, caps boost)
    eq_max_delay: int = 16  # echo-delay search range (samples)
    eq_ema: float = 1.0  # per-block tap smoothing (1 = none)
    # runtime guard: slots whose fine offset exceeds this hold identity taps
    eq_max_fine_offset_hz: float = 3000.0
    # engagement hysteresis: decisive fits in a row before the inverse applies
    eq_engage_blocks: int = 2

    @property
    def sps(self) -> float:
        return self.sample_rate / self.symbol_rate

    @property
    def cfo_span_hz(self) -> float:
        if self.cfo_max_hz < 0:
            return 0.23 * self.symbol_rate
        return self.cfo_max_hz


class CqpskState(NamedTuple):
    rrc_tail: torch.Tensor  # complex FIR carry
    interp_tail: torch.Tensor  # complex filtered samples
    pos: torch.Tensor
    freq: torch.Tensor
    integrator: torch.Tensor
    prev_sym: torch.Tensor  # complex symbol at previous instant
    bias: torch.Tensor  # carrier-offset phase bias (radians/symbol)
    cfo_hz: torch.Tensor  # acquired carrier offset (NCO pre-correction)
    cfo_phase: torch.Tensor  # uint32 NCO phase carry for the correction
    eq_taps: torch.Tensor  # (T,) complex equalizer taps (T=0 when off)
    eq_tail: torch.Tensor  # (T-1,) streaming-conv carry
    eq_acf: torch.Tensor  # EMA'd autocorrelation lags for the echo fit
    eq_hits: torch.Tensor  # consecutive decisive fits (int32)


def cqpsk_init(cfg: CqpskConfig, device: DeviceLike = None) -> CqpskState:
    dev = resolve_device(device)
    rrc = design_rrc_cqpsk(float(cfg.sample_rate), cfg.symbol_rate, cfg.rrc_alpha)
    t = max(cfg.equalizer_taps, 0)
    if t != 0 and t % 2 != 1:
        raise ValueError("equalizer_taps must be odd (or 0 = off)")
    lags = 0
    if t > 0:
        lags = _eq_candidates(float(cfg.sample_rate), cfg.symbol_rate, cfg.rrc_alpha,
                              int(cfg.eq_max_delay))[2] + 1

    def scalar(v, dtype=torch.float32):
        return torch.tensor(v, dtype=dtype, device=dev)

    return CqpskState(
        rrc_tail=ops.fir_init(len(rrc), torch.complex64, device=dev),
        interp_tail=torch.zeros(INTERP_TAIL, dtype=torch.complex64, device=dev),
        pos=scalar(float(INTERP_TAIL)),
        freq=scalar(0.0),  # set from sps on first block
        integrator=scalar(0.0),
        prev_sym=scalar(0.0, torch.complex64),
        bias=scalar(0.0),
        cfo_hz=scalar(0.0),
        cfo_phase=torch.zeros((), dtype=torch.uint32, device=dev),
        eq_taps=eqz.init_taps(t, dev),
        eq_tail=torch.zeros(max(t - 1, 0), dtype=torch.complex64, device=dev),
        eq_acf=torch.zeros(lags, dtype=torch.complex64, device=dev),
        eq_hits=scalar(0, torch.int32),
    )


def n_symbols_per_block(cfg: CqpskConfig, block_len: int) -> int:
    return int(round(block_len / cfg.sps))


# --- K13: the 4th-power spectrum and its line search --------------------------------

K13_CLUSTER = 8  # CTAs a row of K13_cfo_lines: the portable cluster size


class CfoLinesPlan(NamedTuple):
    """How K13_cfo_lines runs, as the kernel takes it: ``cluster`` CTAs a
    row; rank ``c`` sums bins ``[c bins, (c + 1) bins)`` for the mean and
    searches candidates ``[c per, (c + 1) per)``; ``split`` is
    :func:`cfo_wrap_split` packed as ``(b1, b2, dp0, dm0, dp1, dm1, dp2,
    dm2)`` (three ranges, empty ones at the end); ``centre`` the two bins of
    the zero-offset candidate ``j = k4``; ``ctas`` the launch's."""

    cluster: int
    bins: int
    per: int
    split: tuple
    centre: tuple
    ctas: int


def cfo_wrap_split(size: int, k4: int, off: int) -> list:
    """The candidates ``j = 0 .. 2 k4`` cut where one of their bins
    ``(j - k4 +- off) mod size`` wraps: at most three contiguous ranges
    ``(start, end, dp, dm)``, in which candidate ``j`` reads bins ``j + dp``
    and ``j + dm``, all in ``[0, size)``."""
    n = 2 * k4 + 1
    cuts = {0}
    for first in (-k4 + off, -k4 - off):  # the bin of candidate 0, before the wrap
        r = first % size
        if 0 < size - r < n:  # the bins reach size: they wrap to 0 at j = size - r
            cuts.add(size - r)
    starts = sorted(cuts)
    ends = starts[1:] + [n]
    return [(a, b, (a - k4 + off) % size - a, (a - k4 - off) % size - a) for a, b in zip(starts, ends)]


def cfo_lines_plan(rows: int, size: int, k4: int, off: int, cluster: int = K13_CLUSTER) -> CfoLinesPlan:
    """K13_cfo_lines' plan for ``rows`` rows of ``size`` bins (a power of 2,
    >= 1,024) and ``2 k4 + 1`` candidates."""
    ranges = cfo_wrap_split(size, k4, off)
    n = 2 * k4 + 1
    ranges += [(n, n, 0, 0)] * (3 - len(ranges))
    split = (ranges[1][0], ranges[2][0]) + tuple(d for r in ranges for d in r[2:])
    return CfoLinesPlan(cluster, size // cluster, -(-n // cluster), split, (off % size, -off % size),
                        rows * cluster)


def cfo_power_plain(filt: torch.Tensor, size: int) -> torch.Tensor:
    """Plain version of K13_cfo_power: ``x^4`` of the rows ``(R, n)``,
    zero-padded to ``(R, size)``."""
    p4 = filt * filt
    p4 = p4 * p4
    buf = torch.zeros((filt.shape[0], size), dtype=p4.dtype, device=filt.device)
    buf[:, : filt.shape[-1]] = p4
    return buf


def cfo_power(filt: torch.Tensor, size: int) -> torch.Tensor:
    """K13_cfo_power: see :func:`cfo_power_plain`.  Only a CPU tensor takes
    the plain version."""
    if filt.device.type == "cpu":
        return cfo_power_plain(filt, size)
    if filt.dim() != 2 or filt.dtype != torch.complex64:
        raise ValueError("K13_cfo_power takes complex64 rows of shape (R, n)")
    rows, n = filt.shape
    if not 0 <= n <= size or size % 2:
        raise ValueError(f"K13_cfo_power pads {n} samples to an even size >= n, not {size}")
    buf = torch.empty((rows, size), dtype=torch.complex64, device=filt.device)
    launch("K13_cfo_power", filt.device, filt.contiguous(), rows, n, size, buf)
    return buf


def cfo_lines_plain(spec: torch.Tensor, k4: int, off: int, df_step: float):
    """Plain version of K13_cfo_lines over the complex spectrum ``X`` ``(R,
    size)``: with ``A = |X|``, ``M[k] = A[(k+off) % size] + A[(k-off) %
    size]`` for ``k`` in ``-k4..k4``, the first argmax ``j``, and ``(j - k4)
    df_step`` where the line is significant (``M[j] > 8 mean(A)`` and ``>
    1.5 M[k4]``), else 0.  Returns ``(resid_hz, j)``."""
    spec = torch.abs(spec)
    size = spec.shape[-1]
    k = torch.arange(-k4, k4 + 1, device=spec.device)
    m = spec[:, (k + off) % size] + spec[:, (k - off) % size]
    j = torch.argmax(m, dim=-1)
    mj = m.gather(1, j[:, None])[:, 0]
    df = (j - k4).to(torch.float32) * df_step
    sig = (mj > 8.0 * spec.mean(-1)) & (mj > 1.5 * m[:, k4])
    return torch.where(sig, df, torch.zeros_like(df)), j.to(torch.int32)


def cfo_lines(spec: torch.Tensor, k4: int, off: int, df_step: float):
    """K13_cfo_lines: see :func:`cfo_lines_plain`.  Only a CPU tensor takes
    the plain version."""
    if spec.device.type == "cpu":
        return cfo_lines_plain(spec, k4, off, df_step)
    dev = spec.device
    if spec.dim() != 2 or spec.dtype != torch.complex64:
        raise ValueError("K13_cfo_lines takes complex64 spectra of shape (R, size)")
    rows, size = spec.shape
    if not 0 < 2 * k4 + 1 <= size or size % (2 * K13_CLUSTER):
        raise ValueError(f"K13_cfo_lines has {2 * k4 + 1} candidates for {size} bins")
    plan = cfo_lines_plan(rows, size, k4, off)
    resid = torch.empty(rows, dtype=torch.float32, device=dev)
    j = torch.empty(rows, dtype=torch.int32, device=dev)
    launch("K13_cfo_lines", dev, spec.contiguous(), rows, size, k4, plan.cluster, plan.per, *plan.split,
           *plan.centre, float(df_step), resid, j)
    return resid, j


def _cfo_search(cfg: CqpskConfig, n: int) -> tuple:
    """``(fft size, k4, off, df_step)`` of the 4th-power search on n samples."""
    fs = float(cfg.sample_rate)
    rs = float(cfg.symbol_rate)
    size = 1 << int(np.ceil(np.log2(max(int(n), 1024))))
    span = min(cfg.cfo_span_hz, 0.249 * rs)
    k4 = max(1, int(round(4.0 * span / fs * size)))
    off = int(round(rs / 2.0 / fs * size))
    return size, k4, off, float(np.float32(fs / size / 4.0))


def _estimate_cfo_residual(filt: torch.Tensor, cfg: CqpskConfig) -> torch.Tensor:
    """Feedforward CFO estimate per row from the 4th-power spectrum:
    pi/4-DQPSK's ``x^4`` carries lines at ``4 CFO +- Rs/2``; the joint
    two-line search is unambiguous for |CFO| < Rs/4.  0 where no line is
    significant (dead air), so the carried ``cfo_hz`` freezes.  K13_cfo_power
    writes ``x^4`` padded to the FFT's size, cuFFT transforms it, and
    K13_cfo_lines searches the spectrum."""
    size, k4, off, df_step = _cfo_search(cfg, filt.shape[-1])
    spec = torch.fft.fft(cfo_power(filt, size), dim=-1)
    return cfo_lines(spec, k4, off, df_step)[0]


# --- the simulcast equalizer ---------------------------------------------------------


@lru_cache(maxsize=8)
def _eq_candidates(
    sample_rate: float, symbol_rate: float, alpha: float, max_delay: int
) -> tuple:
    """CQPSK candidate grid: the clean post-RX-RRC acf ``ifft(|R|^4)``
    template; noise passes the RX RRC, so its acf is the RRC's."""
    nfft = EQ_NFFT
    rrc = design_rrc_cqpsk(sample_rate, symbol_rate, alpha)
    R2 = np.abs(np.fft.fft(rrc, nfft)) ** 2
    r_s = np.fft.ifft(R2 * R2).real
    r_s = r_s / r_s[0]
    rho = np.fft.ifft(R2).real
    rho = rho / rho[0]
    n_tau = max_delay + 12
    return eqz.build_candidates(
        r_s[: n_tau + max_delay + 1].astype(np.complex64),
        rho[: n_tau + 1].astype(np.float64),
        max_delay,
    )


@lru_cache(maxsize=8)
def _eq_grid(sample_rate: float, symbol_rate: float, alpha: float, max_delay: int,
             device: torch.device) -> eqz.EchoGrid:
    return eqz.grid_on(_eq_candidates(sample_rate, symbol_rate, alpha, max_delay), device)


def _cfg_grid(cfg: CqpskConfig, device: torch.device) -> eqz.EchoGrid:
    return _eq_grid(float(cfg.sample_rate), cfg.symbol_rate, cfg.rrc_alpha,
                    int(cfg.eq_max_delay), device)


def _echo_mmse_taps(x, acf_acc, cfg: CqpskConfig, enable=None) -> tuple:
    """Fit the LSM echo channel per row and build its MMSE inverse."""
    return eqz.fit_and_invert(x, acf_acc, _cfg_grid(cfg, x.device), cfg.equalizer_taps,
                              cfg.eq_lambda, enable=enable)


# --- K13: block timing and differential detection --------------------------------------


def _timing_state(state: CqpskState) -> torch.Tensor:
    """K13's carried scalars, ``(6, R)`` f32: pos, freq, integrator,
    bias, and the previous symbol's real and imaginary parts."""
    return torch.stack([state.pos, state.freq, state.integrator, state.bias,
                        state.prev_sym.real, state.prev_sym.imag])


def cqpsk_timing_plain(buf, st, n_sym: int, cfg: CqpskConfig):
    """Plain version of K13's timing over complex rows ``buf =
    interp_tail ++ filt`` ``(R, 64 + n)`` and the carried scalars ``st``
    ``(6, R)``.  Returns ``(soft, dibits, out)``, ``out`` ``(6, R)``: the
    recentered pos, freq, integrator, bias and the last symbol (re, im)."""
    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002)
    pos, freq_in, integ_in, bias_in = st[0], st[1], st[2], st[3]
    prev_sym = torch.complex(st[4], st[5])
    freq0 = torch.where(freq_in < 1.0, torch.full_like(freq_in, c.sps), freq_in)
    filt = buf[:, INTERP_TAIL:]
    u = torch.abs(filt) ** 2
    lock, slope, delta_om = om_line(u, u.sum(-1), pos, c)

    m = torch.arange(n_sym, dtype=torch.float32, device=buf.device)
    base = pos[:, None] + m * freq0[:, None]
    hi = float(buf.shape[-1] - 2)

    def gardner(off):
        p = base + off[:, None]
        y = _sample(buf, p, hi)
        ym = _sample(buf, p - (freq0 * 0.5)[:, None], hi)
        g = (torch.conj(ym[:, 1:]) * (y[:, :-1] - y[:, 1:])).real.mean(-1)
        return g / (torch.abs(y) ** 2).mean(-1).clamp_min(1e-6)

    delta = newton_phase(gardner, delta_om, c)
    sig = lock > c.lock  # dead-air gate: no symbol-rate line -> freeze timing
    delta = torch.where(sig, delta, torch.zeros_like(delta))
    slope = torch.where(sig, slope, torch.zeros_like(slope))
    integ, freq = loop_update(integ_in, slope, delta, n_sym, c)
    syms = _sample(buf, base + (delta[:, None] + slope[:, None] * (m - 0.5 * n_sym)), hi)
    return _detect(buf, syms, prev_sym, bias_in, pos + delta + n_sym * freq, freq, integ, c)


def _detect(buf, syms, prev_sym, bias_in, pos_end, freq, integ, c: TimingConsts):
    """Differential detection of the symbols ``syms`` ``(R, n_sym)`` after
    the carried one (``prev_sym``) and the slow bias tracker, shared by
    the block timing and the scan: ``(soft, dibits, out)``, ``out`` the
    recentered position, freq, integrator, bias and the last symbol."""
    # differential phase detection (includes the block-boundary carry)
    prev_syms = torch.cat([prev_sym[:, None], syms[:, :-1]], dim=-1)
    z = syms * torch.conj(prev_syms)
    dphi = torch.atan2(z.imag, z.real)
    # residual carrier offset shows as a constant bias: track it slowly via
    # the distance to the nearest pi/4 constellation point
    quant = torch.round(_div(dphi - bias_in[:, None], _QUARTER_PI)).clamp(-3.0, 3.0)
    resid = dphi - bias_in[:, None] - quant * _QUARTER_PI
    bias = bias_in + 0.02 * resid.mean(-1)
    soft = _div(dphi - bias[:, None], _QUARTER_PI)
    last = syms[:, -1]
    out = torch.stack([recenter(pos_end - float(buf.shape[-1] - INTERP_TAIL), c), freq, integ,
                       bias, last.real, last.imag])
    return soft, soft_to_dibits(soft), out


def cqpsk_scan_plain(buf, st, n_sym: int, cfg: CqpskConfig):
    """Plain version of K13s, the per-symbol timing of
    ``timing_impl="scan"`` (the complex Gardner loop), over complex rows
    ``buf`` and the carried scalars ``st`` ``(6, R)``, then the block
    branch's detector.  Returns ``(soft, dibits, out)`` as
    :func:`cqpsk_timing_plain`."""
    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002)
    pos, freq_in, integ, bias_in = st[0], st[1], st[2], st[3]
    prev_sym = torch.complex(st[4], st[5])
    freq0 = torch.where(freq_in < 1.0, torch.full_like(freq_in, c.sps), freq_in)

    def sample(p):
        return interp_clamped(buf, p)

    def error(y, y_mid, prev):
        # the complex Gardner TED, Re(conj(y_mid) (prev - y))
        d = prev - y
        return (y_mid.real * d.real + y_mid.imag * d.imag).clamp(-2.0, 2.0)

    syms, pos, freq, integ, _ = scan_loop(sample, pos, freq0, integ, prev_sym, n_sym, c,
                                          _loop_gains(cfg), error)
    return _detect(buf, syms, prev_sym, bias_in, pos, freq, integ, c)


def cqpsk_scan(buf, st, n_sym: int, cfg: CqpskConfig):
    """K13s: see :func:`cqpsk_scan_plain`.  Only a CPU tensor takes the
    plain version."""
    if buf.device.type == "cpu":
        return cqpsk_scan_plain(buf, st, n_sym, cfg)
    return launch_scan("K13s_cqpsk_scan", buf, st, n_sym,
                       timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002), _loop_gains(cfg))


def cqpsk_timing(buf, st, n_sym: int, cfg: CqpskConfig):
    """K13's timing: see :func:`cqpsk_timing_plain`.  Only a CPU tensor
    takes the plain version."""
    if buf.device.type == "cpu":
        return cqpsk_timing_plain(buf, st, n_sym, cfg)
    return launch_timing("K13_cqpsk_timing", buf, st, n_sym,
                         timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002))


# --- the demodulator ----------------------------------------------------------------


def cqpsk_demodulate(iq: torch.Tensor, state: CqpskState, cfg: CqpskConfig, eq_enable=None):
    """One block per row -> ``(soft_symbols, dibits, state)``; soft in
    C4FM units.  ``eq_enable`` ``(R,)`` bool is the equalizer's runtime
    guard (False holds identity taps and restarts the echo fit)."""
    if iq.dim() == 1:
        return _one_row(cqpsk_demodulate, iq, state, cfg, eq_enable)
    fs = float(cfg.sample_rate)
    dev = iq.device
    cfo_on = cfg.cfo_span_hz > 0
    if cfo_on:
        # de-rotate by the acquired offset (phase-continuous NCO)
        iq, cfo_phase = ops.freq_shift(iq, -state.cfo_hz, fs, state.cfo_phase)
    else:
        cfo_phase = state.cfo_phase
    rrc = _rrc_on(fs, cfg.symbol_rate, cfg.rrc_alpha, dev)
    filt, rrc_tail = ops.fir_filter(iq, rrc, state.rrc_tail)
    # normalize amplitude blockwise (AGC)
    scale = 1.0 / torch.sqrt((torch.abs(filt) ** 2).mean(-1)).clamp_min(1e-6)
    filt = filt * scale[:, None]

    cfo_hz = state.cfo_hz
    if cfo_on:
        # the residual offset of THIS block, removed before detection and
        # folded into the carried NCO so the next block continues exactly
        resid_hz = _estimate_cfo_residual(filt, cfg)
        if cfg.equalizer_taps > 0:
            # an echo can notch one of the two 4th-power lines, aliasing
            # the line-pair metric by Rs/4: resolve via the acf fit
            resid_hz = eqz.resolve_cfo_alias(iq, rrc, resid_hz, cfg.symbol_rate / 4.0, fs,
                                             _cfg_grid(cfg, dev))
        nf = filt.shape[-1]
        ramp = torch.arange(nf, dtype=torch.float32, device=dev) * float(
            np.float32(-2.0 * np.pi / fs))
        ph = ramp * resid_hz[:, None]
        filt = filt * torch.complex(torch.cos(ph), torch.sin(ph))
        span = float(np.float32(min(cfg.cfo_span_hz, 0.249 * float(cfg.symbol_rate))))
        cfo_hz = (state.cfo_hz + resid_hz).clamp(-span, span)
        cfo_phase = _next_phase(cfo_phase, nf, tuning_word(resid_hz, fs))

    if cfg.equalizer_taps > 0:
        # simulcast equalizer; a CFO step this block restarts the fit and
        # holds identity taps until the carrier settles
        allowed = torch.ones(iq.shape[0], dtype=torch.bool, device=dev)
        if cfo_on:
            allowed = resid_hz.abs() < 20.0
        if eq_enable is not None:
            allowed = allowed & eq_enable.to(device=dev, dtype=torch.bool)
        acf_in = torch.where(allowed[:, None], state.eq_acf, torch.zeros_like(state.eq_acf))
        est, eq_acf, sig = _echo_mmse_taps(filt, acf_in, cfg, enable=allowed)
        eq_hits, est = _engage(est, sig, allowed, state.eq_hits, cfg)
        eq_taps = cfg.eq_ema * est + (1.0 - cfg.eq_ema) * state.eq_taps
        filt, eq_tail = ops.fir_filter(filt, eq_taps, state.eq_tail)
    else:
        eq_taps, eq_tail, eq_acf = state.eq_taps, state.eq_tail, state.eq_acf
        eq_hits = state.eq_hits

    buf = torch.cat([state.interp_tail, filt], dim=-1)
    n_sym = n_symbols_per_block(cfg, iq.shape[-1])
    timing = cqpsk_timing if cfg.timing_impl == "block" else cqpsk_scan
    soft, dibits, out = timing(buf, _timing_state(state), n_sym, cfg)
    new_state = CqpskState(
        rrc_tail=rrc_tail, interp_tail=buf[:, -INTERP_TAIL:], pos=out[0], freq=out[1],
        integrator=out[2], prev_sym=torch.complex(out[4], out[5]), bias=out[3], cfo_hz=cfo_hz,
        cfo_phase=cfo_phase, eq_taps=eq_taps, eq_tail=eq_tail, eq_acf=eq_acf, eq_hits=eq_hits,
    )
    return soft, dibits, new_state


# ---------------------------------------------------------------------------
# Modulator (tests)
# ---------------------------------------------------------------------------


def modulate_cqpsk(
    dibits: np.ndarray,
    sample_rate: float = 48_000.0,
    symbol_rate: float = 4800.0,
    alpha: float = 0.2,
    amplitude: float = 1.0,
) -> np.ndarray:
    """Dibits -> pi/4-DQPSK IQ (differentially encoded phase steps)."""
    sps = sample_rate / symbol_rate
    if abs(sps - round(sps)) >= 1e-9:
        raise ValueError("integer sps required for synthesis")
    sps = int(round(sps))
    steps = DIBIT_SYMBOLS[np.asarray(dibits, np.uint8)] * (np.pi / 4)
    phases = np.cumsum(steps)
    symbols = np.exp(1j * phases)
    impulses = np.zeros(len(symbols) * sps, np.complex64)
    impulses[::sps] = symbols * sps
    h = design_rrc_cqpsk(sample_rate, symbol_rate, alpha)
    shaped = _sps.lfilter(h, 1.0, impulses)
    return (amplitude * shaped / np.abs(shaped).max()).astype(np.complex64)


def modulate_cqpsk_cyclic(
    dibits: np.ndarray,
    sample_rate: float = 48_000.0,
    symbol_rate: float = 4800.0,
    alpha: float = 0.2,
    amplitude: float = 1.0,
) -> np.ndarray:
    """Dibits -> seamlessly *loopable* pi/4-DQPSK IQ: <= 2 pad dibits
    close the differential phase to a multiple of 2 pi, and the RRC
    shaping is a circular convolution."""
    sps = sample_rate / symbol_rate
    if abs(sps - round(sps)) >= 1e-9:
        raise ValueError("integer sps required for synthesis")
    sps = int(round(sps))
    units = DIBIT_SYMBOLS[np.asarray(dibits, np.uint8)].astype(np.int64)
    residue = int(np.sum(units)) % 8  # phase in pi/4 units, mod 2*pi
    # pad steps (in {+1,+3,-1,-3}) that sum to -residue mod 8
    pads = {0: [], 1: [-1], 2: [-1, -1], 3: [-3], 4: [3, 1], 5: [3],
            6: [1, 1], 7: [1]}[residue]
    units = np.concatenate([units, np.asarray(pads, np.int64)])
    phases = np.cumsum(units * (np.pi / 4))
    symbols = np.exp(1j * phases)
    n = len(symbols) * sps
    impulses = np.zeros(n, np.complex128)
    impulses[::sps] = symbols * sps
    h = design_rrc_cqpsk(sample_rate, symbol_rate, alpha).astype(np.float64)
    h_pad = np.zeros(n)
    h_pad[: len(h)] = h
    h_pad = np.roll(h_pad, -(len(h) // 2))  # zero-delay centered pulse
    shaped = np.fft.ifft(np.fft.fft(impulses) * np.fft.fft(h_pad))
    return (amplitude * shaped / np.abs(shaped).max()).astype(np.complex64)
