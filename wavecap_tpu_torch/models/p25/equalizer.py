"""Feedforward simulcast echo equalizer shared by the P25 demods.

Counterpart of ``wavecap_tpu/models/p25/equalizer.py`` (see its module
docstring for the method and its caveats).  Simulcast distortion is a
two-transmitter single-echo channel ``H(w) = 1 + a e^{j theta} e^{-j w d}``;
the echo is identified by matching the block autocorrelation against a
precomputed grid of predicted acfs (``build_candidates``, host numpy kept
verbatim so the table is bit-identical), and the regularized MMSE
inverse ``W = conj(H)/(|H|^2 + lambda)`` becomes FIR taps.

Every function is batched over a leading row (slot) axis: ``x`` is
``(R, n)``, the carried acf ``(R, n_tau+1)``, ``enable`` ``(R,)``.

Kernel K14 ``echo_fit`` carries the fit on the card, with its plain
version here: the block acf over the lags (normalised, the finiteness
guard, the EMA and the enable guard), the residual against every
candidate with the first argmin, the gate, and the 41 taps synthesised
as a direct inverse DFT of ``W`` at the needed indices.  Its score mode
(the minimum residual only) serves ``resolve_cfo_alias``.  The acf
streams each row through a cluster of CTAs (:func:`k14_plan`), so a
row may have any length.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ...kernels import launch
from ...ops import fir as fir_ops
from ...utils.torchenv import DeviceLike, resolve_device

EQ_NFFT = 512
_W_GRID = (2.0 * np.pi * np.arange(EQ_NFFT) / EQ_NFFT).astype(np.float32)


def init_taps(n_taps: int, device: DeviceLike = None) -> torch.Tensor:
    w0 = np.zeros(max(n_taps, 0), np.complex64)
    if n_taps > 0:
        w0[n_taps // 2] = 1.0
    return torch.from_numpy(w0).to(resolve_device(device))


@lru_cache(maxsize=16)
def _identity(n_taps: int, device: torch.device) -> torch.Tensor:
    """Identity taps, cached per device (no upload each block)."""
    return init_taps(n_taps, device)


@lru_cache(maxsize=16)
def _inverse_dft_tables(n_taps: int, device: torch.device) -> tuple:
    """The f32 frequency grid and the FIR window's FFT indices on ``device``."""
    return (torch.from_numpy(_W_GRID).to(device),
            torch.from_numpy((np.arange(n_taps) - n_taps // 2) % EQ_NFFT).to(device))


def build_candidates(
    r_ref: np.ndarray, noise_acf: np.ndarray, max_delay: int
) -> tuple:
    """Predicted normalized acfs for every (d, theta, a, nu) candidate.

    ``r_ref``: clean-signal acf for lags 0..n_tau+max_delay (the extra
    tail feeds the shifted-template lookups at t+d; conjugate-symmetric
    continuation used for negative lags); ``noise_acf``: the noise
    process's acf over lags 0..n_tau (a delta for white noise ahead of
    the receive filtering, the filter acf after it).  Candidate 0 is the
    no-echo model used for gating.  Returns (preds, params, n_tau) with
    ``preds`` (n_cand, n_tau+1) complex64 normalized to preds[:,0]=1 and
    ``params`` rows (d, theta, a)."""
    n_tau = len(r_ref) - 1 - max_delay
    n_ext = len(r_ref) - 1

    def rr(k: int) -> complex:
        if abs(k) > n_ext:
            return 0.0j
        return complex(r_ref[k]) if k >= 0 else complex(np.conj(r_ref[-k]))

    cands = [(0.0, 0.0, 0.0, 0.0)]
    for d in range(1, max_delay + 1):
        for th in np.linspace(0, 2 * np.pi, 32, endpoint=False):
            for a in (0.15, 0.25, 0.35, 0.45, 0.55, 0.65, 0.75, 0.85):
                for nu in (0.0, 0.1, 0.25):
                    cands.append((float(d), float(th), float(a), float(nu)))
    taus = np.arange(n_tau + 1)
    preds = np.zeros((len(cands), n_tau + 1), np.complex64)
    for i, (d, th, a, nu) in enumerate(cands):
        di = int(d)
        r = np.array(
            [
                (1 + a * a) * rr(t)
                + a * np.exp(1j * th) * rr(t - di)
                + a * np.exp(-1j * th) * rr(t + di)
                for t in taus
            ]
        )
        r = r + nu * noise_acf[: n_tau + 1]
        preds[i] = (r / r[0].real).astype(np.complex64)
    params = np.asarray([(c[0], c[1], c[2]) for c in cands], np.float32)
    return preds, params, n_tau


class EchoGrid(NamedTuple):
    """A candidate table on a device: ``preds`` (C, n_tau+1) complex64,
    ``params`` (C, 3) f32 rows (d, theta, a)."""

    preds: torch.Tensor
    params: torch.Tensor
    n_tau: int


def grid_on(table: tuple, device: torch.device) -> EchoGrid:
    preds, params, n_tau = table
    return EchoGrid(torch.as_tensor(preds).to(device), torch.as_tensor(params).to(device), int(n_tau))


def block_acf(x: torch.Tensor, n_tau: int) -> torch.Tensor:
    """Normalized complex acf of each row, ``mean(x[tau:] conj(x[:n-tau]))``
    over the real lag-0 power, for lags 0..n_tau."""
    n = x.shape[-1]
    xc = torch.conj(x)
    r = torch.stack([(x[:, tau:] * xc[:, : n - tau]).mean(-1) for tau in range(n_tau + 1)], -1)
    d = r[:, :1].real.clamp_min(1e-9)
    return torch.complex(r.real / d, r.imag / d)


def _lag_products(x: torch.Tensor, n_tau: int) -> torch.Tensor:
    """:func:`block_acf`, zeroed on a row that is not finite (a
    pathological block must not poison the EMA)."""
    r = block_acf(x, n_tau)
    finite = torch.isfinite(r.real).all(-1) & torch.isfinite(r.imag).all(-1)
    return torch.where(finite[:, None], r, torch.zeros_like(r))


def _residuals(acf: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """``sum_k |preds[c, k] - acf[r, k]|^2`` as ``(R, C)``."""
    return (torch.abs(preds[None, :, :] - acf[:, None, :]) ** 2).sum(-1)


def _mmse_taps(a: torch.Tensor, theta: torch.Tensor, d: torch.Tensor, n_taps: int,
               lam: float) -> torch.Tensor:
    """The windowed inverse FFT of ``conj(H)/(|H|^2 + lam)`` per row."""
    w, idx = _inverse_dft_tables(n_taps, a.device)
    ph = -(w[None, :] * d[:, None])
    e = torch.complex(torch.cos(ph), torch.sin(ph))
    ae = torch.complex(a * torch.cos(theta), a * torch.sin(theta))
    h = 1.0 + ae[:, None] * e
    den = torch.abs(h) ** 2 + lam
    wk = torch.complex(h.real / den, -h.imag / den)
    return torch.fft.ifft(wk, dim=-1)[:, idx].to(torch.complex64)


# --- K14: echo fit --------------------------------------------------------------


class K14Plan(NamedTuple):
    """How K14's acf pass splits a row of ``n`` samples: ``ctas`` CTAs (one
    thread-block cluster) a row, ``threads`` a CTA, each taking ``per``
    consecutive samples of a pass of ``chunk`` samples and reading their
    ``lookback`` (the lags less one) from the staged chunk; CTA ``c`` of a
    row takes the passes ``c, c + ctas, ...``.  Each thread sums its
    samples' products lag by lag, each CTA its threads' sums (four chains
    over the threads, each thread's sums in order), and the CTAs of a row
    their sums in rank order.  ``kernels/csrc/echo_fit.cu`` computes the
    same plan (``acf_ctas``) from its constants."""

    ctas: int
    threads: int
    per: int
    chunk: int
    lookback: int


K14_THREADS = 128  # echo_fit.cu: kAcfThreads
K14_PER = 8  # kPer
K14_MAX_CTAS = 8  # kMaxCtas


def k14_plan(n: int, lags: int) -> K14Plan:
    """The acf pass's launch plan for rows of ``n`` samples and ``lags`` lags."""
    chunk = K14_THREADS * K14_PER
    ctas = min(max(-(-int(n) // chunk), 1), K14_MAX_CTAS)
    return K14Plan(ctas, K14_THREADS, K14_PER, chunk, int(lags) - 1)


def echo_fit_plain(x, acf_acc, enable, grid: EchoGrid, n_taps: int, lam: float,
                   a_floor: float, gate_ratio: float, acf_ema: float):
    """Plain version of K14's fit: ``(taps, acf, significant, j)`` per row."""
    r = _lag_products(x, grid.n_tau)
    seen = torch.abs(acf_acc).sum(-1) > 0
    acf = torch.where(seen[:, None], (1.0 - acf_ema) * acf_acc + acf_ema * r, r)
    acf = torch.where(enable[:, None], acf, torch.zeros_like(acf))
    resid = _residuals(acf, grid.preds)
    j = torch.argmin(resid, dim=-1)
    d, theta, a = grid.params[j].unbind(-1)
    rj = resid.gather(1, j[:, None])[:, 0]
    sig = (rj < gate_ratio * resid[:, 0]) & (a >= a_floor) & enable
    a = torch.where(sig, a, torch.zeros_like(a))
    taps = _mmse_taps(a, theta, d, n_taps, lam)
    taps = torch.where(enable[:, None], taps, _identity(n_taps, x.device)[None, :])
    return taps, acf, sig, j.to(torch.int32)


def echo_score_plain(x, grid: EchoGrid) -> torch.Tensor:
    """Plain version of K14's score mode: the least residual of each row's
    normalized acf over the candidates."""
    return _residuals(_lag_products(x, grid.n_tau), grid.preds).min(-1).values


def _k14(x, grid: EchoGrid, acf_acc=None, enable=None, n_taps=0, lam=0.0, a_floor=0.0,
         gate_ratio=0.0, acf_ema=0.0):
    dev = x.device
    if x.dim() != 2 or x.dtype != torch.complex64:
        raise ValueError("K14 takes complex64 rows of shape (R, n)")
    rows, n = x.shape
    lags = grid.n_tau + 1
    if lags > 32:
        raise NotImplementedError(f"K14 fits at most 32 lags, not {lags}")
    if grid.preds.device != dev or grid.preds.dtype != torch.complex64:
        raise ValueError("K14's candidate table must be complex64 on the input's device")
    x = x.contiguous()
    fit = acf_acc is not None
    acf = torch.empty((rows, lags), dtype=torch.complex64, device=dev)
    best = torch.empty(rows, dtype=torch.int64, device=dev)
    score = torch.empty(rows, dtype=torch.float32, device=dev)
    taps = sig = j = None
    if fit:
        if acf_acc.shape != (rows, lags) or acf_acc.dtype != torch.complex64:
            raise ValueError(f"K14's carried acf must be complex64 ({rows}, {lags})")
        acf_acc = acf_acc.to(dev).contiguous()
        enable = enable.to(device=dev, dtype=torch.bool).contiguous()
        taps = torch.empty((rows, n_taps), dtype=torch.complex64, device=dev)
        sig = torch.empty(rows, dtype=torch.bool, device=dev)
        j = torch.empty(rows, dtype=torch.int32, device=dev)
    launch("K14_echo_fit", dev, x, rows, n, grid.n_tau, grid.preds.contiguous(),
           grid.params.contiguous(), grid.preds.shape[0], acf_acc, enable, acf, best, score,
           taps, sig, j, n_taps, float(lam), float(a_floor), float(gate_ratio), float(acf_ema),
           int(fit))
    return acf, score, taps, sig, j


def echo_fit(x, acf_acc, enable, grid: EchoGrid, n_taps: int, lam: float, a_floor: float,
             gate_ratio: float, acf_ema: float):
    """K14: see :func:`echo_fit_plain`.  Only a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return echo_fit_plain(x, acf_acc, enable, grid, n_taps, lam, a_floor, gate_ratio, acf_ema)
    acf, _, taps, sig, j = _k14(x, grid, acf_acc, enable, n_taps, lam, a_floor, gate_ratio,
                                acf_ema)
    return taps, acf, sig, j


def echo_score(x, grid: EchoGrid) -> torch.Tensor:
    """K14's score mode: see :func:`echo_score_plain`."""
    if x.device.type == "cpu":
        return echo_score_plain(x, grid)
    return _k14(x, grid)[1]


# --- the reference's entry points ------------------------------------------------


def resolve_cfo_alias(
    iq: torch.Tensor,
    rx_filt: torch.Tensor,
    df: torch.Tensor,
    alias_hz: float,
    sample_rate: float,
    grid: EchoGrid,
    margin: float = 0.8,
) -> torch.Tensor:
    """Disambiguate each row's 4th-power CFO estimate ``df`` (R,) under
    multipath: score ``df`` and ``df -+ alias_hz`` by their best echo-grid
    fit, each de-rotating the raw rows and re-filtering them with
    ``mode="same"``; move off ``df`` only on a decisive (``margin``) win.
    The three candidates of every row go through one K7 and one K14
    launch."""
    rows, n = iq.shape
    idx = torch.arange(n, dtype=torch.float32, device=iq.device)
    t = idx / torch.full_like(idx, sample_rate)  # an IEEE division on every device
    cands = torch.stack([df, df - alias_hz, df + alias_hz])  # (3, R)
    ph = (np.float32(-2.0 * np.pi) * cands)[..., None] * t
    x = iq[None] * torch.complex(torch.cos(ph), torch.sin(ph))
    filt = fir_ops.conv_same(x.reshape(3 * rows, n), rx_filt)
    s0, s_lo, s_hi = echo_score(filt, grid).reshape(3, rows)
    return torch.where(
        s_lo < torch.minimum(s0 * margin, s_hi),
        cands[1],
        torch.where(s_hi < s0 * margin, cands[2], df),
    )


def fit_and_invert(
    x: torch.Tensor,
    acf_acc: torch.Tensor,
    grid: EchoGrid,
    n_taps: int,
    lam: float,
    a_floor: float = 0.35,
    gate_ratio: float = 0.6,
    acf_ema: float = 0.5,
    enable=None,
) -> tuple:
    """One block of the echo fit per row: measure the acf (EMA'd with the
    carried ``acf_acc``), match the candidate grid, synthesize the MMSE
    inverse.  Returns ``(taps, new_acf_state, significant)``; identity
    taps (and ``significant`` False) when the block is too small, no
    material echo is found, or the echo model does not beat the no-echo
    candidate decisively.  ``enable`` (R,) bool False forces identity taps
    and restarts the acf estimate."""
    rows, n = x.shape
    if n < 4 * (grid.n_tau + 1):  # static: block too small to estimate
        ident = _identity(n_taps, x.device).expand(rows, n_taps).contiguous()
        return ident, acf_acc, torch.zeros(rows, dtype=torch.bool, device=x.device)
    if enable is None:
        enable = torch.ones(rows, dtype=torch.bool, device=x.device)
    taps, acf, sig, _ = echo_fit(x, acf_acc, enable, grid, n_taps, lam, a_floor, gate_ratio,
                                 acf_ema)
    return taps, acf, sig
