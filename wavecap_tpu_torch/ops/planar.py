"""Planar-complex kernels: IQ as (real, imag) f32 planes, DFTs as matmuls.

Counterpart of ``wavecap_tpu/ops/planar.py``.  The tables are the
reference's, built in float64 with numpy and cast to f32, so both sides
multiply by the same numbers.  Matmuls run in full f32 (TF32 is off, see
``torchenv``).

* The DFTs (``planar_matmul_dft``, ``planar_factored_dft``) are the plain
  versions of the channelizer's cross-arm DFT (kernel K2 in
  ``ops/channelizer.py``).
* ``planar_channelize`` is the channelizer on planes.  On the card it
  joins the planes into one complex block and runs K1 ``unpack_arms`` and
  K2 ``arm_dft``, as ``channelize`` does, at every M (the reference's
  planar channelizer is a matmul DFT even where M is a power of two).  Its
  plain version, :func:`planar_channelize_plain`, is the reference's own
  formulation: two parity stacks, the single matmul DFT, the twiddle, the
  odd-step sign and the interleave.
* ``planar_power_spectrum`` is the windowed spectrum as four f32 matmuls
  against the cos/sin tables, on every device, as the reference computes
  it.
* ``planar_freq_shift`` (the exact uint32 NCO of ``ops/nco.py``),
  ``planar_quadrature_demod`` (the exact ``atan2``) and
  ``planar_rssi_dbfs`` are elementwise torch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device
# design_prototype: unused here, kept as the reference's module imports it
from .channelizer import ChannelizerConfig, _arms_rev, _epilogue_tables, arm_dft, design_prototype, unpack_arms
from .nco import _as_u32, _next_phase, nco_phases, tuning_word


@lru_cache(maxsize=16)
def dft_matrices(m: int, inverse: bool = False):
    """(cos, sin) of the DFT: X[c] = sum_k x[k] * exp(-+2pi i k c / m)."""
    k = np.arange(m)
    ang = 2.0 * np.pi * np.outer(k, k) / m
    sign = 1.0 if inverse else -1.0
    return np.cos(ang).astype(np.float32), (sign * np.sin(ang)).astype(np.float32)


def _t(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def planar_matmul_dft(re: torch.Tensor, im: torch.Tensor, m: int, inverse: bool = False):
    """Batched DFT over the last axis via two real matmuls per plane."""
    c, s = dft_matrices(m, inverse)
    cj, sj = _t(c, re), _t(s, re)
    yr = re @ cj - im @ sj
    yi = re @ sj + im @ cj
    return yr, yi


@lru_cache(maxsize=16)
def _dft_factor(m: int) -> tuple[int, int] | None:
    """Split ``m = m1 * m2`` with both factors >= 8, closest to sqrt(m);
    None if no such factorization exists (prime-ish m)."""
    best = None
    for m1 in range(8, int(np.sqrt(m)) + 1):
        if m % m1 == 0 and m // m1 >= 8:
            best = (m1, m // m1)
    return best


@lru_cache(maxsize=16)
def _factored_mats(m: int, inverse: bool):
    m1, m2 = _dft_factor(m)  # type: ignore[misc]
    sign = 1.0 if inverse else -1.0
    a1 = 2.0 * np.pi * np.outer(np.arange(m1), np.arange(m1)) / m1
    a2 = 2.0 * np.pi * np.outer(np.arange(m2), np.arange(m2)) / m2
    tw = 2.0 * np.pi * np.outer(np.arange(m1), np.arange(m2)) / m
    return (
        (np.cos(a1).astype(np.float32), (sign * np.sin(a1)).astype(np.float32)),
        (np.cos(a2).astype(np.float32), (sign * np.sin(a2)).astype(np.float32)),
        (np.cos(tw).astype(np.float32), (sign * np.sin(tw)).astype(np.float32)),
    )


def planar_factored_dft(re: torch.Tensor, im: torch.Tensor, m: int, inverse: bool = False):
    """Two-stage Cooley-Tukey DFT as planar matmuls.

    With k = m2*k1 + k2 and c = c1 + m1*c2: a stage-1 m1-point DFT over
    k1, a twiddle by c1*k2, a stage-2 m2-point DFT over k2, then the
    (c1, c2) -> c1 + m1*c2 reorder.
    """
    (c1m, s1m), (c2m, s2m), (twc, tws) = _factored_mats(m, inverse)
    m1, m2 = c1m.shape[0], c2m.shape[0]
    c1j, s1j, c2j, s2j = (_t(a, re) for a in (c1m, s1m, c2m, s2m))
    twcj, twsj = _t(twc, re), _t(tws, re)

    lead = re.shape[:-1]
    xr = re.reshape(lead + (m1, m2))
    xi = im.reshape(lead + (m1, m2))

    def mm1(x, mat):  # stage 1: DFT over k1 -> A[..., c1, k2]
        return torch.einsum("...ab,ac->...cb", x, mat)

    ar = mm1(xr, c1j) - mm1(xi, s1j)
    ai = mm1(xr, s1j) + mm1(xi, c1j)

    br = ar * twcj - ai * twsj
    bi = ar * twsj + ai * twcj

    def mm2(x, mat):  # stage 2: DFT over k2 -> X[..., c1, c2]
        return torch.einsum("...cb,bd->...cd", x, mat)

    yr = mm2(br, c2j) - mm2(bi, s2j)
    yi = mm2(br, s2j) + mm2(bi, c2j)

    yr = yr.transpose(-1, -2).reshape(lead + (m,))
    yi = yi.transpose(-1, -2).reshape(lead + (m,))
    return yr, yi


# --- elementwise planar ops ---------------------------------------------------


def planar_freq_shift(re: torch.Tensor, im: torch.Tensor, offset_hz, sample_rate: float, phase0_u32=0):
    """Planar mirror of ``ops.freq_shift``; returns ``(re, im, next_phase)``
    with the phase a uint32 tensor, as ``freq_shift`` returns it."""
    n = re.shape[-1]
    dphi = tuning_word(offset_hz, sample_rate, device=re.device)
    p0 = _as_u32(phase0_u32, re.device)
    ph = nco_phases(n, dphi, p0)
    c, s = torch.cos(ph), torch.sin(ph)
    return re * c - im * s, re * s + im * c, _next_phase(p0, n, dphi)


def planar_quadrature_demod(re: torch.Tensor, im: torch.Tensor, sample_rate: float, prev_re: torch.Tensor,
                            prev_im: torch.Tensor, max_deviation_hz: float = 75_000.0):
    """Planar FM discriminator; returns ``(audio, last_re, last_im)``."""
    pre = torch.cat([prev_re[..., None], re[..., :-1]], dim=-1)
    pim = torch.cat([prev_im[..., None], im[..., :-1]], dim=-1)
    pr = re * pre + im * pim
    pi = im * pre - re * pim
    scale = float(np.float32(sample_rate / (2.0 * np.pi * max_deviation_hz)))
    return (torch.atan2(pi, pr) * scale).to(torch.float32), re[..., -1], im[..., -1]


def planar_rssi_dbfs(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    p = torch.mean(re * re + im * im, dim=-1)
    return 10.0 * torch.log10(p.clamp_min(1e-20))


# --- the channelizer on planes --------------------------------------------------


def planar_channelizer_init(cfg: ChannelizerConfig, device: DeviceLike = None):
    """History carry as two f32 planes of the last ``M*T`` input samples."""
    n = cfg.channel_count * cfg.taps_per_channel
    dev = resolve_device(device)
    return torch.zeros(n, dtype=torch.float32, device=dev), torch.zeros(n, dtype=torch.float32, device=dev)


def _history(hist: torch.Tensor, x: torch.Tensor, h: int) -> torch.Tensor:
    """The last ``h`` samples of ``hist ++ x``."""
    n = x.shape[-1]
    return x[n - h:].clone() if n >= h else torch.cat([hist, x])[-h:]


def planar_channelize_plain(re: torch.Tensor, im: torch.Tensor, state, cfg: ChannelizerConfig):
    """Plain version of :func:`planar_channelize`, the reference's
    formulation on planes."""
    m, t = cfg.channel_count, cfg.taps_per_channel
    if re.shape[-1] % m != 0:
        raise ValueError(f"block length {re.shape[-1]} must be a multiple of M={m}")
    r_steps = re.shape[-1] // m
    dev = re.device
    arms = _arms_rev(m, t, cfg.cutoff_scale, dev)
    hist_re, hist_im = state
    xr = torch.cat([hist_re, re])
    xi = torch.cat([hist_im, im])

    def parity_stack(x_ext: torch.Tensor, offset: int) -> torch.Tensor:
        w = x_ext[offset : offset + (r_steps + t - 1) * m].reshape(r_steps + t - 1, m)
        u = torch.zeros((r_steps, m), dtype=torch.float32, device=dev)
        for k in range(t):
            u = u + w[t - 1 - k : t - 1 - k + r_steps] * arms[k]
        return u

    tw, sign = _epilogue_tables(m, dev)
    tw_c, tw_s = tw.real, tw.imag
    ys = []
    for offset in (1, 1 + m // 2):
        dr, di = planar_matmul_dft(parity_stack(xr, offset), parity_stack(xi, offset), m)
        ys.append((dr * tw_c - di * tw_s, dr * tw_s + di * tw_c))
    (yr_e, yi_e), (yr_o, yi_o) = ys
    yr = torch.stack([yr_e, yr_o * sign], dim=1).reshape(2 * r_steps, m).T
    yi = torch.stack([yi_e, yi_o * sign], dim=1).reshape(2 * r_steps, m).T
    h = m * t
    return yr, yi, (_history(hist_re, re, h), _history(hist_im, im, h))


def planar_channelize(re: torch.Tensor, im: torch.Tensor, state, cfg: ChannelizerConfig):
    """Planar mirror of ``ops.channelizer.channelize``.

    Args: ``re, im`` of shape ``(N,)``, ``state = (hist_re, hist_im)``.
    Returns ``(chan_re, chan_im, state)`` with channel planes ``(M, 2N/M)``.

    On a CUDA tensor: the planes joined into one complex64 block (and the
    history likewise), K1 ``unpack_arms`` and K2 ``arm_dft`` at every M,
    the channels split back into planes (K1 raises the plain version's
    ``ValueError`` on a partial block).  Only a CPU tensor takes
    :func:`planar_channelize_plain`.
    """
    if re.device.type == "cpu":
        return planar_channelize_plain(re, im, state, cfg)
    m, t = cfg.channel_count, cfg.taps_per_channel
    hist_re, hist_im = state
    _, u = unpack_arms(torch.complex(re, im), torch.complex(hist_re, hist_im), cfg)
    chans = torch.view_as_real(arm_dft(u, cfg))
    h = m * t
    return (chans[..., 0].contiguous(), chans[..., 1].contiguous(),
            (_history(hist_re, re, h), _history(hist_im, im, h)))


# --- spectrum: windowed DFT as matmuls, power in dB ------------------------------


@lru_cache(maxsize=8)
def _spectrum_mats(nfft: int):
    win = np.hanning(nfft).astype(np.float32)
    c, s = dft_matrices(nfft)
    return win, c, s


@lru_cache(maxsize=8)
def _spectrum_tables(nfft: int, device: torch.device) -> tuple:
    """:func:`_spectrum_mats` on ``device``, uploaded once."""
    return tuple(torch.from_numpy(a).to(device) for a in _spectrum_mats(nfft))


def planar_power_spectrum(re: torch.Tensor, im: torch.Tensor, fft_size: int = 2048) -> torch.Tensor:
    """Power spectrum (dB, fftshifted) of the first ``fft_size`` samples of
    each row, as four f32 matmuls against the DFT tables."""
    win, c, s = _spectrum_tables(fft_size, re.device)
    wr = re[..., :fft_size] * win
    wi = im[..., :fft_size] * win
    yr = wr @ c - wi @ s
    yi = wr @ s + wi @ c
    p = (yr * yr + yi * yi) / float(np.float32(fft_size))
    p = torch.roll(p, fft_size // 2, dims=-1)  # fftshift
    return (10.0 * torch.log10(p.clamp_min(1e-20))).to(torch.float32)
