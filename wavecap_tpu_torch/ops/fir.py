"""Streaming FIR filtering, decimation and polyphase resampling.

Counterpart of ``wavecap_tpu/ops/fir.py``.  Streaming state is an
overlap-save carry: the last ``taps-1`` input samples of the previous
block; prepending it and running a valid convolution continues
``lfilter(b, 1, .)`` exactly.

Two kernels carry the rate changes on the card, each with its plain
version here:

* K7 ``strided_fir``: the valid convolution with an output stride, over
  real or complex rows, with real or complex taps shared by every row or
  one set per row, optionally behind a carried head (the overlap-save
  tail) and an exact uint32 NCO mix of the input.  It is the direct
  convolution of ``conv_valid``, ``fir_decimate``, the wide slots'
  shift-and-decimate, ``resample_poly_stream``'s ``up == 1`` branch and
  the P25 filters and simulcast equaliser.  Its plain version is
  ``conv1d`` in full f32 (TF32 is off, see ``torchenv``; grouped for
  per-row taps, four real convolutions for complex taps), the
  reference's direct path off the TPU.
* K5 ``polyphase_resample``: the rational resampler
  ``y[m] = sum_k h[p_m + k up] v[q_m - k]``, causal with a tail carry or
  centered one-shot, of ``resample_poly_stream`` and ``resample_poly``.

FFT convolution (``_conv_valid_fft``, taps > 128) runs on ``torch.fft``
(cuFFT on the card), as the reference runs XLA's FFT.  With
``WAVECAP_FIR_MATMUL=1`` (read at each call), ``conv_valid`` takes the
reference's banded-matmul route (``_conv_valid_matmul``, an f32 ``einsum``,
cuBLAS on the card) where the reference takes it; unset or ``0`` keeps K7.
"""

from __future__ import annotations

import os
from functools import lru_cache
from math import gcd
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as _sps

from ..kernels import launch
from ..utils.torchenv import DeviceLike, resolve_device
from .nco import _next_phase, nco_phases

_K7_R = 8  # outputs a thread of K7 (kernels/csrc/strided_fir.cu: kR)
_K7_SMALL_OUTPUTS = 400_000  # a launch of at most this many outputs ...
_K7_SHORT_TAPS = 128  # ... and taps takes the direct variant
_K7_DIRECT_TILE = 128  # the direct variant's outputs (threads) a block (kDirectTile)
_K7_MAX_THREADS = 512  # threads a K7 block, at most (kMaxThreads)
_K7_FILL_CTAS = 100  # fewer blocks than this: smaller tiles
_K7_BIG_ITEMS = 2 * 132  # tiles of 32 groups for two rounds of the SMs: big tiles
_K7_FILL_THREADS = 132 * 1024  # fewer threads than this: split the taps
_K7_SMEM_MAX = 232_448  # the H100's 227 KB a block (kSmemMax)
_K5_PER = 8  # outputs a thread of K5's table variant (kernels/csrc/resample_poly.cu)
_K5_THREADS = 256  # threads a block of the table variant, at most (rounded down to a multiple of up)
_K5_ROW_TILE = 256  # outputs (threads) a block of the row variant
_SMEM_LIMIT = 200 * 1024  # bytes of shared memory a kernel asks for, at most


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _conv_valid_fft(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Valid-mode convolution via one big FFT (long-filter path)."""
    n = x.shape[-1]
    t = taps.shape[-1]
    nfft = _next_pow2(n)
    xf = torch.fft.fft(x.to(torch.complex64), nfft)
    hf = torch.fft.fft(taps.to(torch.complex64), nfft)
    y = torch.fft.ifft(xf * hf)[..., t - 1 : n]
    if not x.is_complex() and not taps.is_complex():
        return y.real.to(torch.float32)
    return y


# --- K7: strided valid FIR, optional head and NCO ------------------------------


class K7Plan(NamedTuple):
    """How K7 runs: blocks of ``threads = phase_sets x groups x splits``
    threads, each block a ``tile`` of ``groups x r`` outputs of one row.
    A thread owns ``r`` consecutive outputs, a phase set ``ps`` (the
    phases ``p = ps, ps + phase_sets, ... < stride``) and of each phase the
    run of ``q_split`` taps ``q`` of its split (tap ``p + q stride``), its
    sums carried from phase to phase; the ``phase_sets x splits`` partial
    sums of an output are added set by set, split by split.  ``span`` input
    samples are staged a block, ``smem`` bytes in all.  ``group_fast``: the
    lanes of a warp take consecutive groups (else consecutive phase sets).
    K7's entry takes ``groups``, ``phase_sets``, ``splits`` and ``direct``
    and derives the rest as here."""

    groups: int
    phase_sets: int
    splits: int
    r: int
    tile: int
    threads: int
    q_split: int
    span: int
    smem: int
    group_fast: bool
    direct: bool


def _plane(n: int) -> int:
    """Floats of a staged plane of ``n`` samples: one of padding every 32."""
    return n + (n >> 5) + 1


def _k7_direct(t: int, d: int, cplx: bool, taps_cplx: bool) -> K7Plan:
    """The direct variant: an output a thread, 128 a block, every tap in
    one thread, the block's span and the taps staged."""
    span = (_K7_DIRECT_TILE - 1) * d + t
    smem = 4 * ((t * (2 if taps_cplx else 1) + 3) & ~3) + (8 if cplx else 4) * span
    return K7Plan(_K7_DIRECT_TILE, 1, 1, 1, _K7_DIRECT_TILE, _K7_DIRECT_TILE, t, span, smem, False, True)


def _k7_layout(t: int, d: int, g: int, ps: int, s: int, cplx: bool, taps_cplx: bool) -> K7Plan:
    """The pipelined variant's layout of ``g`` groups, ``ps`` phase sets
    and ``s`` splits, as the kernel derives it."""
    r = _K7_R
    q = -(-t // d)
    q_split = -(-(-(-q // s)) // r) * r
    tile = g * r
    span = (tile - 1) * d + t
    planes = 2 if cplx else 1
    body = planes * _plane(span)
    if ps * s > 1:
        body = max(body, planes * ps * s * (tile + 1))
    taps_floats = (t * (2 if taps_cplx else 1) + 3) & ~3
    raw_off = (taps_floats + body + 3) & ~3  # the raw span, copied in while the last tile computes
    return K7Plan(g, ps, s, r, tile, ps * g * s, q_split, span, 4 * (raw_off + planes * span), ps < 16, False)


@lru_cache(maxsize=256)
def k7_plan(n_taps: int, stride: int, rows: int, n_out: int, cplx: bool, taps_cplx: bool,
            forced: tuple | None = None) -> K7Plan | None:
    """K7's launch plan, the one the kernel runs.  A launch of at most
    400,000 outputs and 128 taps takes the direct variant.  Else a phase
    set a phase; 32 groups of 8 outputs a block at stride 1, else as many
    as 512 threads hold (at most 16), but 32 groups and 16 phase sets for
    a stride of 16 or more whose tiles of 32 groups number 264 or more;
    fewer groups while the launch has fewer than 100 blocks; then the taps
    split 2, 4 or 8 ways while the launch has fewer than 132 x 1,024
    threads and each split keeps 16 taps; a warp at least.  A plan past a
    block's shared memory gives up its big tiles, then halves its groups;
    where no pipelined plan fits, the direct variant, and ``None`` where
    that does not fit either.  ``forced``: ``(groups, phase_sets, splits[,
    direct])`` in its place."""
    t, d, r = int(n_taps), int(stride), _K7_R
    direct = _k7_direct(t, d, cplx, taps_cplx)
    if forced is not None:
        if len(forced) > 3 and forced[3]:
            return direct
        return _k7_layout(t, d, *forced[:3], cplx, taps_cplx)
    if rows * n_out <= _K7_SMALL_OUTPUTS and t <= _K7_SHORT_TAPS and direct.smem <= _K7_SMEM_MAX:
        return direct
    q = -(-t // d)

    def ctas(gg: int) -> int:
        return rows * -(-n_out // (gg * r))

    starts = [(32 if d == 1 else max(min(_K7_MAX_THREADS // d, 16), 1), d, False)]
    if d >= 16 and ctas(32) >= _K7_BIG_ITEMS:  # long decimating rows: big tiles, fewer partial sums
        starts.insert(0, (32, 16, True))
    for g, ps, big in starts:
        while g > 4 and ctas(g) < _K7_FILL_CTAS:
            g = (g + 1) // 2
        while True:
            s = 1
            while (s < 8 and ps * g * s * 2 <= _K7_MAX_THREADS and -(-q // (2 * s)) >= 2 * r
                   and ctas(g) * ps * g * s < _K7_FILL_THREADS):
                s *= 2
            gw = g
            while ps * gw * s < 32:  # a warp at least
                gw *= 2
            plan = _k7_layout(t, d, gw, ps, s, cplx, taps_cplx)
            if plan.smem <= _K7_SMEM_MAX and plan.threads <= _K7_MAX_THREADS:
                return plan
            if big or g == 1:  # big tiles only whole
                break
            g //= 2
    return direct if direct.smem <= _K7_SMEM_MAX else None


def _conv1d_rows(xr: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """Real rows ``B + (n,)`` against one real kernel ``(T,)`` or one per
    row, ``B + (T,)`` (a grouped convolution)."""
    lead = xr.shape[:-1]
    n = xr.shape[-1]
    if taps.dim() == 1:
        kern = taps.flip(-1).to(torch.float32).reshape(1, 1, -1)
        y = F.conv1d(xr.reshape(-1, 1, n).to(torch.float32), kern, stride=stride)
    else:
        rows = int(np.prod(lead))
        kern = taps.flip(-1).to(torch.float32).reshape(rows, 1, -1)
        y = F.conv1d(xr.reshape(1, rows, n).to(torch.float32), kern, stride=stride, groups=rows)
    return y.reshape(lead + (y.shape[-1],))


def _conv_rows(v: torch.Tensor, taps: torch.Tensor, stride: int) -> torch.Tensor:
    """K7's convolution on the plain path: complex taps as the reference's
    four real convolutions, complex rows as two."""
    if taps.is_complex():
        kr, ki = taps.real, taps.imag
        vr = v.real if v.is_complex() else v
        vi = v.imag if v.is_complex() else torch.zeros_like(vr)
        return torch.complex(_conv1d_rows(vr, kr, stride) - _conv1d_rows(vi, ki, stride),
                             _conv1d_rows(vr, ki, stride) + _conv1d_rows(vi, kr, stride))
    if v.is_complex():
        return torch.complex(_conv1d_rows(v.real, taps, stride), _conv1d_rows(v.imag, taps, stride))
    return _conv1d_rows(v, taps, stride)


def _k7_rows(x, head, nco) -> tuple:
    """The batch shape of K7's output: the head's, the NCO's or the input's."""
    if head is not None:
        return tuple(head.shape[:-1])
    if nco is not None:
        return tuple(nco[0].shape)
    return tuple(x.shape[:-1])


def strided_fir_plain(x: torch.Tensor, taps: torch.Tensor, stride: int,
                      head: torch.Tensor | None = None, nco: tuple | None = None):
    """Plain version of K7.

    ``v = head ++ mix(x)`` along the last axis, where ``mix`` multiplies by
    the exact NCO ``exp(i 2 pi acc[n] / 2**32)``, ``acc[n] = phase0 +
    n dphi`` (``nco = (dphi, phase0)``, uint32 per row), and ``x`` may be
    one row shared by all.  ``taps`` is ``(T,)``, shared, or one set per
    output row, ``B + (T,)``; real or complex.  Returns ``(y, tail,
    phase1)``: ``y[..., m] = sum_k taps[..., k] v[..., m*stride + T-1-k]``
    over the valid range, the last ``T-1`` samples of ``v``, and the next
    NCO phase (``None`` without an NCO).
    """
    lead = _k7_rows(x, head, nco)
    n = x.shape[-1]
    phase1 = None
    if nco is not None:
        dphi, phase0 = nco
        ph = nco_phases(n, dphi, phase0)
        x = x * torch.complex(torch.cos(ph), torch.sin(ph))
        phase1 = _next_phase(phase0, n, dphi)
    x = x.expand(lead + (n,))
    v = torch.cat([head.to(x.dtype), x], dim=-1) if head is not None else x
    t = taps.shape[-1]
    if v.shape[-1] < t:  # fewer samples than taps: no output, the tail carries them
        cplx = v.is_complex() or taps.is_complex()
        y = torch.empty(lead + (0,), dtype=torch.complex64 if cplx else torch.float32,
                        device=v.device)
    else:
        y = _conv_rows(v, taps, stride)
    tail = v[..., max(v.shape[-1] - (t - 1), 0):] if t > 1 else v[..., :0]
    return y, tail, phase1


def strided_fir(x: torch.Tensor, taps: torch.Tensor, stride: int,
                head: torch.Tensor | None = None, nco: tuple | None = None):
    """K7: see :func:`strided_fir_plain`.  Only a CPU tensor takes the
    plain version.  With fewer head and input samples than taps there is
    no output: without an NCO the tail is copied and nothing launches,
    with one K7 runs with no output tiles and writes the mixed tail and
    the next phase."""
    if x.device.type == "cpu":
        return strided_fir_plain(x, taps, stride, head, nco)
    dev = x.device
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"K7 filters float32 or complex64 rows, not {x.dtype}")
    if taps.dtype not in (torch.float32, torch.complex64) or taps.device != dev:
        raise ValueError("K7 takes float32 or complex64 taps on the input's device")
    cplx = x.is_complex()
    taps_cplx = taps.is_complex()
    if (nco is not None or taps_cplx) and not cplx:
        raise ValueError("K7 mixes an NCO into, and applies complex taps to, complex input only")
    lead = _k7_rows(x, head, nco)
    rows = int(np.prod(lead)) if lead else 1
    taps_stride = 0
    if taps.dim() != 1:
        if tuple(taps.shape[:-1]) != lead:
            raise ValueError(f"K7's per-row taps {tuple(taps.shape)} do not match rows {lead}")
        taps_stride = taps.shape[-1]
    n = x.shape[-1]
    x2 = x.reshape(int(np.prod(x.shape[:-1])), n).contiguous()
    if x2.shape[0] not in (1, rows):
        raise ValueError(f"K7 input has {x2.shape[0]} rows for {rows} output rows")
    t = taps.shape[-1]
    h_len = 0
    head2 = None
    if head is not None:
        h_len = head.shape[-1]
        head2 = head.to(x.dtype).reshape(rows, h_len).contiguous()
    total = h_len + n
    n_out = max((total - t) // stride + 1, 0)
    tail_len = min(total, t - 1)  # fewer samples than taps: the tail holds all of them
    if n_out == 0 and nco is None:  # nothing to filter or mix: the tail is a copy
        v = torch.cat([head2, x2.expand(rows, n)], -1) if head2 is not None else x2.expand(rows, n)
        return (x.new_empty(lead + (0,)), v[:, total - tail_len:].reshape(lead + (tail_len,)),
                None)
    plan = k7_plan(t, stride, rows, n_out, cplx, taps_cplx)
    if plan is None:
        raise NotImplementedError(f"K7 at stride {stride} with {t} taps: no tile fits a block's "
                                  "shared memory")
    dphi = phase0 = phase1 = None
    if nco is not None:
        dphi = nco[0].to(dev).reshape(rows).contiguous()
        phase0 = nco[1].to(dev).reshape(rows).contiguous()
        if dphi.dtype != torch.uint32 or phase0.dtype != torch.uint32:
            raise ValueError("K7's NCO words and phases are uint32")
        phase1 = torch.empty(rows, dtype=torch.uint32, device=dev)
    y = torch.empty((rows, n_out), dtype=x.dtype, device=dev)
    tail = torch.empty((rows, tail_len), dtype=x.dtype, device=dev)
    launch(
        "K7_strided_fir", dev, x2, x2.shape[0], head2, h_len, taps.contiguous(), t, taps_stride,
        int(taps_cplx), stride, dphi, phase0, y, tail if tail_len else None, phase1, rows, n,
        n_out, int(cplx), plan.groups, plan.phase_sets, plan.splits, int(plan.direct),
    )
    phase1 = None if phase1 is None else phase1.reshape(lead)
    return y.reshape(lead + (n_out,)), tail.reshape(lead + (tail_len,)), phase1


def _conv_valid_direct(x: torch.Tensor, taps: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``y[m] = sum_k taps[k] * x[m*stride + (T-1-k)]`` over the last axis,
    one K7 launch (plain ``conv1d`` on the CPU).  ``taps`` is shared
    ``(T,)`` or per row ``B + (T,)``; complex taps filter complex rows
    (real input is promoted), as the reference's four real convolutions."""
    if taps.is_complex():
        return strided_fir(x.to(torch.complex64), taps.to(torch.complex64), stride)[0]
    xx = x if x.is_complex() else x.to(torch.float32)
    return strided_fir(xx, taps.to(torch.float32), stride)[0]


def conv_same(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """``numpy.convolve(x, taps, mode="same")`` along the last axis for
    ``n >= len(taps)``: zero-pad so the valid convolution (K7) keeps the
    centre ``n`` samples of the full one."""
    t = taps.shape[-1]
    if x.shape[-1] < t:
        raise ValueError(f"conv_same needs at least {t} samples, not {x.shape[-1]}")
    right = (t - 1) // 2
    lead = x.shape[:-1]
    xin = torch.cat([torch.zeros(lead + (t - 1 - right,), dtype=x.dtype, device=x.device), x,
                     torch.zeros(lead + (right,), dtype=x.dtype, device=x.device)], -1)
    return _conv_valid_direct(xin, taps)


_CONV_TILE = 128


@lru_cache(maxsize=32)
def _band_index(t: int, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """Where the band of a ``t``-tap filter holds a tap, and which:
    ``band[i, o] = taps[o + t-1-i]`` for ``0 <= o + t-1-i < t``."""
    i = np.arange(_CONV_TILE + t - 1)[:, None]
    o = np.arange(_CONV_TILE)[None, :]
    k_idx = o + (t - 1) - i
    valid = (k_idx >= 0) & (k_idx < t)
    return torch.from_numpy(valid).to(device), torch.from_numpy(np.clip(k_idx, 0, t - 1)).to(device)


def _conv_valid_matmul(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Valid convolution as a banded-matrix tile matmul (the reference's MXU
    route).

    The outputs of each row are cut into ``_CONV_TILE``-sample tiles; a
    tile is its ``tile + T - 1`` input samples times the band
    ``band[i, o] = taps[o + T-1-i]`` (zero off the band), one f32 ``einsum``
    over every row and tile.  ``x`` is ``B + (n,)``, real or complex
    (complex rows ride as two real planes); ``taps`` are real, shared
    ``(T,)`` or one set per row ``B + (T,)`` (a band per row).
    """
    t = taps.shape[-1]
    n = x.shape[-1]
    lead = x.shape[:-1]
    m_out = n - t + 1
    tile = _CONV_TILE
    n_tiles = -(-m_out // tile)
    valid, k_idx = _band_index(t, x.device)
    band = torch.where(valid, taps.to(device=x.device, dtype=torch.float32)[..., k_idx], 0.0)

    planes = torch.stack([x.real, x.imag], dim=-2) if x.is_complex() else x.to(torch.float32)[..., None, :]
    pad = n_tiles * tile + tile - n  # one spare tile for the last window
    rows = F.pad(planes, (0, pad)).reshape(lead + (planes.shape[-2], n_tiles + 1, tile))
    win = torch.cat([rows[..., :-1, :], rows[..., 1:, : t - 1]], dim=-1)  # B + (P, n_tiles, tile+T-1)
    spec = "...pnk,ko->...pno" if taps.dim() == 1 else "...pnk,...ko->...pno"
    y = torch.einsum(spec, win, band).reshape(lead + (planes.shape[-2], n_tiles * tile))[..., :m_out]
    return torch.complex(y[..., 0, :], y[..., 1, :]) if x.is_complex() else y[..., 0, :]


def conv_valid(x: torch.Tensor, taps: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Valid convolution: FFT for long filters; with ``WAVECAP_FIR_MATMUL=1``
    the banded matmul where the reference takes it; else the direct path
    (K7 on the card, the reference's choice off the TPU)."""
    t = int(taps.shape[-1])
    if stride == 1 and t > 128:
        return _conv_valid_fft(x, taps)
    if (
        stride == 1
        and t > 8
        and os.environ.get("WAVECAP_FIR_MATMUL") == "1"  # read each call, as the reference
        and not taps.is_complex()
        and x.shape[-1] >= 4 * _CONV_TILE
    ):
        return _conv_valid_matmul(x, taps)
    return _conv_valid_direct(x, taps, stride)


def fir_init(taps_len: int, dtype=torch.complex64, device: DeviceLike = None) -> torch.Tensor:
    """Zero overlap-save carry for a ``taps_len``-tap filter."""
    return torch.zeros((taps_len - 1,), dtype=dtype, device=resolve_device(device))


def fir_filter(x: torch.Tensor, taps: torch.Tensor, tail: torch.Tensor):
    """Streaming FIR: ``(y, new_tail)``; exact ``lfilter(b,1,.)`` continuation.

    ``x`` is ``B + (n,)`` and ``tail`` is ``B + (taps-1,)``.
    """
    t = taps.shape[-1]
    if x.shape[-1] == 0:
        return x, tail
    xin = torch.cat([tail.to(x.dtype), x], dim=-1)
    y = conv_valid(xin, taps)
    new_tail = xin[..., -(t - 1):] if t > 1 else tail
    return y, new_tail


def fir_decimate(x: torch.Tensor, taps: torch.Tensor, decim: int, tail: torch.Tensor):
    """Streaming decimating FIR: ``lfilter(b, 1, stream)[::decim]`` when
    block lengths are multiples of ``decim``.  Returns ``(y, new_tail)``."""
    if x.shape[-1] == 0:
        return x[..., :0], tail
    y, new_tail, _ = strided_fir(x, taps, decim, head=tail)
    return y, new_tail


# --- filter design (host side, cached) --------------------------------------------


@lru_cache(maxsize=128)
def design_lowpass_fir(num_taps: int, cutoff_norm: float, beta: float = 8.0) -> np.ndarray:
    """Kaiser-windowed lowpass prototype (cutoff normalized to Nyquist)."""
    return _sps.firwin(num_taps, cutoff_norm, window=("kaiser", beta)).astype(np.float32)


@lru_cache(maxsize=128)
def design_decimation_fir(decim: int, sample_rate: float, beta: float = 7.857) -> np.ndarray:
    """Anti-alias FIR for ``decim``:1, ~80 dB stopband (Kaiser)."""
    nyq_out = sample_rate / decim / 2.0
    cutoff = 0.8 * nyq_out
    width = 0.4 * nyq_out
    numtaps, _ = _sps.kaiserord(80.0, width / (sample_rate / 2.0))
    numtaps = int(numtaps) | 1  # odd length, linear phase
    return _sps.firwin(numtaps, cutoff, window=("kaiser", beta), fs=sample_rate).astype(np.float32)


@lru_cache(maxsize=128)
def design_resample_poly_filter(up: int, down: int) -> np.ndarray:
    """The FIR of ``scipy.signal.resample_poly`` (kaiser 5.0, 10 taps/phase)."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate
    half_len = 10 * max_rate
    h = _sps.firwin(2 * half_len + 1, f_c, window=("kaiser", 5.0))
    return (h * up).astype(np.float64).astype(np.float32)


def _resample_plan(in_rate: int, out_rate: int):
    g = gcd(int(in_rate), int(out_rate))
    up, down = int(out_rate) // g, int(in_rate) // g
    return up, down, design_resample_poly_filter(up, down)


@lru_cache(maxsize=32)
def _resample_taps(up: int, down: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(design_resample_poly_filter(up, down)).to(device)


@lru_cache(maxsize=32)
def _phase_table(up: int, down: int, device: torch.device) -> torch.Tensor:
    """``phases[p, k] = h[p + k up]`` (zero past the end), ``(up, ph_len)``
    f32 on ``device``."""
    taps = design_resample_poly_filter(up, down)
    t = len(taps)
    ph_len = -(-t // up)
    padded = np.zeros(up * ph_len, np.float32)
    padded[:t] = taps
    return torch.from_numpy(padded.reshape(ph_len, up).T.copy()).to(device)


@lru_cache(maxsize=32)
def _phase_table_t(up: int, down: int, device: torch.device) -> torch.Tensor:
    """K5's table variant's copy of :func:`_phase_table`, transposed:
    ``(ph_len, up)``, so that a warp's consecutive phases read one row."""
    return _phase_table(up, down, device).T.contiguous()


class K5Plan(NamedTuple):
    """How K5 runs a ratio: ``variant`` 0 (the table variant: ``threads`` a
    block, each ``per`` outputs ``up`` apart, ``tile`` outputs a block,
    ``span`` staged inputs, ``smem`` bytes) or 1 (the row variant: a thread
    an output, ``tile`` outputs and ``span`` staged inputs a block, each
    thread reading its phase row from device memory)."""

    variant: int
    threads: int
    per: int
    tile: int
    span: int
    smem: int


def k5_plan(up: int, down: int, ph_len: int) -> K5Plan:
    """The table variant where its table and span fit in shared memory and
    its in-block offsets ``p0 + i down`` fit in int32; else the row
    variant.  ``span`` covers every tap of every output of a full tile:
    the last output's span index is ``L + (p0 + (tile - 1) down) div up``."""
    if up <= _K5_THREADS * 4:
        threads = up * max(1, _K5_THREADS // up)
        tile = threads * _K5_PER
        span = ph_len - 1 + (up - 1 + (tile - 1) * down) // up + 1
        smem = 4 * (ph_len * up + span)
        if smem <= _SMEM_LIMIT and up - 1 + (tile - 1) * down < 2**31:
            return K5Plan(0, threads, _K5_PER, tile, span, smem)
    span = ph_len - 1 + (up - 1 + (_K5_ROW_TILE - 1) * down) // up + 1
    return K5Plan(1, _K5_ROW_TILE, 1, _K5_ROW_TILE, span, 4 * span)


@lru_cache(maxsize=32)
def _resample_gather(up: int, down: int, off: int, n_out: int, device: torch.device):
    """The plain version's per-output windows and coefficients:
    ``(idx, coeffs)``, both ``(n_out, ph_len)``, for ``p_m = (off + m
    down) mod up`` and ``q_m = (off + m down) div up + L``."""
    phases = _phase_table(up, down, device)
    ph_len = phases.shape[1]
    a = off + np.arange(n_out, dtype=np.int64) * down
    p_idx = a % up
    q_idx = a // up + (ph_len - 1)
    idx = q_idx[:, None] - np.arange(ph_len)[None, :]
    p_t = torch.from_numpy(p_idx).to(device)
    return torch.from_numpy(idx).to(device), phases[p_t].contiguous()


# --- K5: polyphase rational resample -----------------------------------------------


def polyphase_resample_plain(x: torch.Tensor, up: int, down: int, off: int,
                             head: torch.Tensor | None, n_out: int) -> torch.Tensor:
    """Plain version of K5 over real rows ``x`` (``B + (n,)``):
    ``y[m] = sum_k h[p_m + k up] v[q_m - k]`` with ``v = head ++ x ++ 0``
    (a zero head of ``L = ph_len - 1`` samples when ``head`` is None),
    ``p_m = (off + m down) mod up``, ``q_m = (off + m down) div up + L``."""
    idx, coeffs = _resample_gather(up, down, int(off), int(n_out), x.device)
    ph_len = coeffs.shape[1]
    lead = x.shape[:-1]
    if head is None:
        head = torch.zeros(lead + (ph_len - 1,), dtype=x.dtype, device=x.device)
    pad_r = torch.zeros(lead + (ph_len + down // up + 2,), dtype=x.dtype, device=x.device)
    v = torch.cat([head.to(x.dtype).expand(lead + (ph_len - 1,)), x, pad_r], dim=-1)
    return (v[..., idx] * coeffs).sum(dim=-1)


def polyphase_resample(x: torch.Tensor, up: int, down: int, off: int,
                       head: torch.Tensor | None, n_out: int) -> torch.Tensor:
    """K5: see :func:`polyphase_resample_plain`.  Only a CPU tensor takes
    the plain version."""
    if x.device.type == "cpu":
        return polyphase_resample_plain(x, up, down, off, head, n_out)
    dev = x.device
    if x.dtype != torch.float32:
        raise ValueError(f"K5 resamples float32 rows, not {x.dtype}")
    phases = _phase_table(up, down, dev)
    ph_len = phases.shape[1]
    lead = x.shape[:-1]
    n = x.shape[-1]
    x2 = x.reshape(-1, n).contiguous()
    rows = x2.shape[0]
    head2 = None
    if head is not None:
        head2 = head.to(torch.float32).expand(lead + (ph_len - 1,)).reshape(rows, ph_len - 1)
        head2 = head2.contiguous()
    plan = k5_plan(up, down, ph_len)
    table = _phase_table_t(up, down, dev) if plan.variant == 0 else phases
    y = torch.empty((rows, n_out), dtype=torch.float32, device=dev)
    if rows and n_out:
        launch("K5_resample_poly", dev, x2, head2, table, y, rows, n, ph_len - 1, up, down,
               ph_len, int(off), n_out, plan.variant, plan.threads, plan.span)
    return y.reshape(lead + (n_out,))


def resample_stream_init(in_rate: int, out_rate: int, dtype=torch.float32,
                         device: DeviceLike = None) -> torch.Tensor:
    """Carry state (input tail) for :func:`resample_poly_stream`."""
    dev = resolve_device(device)
    if int(in_rate) == int(out_rate):
        return torch.zeros((0,), dtype=dtype, device=dev)
    up, down, taps_np = _resample_plan(in_rate, out_rate)
    if up == 1:
        return torch.zeros((len(taps_np) - 1,), dtype=dtype, device=dev)
    ph_len = -(-len(taps_np) // up)
    return torch.zeros((ph_len - 1,), dtype=dtype, device=dev)


def resample_poly_stream(x: torch.Tensor, in_rate: int, out_rate: int, tail: torch.Tensor):
    """Streaming polyphase resample, segmentation-invariant: the causal
    form of :func:`resample_poly`.  A block whose length ``down`` does not
    divide takes the centered one-shot resample and keeps the old tail,
    as the reference does.  Returns ``(y, new_tail)``."""
    if int(in_rate) == int(out_rate):
        return x, tail
    n = x.shape[-1]
    if n == 0:  # empty block: state passes through unchanged
        return x[..., :0], tail
    up, down, taps_np = _resample_plan(in_rate, out_rate)
    if n % down != 0:
        return resample_poly(x, in_rate, out_rate), tail
    if up == 1:
        taps = _resample_taps(up, down, x.device)
        y, new_tail, _ = strided_fir(x, taps, down, head=tail.expand(x.shape[:-1] + tail.shape[-1:]))
        return y[..., : n // down], new_tail
    ell = -(-len(taps_np) // up) - 1
    y = polyphase_resample(x, up, down, 0, tail, n * up // down)
    xin = torch.cat([tail.to(x.dtype).expand(x.shape[:-1] + (ell,)), x], dim=-1)
    return y, xin[..., xin.shape[-1] - ell:]


def resample_poly(x: torch.Tensor, in_rate: int, out_rate: int) -> torch.Tensor:
    """One-shot polyphase resample of a whole block, matching
    ``scipy.signal.resample_poly(x, up, down)``: centered, with
    ``ceil(n up / down)`` outputs."""
    if int(in_rate) == int(out_rate):
        return x
    up, down, taps_np = _resample_plan(in_rate, out_rate)
    n = x.shape[-1]
    n_out = -(-n * up // down)
    half = (len(taps_np) - 1) // 2
    if up == 1:
        lead = x.shape[:-1]
        xin = torch.cat([torch.zeros(lead + (half,), dtype=x.dtype, device=x.device), x,
                         torch.zeros(lead + (half + down,), dtype=x.dtype, device=x.device)], -1)
        return _conv_valid_direct(xin, _resample_taps(up, down, x.device), down)[..., :n_out]
    if x.is_complex():
        return torch.complex(polyphase_resample(x.real.contiguous(), up, down, half, None, n_out),
                             polyphase_resample(x.imag.contiguous(), up, down, half, None, n_out))
    return polyphase_resample(x.to(torch.float32), up, down, half, None, n_out)
