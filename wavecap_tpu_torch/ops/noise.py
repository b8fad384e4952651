"""Impulse noise blanking and spectral noise reduction.

Counterpart of ``wavecap_tpu/ops/noise.py``: the median-baseline impulse
blanker with a max-pool dilation of its mask, and the STFT Wiener-gain
spectral subtraction with overlap-add.  Both are block-local: no state
is carried from one block to the next.

Two kernels carry them on the card, each with its plain version here:

* K11a ``noise_blanker`` (``kernels/csrc/noise_blanker.cu``): a cluster
  of CTAs a row (:func:`k11a_plan`) computes ``|x|`` once, finds the
  exact midpoint median by a three-digit radix select, then zeroes every
  sample within ``blanking_width`` of one above the threshold, the mask
  dilated on 32-bit words;
* K11b ``spectral_noise_reduction`` (``kernels/csrc/noise_reduction.cu``):
  the framing and Hann window, the per-bin 10th percentile and Wiener
  gain (:func:`k11b_plan`), and the overlap-add are hand-written launches
  around cuFFT's rFFT and irFFT (``torch.fft``), as the reference stands
  on XLA's library FFT.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import launch


def _threshold_factor(threshold_db: float) -> float:
    # the reference multiplies an f32 array by a Python float: the factor
    # is rounded to f32 once (weak typing)
    return float(np.float32(10.0 ** (threshold_db / 20.0)))


def _magnitude(x: torch.Tensor) -> torch.Tensor:
    """``|x|``: ``hypot`` for complex rows (the kernel's ``hypotf``)."""
    if x.is_complex():
        return torch.hypot(x.real, x.imag)
    return x.abs()


def noise_blanker_plain(
    x: torch.Tensor, threshold_db: float = 10.0, blanking_width: int = 3
) -> torch.Tensor:
    """Plain version of K11a: zero out impulses more than ``threshold_db``
    above the row's median level, and ``blanking_width`` samples either
    side of each; a row whose median is below 1e-10 passes unchanged."""
    n = x.shape[-1]
    if n == 0:
        return x
    mag = _magnitude(x)
    # jnp.median is the midpoint quantile: both middle ranks, (a + b) * 0.5
    srt = torch.sort(mag, dim=-1).values
    median = (srt[..., (n - 1) // 2] + srt[..., n // 2]) * 0.5
    thr = median * _threshold_factor(threshold_db)
    mask = (mag > thr[..., None]).to(torch.float32)
    if blanking_width > 0:
        w = 2 * blanking_width + 1
        lead = mask.shape[:-1]
        pooled = torch.nn.functional.max_pool1d(
            mask.reshape(-1, 1, n), w, stride=1, padding=blanking_width
        )
        mask = pooled.reshape(lead + (n,))
    blank = mask > 0
    keep = ~blank | (median < 1e-10)[..., None]
    return torch.where(keep, x, torch.zeros_like(x))


SMEM_LIMIT = 200 * 1024  # bytes of shared memory a plan asks for, at most
K11A_DIGITS = (11, 11, 10)  # the radix select's digits, bits from the top
K11A_THREADS = 512
K11A_ITEMS = (10, 12)  # samples a thread holds at once (template instances)
K11A_SLICE = 6144  # samples a CTA takes before a row is split over a cluster
K11A_MAX_CTAS = 8  # the portable cluster size


class K11aPlan(NamedTuple):
    """How K11a runs rows of ``n`` samples: ``ctas`` CTAs a row (one
    cluster), ``threads`` each holding ``items`` samples at a time (a
    slice of one such chunk keeps them in registers), ``slice`` samples a
    CTA (a multiple of 32; CTA r takes ``[r slice, (r + 1) slice)``), the
    select's ``digits``, ``staged`` (|x| and the mask words kept on chip;
    else |x| recomputed from device memory each pass and the words in a
    scratch row) and ``smem`` bytes of dynamic shared memory."""

    ctas: int
    threads: int
    items: int
    slice: int
    digits: tuple
    staged: bool
    smem: int


def k11a_plan(n: int, cplx: bool) -> K11aPlan:
    """One CTA a row up to :data:`K11A_SLICE` samples, else the fewest
    CTAs (at most 8) that bring a slice down to it; staged where the
    histograms (two, and a cluster's sums), the slice's mask words (plain
    and dilated) and its magnitudes fit in :data:`SMEM_LIMIT`, with the
    fewest :data:`K11A_ITEMS` that hold the slice in one chunk."""
    if n < 1 or n * (2 if cplx else 1) >= 2**31:
        raise ValueError(f"K11a takes rows of 1 to 2**31 floats, not {n} samples")
    ctas = min(K11A_MAX_CTAS, -(-n // K11A_SLICE))
    slice_ = -(-(-(-n // ctas)) // 32) * 32
    hists = 4 * (3 if ctas > 1 else 2) * (1 << max(K11A_DIGITS))
    staged = hists + 4 * (2 * (slice_ // 32) + slice_)
    if staged <= SMEM_LIMIT:
        items = min((i for i in K11A_ITEMS if slice_ <= i * K11A_THREADS), default=K11A_ITEMS[-1])
        return K11aPlan(ctas, K11A_THREADS, items, slice_, K11A_DIGITS, True, staged)
    return K11aPlan(ctas, K11A_THREADS, K11A_ITEMS[-1], slice_, K11A_DIGITS, False, hists)


def noise_blanker(
    x: torch.Tensor, threshold_db: float = 10.0, blanking_width: int = 3
) -> torch.Tensor:
    """K11a: see :func:`noise_blanker_plain`.  ``x`` is ``B + (n,)``,
    float32 or complex64.  Only a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        return noise_blanker_plain(x, threshold_db, blanking_width)
    n = x.shape[-1]
    if x.numel() == 0:
        return x
    if x.dtype not in (torch.float32, torch.complex64):
        raise ValueError(f"K11a blanks float32 or complex64 rows, not {x.dtype}")
    if blanking_width < 0:
        raise ValueError("blanking_width must be >= 0")
    x2 = x.reshape(-1, n).contiguous()
    rows = x2.shape[0]
    out = torch.empty_like(x2)
    plan = k11a_plan(n, x.is_complex())
    words = None if plan.staged else torch.empty((rows, 2 * -(-n // 32)), dtype=torch.int32, device=x.device)
    launch("K11a_noise_blanker", x.device, x2, out, words, rows, n, int(x.is_complex()),
           _threshold_factor(threshold_db), int(blanking_width), plan.ctas, plan.threads, plan.items,
           plan.slice, int(plan.staged), *plan.digits, plan.smem)
    return out.reshape(x.shape)


# --- K11b: spectral noise reduction -------------------------------------------------


def _nr_plan(n: int, fft_size: int, overlap: float) -> tuple[int, int, int]:
    """``(hop, frames, out_len)`` of the reference's framing."""
    hop = int(fft_size * (1.0 - overlap))
    frames = (n - fft_size) // hop + 1
    return hop, frames, (frames - 1) * hop + fft_size


def _percentile_pos(frames: int) -> float:
    """``jnp.percentile(., 10.0)``'s position ``q (F - 1)``, in float32 as
    ``jax._src.numpy.reductions._quantile`` computes it: ``q = 10 / 100``
    then ``q * (F - 1)``."""
    q = np.float32(np.float32(10.0) / np.float32(100.0))
    return float(np.float32(q * np.float32(frames - 1)))


@lru_cache(maxsize=16)
def _nr_tables(n: int, fft_size: int, overlap: float, device: torch.device):
    """The Hann window and the overlap-added window power ``wsum`` (float32,
    summed in frame order from 0, as the reference's scatter-add)."""
    hop, frames, out_len = _nr_plan(n, fft_size, overlap)
    win = np.hanning(fft_size).astype(np.float32)
    w2 = win * win
    wsum = np.zeros(out_len, np.float32)
    for f in range(frames):
        wsum[f * hop : f * hop + fft_size] += w2
    return torch.from_numpy(win).to(device), torch.from_numpy(wsum).to(device)


K11B_BUCKETS = (8, 16, 24, 32)  # the register gain's frame buckets (template instances)
K11B_TILE = 32  # bins a block of the staged gain, at most


class K11bPlan(NamedTuple):
    """How K11b's gain runs F frames: ``bucket`` > 0, the register variant
    (F padded to ``bucket``, the ``least`` smallest magnitudes kept), or
    0, the staged variant (``tile`` bins a block, ``smem`` bytes)."""

    bucket: int
    least: int
    tile: int
    smem: int


def k11b_plan(frames: int) -> K11bPlan:
    """The register variant for F <= 32; above, the staged variant with the
    widest tile of bins (32, 16, ..., 1) whose magnitudes and gains fit in
    :data:`SMEM_LIMIT`."""
    if frames < 1:
        raise ValueError(f"K11b needs a frame, not {frames}")
    for bucket in K11B_BUCKETS:
        if frames <= bucket:
            return K11bPlan(bucket, -(-(bucket - 1) // 10) + 1, 0, 0)
    tile = K11B_TILE
    while tile > 1 and 4 * (frames * tile + tile) > SMEM_LIMIT:
        tile //= 2
    smem = 4 * (frames * tile + tile)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K11b's staged gain takes at most {SMEM_LIMIT // 4 - 1} frames, not {frames}")
    return K11bPlan(0, 0, tile, smem)


def spectral_noise_reduction_plain(
    x: torch.Tensor,
    reduction_db: float = 12.0,
    fft_size: int = 1024,
    overlap: float = 0.5,
) -> torch.Tensor:
    """Plain version of K11b: STFT spectral subtraction with a Wiener-like
    soft gain.  Noise floor per bin = 10th percentile of the frames'
    magnitudes; gain = ``max(0.1, 1 - (noise k / |X|)^2)``; overlap-add
    divided by the window power; the samples past the last frame pass
    through."""
    n = x.shape[-1]
    if n < fft_size:
        return x
    hop, frames, out_len = _nr_plan(n, fft_size, overlap)
    win, wsum = _nr_tables(n, fft_size, overlap, x.device)
    idx = (torch.arange(frames, device=x.device)[:, None] * hop
           + torch.arange(fft_size, device=x.device)[None, :])
    spec = torch.fft.rfft(x[..., idx] * win, dim=-1)
    mag = _magnitude(spec)
    # jnp.percentile's linear interpolation between ranks floor(q), ceil(q)
    pos = _percentile_pos(frames)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    hw = np.float32(np.float32(pos) - np.float32(lo))
    lw = np.float32(np.float32(1.0) - hw)
    srt = torch.sort(mag, dim=-2).values
    floor = srt[..., lo : lo + 1, :] * float(lw) + srt[..., hi : hi + 1, :] * float(hw)
    k = float(np.float32(10.0 ** (reduction_db / 20.0)))
    ratio = floor * k / torch.clamp_min(mag, 1e-10)
    gain = torch.clamp_min(torch.clamp_min(1.0 - ratio * ratio, 0.0), 0.1)
    clean = torch.fft.irfft(spec * gain, fft_size, dim=-1).to(torch.float32) * win
    lead = x.shape[:-1]
    y = torch.zeros(lead + (out_len,), dtype=torch.float32, device=x.device)
    for f in range(frames):  # frame order, as the reference's scatter-add
        y[..., f * hop : f * hop + fft_size] += clean[..., f, :]
    y = y / torch.clamp_min(wsum, 1e-6)
    if out_len < n:
        y = torch.cat([y, x[..., out_len:].to(torch.float32)], dim=-1)
    return y[..., :n]


def spectral_noise_reduction(
    x: torch.Tensor,
    reduction_db: float = 12.0,
    fft_size: int = 1024,
    overlap: float = 0.5,
) -> torch.Tensor:
    """K11b: see :func:`spectral_noise_reduction_plain`.  ``x`` is float32
    ``B + (n,)``.  On a CUDA tensor three launches (frames, gain,
    overlap-add) run around cuFFT's rFFT and irFFT; only a CPU tensor
    takes the plain version."""
    if x.device.type == "cpu":
        return spectral_noise_reduction_plain(x, reduction_db, fft_size, overlap)
    n = x.shape[-1]
    if n < fft_size:
        return x
    if x.dtype != torch.float32:
        raise ValueError(f"K11b takes float32 rows, not {x.dtype}")
    if x.numel() == 0:
        return x
    hop, frames, out_len = _nr_plan(n, fft_size, overlap)
    if hop <= 0:
        raise ValueError(f"overlap {overlap} leaves no hop")
    dev = x.device
    win, wsum = _nr_tables(n, fft_size, overlap, dev)
    x2 = x.reshape(-1, n).contiguous()
    rows = x2.shape[0]
    plan = k11b_plan(frames)
    framed = torch.empty((rows, frames, fft_size), dtype=torch.float32, device=dev)
    launch("K11b_nr_frames", dev, x2, win, framed, rows, n, frames, fft_size, hop)
    spec = torch.fft.rfft(framed, dim=-1).contiguous()
    bins = spec.shape[-1]
    pos = _percentile_pos(frames)
    k = float(np.float32(10.0 ** (reduction_db / 20.0)))
    launch("K11b_nr_gain", dev, spec, rows, frames, bins, pos, k, plan.bucket, plan.tile, plan.smem)
    clean = torch.fft.irfft(spec, fft_size, dim=-1).contiguous()
    y = torch.empty_like(x2)
    launch("K11b_nr_overlap_add", dev, clean, x2, win, wsum, y, rows, n, frames, fft_size, hop,
           out_len)
    return y.reshape(x.shape)
