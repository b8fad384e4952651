"""Windowed FFT power spectrum for the waterfall/spectrum stream.

Counterpart of ``wavecap_tpu/ops/spectrum.py``: Hann window, power in
dB, fftshift, on ``torch.fft`` (cuFFT on the card), as the reference
stands on XLA's library FFT.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=16)
def _hann(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.hanning(n).astype(np.float32)).to(device)


@lru_cache(maxsize=16)
def _frame_index(n: int, fft_size: int, total: int, device: torch.device) -> torch.Tensor:
    """(total, fft_size) sample indices of ``total`` evenly spaced frames."""
    starts = np.linspace(0, n - fft_size, total).astype(np.int64)
    return torch.from_numpy(starts[:, None] + np.arange(fft_size)[None, :]).to(device)


def _db(p: torch.Tensor) -> torch.Tensor:
    return (10.0 * torch.log10(p.clamp_min(1e-20))).to(torch.float32)


def power_spectrum(
    iq: torch.Tensor, fft_size: int = 2048, ref_level: float = 1.0
) -> torch.Tensor:
    """Single power spectrum (dB, fftshifted) of the first frame of ``iq``."""
    frame = iq[..., :fft_size]
    if frame.shape[-1] < fft_size:  # short/empty block: zero-pad the frame
        frame = torch.nn.functional.pad(frame, (0, fft_size - frame.shape[-1]))
    spec = torch.fft.fftshift(torch.fft.fft(frame * _hann(fft_size, iq.device), dim=-1), dim=-1)
    p = (spec.abs() ** 2) / (float(np.float32(fft_size)) * ref_level)
    return _db(p)


def spectrogram(
    iq: torch.Tensor,
    fft_size: int = 2048,
    hop: int | None = None,
    average: int = 1,
) -> torch.Tensor:
    """All frames of the block: ``(..., n_frames, fft_size)`` dB spectra."""
    hop = hop or fft_size
    n = iq.shape[-1]
    n_frames = max((n - fft_size) // hop + 1, 0)
    if n_frames == 0:
        return torch.zeros(iq.shape[:-1] + (0, fft_size), dtype=torch.float32, device=iq.device)
    if hop == fft_size:
        frames = iq[..., : n_frames * fft_size].reshape(iq.shape[:-1] + (n_frames, fft_size))
    else:
        idx = np.arange(n_frames)[:, None] * hop + np.arange(fft_size)[None, :]
        frames = iq[..., torch.from_numpy(idx).to(iq.device)]
    spec = torch.fft.fftshift(torch.fft.fft(frames * _hann(fft_size, iq.device), dim=-1), dim=-1)
    p = (spec.abs() ** 2) / float(fft_size)
    if average > 1:
        k = (n_frames // average) * average
        p = p[..., :k, :].reshape(p.shape[:-2] + (-1, average, fft_size)).mean(-2)
    return _db(p)


def spectrogram_sampled(
    iq: torch.Tensor,
    fft_size: int = 2048,
    n_out: int = 2,
    avg: int = 8,
) -> torch.Tensor:
    """``n_out`` averaged dB spectra from ``n_out*avg`` evenly spaced
    sampled windows across the block."""
    n = iq.shape[-1]
    total = n_out * avg
    if n < fft_size or total <= 0:
        return torch.zeros(iq.shape[:-1] + (0, fft_size), dtype=torch.float32, device=iq.device)
    frames = iq[..., _frame_index(n, fft_size, total, iq.device)]
    spec = torch.fft.fftshift(torch.fft.fft(frames * _hann(fft_size, iq.device), dim=-1), dim=-1)
    p = (spec.abs() ** 2) / float(fft_size)
    p = p.reshape(p.shape[:-2] + (n_out, avg, fft_size)).mean(-2)
    return _db(p)
