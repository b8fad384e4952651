"""Demodulation primitives: the FM discriminator, the AM envelope and the
SSB product detector (counterpart of ``wavecap_tpu/ops/demod.py``).

The discriminator carries the previous block's last sample so that
``angle(x[n]·conj(x[n-1]))`` is exact across block edges.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device

_HALF_PI = float(np.float32(np.pi / 2))
_PI = float(np.float32(np.pi))


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """7th-order polynomial atan2 with quadrant folding (~1e-4 rad)."""
    ax = x.abs()
    ay = y.abs()
    hi = torch.maximum(ax, ay)
    lo = torch.minimum(ax, ay)
    a = lo / hi.clamp_min(1e-30)
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    r = torch.where(ay > ax, _HALF_PI - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def quadrature_demod(
    iq: torch.Tensor,
    sample_rate: float,
    prev_sample: torch.Tensor,
    max_deviation_hz: float = 75_000.0,
    atan_impl: str = "exact",
):
    """FM discriminator ``angle(x[n]·conj(x[n-1])) · fs/(2π·dev)``.

    ``iq`` is ``B + (n,)`` and ``prev_sample`` is ``B``.  Returns
    ``(audio, last_sample)``.
    """
    x = iq.to(torch.complex64)
    if x.shape[-1] == 0:
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device), prev_sample
    prev = torch.cat([prev_sample.to(torch.complex64)[..., None], x[..., :-1]], dim=-1)
    prod = x * prev.conj()
    scale = float(np.float32(sample_rate / (2.0 * np.pi * max_deviation_hz)))
    atan = fast_atan2 if atan_impl == "fast" else torch.atan2
    audio = atan(prod.imag, prod.real) * scale
    return audio.to(torch.float32), x[..., -1]


def am_envelope(iq: torch.Tensor) -> torch.Tensor:
    """AM envelope detection (magnitude)."""
    return iq.abs().to(torch.float32)


def ssb_product(iq_shifted: torch.Tensor) -> torch.Tensor:
    """SSB product detection: the real part after the BFO shift."""
    return iq_shifted.real.to(torch.float32)


def fm_discriminator_init(dtype=torch.complex64, device: DeviceLike = None) -> torch.Tensor:
    return torch.zeros((), dtype=dtype, device=resolve_device(device))
