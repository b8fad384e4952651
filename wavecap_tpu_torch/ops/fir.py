"""Streaming FIR filtering and the resampler's identity case.

Counterpart of ``wavecap_tpu/ops/fir.py``.  Streaming state is an
overlap-save carry: the last ``taps-1`` input samples of the previous
block; prepending it and running a valid convolution continues
``lfilter(b, 1, .)`` exactly.

The valid convolution is the reference's direct form (the path it takes
off the TPU), here ``torch.nn.functional.conv1d`` in full f32 (TF32 is
off, see ``torchenv``).  It is the plain version of the FIR inside
kernel K4 (``models/channel_bank.py``).  FFT convolution (taps > 128),
complex taps and the rational resampler are ROADMAP kernels K7 and K5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.torchenv import DeviceLike, resolve_device


def _conv_valid_direct(x: torch.Tensor, taps: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``y[m] = sum_k taps[k] * x[m*stride + (T-1-k)]`` over the last axis."""
    if taps.is_complex():
        raise NotImplementedError("complex taps are ROADMAP kernel K7 (wide path, equalizer)")
    kern = taps.flip(-1).to(torch.float32).reshape(1, 1, -1)

    def conv1d(xr: torch.Tensor) -> torch.Tensor:
        lead = xr.shape[:-1]
        y = F.conv1d(xr.reshape(-1, 1, xr.shape[-1]).to(torch.float32), kern, stride=stride)
        return y.reshape(lead + (y.shape[-1],))

    if x.is_complex():
        return torch.complex(conv1d(x.real), conv1d(x.imag))
    return conv1d(x)


def conv_valid(x: torch.Tensor, taps: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Valid convolution with real taps (the reference's direct path)."""
    if stride == 1 and int(taps.shape[-1]) > 128:
        raise NotImplementedError("FFT convolution for taps > 128 is ROADMAP kernel K7")
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


def resample_stream_init(in_rate: int, out_rate: int, dtype=torch.float32,
                         device: DeviceLike = None) -> torch.Tensor:
    """Carry state of ``resample_poly_stream`` (empty for equal rates)."""
    if int(in_rate) != int(out_rate):
        raise NotImplementedError(
            "rational resampling is ROADMAP kernel K5 (48 kHz audio, the next slice)"
        )
    return torch.zeros((0,), dtype=dtype, device=resolve_device(device))


def resample_poly_stream(x: torch.Tensor, in_rate: int, out_rate: int, tail: torch.Tensor):
    """Streaming polyphase resample; only the identity (equal rates) here."""
    if int(in_rate) != int(out_rate):
        raise NotImplementedError(
            "rational resampling is ROADMAP kernel K5 (48 kHz audio, the next slice)"
        )
    return x, tail
