"""Phase-locked loops: SAM carrier recovery and the QPSK Costas loop.

Counterpart of ``wavecap_tpu/ops/pll.py``.  Both are per-sample PI
feedback loops, sequential by nature.  On the card, kernel K10
(``kernels/csrc/pll.cu``) runs one thread per row through the block;
the plain version here is the same loop in torch, one step per sample
over all rows at once, with the reference's f32 constants and wrap
rules.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import launch
from ..utils.torchenv import DeviceLike, resolve_device

_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2 * np.pi))
_EPS = float(np.float32(1e-10))
_K10_PLL, _K10_COSTAS = 0, 1


class PllState(NamedTuple):
    phase: torch.Tensor  # f32, radians
    freq: torch.Tensor  # f32, radians/sample (integrator)


def pll_init(dtype=torch.float32, device: DeviceLike = None) -> PllState:
    dev = resolve_device(device)
    return PllState(torch.zeros((), dtype=dtype, device=dev),
                    torch.zeros((), dtype=dtype, device=dev))


def pll_coeffs(loop_bandwidth_hz: float, sample_rate: float, damping: float = 0.707):
    """2nd-order PI loop coefficients ``(alpha, beta)``."""
    omega_n = 2.0 * np.pi * loop_bandwidth_hz
    alpha = 2.0 * damping * omega_n / sample_rate
    beta = (omega_n**2) / (sample_rate**2)
    return float(alpha), float(beta)


def _loop_plain(iq: torch.Tensor, state: PllState, alpha: float, beta: float, detector: int):
    """Plain version of K10 over ``B + (n,)`` rows."""
    a = float(np.float32(alpha))
    b = float(np.float32(beta))
    lead = iq.shape[:-1]
    phase = state.phase.to(torch.float32).expand(lead).clone()
    integ = state.freq.to(torch.float32).expand(lead).clone()
    x = iq.to(torch.complex64)
    out = torch.empty_like(x)
    for i in range(x.shape[-1]):
        lo = torch.complex(torch.cos(-phase), torch.sin(-phase))
        mixed = x[..., i] * lo
        if detector == _K10_PLL:
            err = torch.atan2(mixed.imag, mixed.real.abs() + _EPS)
        else:
            err = torch.sign(mixed.real) * mixed.imag - torch.sign(mixed.imag) * mixed.real
            err = err.clamp(-1.0, 1.0)
        integ = integ + b * err
        corr = a * err + integ
        if detector == _K10_PLL:
            phase = phase + corr
            phase = torch.where(phase > _PI, phase - _TWO_PI, phase)
            phase = torch.where(phase < -_PI, phase + _TWO_PI, phase)
        else:
            # jnp.mod: the remainder takes the divisor's sign
            phase = torch.remainder(phase + corr + _PI, _TWO_PI) - _PI
        out[..., i] = mixed
    return out, PllState(phase, integ)


def _loop(iq: torch.Tensor, state: PllState, alpha: float, beta: float, detector: int):
    """K10: see :func:`_loop_plain`.  Only a CPU tensor takes the plain
    version."""
    if iq.shape[-1] == 0:  # empty block: the state passes through unchanged
        return iq, state
    if iq.device.type == "cpu":
        return _loop_plain(iq, state, alpha, beta, detector)
    dev = iq.device
    if iq.dtype != torch.complex64:
        raise ValueError(f"K10 tracks complex64 rows, not {iq.dtype}")
    lead = iq.shape[:-1]
    n = iq.shape[-1]
    x = iq.reshape(-1, n).contiguous()
    rows = x.shape[0]
    phase0 = state.phase.to(torch.float32).expand(lead).reshape(rows).contiguous()
    freq0 = state.freq.to(torch.float32).expand(lead).reshape(rows).contiguous()
    out = torch.empty_like(x)
    phase1 = torch.empty(rows, dtype=torch.float32, device=dev)
    freq1 = torch.empty(rows, dtype=torch.float32, device=dev)
    launch("K10_pll", dev, x, out, phase0, freq0, phase1, freq1, rows, n,
           float(np.float32(alpha)), float(np.float32(beta)), detector)
    return out.reshape(iq.shape), PllState(phase1.reshape(lead), freq1.reshape(lead))


def carrier_recovery_pll(
    iq: torch.Tensor,
    sample_rate: float,
    state: PllState,
    loop_bandwidth_hz: float = 50.0,
    damping: float = 0.707,
):
    """Track the carrier; return coherent baseband and the locked LO phase.

    Phase detector ``atan2(imag(mixed), |real(mixed)|)`` (insensitive to
    the AM modulation's sign), PI loop filter.  Returns
    ``(coherent, state)`` with ``coherent = iq * exp(-j phase)``.
    """
    alpha, beta = pll_coeffs(loop_bandwidth_hz, sample_rate, damping)
    return _loop(iq, state, alpha, beta, _K10_PLL)


def costas_loop_qpsk(iq: torch.Tensor, state: PllState, alpha: float, beta: float):
    """4th-power Costas loop for (pi/4-D)QPSK carrier tracking: detector
    ``sign(I) Q - sign(Q) I`` clipped to [-1, 1].  Returns
    ``(derotated, state)``."""
    return _loop(iq, state, alpha, beta, _K10_COSTAS)
