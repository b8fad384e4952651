"""Phase-locked loops: SAM carrier recovery and the QPSK Costas loop.

Counterpart of ``wavecap_tpu/ops/pll.py``.  Both are per-sample PI
feedback loops, sequential by nature.  On the card, kernel K10
(``kernels/csrc/pll.cu``) runs one thread per row through the block;
the plain version here is the same loop in torch, one step per sample
over all rows at once, with the reference's f32 constants and wrap
rules.

K10 computes sin, cos and the detector's atan with its own polynomials
(``kernels/csrc/pll_math.cuh``); their float32 coefficients are the
``K10_*`` constants below, handed to the kernel by value
(:func:`k10_coeffs`), so a CPU emulation evaluates the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import launch
from ..kernels.build import K10Coeffs
from ..utils.torchenv import DeviceLike, resolve_device

_PI = float(np.float32(np.pi))
_TWO_PI = float(np.float32(2 * np.pi))
_EPS = float(np.float32(1e-10))
_K10_PLL, _K10_COSTAS = 0, 1

# K10's step functions (pll_math.cuh), float32.  sin and cos: x = j pi/2 + r,
# j = rint(x 2/pi) (as fma(x, 2/pi, 1.5 * 2^23) - 1.5 * 2^23), r by three
# multiply-adds with pi/2 = sum of K10_PIO2;
# sin r = r + r z P_s(z), cos r = 1 - z/2 + z^2 P_c(z), z = r^2, Cephes'
# sinf / cosf coefficients (Moshier, public domain), highest power first.
K10_TWO_OVER_PI = np.float32(2.0 / np.pi)
K10_PIO2 = np.array([1.5707964, -4.371139e-08, -1.7151245e-15], np.float32)
K10_SIN = np.array([-1.9515295891e-4, 8.3321608736e-3, -1.6666654611e-1], np.float32)
K10_COS = np.array([2.443315711809948e-5, -1.388731625493765e-3, 4.166664568298827e-2], np.float32)
# atan t = t + t s P_a(s), s = t^2, t in [0, 1]: a minimax fit of relative
# error (0.28 ulp before rounding), highest power first, evaluated by
# Estrin's scheme
K10_ATAN = np.array([0.0029206383, -0.016367715, 0.04321152, -0.07552186, 0.10665992,
                     -0.14211053, 0.19993773, -0.33333153], np.float32)
K10_ATAN_PIO2 = np.float32(np.pi / 2)
# |x| above which the kernel takes the library's sincosf: a wrapped phase
# is within pi; a state handed over may not be
K10_FAST_MAX = np.float32(2.0 * np.pi)


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


def k10_coeffs() -> K10Coeffs:
    """The ``K10_*`` constants as the kernel's by-value argument."""
    return K10Coeffs(float(K10_TWO_OVER_PI), tuple(map(float, K10_PIO2)), tuple(map(float, K10_SIN)),
                     tuple(map(float, K10_COS)), tuple(map(float, K10_ATAN)), float(K10_ATAN_PIO2),
                     float(K10_FAST_MAX))


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
           float(np.float32(alpha)), float(np.float32(beta)), detector, k10_coeffs())
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
