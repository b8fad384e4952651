"""Numerically-controlled oscillator and phase-continuous frequency shift.

Counterpart of ``wavecap_tpu/ops/nco.py``.  Phase is an exact 32-bit
wrapped accumulator in "turns" (2**32 counts per turn), so it never
drifts across blocks.  This torch has no uint32 addition, so the
accumulator is computed in int64 and masked to 32 bits; the carried
phase is stored as ``torch.uint32`` like the reference's.

Every step that decides a bit of the tuning word or of the phase is the
reference's f32 operation in the same order (f32 division, Python-sign
``remainder``, half-to-even ``round``), so words and accumulators match
the reference bit for bit.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device

TWO_PI = 2.0 * np.pi
_TURN = 4294967296.0  # 2**32
_MASK = 0xFFFFFFFF
_RAD_PER_COUNT = np.float32(TWO_PI / _TURN)


def _u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _MASK


def _i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    return (x & _MASK).to(torch.uint32)


@lru_cache(maxsize=256)
def _u32_const(value: int, device: torch.device) -> torch.Tensor:
    """A host constant on ``device``, uploaded once: a fresh upload per block
    would be a host sync per call on the card."""
    return torch.tensor(value, dtype=torch.uint32, device=device)


@lru_cache(maxsize=8)
def _rad_per_count(device: torch.device) -> torch.Tensor:
    return torch.tensor(_RAD_PER_COUNT, device=device)


def _as_u32(value, device: torch.device) -> torch.Tensor:
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.uint32)
    return _u32_const(int(value) & _MASK, torch.device(device))


def tuning_word(offset_hz, sample_rate: float, device: DeviceLike = None) -> torch.Tensor:
    """Phase increment per sample in uint32 turns.

    A Python number takes exact f64 host math (``device`` says where the
    word goes); a tensor takes the reference's traced f32 branch, whose
    hi/lo split assembles the word because f32 cannot hold 32 bits.
    """
    fs = float(sample_rate)
    if isinstance(offset_hz, (int, float)):
        word = int(round((float(offset_hz) / fs) * _TURN)) & _MASK
        return _u32_const(word, resolve_device(device))
    off = offset_hz.to(torch.float32)
    # tensor / tensor: an IEEE f32 division, as the reference's
    frac = torch.remainder(off / torch.full_like(off, fs), 1.0)
    x = frac * 65536.0
    hi = torch.floor(x)
    lo = torch.round((x - hi) * 65536.0)
    return _i64_to_u32(hi.to(torch.int64) * 65536 + lo.to(torch.int64))


def nco_phases(n: int, dphi_u32: torch.Tensor, phase0_u32: torch.Tensor) -> torch.Tensor:
    """Exact wrapped phases (radians, f32) for ``n`` consecutive samples.

    ``dphi_u32`` and ``phase0_u32`` are scalars or share a batch shape
    ``B``; the result is ``B + (n,)``.
    """
    idx = torch.arange(n, dtype=torch.int64, device=dphi_u32.device)
    acc = (_u32_to_i64(phase0_u32)[..., None] + idx * _u32_to_i64(dphi_u32)[..., None]) & _MASK
    return acc.to(torch.float32) * _rad_per_count(acc.device)


def _next_phase(phase0_u32: torch.Tensor, n: int, dphi_u32: torch.Tensor) -> torch.Tensor:
    return _i64_to_u32(_u32_to_i64(phase0_u32) + n * _u32_to_i64(dphi_u32))


def freq_shift(iq: torch.Tensor, offset_hz, sample_rate: float, phase0_u32=0):
    """Mix ``iq`` (``B + (n,)``) with ``exp(+2j*pi*offset_hz*t)``.

    ``offset_hz`` and ``phase0_u32`` are scalars or of batch shape ``B``.
    Returns ``(shifted, next_phase0_u32)``; thread the phase into the
    next block for glitch-free streaming.
    """
    n = iq.shape[-1]
    dphi = tuning_word(offset_hz, sample_rate, device=iq.device)
    p0 = _as_u32(phase0_u32, iq.device)
    ph = nco_phases(n, dphi, p0)
    osc = torch.complex(torch.cos(ph), torch.sin(ph))
    return iq * osc, _next_phase(p0, n, dphi)


def real_osc(n: int, freq_hz, sample_rate: float, phase0_u32=0, device: DeviceLike = None):
    """Real cosine oscillator block (for BFO / pilot regeneration); returns
    ``(cos, next_phase0_u32)``.  ``device`` says where a Python-number
    frequency and phase put the block; tensors keep their own."""
    dev = phase0_u32.device if isinstance(phase0_u32, torch.Tensor) else (
        freq_hz.device if isinstance(freq_hz, torch.Tensor) else resolve_device(device))
    dphi = tuning_word(freq_hz, sample_rate, device=dev)
    p0 = _as_u32(phase0_u32, dev)
    return torch.cos(nco_phases(n, dphi, p0)), _next_phase(p0, n, dphi)
