"""Planar-complex DFTs: IQ as (real, imag) f32 planes, DFT as matmuls.

Counterpart of the DFT half of ``wavecap_tpu/ops/planar.py``.  These are
the plain versions of the channelizer's cross-arm DFT (kernel K2 in
``ops/channelizer.py``); the tables are the reference's, built in
float64 with numpy and cast to f32, so both sides multiply by the same
numbers.  Matmuls run in full f32 (TF32 is off, see ``torchenv``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


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
