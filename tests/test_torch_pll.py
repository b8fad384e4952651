"""K10's own step functions (``kernels/csrc/pll_math.cuh``) emulated in
numpy float32 from the coefficients in ``wavecap_tpu_torch/ops/pll.py``,
in the kernel's order, against float64 and the JAX package, on the CPU.

``fma32`` is an exact float32 fused multiply-add: the product of two
float32 values is exact in float64, the sum is rounded to odd in float64
(53 >= 24 + 2 bits), then once to float32.  The kernel's reciprocal
(``rcp.approx``, within 1 ulp) is stood in for by the correctly rounded
one; the Newton step after it makes the quotient the same but in rare
ties, and the card's own check (``chip_smoke.py``, K10's functions)
holds the kernel's.  Floors, each with its reason: sin and cos within 2
ulp of float64 (the reduction's and the polynomial's roundings); the
detector's atan within 3 ulp of float64 ``arctan2`` (the quotient and
the polynomial each add theirs); the Costas wrap bit-equal to
``jnp.mod(v, 2 pi) - pi``; the emulated loop >= 50 dB and <= 1e-3 rad
against the reference, as the kernel is held (``test_torch_analog.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu.ops import pll as jpll
from wavecap_tpu_torch.kernels.build import K10Coeffs
from wavecap_tpu_torch.ops import pll as tpll
from tests.conftest import snr_db

F32, F64 = np.float32, np.float64
PI, TWO_PI = F32(np.pi), F32(2 * np.pi)


def fma32(a, b, c):
    a, b, c = (np.asarray(v, F32).astype(F64) for v in (a, b, c))
    p = a * b  # exact
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)  # p + c = s + err exactly
    other = np.where(err > 0, np.nextafter(s, np.inf), np.nextafter(s, -np.inf))
    odd = np.where((err != 0) & ((s.view(np.int64) & 1) == 0), other, s)
    return odd.astype(F32)


def mul(a, b):
    return np.multiply(np.asarray(a, F32), np.asarray(b, F32), dtype=F32)


def add(a, b):
    return np.add(np.asarray(a, F32), np.asarray(b, F32), dtype=F32)


def sub(a, b):
    return np.subtract(np.asarray(a, F32), np.asarray(b, F32), dtype=F32)


def k10_sincos(x):
    """``k10_sincos``: (sin x, cos x); the library's path past fast_max."""
    x = np.asarray(x, F32)
    shift = F32(12582912.0)  # 1.5 * 2^23
    jm = fma32(x, tpll.K10_TWO_OVER_PI, shift)
    j = sub(jm, shift)
    r = fma32(-j, tpll.K10_PIO2[0], x)
    r = fma32(-j, tpll.K10_PIO2[1], r)
    r = fma32(-j, tpll.K10_PIO2[2], r)
    z = mul(r, r)
    ps = fma32(fma32(tpll.K10_SIN[0], z, tpll.K10_SIN[1]), z, tpll.K10_SIN[2])
    sr = fma32(mul(r, z), ps, r)
    pc = fma32(fma32(tpll.K10_COS[0], z, tpll.K10_COS[1]), z, tpll.K10_COS[2])
    cr = fma32(mul(z, z), pc, fma32(F32(-0.5), z, F32(1.0)))
    q = jm.view(np.int32)  # j mod 4 in the low bits
    s1, c1 = np.where(q & 1, cr, sr), np.where(q & 1, sr, cr)
    s = np.where(q & 2, -s1, s1).astype(F32)
    c = np.where((q + 1) & 2, -c1, c1).astype(F32)
    slow = np.abs(x) > tpll.K10_FAST_MAX
    s = np.where(slow, np.sin(x.astype(F64)).astype(F32), s)
    c = np.where(slow, np.cos(x.astype(F64)).astype(F32), c)
    return s, c


def k10_atan_pos(y, x):
    """``k10_atan_pos``: atan2(y, x) for x > 0."""
    y, x = np.asarray(y, F32), np.asarray(x, F32)
    ay = np.abs(y)
    num, den = np.minimum(ay, x), np.maximum(ay, x)
    r = np.divide(F32(1.0), den, dtype=F32)
    t1 = mul(num, r)
    t = fma32(r, fma32(-den, t1, num), t1)
    s = mul(t, t)
    s2 = mul(s, s)
    s4 = mul(s2, s2)
    c = tpll.K10_ATAN
    r0 = fma32(fma32(c[4], s, c[5]), s2, fma32(c[6], s, c[7]))
    r1 = fma32(fma32(c[0], s, c[1]), s2, fma32(c[2], s, c[3]))
    a = fma32(mul(t, s), fma32(r1, s4, r0), t)
    return np.copysign(np.where(ay > x, sub(tpll.K10_ATAN_PIO2, a), a), y).astype(F32)


def k10_costas_wrap(v):
    """``k10_costas_wrap``: mod(v, 2 pi) - pi without fmodf in -2pi < v < 4pi."""
    v = np.asarray(v, F32)
    r0 = sub(v, PI)
    r1 = sub(sub(v, TWO_PI), PI)
    r2 = sub(add(v, TWO_PI), PI)
    out = np.where(v >= 0, np.where(v < TWO_PI, r0, r1), r2)
    m = np.fmod(v, TWO_PI).astype(F32)
    m = np.where((m != 0) & (m < 0), add(m, TWO_PI), m)
    slow = ~((v > -TWO_PI) & (v < add(TWO_PI, TWO_PI)))
    return np.where(slow, sub(m, PI), out).astype(F32)


def k10_loop(iq, phase, integ, alpha, beta, detector):
    """K10's loop over rows, step by step in the kernel's order."""
    a, b = F32(alpha), F32(beta)
    phase, integ = np.asarray(phase, F32).copy(), np.asarray(integ, F32).copy()
    out = np.empty_like(iq)
    for i in range(iq.shape[-1]):
        z = iq[:, i]
        s, c = k10_sincos(-phase)
        mx = sub(mul(z.real, c), mul(z.imag, s))
        my = add(mul(z.real, s), mul(z.imag, c))
        if detector == 0:
            err = k10_atan_pos(my, add(np.abs(mx), F32(1e-10)))
        else:
            err = sub(mul(np.sign(mx), my), mul(np.sign(my), mx))
            err = np.clip(err, F32(-1), F32(1)).astype(F32)
        integ = add(integ, mul(b, err))
        corr = add(mul(a, err), integ)
        if detector == 0:
            p = add(phase, corr)
            phase = np.where(p > PI, sub(p, TWO_PI), np.where(p < -PI, add(p, TWO_PI), p)).astype(F32)
        else:
            phase = k10_costas_wrap(add(add(phase, corr), PI))
        out[:, i] = mx + 1j * my
    return out, phase, integ


def ulps(ref64, got):
    return np.abs(got.astype(F64) - ref64) / np.spacing(np.abs(ref64).astype(F32)).astype(F64)


def test_coefficients_are_the_kernels_argument():
    c = tpll.k10_coeffs()
    assert isinstance(c, K10Coeffs)
    for field, values in (("pio2", tpll.K10_PIO2), ("sin", tpll.K10_SIN), ("cos", tpll.K10_COS),
                          ("atan", tpll.K10_ATAN)):
        assert np.array_equal(np.array(getattr(c, field)[:], F32), values)
    assert F32(c.two_over_pi) == tpll.K10_TWO_OVER_PI and F32(c.atan_pio2) == tpll.K10_ATAN_PIO2
    assert F32(c.fast_max) == tpll.K10_FAST_MAX
    # the Cody-Waite parts sum to pi/2 far below float32's resolution
    assert abs(sum(float(v) for v in tpll.K10_PIO2) - np.pi / 2) < 1e-16


@pytest.mark.parametrize("lo,hi", [(-np.pi - 0.1, np.pi + 0.1), (-2 * np.pi, 2 * np.pi)])
def test_sincos_within_2_ulp(lo, hi):
    x = np.linspace(lo, hi, 1 << 20).astype(F32)
    # the wrap's edges: +-pi and their neighbours, quadrant boundaries
    edges = np.array([np.pi, np.pi / 2, np.pi / 4, 3 * np.pi / 4, 0.0], F32)
    edges = np.concatenate([edges, np.nextafter(edges, F32(0)), np.nextafter(edges, F32(4))])
    x = np.concatenate([x, edges, -edges])
    x = x[np.abs(x) <= max(abs(lo), abs(hi))]
    s, c = k10_sincos(x)
    assert ulps(np.sin(x.astype(F64)), s).max() <= 2.0
    assert ulps(np.cos(x.astype(F64)), c).max() <= 2.0


def test_atan_of_positive_abscissa_within_3_ulp():
    rng = np.random.default_rng(7)
    n = 1 << 19
    mag = 10.0 ** rng.uniform(-6, 1, (2, n))
    y = (rng.standard_normal(n) * mag[0]).astype(F32)
    x = add(np.abs(rng.standard_normal(n) * mag[1]).astype(F32), F32(1e-10))
    # |y| / x swept through 1, where the two branches meet, and y = 0
    ratio = np.linspace(0.5, 2.0, 1 << 16)
    y = np.concatenate([y, (0.3 * ratio).astype(F32), -(0.3 * ratio).astype(F32), F32([0.0, 1e-30])])
    x = np.concatenate([x, np.full(2 << 16, F32(0.3)), F32([1e-10, 1e-10])])
    got = k10_atan_pos(y, x)
    assert ulps(np.arctan2(y.astype(F64), x.astype(F64)), got).max() <= 3.0


def test_costas_wrap_is_bit_equal_to_jnp_mod():
    v = np.linspace(-2 * np.pi, 4 * np.pi, 1 << 20).astype(F32)
    # the case boundaries and their neighbours, and values for fmodf's branch
    # (no subnormals: XLA on the CPU flushes them to zero, the card does not)
    b = np.array([-2 * np.pi, -np.pi, np.pi, 2 * np.pi, 3 * np.pi, 4 * np.pi], F32)
    v = np.concatenate([v, b, np.nextafter(b, F32(-20)), np.nextafter(b, F32(20)), F32([0.0, -0.0, -1e-30, 1e-30]),
                        F32([-40.0, -7.0, 13.0, 12.566371, 25.2, 1e6])])
    ref = np.asarray(jnp.mod(jnp.asarray(v), 2 * np.pi) - np.pi)
    assert ref.dtype == F32
    assert np.array_equal(k10_costas_wrap(v).view(np.int32), ref.view(np.int32))


@pytest.mark.parametrize("detector", ["pll", "costas"])
def test_emulated_step_matches_reference(rng, detector):
    """``test_torch_analog.py``'s PLL and Costas cases through the emulated
    kernel step, the state carried across an odd split."""
    fs, n = 25_000.0, 2000
    tt = np.arange(n) / fs
    if detector == "pll":
        rows = [0.5 * (1 + 0.5 * np.sin(2 * np.pi * 700 * tt)) * np.exp(1j * (2 * np.pi * f * tt + 0.4))
                for f in (20.0, -35.0)]
    else:
        sym = rng.integers(0, 4, (2, n // 10)).repeat(10, axis=1)
        rows = [np.exp(1j * (np.pi / 4 + np.pi / 2 * sym[i] + 2 * np.pi * f * tt + 0.2))
                for i, f in enumerate((15.0, -10.0))]
    x = np.stack(rows).astype(np.complex64)
    alpha, beta = tpll.pll_coeffs(50.0, fs)
    det = 0 if detector == "pll" else 1
    phase, integ = F32([0.1, -3.1]), F32([0.0, 0.001])
    parts = []
    for a, b in [(0, 777), (777, n)]:
        y, phase, integ = k10_loop(x[:, a:b], phase, integ, alpha, beta, det)
        parts.append(y)
    got = np.concatenate(parts, axis=-1)
    for i in range(2):
        s0 = jpll.PllState(jnp.float32([0.1, -3.1][i]), jnp.float32([0.0, 0.001][i]))
        if det == 0:
            ref, rs = jpll.carrier_recovery_pll(jnp.asarray(x[i]), fs, s0)
        else:
            ref, rs = jpll.costas_loop_qpsk(jnp.asarray(x[i]), s0, alpha, beta)
        ref = np.asarray(ref)
        assert snr_db(ref.real, got[i].real) >= 50 and snr_db(ref.imag, got[i].imag) >= 50
        assert abs(np.angle(np.exp(1j * (float(rs.phase) - float(phase[i]))))) <= 1e-3


def test_emulated_step_matches_the_plain_version():
    """The emulation against the port's plain version (torch's cos, sin,
    atan2) on the same rows: the two differ only by those functions."""
    rng = np.random.default_rng(11)
    n = 600
    tt = np.arange(n) / 25_000.0
    x = (0.3 * np.exp(1j * (2 * np.pi * rng.uniform(-30, 30, (4, 1)) * tt + rng.uniform(-3, 3, (4, 1))))
         ).astype(np.complex64)
    ph0, fr0 = rng.uniform(-3, 3, 4).astype(F32), np.zeros(4, F32)
    alpha, beta = tpll.pll_coeffs(50.0, 25_000.0)
    got, ph, _ = k10_loop(x, ph0, fr0, alpha, beta, 0)
    ref, st = tpll._loop_plain(torch.from_numpy(x), tpll.PllState(torch.from_numpy(ph0), torch.from_numpy(fr0)),
                               alpha, beta, 0)
    ref = ref.numpy()
    assert snr_db(ref.real, got.real) >= 50 and snr_db(ref.imag, got.imag) >= 50
    assert np.max(np.abs(np.angle(np.exp(1j * (st.phase.numpy() - ph))))) <= 1e-3
