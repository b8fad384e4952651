"""K14's orders of work (``kernels/csrc/echo_fit.cu``) emulated in torch
against the JAX package, on the CPU.

* The one-pass acf: a row split over a cluster of CTAs by
  ``models/p25/equalizer.py:k14_plan``, each CTA taking passes of a
  staged chunk, each thread 8 consecutive samples and their lookback (the
  samples before the row read as zero), all lags' sums a thread, the
  threads' sums in four chains, the CTAs' in rank order; then the count,
  the normalisation, the finiteness guard, the EMA with the carried acf
  and the enable guard.  Held against ``block_acf`` and
  ``fit_and_invert``'s acf at program B's (21, 7,500) and at one
  60,000-sample row, past the old kernel's 25,000-sample limit.
  Tolerance: relative L2 <= 1e-6 (f32 sums in another order).
* The table-driven inverse DFT: ``W`` on the 512 points in f32 as the
  kernel evaluates it, the taps ``c -+ m'`` summed from one read of a
  float64 table of ``e^{i pi j / 256}`` at ``(k m') mod 512`` (their
  twiddles are conjugate), 16 terms a lane and the warp's xor-shuffle
  tree.  Held against ``fit_and_invert``'s taps (its
  f32 inverse FFT) over a grid of echoes (a, theta, d), d from 1 to the
  grid's max delay, a = 0 and disabled rows.  Tolerance: relative L2 <=
  1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu.models.p25 import cqpsk as jq
from wavecap_tpu.models.p25 import equalizer as jeqz
from wavecap_tpu_torch.models.p25 import equalizer as teqz

torch.set_num_threads(1)
MAX_DELAY = 16  # program B's grid: 29 lags


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128).ravel()
    got = np.asarray(got).astype(np.complex128).ravel()
    return float(np.linalg.norm(ref - got) / np.linalg.norm(ref))


def rows_of(rng, rows: int, n: int) -> np.ndarray:
    """Band-limited complex rows, half of them behind an echo (4 samples)."""
    x = rng.standard_normal((rows, n + 64)) + 1j * rng.standard_normal((rows, n + 64))
    k = np.hanning(17)
    x = np.stack([np.convolve(r, k / k.sum(), mode="valid")[:n] for r in x])
    x[::2] += 0.8 * np.exp(2.98j) * np.roll(x[::2], 4, axis=-1)
    return x.astype(np.complex64)


def k14_acf_emulate(x: np.ndarray, lags: int, acc=None, enable=None, ema: float = 0.5) -> np.ndarray:
    """K14's acf pass by its plan, in float32: the sums a thread, a CTA and a
    cluster in the kernel's orders, then the finish (fit mode with ``acc``)."""
    rows, n = x.shape
    plan = teqz.k14_plan(n, lags)
    assert plan.lookback == lags - 1 and plan.chunk == plan.threads * plan.per
    n_chunks = -(-n // plan.chunk)
    assert plan.ctas == min(max(n_chunks, 1), 8)
    lead = plan.lookback
    xp = np.zeros((rows, lead + n_chunks * plan.chunk), np.complex64)
    xp[:, lead:lead + n] = x
    xr, xi = torch.from_numpy(xp.real.copy()), torch.from_numpy(xp.imag.copy())
    lag = torch.arange(lags)
    # thread k's sums (rows, ctas, threads, lags), over its passes and samples in order
    re = torch.zeros((rows, plan.ctas, plan.threads, lags))
    im = torch.zeros_like(re)
    k = torch.arange(plan.threads)
    for c in range(n_chunks):
        rank = c % plan.ctas
        for s in range(plan.per):
            i = lead + c * plan.chunk + k * plan.per + s  # the sample, in the padded row
            ar, ai = xr[:, i][..., None], xi[:, i][..., None]
            br, bi = xr[:, i[:, None] - lag], xi[:, i[:, None] - lag]
            re[:, rank] = re[:, rank] + (ar * br + ai * bi)
            im[:, rank] = im[:, rank] + (ai * br - ar * bi)
    # a CTA's: four chains over its threads; a row's: its CTAs in rank order
    chains = [[torch.zeros((rows, plan.ctas, lags)) for _ in range(4)] for _ in range(2)]
    for j in range(plan.threads):
        chains[0][j % 4] = chains[0][j % 4] + re[:, :, j]
        chains[1][j % 4] = chains[1][j % 4] + im[:, :, j]
    part = [(c[0] + c[1]) + (c[2] + c[3]) for c in chains]
    tot_r, tot_i = torch.zeros((rows, lags)), torch.zeros((rows, lags))
    for r in range(plan.ctas):
        tot_r, tot_i = tot_r + part[0][:, r], tot_i + part[1][:, r]
    cnt = torch.clamp(n - lag, min=0).to(torch.float32)
    lr, li = tot_r / cnt, tot_i / cnt
    d = torch.clamp(lr[:, :1], min=1e-9)
    lr, li = lr / d, li / d
    finite = (torch.isfinite(lr) & torch.isfinite(li)).all(-1, keepdim=True)
    v = torch.where(finite, torch.complex(lr, li), torch.zeros((rows, lags), dtype=torch.complex64))
    if acc is None:
        return v.numpy()
    a = torch.from_numpy(acc)
    seen = torch.abs(a).sum(-1, keepdim=True) > 0
    mixed = torch.complex((1.0 - ema) * a.real + ema * v.real, (1.0 - ema) * a.imag + ema * v.imag)
    v = torch.where(seen, mixed, v)
    return torch.where(torch.from_numpy(enable)[:, None], v, torch.zeros_like(v)).numpy()


def test_plan_clusters_every_row():
    """Eight CTAs (one cluster) a row at program B's 7,500 samples and past;
    one for a row of at most one pass."""
    assert teqz.k14_plan(7_500, 29) == teqz.K14Plan(8, 128, 8, 1024, 28)
    assert teqz.k14_plan(60_000, 29).ctas == 8
    assert teqz.k14_plan(1_000, 29).ctas == 1 and teqz.k14_plan(3_000, 29).ctas == 3


@pytest.mark.parametrize("rows,n", [(21, 7_500), (1, 60_000)])
def test_one_pass_acf_matches_block_acf(rng, rows, n):
    """The emulated pass against the reference's ``block_acf`` (score mode:
    no EMA, no guard)."""
    x = rows_of(rng, rows, n)
    n_tau = 28
    got = k14_acf_emulate(x, n_tau + 1)
    for r in range(rows):
        ref = np.asarray(jeqz.block_acf(jnp.asarray(x[r]), n_tau))
        assert rel_l2(ref, got[r]) <= 1e-6, r


@pytest.mark.parametrize("rows,n", [(21, 7_500), (1, 60_000)])
def test_one_pass_acf_matches_fit_and_invert(rng, rows, n):
    """Fit mode: the EMA with a carried acf on some rows, a fresh start on
    the others, the enable guard off on one, against ``fit_and_invert``'s
    new acf state."""
    x = rows_of(rng, rows, n)
    preds, params, n_tau = jq._eq_candidates(48_000.0, 4800.0, 0.2, MAX_DELAY)
    acc = k14_acf_emulate(rows_of(rng, rows, n), n_tau + 1)
    acc[1::3] = 0.0
    enable = np.arange(rows) != 5
    got = k14_acf_emulate(x, n_tau + 1, acc, enable)
    for r in range(rows):
        _, ref, _ = jeqz.fit_and_invert(jnp.asarray(x[r]), jnp.asarray(acc[r]), preds, params, n_tau, 41, 0.01,
                                        enable=jnp.bool_(enable[r]))
        ref = np.asarray(ref)
        if not enable[r]:
            assert not ref.any() and not got[r].any()
            continue
        assert rel_l2(ref, got[r]) <= 1e-6, r


def k14_taps_emulate(a: float, theta: float, d: float, on: bool, n_taps: int, lam: float) -> np.ndarray:
    """K14's epilogue for one row: W in f32; the taps c -+ m' from one
    float64 twiddle table read a term (conjugate twiddles), four sums (Re W
    cos, Im W sin, Re W sin, Im W cos) of 16 terms a lane, each through the
    warp's xor-shuffle tree, then combined."""
    nfft = teqz.EQ_NFFT
    wk = torch.from_numpy(teqz._W_GRID)
    ph = -(wk * torch.tensor(d, dtype=torch.float32))
    er, ei = torch.cos(ph), torch.sin(ph)
    amp, th = torch.tensor(a, dtype=torch.float32), torch.tensor(theta, dtype=torch.float32)
    ar, ai = amp * torch.cos(th), amp * torch.sin(th)
    hr = 1.0 + (ar * er - ai * ei)
    hi = ar * ei + ai * er
    m = torch.hypot(hr, hi)
    den = m * m + lam
    wr, wi = (hr / den).double().numpy(), (-(hi / den)).double().numpy()
    j = np.arange(nfft)
    cos_t, sin_t = np.cos(np.pi * j / 256), np.sin(np.pi * j / 256)
    c = n_taps // 2
    taps = np.zeros(n_taps, np.complex64)
    if not on:
        taps[c] = 1.0
        return taps
    k = np.arange(32)[:, None] + 32 * np.arange(nfft // 32)[None, :]  # (lane, term)

    def tree(terms):
        lanes = np.zeros(32)
        for i in range(nfft // 32):
            lanes = lanes + terms[:, i]
        for o in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[np.arange(32) ^ o]
        return lanes[0]

    for item in range(c + 1):
        e_c, e_s = cos_t[(k * item) % nfft], sin_t[(k * item) % nfft]
        ac, bs = tree(wr[k] * e_c), tree(wi[k] * e_s)
        as_, bc = tree(wr[k] * e_s), tree(wi[k] * e_c)
        taps[c - item] = np.complex64(complex((ac + bs) / nfft, (bc - as_) / nfft))
        if item and c + item < n_taps:
            taps[c + item] = np.complex64(complex((ac - bs) / nfft, (as_ + bc) / nfft))
    return taps


def fit_with_echo(x, d, theta, a, enable=True, a_floor=0.35):
    """``fit_and_invert`` driven to the echo (d, theta, a): a two-candidate
    grid whose second candidate is the block's own acf (residual 0, so it
    wins and beats the no-echo candidate decisively)."""
    n_tau = 28
    acf = np.asarray(jeqz.block_acf(jnp.asarray(x), n_tau)).astype(np.complex64)
    preds = np.stack([acf + 1.0, acf]).astype(np.complex64)
    params = np.array([(0.0, 0.0, 0.0), (d, theta, a)], np.float32)
    taps, _, sig = jeqz.fit_and_invert(jnp.asarray(x), jnp.zeros(n_tau + 1, jnp.complex64), preds, params,
                                       n_tau, 41, 0.01, a_floor=a_floor, enable=jnp.bool_(enable))
    return np.asarray(taps), bool(sig)


@pytest.mark.parametrize("d", range(1, MAX_DELAY + 1))
def test_table_dft_matches_fit_and_invert(rng, d):
    """Every delay of the grid, over amplitudes and phases: the emulated
    taps against the reference's inverse FFT of ``W``."""
    x = rows_of(rng, 1, 2_000)[0]
    for a in (0.35, 0.55, 0.85):
        for theta in (0.0, 1.3, 2.98, 5.5):
            ref, sig = fit_with_echo(x, float(d), theta, a)
            assert sig
            got = k14_taps_emulate(np.float32(a), np.float32(theta), np.float32(d), True, 41, 0.01)
            assert rel_l2(ref, got) <= 1e-6, (a, theta)


def test_table_dft_without_an_echo_and_disabled(rng):
    """a = 0 (an echo below the floor is gated off: W = 1 / (1 + lambda))
    and a disabled row (identity taps)."""
    x = rows_of(rng, 1, 2_000)[0]
    ref, sig = fit_with_echo(x, 4.0, 2.98, 0.2)
    assert not sig
    got = k14_taps_emulate(0.0, np.float32(2.98), 4.0, True, 41, 0.01)
    assert rel_l2(ref, got) <= 1e-6
    ref, sig = fit_with_echo(x, 4.0, 2.98, 0.8, enable=False)
    assert not sig
    np.testing.assert_array_equal(ref, k14_taps_emulate(0.0, 2.98, 4.0, False, 41, 0.01))
