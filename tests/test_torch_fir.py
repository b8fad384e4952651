"""The port's FIR, decimation and resampling against the JAX package's, on the CPU.

The plain versions of K7 (``conv1d`` in f32) and K5 (a gather and a sum
over each output's phase taps) run here.  Floors, each with its reason:
relative L2 <= 1e-5 for the short f32 dot products of K5 and K7 against
the reference (sums taken in other orders); 60 dB against float64
``scipy.signal.resample_poly``, the reference's own floor
(``tests/test_ops_core.py:133-143``); NCO phases bit-exact.
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.ops import fir as jfir
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.ops import fir as tfir
from tests.conftest import snr_db

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128).ravel()
    got = np.asarray(got).astype(np.complex128).ravel()
    return float(np.linalg.norm(ref - got) / np.linalg.norm(ref))


def noise(rng, shape, cplx=False) -> np.ndarray:
    x = rng.standard_normal(shape)
    if cplx:
        x = x + 1j * rng.standard_normal(shape)
        return x.astype(np.complex64)
    return x.astype(np.float32)


# in rate, out rate, block length: 24/25 streams, 48/25 and the wide IF's
# 24000/121951 take the one-shot fallback (the length is not a multiple of
# down), 1/5 streams through K7's strided branch
STREAM_CASES = [(50_000, 48_000, 1000), (25_000, 48_000, 506), (25_000, 48_000, 500),
                (240_000, 48_000, 2000), (243_902, 48_000, 700)]


@pytest.mark.parametrize("in_rate,out_rate,n", STREAM_CASES)
def test_resample_poly_stream_matches_over_blocks(rng, in_rate, out_rate, n):
    rows = 3
    x = noise(rng, (3, rows, n))
    tail = tops.resample_stream_init(in_rate, out_rate, device="cpu").expand(rows, -1)
    ref_tail = jops.resample_stream_init(in_rate, out_rate)
    assert tail.shape[-1] == ref_tail.shape[-1]
    ref_tails = [ref_tail] * rows
    for k in range(3):
        y, tail = tops.resample_poly_stream(t(x[k]), in_rate, out_rate, tail)
        for i in range(rows):
            ref, ref_tails[i] = jops.resample_poly_stream(jnp.asarray(x[k, i]), in_rate, out_rate,
                                                          ref_tails[i])
            assert y.shape[-1] == ref.shape[-1]
            assert rel_l2(ref, y[i].numpy()) <= 1e-5, (k, i)
            np.testing.assert_array_equal(tail[i].numpy(), np.asarray(ref_tails[i]))


@pytest.mark.parametrize("in_rate,out_rate", [(2_400_000, 48_000), (50_000, 48_000),
                                              (48_000, 8_000), (8_000, 48_000), (25_000, 48_000)])
def test_resample_poly_matches_scipy_and_reference(rng, in_rate, out_rate):
    x = noise(rng, (2, 4800))
    up, down, taps = tfir._resample_plan(in_rate, out_rate)
    np.testing.assert_array_equal(taps, jfir.design_resample_poly_filter(up, down))
    y = tops.resample_poly(t(x), in_rate, out_rate)
    for i in range(2):
        expected = sps.resample_poly(x[i].astype(np.float64), up, down)
        assert y.shape[-1] == len(expected)
        assert snr_db(expected, y[i].numpy()) > 60
        ref = jops.resample_poly(jnp.asarray(x[i]), in_rate, out_rate)
        assert rel_l2(ref, y[i].numpy()) <= 1e-5


def test_resample_poly_complex_input(rng):
    x = noise(rng, 1000, cplx=True)
    got = tops.resample_poly(t(x), 25_000, 48_000).numpy()
    ref = jops.resample_poly(jnp.asarray(x), 25_000, 48_000)
    assert got.dtype == np.complex64
    assert rel_l2(ref, got) <= 1e-5


def test_fir_decimate_complex_over_blocks(rng):
    """The wide path's decimator (1 Msps / 4) on complex input, its
    overlap-save tail carried."""
    taps = tops.design_decimation_fir(4, 1_000_000.0)
    np.testing.assert_array_equal(taps, jops.design_decimation_fir(4, 1_000_000.0))
    x = noise(rng, (3, 2000), cplx=True)
    tail = tops.fir_init(len(taps), device="cpu")
    ref_tail = jops.fir_init(len(taps))
    for k in range(3):
        y, tail = tops.fir_decimate(t(x[k]), t(taps), 4, tail)
        ref, ref_tail = jops.fir_decimate(jnp.asarray(x[k]), jnp.asarray(taps), 4, ref_tail)
        assert y.shape == ref.shape == (500,)
        assert rel_l2(ref, y.numpy()) <= 1e-5
        np.testing.assert_array_equal(tail.numpy(), np.asarray(ref_tail))


@pytest.mark.parametrize("stride", [1, 3])
def test_complex_taps_take_four_real_convolutions(rng, stride):
    """Complex taps (the reference once dropped their imaginary part) on
    complex and on real input, against the reference and numpy."""
    taps = noise(rng, 9, cplx=True)
    for x in (noise(rng, 300, cplx=True), noise(rng, 300)):
        got = tfir._conv_valid_direct(t(x), t(taps), stride).numpy()
        ref = np.asarray(jfir._conv_valid_direct(jnp.asarray(x), jnp.asarray(taps), stride))
        full = np.convolve(x.astype(np.complex128), taps.astype(np.complex128), mode="valid")[::stride]
        assert got.dtype == np.complex64 and got.shape == ref.shape == full.shape
        assert rel_l2(ref, got) <= 1e-5
        assert rel_l2(full, got) <= 1e-5


@pytest.mark.parametrize("n_taps", [129, 301])
def test_conv_valid_fft_for_long_filters(rng, n_taps):
    taps = noise(rng, n_taps)
    for x in (noise(rng, 3000), noise(rng, 3000, cplx=True)):
        got = tops.conv_valid(t(x), t(taps)).numpy()
        ref = np.asarray(jops.conv_valid(jnp.asarray(x), jnp.asarray(taps)))
        assert got.shape == ref.shape == (3000 - n_taps + 1,)
        assert got.dtype == ref.dtype
        # one FFT of 4096 points in f32 each side: ~1e-6 relative
        assert rel_l2(ref, got) <= 1e-5
        assert rel_l2(np.convolve(x, taps, mode="valid"), got) <= 1e-5


def test_strided_fir_with_nco_matches_shift_then_decimate(rng):
    """K7's plain version with the NCO: two rows sharing one input, each
    with its own tuning word and carried phase, against the reference's
    ``freq_shift`` + ``fir_decimate`` per row; phases bit-exact."""
    fs, decim = 1_000_000.0, 4
    taps = tops.design_decimation_fir(decim, fs)
    x = noise(rng, 4000, cplx=True)
    off = np.array([-250_000.0, 123_456.7], np.float32)
    p0 = np.array([0xFFFF0000, 12345], np.uint32)
    head = noise(rng, (2, len(taps) - 1), cplx=True)
    dphi = tops.tuning_word(-t(off), fs)
    y, tail, p1 = tfir.strided_fir(t(x), t(taps), decim, head=t(head), nco=(dphi, t(p0)))
    for i in range(2):
        shifted, ref_p1 = jops.freq_shift(jnp.asarray(x), -jnp.asarray(off[i]), fs, jnp.uint32(p0[i]))
        ref, ref_tail = jops.fir_decimate(shifted, jnp.asarray(taps), decim, jnp.asarray(head[i]))
        assert rel_l2(ref, y[i].numpy()) <= 1e-5
        assert rel_l2(ref_tail, tail[i].numpy()) <= 1e-6
        assert int(p1[i]) == int(ref_p1)


# --- K5's block plan (kernels/csrc/resample_poly.cu), emulated in numpy --------------

CPU = torch.device("cpu")
# (in rate, n, streaming): 48/25 one-shot at 10 Msps / 800 channels' 4,920
# samples, 24/25 streaming at the engine's 2.4 Msps geometry, the wide IF's
# 24000/121951 one-shot at n_if = 1,968,000 / 41
K5_CASES = [(25_000, 4920, False), (50_000, 10_000, True), (243_902, 48_000, False)]


def k5_emulate(x, head, up, down, off, n_out):
    """K5's output by its plan: the block base in int64, the offsets within
    a block in int32 (asserted), the staged span covering every tap of
    every output of a full tile (asserted); float64 sums."""
    taps = tfir.design_resample_poly_filter(up, down)
    ph_len = -(-len(taps) // up)
    lead = ph_len - 1
    plan = tfir.k5_plan(up, down, ph_len)
    rows, n = x.shape
    hd = np.zeros((rows, lead), np.float32) if head is None else head
    vv = np.concatenate([hd, x, np.zeros((rows, 1), np.float32)], -1).astype(np.float64)

    def v_at(j):  # v = head ++ x ++ zeros
        return vv[:, np.where((j >= 0) & (j < lead + n), j, lead + n)]

    y = np.zeros((rows, n_out))
    k = np.arange(ph_len)
    if plan.variant == 0:
        table_t = tfir._phase_table_t(up, down, CPU).numpy().astype(np.float64)
        t_, r_ = np.arange(plan.threads), np.arange(plan.per)
        i = ((t_ // up) * up * plan.per + t_ % up)[:, None] + up * r_[None, :]  # (threads, per)
        assert np.array_equal(np.sort(i.ravel()), np.arange(plan.tile))  # every output once
        for blk in range(-(-n_out // plan.tile)):
            m0 = blk * plan.tile
            a0 = np.int64(off) + np.int64(m0) * down
            p0, j0 = int(a0 % up), a0 // up
            v32 = p0 + i[:, :1].astype(np.int64) * down  # each thread's one 32-bit divide
            assert (p0 + i.astype(np.int64) * down).max() < 2**31
            p, s = v32 % up, lead + v32 // up + down * r_[None, :]
            assert np.array_equal(s, lead + (p0 + i.astype(np.int64) * down) // up)
            idx = s[..., None] - k  # (threads, per, ph_len) span reads
            assert idx.min() >= 0 and idx.max() < plan.span
            span = v_at(j0 + np.arange(plan.span))
            vals = (span[:, idx] * table_t[k[None, None, :], p[:, :, None]]).sum(-1)
            m = m0 + i
            y[:, m[m < n_out]] = vals[:, m < n_out]
    else:
        phases = tfir._phase_table(up, down, CPU).numpy().astype(np.float64)
        m = np.arange(n_out, dtype=np.int64)
        a0 = off + (m // plan.tile) * plan.tile * down
        v32 = a0 % up + (m % plan.tile) * down
        assert v32.max() < 2**31
        p, s = v32 % up, lead + v32 // up  # tap 0's index in the block's span
        assert (s - (ph_len - 1)).min() >= 0 and s.max() < plan.span
        q = a0 // up + s
        for row in range(rows):
            y[row] = (phases[p[:, None], k[None, :]] * v_at(q[:, None] - k[None, :])[row]).sum(-1)
    return y


@pytest.mark.parametrize("in_rate,n,streaming", K5_CASES)
def test_k5_block_plan_reproduces_the_plain_version(rng, in_rate, n, streaming):
    up, down, taps = tfir._resample_plan(in_rate, 48_000)
    ph_len = -(-len(taps) // up)
    rows = 1 if up > 1000 else 3
    x = noise(rng, (rows, n))
    if streaming:
        head, off, n_out = noise(rng, (rows, ph_len - 1)), 0, n * up // down
    else:
        head, off, n_out = None, (len(taps) - 1) // 2, -(-n * up // down)
    want = tfir.polyphase_resample_plain(t(x), up, down, off, None if head is None else t(head), n_out).numpy()
    got = k5_emulate(x, head, up, down, off, n_out)
    # the same f32 products summed in float64 against torch's f32 sum
    assert rel_l2(want, got) <= 1e-6
    assert tfir.k5_plan(up, down, ph_len).variant == (1 if up > 1000 else 0)


@pytest.mark.parametrize("in_rate", [25_000, 50_000, 243_902])
def test_k5_transposed_table(in_rate):
    up, down, taps = tfir._resample_plan(in_rate, 48_000)
    ph_len = -(-len(taps) // up)
    table_t = tfir._phase_table_t(up, down, CPU)
    assert table_t.shape == (ph_len, up) and table_t.is_contiguous()
    assert torch.equal(table_t, tfir._phase_table(up, down, CPU).T)
    padded = np.zeros(ph_len * up, np.float32)
    padded[: len(taps)] = taps
    k, p = np.meshgrid(np.arange(ph_len), np.arange(up), indexing="ij")
    assert np.array_equal(table_t.numpy(), padded[p + k * up])  # phases[p, k] = h[p + k up]


@pytest.mark.parametrize("in_rate,out_rate", [(25_000, 48_000), (50_000, 48_000), (243_902, 48_000),
                                              (12_500, 48_000), (24_000, 48_000), (10_000, 48_000),
                                              (44_100, 48_000), (48_000, 44_100), (2_400_000 // 41, 48_000)])
def test_k5_plan_fits(in_rate, out_rate):
    """The table variant's shared memory and int32 offsets for every ratio
    it takes, and the span its worst block needs; the warp variant where
    the table does not fit."""
    up, down, taps = tfir._resample_plan(in_rate, out_rate)
    if up == 1:
        return  # up == 1 streams through K7
    ph_len = -(-len(taps) // up)
    plan = tfir.k5_plan(up, down, ph_len)
    if plan.variant == 0:
        assert plan.threads % up == 0 and plan.threads <= 1024 and plan.tile == plan.threads * plan.per
        assert plan.smem == 4 * (ph_len * up + plan.span) <= 200 * 1024
        assert up - 1 + (plan.tile - 1) * down < 2**31
        assert plan.span == ph_len - 1 + (up - 1 + (plan.tile - 1) * down) // up + 1
    else:
        assert 4 * ph_len * up > 200 * 1024 or up > 1024
        assert up - 1 + (plan.tile - 1) * down < 2**31 and plan.smem == 4 * plan.span <= 200 * 1024
        assert plan.span == ph_len - 1 + (up - 1 + (plan.tile - 1) * down) // up + 1
