"""K7's launch plan (``ops/fir.py:k7_plan``, ``kernels/csrc/strided_fir.cu``)
emulated in torch against the JAX package, on the CPU.

The kernel gives each thread a set of phases ``p`` of the stride, ``r``
consecutive outputs and of each phase a run of its taps (its split); the
partial sums of an output are then added, the splits pairwise and the
phase sets in order.  The emulation sums in that order, in float32, over the staged span the
plan sizes (asserted to cover every tap of every output of a tile), at
the paths' shapes: a mesh shard's wide slots (1,031 taps, stride 41, the
NCO) and the whole block, the simulcast equaliser (41 complex taps a row,
stride 1), the P25 filters of a mesh shard (63 real taps on complex rows,
83 on real rows) and of program A, and short and empty blocks.  Tolerance: relative L2 <= 1e-5 against the
reference's ``fir_decimate`` / ``_conv_valid_direct`` (f32 sums in
another order than XLA's convolution).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.ops import fir as jfir
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.models.p25 import c4fm as tc
from wavecap_tpu_torch.ops import fir as tfir

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
        return (0.1 * x).astype(np.complex64)
    return (0.1 * x).astype(np.float32)


def assert_span_covers(plan: tfir.K7Plan, big_t: int, d: int, n_out: int) -> None:
    """Every sample a tile's outputs read lies in the span the plan stages."""
    m = np.arange(n_out) % plan.tile
    for p in range(d):
        q_p = -(-(big_t - p) // d)
        lo = (m - (q_p - 1)) * d + big_t - 1 - p
        hi = m * d + big_t - 1 - p
        assert (lo >= 0).all() and (hi < plan.span).all()


def k7_emulate(v: np.ndarray, taps: np.ndarray, stride: int, plan: tfir.K7Plan) -> np.ndarray:
    """K7's outputs over ``v = head ++ mix(x)`` (rows, N) by ``plan``:
    ``(rows, n_out)``, each output the float32 sum of its ``phase_sets x
    splits`` partials: each partial its phase set's phases in turn and of
    each the taps of its split in tap order (complex taps keep four real
    sums), a set's splits added pairwise (the lanes' shuffle tree), then
    the sets in order."""
    rows, n = v.shape
    big_t = taps.shape[-1]
    d = stride
    n_out = max((n - big_t) // d + 1, 0)
    if plan.direct:
        return k7_direct_emulate(v, taps, stride, plan)
    assert plan.threads == plan.phase_sets * plan.groups * plan.splits <= tfir._K7_MAX_THREADS
    assert 1 <= plan.phase_sets <= d
    assert plan.q_split % plan.r == 0 and plan.tile == plan.groups * plan.r
    assert plan.span == (plan.tile - 1) * d + big_t
    assert_span_covers(plan, big_t, d, n_out)
    m = np.arange(n_out)
    h = np.broadcast_to(taps, (rows, big_t))
    vt = t(v)
    cplx_taps = np.iscomplexobj(taps)
    hr = t(h.real.astype(np.float32))
    hi = t(h.imag.astype(np.float32)) if cplx_taps else None
    y = None
    for ps in range(plan.phase_sets):
        splits = []
        for s in range(plan.splits):
            if cplx_taps:
                sums = [torch.zeros((rows, n_out)) for _ in range(4)]  # rr, ii, ir, ri
            else:
                acc = torch.zeros((rows, n_out), dtype=vt.dtype)
            for p in range(ps, d, plan.phase_sets):
                q_p = -(-(big_t - p) // d)
                q0, q1 = s * plan.q_split, min((s + 1) * plan.q_split, q_p)
                for q in range(q0, q1):
                    u = vt[:, torch.from_numpy((m - q) * d + big_t - 1 - p)]
                    k = p + q * d
                    if cplx_taps:
                        sums[0] = sums[0] + hr[:, k:k + 1] * u.real
                        sums[1] = sums[1] + hi[:, k:k + 1] * u.imag
                        sums[2] = sums[2] + hi[:, k:k + 1] * u.real
                        sums[3] = sums[3] + hr[:, k:k + 1] * u.imag
                    else:
                        acc = acc + hr[:, k:k + 1] * u
            splits.append(torch.complex(sums[0] - sums[1], sums[2] + sums[3]) if cplx_taps else acc)
        while len(splits) > 1:  # the split lanes' xor-shuffle tree
            splits = [splits[i] + splits[i + 1] for i in range(0, len(splits), 2)]
        y = splits[0] if y is None else y + splits[0]
    return y.numpy()


def k7_direct_emulate(v: np.ndarray, taps: np.ndarray, stride: int, plan: tfir.K7Plan) -> np.ndarray:
    """The direct variant: a thread an output of a 128-output tile, its taps
    in order (complex taps: four real sums), over the tile's staged span."""
    rows, n = v.shape
    big_t = taps.shape[-1]
    n_out = max((n - big_t) // stride + 1, 0)
    assert plan.tile == plan.threads == 128 and plan.span == 127 * stride + big_t
    assert_span_covers(plan, big_t, stride, n_out)
    m = np.arange(n_out)
    h = np.broadcast_to(taps, (rows, big_t))
    vt = t(v)
    if np.iscomplexobj(taps):
        sums = [torch.zeros((rows, n_out)) for _ in range(4)]
        hr, hi = t(h.real.astype(np.float32)), t(h.imag.astype(np.float32))
    else:
        acc = torch.zeros((rows, n_out), dtype=vt.dtype)
        hr = t(h.astype(np.float32))
    for k in range(big_t):
        u = vt[:, torch.from_numpy(m * stride + big_t - 1 - k)]
        if np.iscomplexobj(taps):
            sums = [sums[0] + hr[:, k:k + 1] * u.real, sums[1] + hi[:, k:k + 1] * u.imag,
                    sums[2] + hi[:, k:k + 1] * u.real, sums[3] + hr[:, k:k + 1] * u.imag]
        else:
            acc = acc + hr[:, k:k + 1] * u
    if np.iscomplexobj(taps):
        acc = torch.complex(sums[0] - sums[1], sums[2] + sums[3])
    return acc.numpy()


def test_plan_matches_the_kernels_rules():
    """The plans at the paths' shapes: the wide slots' 2 x 48,000 outputs in
    tiles of 32 groups of 8 with 16 phase sets, a mesh shard's 6,000 in 12
    groups with a phase set a phase (1,031 taps: not short), program A's
    low-pass and B's alias filter in 32 groups with the taps split 2 and 4
    ways, the small launches of short filters direct; every plan inside a block's
    limits."""
    cases = {  # (taps, stride, rows, n_out, cplx, taps cplx) -> (groups, phase sets, splits), or direct
        (1031, 41, 2, 48_000, True, False): (32, 16, 1),
        (1031, 41, 2, 6_000, True, False): (12, 41, 1),
        (63, 1, 50, 12_500, True, False): (32, 1, 2),
        (83, 1, 63, 7_500, True, False): (32, 1, 4),
        (41, 1, 21, 7_500, True, True): "direct",
        (63, 1, 50, 1_500, True, False): "direct",
        (83, 1, 50, 1_500, False, False): "direct",
        (101, 5, 2, 9_600, False, False): "direct",
        (101, 5, 2, 2, False, False): "direct",
    }
    for args, want in cases.items():
        plan = tfir.k7_plan(*args)
        assert plan.direct == (want == "direct"), args
        if not plan.direct:
            assert (plan.groups, plan.phase_sets, plan.splits, plan.r) == want + (8,), args
        assert 32 <= plan.threads <= tfir._K7_MAX_THREADS and plan.smem <= tfir._K7_SMEM_MAX
        assert plan.splits == 1 or plan.threads % 32 == 0


def test_plan_wide_shard_with_nco(rng):
    """A mesh shard's wide slots (program E: 2 slots, 1,031 taps, stride 41,
    one shared 247,030-sample row, each slot its own NCO): the plan's
    emulation over the reference's ``freq_shift`` output against its
    ``_conv_valid_direct``, and the port's plain version."""
    fs, decim = 10_000_000.0, 41
    taps = tops.design_decimation_fir(decim, fs)
    assert len(taps) == 1031
    n = 246_000 + len(taps) - 1
    x = noise(rng, n, cplx=True)
    off = np.array([700_000.0, -1_200_000.0], np.float32)
    p0 = np.array([0xFFFF0000, 12345], np.uint32)
    dphi = tops.tuning_word(-t(off), fs)
    shifted = np.stack([np.asarray(jops.freq_shift(jnp.asarray(x), -jnp.asarray(off[i]), fs,
                                                   jnp.uint32(p0[i]))[0]) for i in range(2)])
    n_out = (n - len(taps)) // decim + 1
    assert n_out == 6000
    plan = tfir.k7_plan(len(taps), decim, 2, n_out, True, False)
    got = k7_emulate(shifted, taps, decim, plan)
    plain, _, _ = tfir.strided_fir_plain(t(x), t(taps), decim, nco=(dphi, t(p0)))
    for i in range(2):
        ref = np.asarray(jfir._conv_valid_direct(jnp.asarray(shifted[i]), jnp.asarray(taps), decim))
        assert ref.shape == (n_out,)
        assert rel_l2(ref, got[i]) <= 1e-5, i
        assert rel_l2(ref, plain[i].numpy()) <= 1e-5, i


def test_plan_wide_block_phase_sets(rng):
    """The wide slots' whole block (program D: 2 slots behind their carried
    heads, 1,968,000 samples, 48,000 outputs each): tiles of 32 groups and
    16 phase sets, so a thread carries its sums over two or three phases."""
    fs, decim = 10_000_000.0, 41
    taps = tops.design_decimation_fir(decim, fs)
    n = 1_968_000
    x = noise(rng, n, cplx=True)
    head = noise(rng, (2, len(taps) - 1), cplx=True)
    plan = tfir.k7_plan(len(taps), decim, 2, n // decim, True, False)
    assert (plan.groups, plan.phase_sets) == (32, 16)
    v = np.concatenate([head, np.broadcast_to(x, (2, n))], -1)
    got = k7_emulate(v, taps, decim, plan)
    for i in range(2):
        ref, _ = jops.fir_decimate(jnp.asarray(x), jnp.asarray(taps), decim, jnp.asarray(head[i]))
        assert ref.shape == (n // decim,)
        assert rel_l2(ref, got[i]) <= 1e-5, i


def test_plan_equaliser_complex_taps(rng):
    """The simulcast equaliser: 21 rows of 40 + 7,500 complex samples, 41
    complex taps a row, stride 1: the direct variant, and the
    register-blocked one forced (the taps split 2 ways)."""
    rows, n_b = 21, 7_500
    x = noise(rng, (rows, n_b + 40), cplx=True)
    taps = (rng.standard_normal((rows, 41)) + 1j * rng.standard_normal((rows, 41))).astype(np.complex64) * 0.2
    plan = tfir.k7_plan(41, 1, rows, n_b, True, True)
    assert plan.direct
    got = k7_emulate(x, taps, 1, plan)
    forced = tfir.k7_plan(41, 1, rows, n_b, True, True, forced=(32, 1, 2))  # the register-blocked variant
    assert rel_l2(got, k7_emulate(x, taps, 1, forced)) <= 1e-5
    for r in range(rows):
        ref = np.asarray(jfir._conv_valid_direct(jnp.asarray(x[r]), jnp.asarray(taps[r]), 1))
        assert rel_l2(ref, got[r]) <= 1e-5, r
    plain = tfir.strided_fir_plain(t(x), t(taps), 1)[0].numpy()
    assert rel_l2(plain, got) <= 1e-5


@pytest.mark.parametrize("which,n", [("lpf-complex", 1_500), ("rrc-real", 1_500), ("lpf-complex", 12_500)])
def test_plan_p25_filters(rng, which, n):
    """The P25 filters of 50 rows through ``fir_filter``'s carried head:
    C4FM's 63-tap low-pass on complex rows and its 83-tap RRC on the real
    discriminator output at program F's 1,500 channel samples a shard (a
    small launch: the direct variant), and the low-pass at program A's
    12,500 (8 outputs a thread, the taps split 2 ways)."""
    fs = 50_000.0
    lpf, rrc = tc.design_baseband_lpf(fs), tc.design_rrc(fs)
    taps, cplx = (lpf, True) if which == "lpf-complex" else (rrc, False)
    rows = 50
    x = noise(rng, (rows, n), cplx=cplx)
    head = noise(rng, (rows, len(taps) - 1), cplx=cplx)
    plan = tfir.k7_plan(len(taps), 1, rows, n, cplx, False)
    assert plan.direct == (n == 1_500)
    got = k7_emulate(np.concatenate([head, x], -1), taps, 1, plan)
    y, tail = tops.fir_filter(t(x), t(taps), t(head))
    for r in range(rows):
        ref, ref_tail = jops.fir_filter(jnp.asarray(x[r]), jnp.asarray(taps), jnp.asarray(head[r]))
        assert rel_l2(ref, got[r]) <= 1e-5, r
        assert rel_l2(ref, y[r].numpy()) <= 1e-5, r
        np.testing.assert_array_equal(np.asarray(ref_tail), tail[r].numpy())


@pytest.mark.parametrize("n_x,h_len", [(7, 100), (7, 50), (0, 100)])
def test_plan_short_and_empty_blocks(rng, n_x, h_len):
    """``resample_poly_stream``'s up == 1 decimator (101 taps, stride 5) on
    blocks of a few samples behind a carried head: two outputs (a partial
    tile), or none (the plan has no tile: the kernel writes only the tail)."""
    taps = tfir.design_resample_poly_filter(1, 5)
    x = noise(rng, (2, n_x))
    head = noise(rng, (2, h_len))
    total = h_len + n_x
    n_out = max((total - len(taps)) // 5 + 1, 0)
    plan = tfir.k7_plan(len(taps), 5, 2, n_out, False, False)
    got = k7_emulate(np.concatenate([head, x], -1), taps, 5, plan)
    y, tail, _ = tfir.strided_fir_plain(t(x), t(taps), 5, head=t(head))
    assert got.shape == y.shape == (2, n_out)
    for r in range(2):
        xin = jnp.concatenate([jnp.asarray(head[r]), jnp.asarray(x[r])])
        ref_tail = np.asarray(xin[max(total - (len(taps) - 1), 0):])
        np.testing.assert_array_equal(ref_tail, tail[r].numpy())
        if n_out:
            ref, _ = jfir.fir_decimate(jnp.asarray(x[r]), jnp.asarray(taps), 5, jnp.asarray(head[r]))
            assert ref.shape == (n_out,)
            assert rel_l2(ref, got[r]) <= 1e-5
            assert rel_l2(ref, y[r].numpy()) <= 1e-5


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("rate", [10_000_000, 12_000_000, 16_000_000, 20_000_000, 25_000_000, 37_000_000,
                                  61_440_000])
def test_plan_fits_the_wide_slots_at_every_rate(rate, rows):
    """The wide slots of a capture at 10 to 61.44 Msps, 0.2 s blocks behind
    their heads: a plan inside a block's threads and shared memory whose
    staged span covers every tap of every output.  Past ~10 Msps the big
    tiles' span (255 strides and the taps, staged twice) no longer fits, and
    the plan takes a phase set a phase."""
    decim = max(1, rate // 240_000)
    big_t = len(tops.design_decimation_fir(decim, float(rate)))
    n_out = (rate // 5 - 1) // decim + 1
    plan = tfir.k7_plan(big_t, decim, rows, n_out, True, False)
    assert plan is not None
    assert plan.smem <= tfir._K7_SMEM_MAX and 32 <= plan.threads <= tfir._K7_MAX_THREADS
    assert plan.splits == 1 or plan.threads % 32 == 0
    assert plan.span == (plan.tile - 1) * decim + big_t
    assert_span_covers(plan, big_t, decim, n_out)
    if rate > 10_000_000:
        assert not plan.direct and plan.phase_sets == decim


def test_plan_wide_slots_at_20_msps(rng):
    """The wide slots of a 20 Msps capture (2,085 taps, stride 83) behind
    their heads, at 6,000 outputs a slot, where the plan is the one of the
    0.2 s block's 48,193: its emulation against the reference's
    ``fir_decimate``."""
    fs, decim = 20_000_000.0, 83
    taps = tops.design_decimation_fir(decim, fs)
    assert len(taps) == 2085
    n = 6_000 * decim
    plan = tfir.k7_plan(len(taps), decim, 2, n // decim, True, False)
    block = tfir.k7_plan(len(taps), decim, 2, (4_000_000 - 1) // decim + 1, True, False)
    assert (plan.groups, plan.phase_sets, plan.splits, plan.direct) == \
        (block.groups, block.phase_sets, block.splits, block.direct) == (6, 83, 1, False)
    x = noise(rng, n, cplx=True)
    head = noise(rng, (2, len(taps) - 1), cplx=True)
    got = k7_emulate(np.concatenate([head, np.broadcast_to(x, (2, n))], -1), taps, decim, plan)
    for i in range(2):
        ref, _ = jops.fir_decimate(jnp.asarray(x), jnp.asarray(taps), decim, jnp.asarray(head[i]))
        assert ref.shape == (n // decim,)
        assert rel_l2(ref, got[i]) <= 1e-5, i
