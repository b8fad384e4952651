"""K3's launch plan (``models/channel_bank.py:k3_plan``, ``kernels/csrc/
slot_frontend.cu``) emulated in numpy against the JAX package, on the CPU.

The kernel cuts each slot row into ``cluster`` segments of ``seg``
samples, one CTA each; a thread mixes 4 consecutive samples a pass with
the closed-form NCO phase ``p0 + n dphi``; the discriminator takes
``y[n-1]`` from the thread's own samples, the previous lane's last one,
or, for a warp's first lane, recomputes it (the row's first sample takes
``prev``); the power is summed a thread, then by the block sum's shuffle
trees, then over the cluster's CTAs in rank order.  The emulation follows
those rules at the paths' shapes (the slice, programs A, B and D, a mesh
shard of E and F, and a 60,000-sample row, which the kernel's first
design refused) and holds them against ``freq_shift`` + ``rssi_dbfs`` +
``quadrature_demod``: tuning words and phases bit-exact, RSSI within 1e-3
dB (another summation order), the discriminator >= 80 dB (fast atan2 and
the mix in float32 against XLA's), shifted rows within rel L2 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu_torch.models import channel_bank as tcb
from wavecap_tpu_torch.ops import demod as tdemod
from wavecap_tpu_torch.ops import nco as tnco
from tests.conftest import snr_db

torch.set_num_threads(1)

RATE = 25_000.0  # the channel rate of 12.5 kHz bins at 10 Msps
SCALE = float(np.float32(RATE / (2.0 * np.pi * 5_000.0)))


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128).ravel()
    got = np.asarray(got).astype(np.complex128).ravel()
    return float(np.linalg.norm(ref - got) / np.linalg.norm(ref))


def mix(x: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """The kernel's mix of samples ``x`` at NCO counts ``acc`` (float32)."""
    ph = acc.astype(np.float32) * np.float32(2 * np.pi / 2**32)
    c, s = (f(torch.from_numpy(ph)).numpy() for f in (torch.cos, torch.sin))
    re, im = x.real.astype(np.float32), x.imag.astype(np.float32)
    return ((re * c - im * s) + 1j * (re * s + im * c)).astype(np.complex64)


def shuffle_tree(v: np.ndarray) -> np.ndarray:
    """``v += shfl_xor(v, o)`` for o = 16 .. 1 over the last axis (32 lanes)."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lane ^ o]).astype(np.float32)
    return v


def block_sum(v: np.ndarray) -> np.ndarray:
    """``common.cuh:block_sum`` over the last axis (threads, a multiple of 32)."""
    warps = v.shape[-1] // 32
    lanes = shuffle_tree(v.reshape(v.shape[:-1] + (warps, 32)))[..., 0]  # each warp's total
    pad = np.zeros(v.shape[:-1] + (32,), np.float32)
    pad[..., :warps] = lanes
    return shuffle_tree(pad)[..., 0]


def k3_emulate(chans, index, dphi, p0, prev, mode: int, plan: tcb.K3Plan):
    """K3 by ``plan``: ``(out, rssi, phase1, last)``."""
    m, s = chans.shape
    slots = index.shape[0]
    seg, cluster, threads, passes = plan.seg, plan.cluster, plan.threads, plan.passes
    assert seg % 128 == 0 and 1 <= cluster <= 8 and threads % 32 == 0 and threads <= 512
    assert (cluster - 1) * seg < s <= cluster * seg and passes * threads * 4 >= seg
    assert plan.ctas == slots * cluster
    x = chans[np.clip(index, 0, m - 1)]  # the reference's gather clamps
    # each sample's place: CTA rank, pass, thread, slot in the thread
    n = np.arange(s)
    rank, off = n // seg, n % seg
    pss, rem = off // (threads * 4), off % (threads * 4)
    tid, j = rem // 4, rem % 4
    assert (rank < cluster).all() and (pss < passes).all()
    acc = (p0[:, None].astype(np.uint64) + n.astype(np.uint64) * dphi[:, None].astype(np.uint64)) & 0xFFFFFFFF
    y = mix(x, acc)
    # the power: a thread's samples in pass and sample order, zero-padded
    # past its segment, then the block sum, then the ranks in order
    span = cluster * passes * threads * 4
    yp = np.zeros((slots, span), np.complex64)
    yp[:, rank * passes * threads * 4 + pss * threads * 4 + tid * 4 + j] = y
    sq = (yp.real * yp.real + yp.imag * yp.imag).astype(np.float32)
    sq = sq.reshape(slots, cluster, passes, threads, 4)
    power = np.zeros((slots, cluster, threads), np.float32)
    for p in range(passes):
        for jj in range(4):
            power = (power + sq[:, :, p, :, jj]).astype(np.float32)
    part = block_sum(power)
    tot = np.zeros(slots, np.float32)
    for r in range(cluster):
        tot = (tot + part[:, r]).astype(np.float32)
    rssi = (np.float32(10.0) * np.log10(np.maximum(tot / np.float32(s), np.float32(1e-20)))).astype(np.float32)
    phase1 = ((p0.astype(np.uint64) + np.uint64(s) * dphi.astype(np.uint64)) & 0xFFFFFFFF).astype(np.uint32)
    if mode == 2:
        return y, rssi, phase1, None
    # y[n-1]: the thread's own (j > 0), the previous lane's last (lane > 0),
    # else recomputed from the row and the phase; the row's first takes prev
    lane = tid % 32
    from_lane = (j == 0) & (lane > 0)
    n_lane = rank * seg + pss * threads * 4 + (tid - 1) * 4 + 3
    assert (n_lane[from_lane] == n[from_lane] - 1).all()
    recompute = (j == 0) & (lane == 0) & (n > 0)
    left = np.empty_like(y)
    left[:, 1:] = y[:, :-1]
    nr = n[recompute]
    left[:, recompute] = mix(x[:, nr - 1], acc[:, nr - 1])
    left[:, 0] = prev
    prod = y * np.conj(left)
    re, im = (torch.from_numpy(np.ascontiguousarray(v.astype(np.float32))) for v in (prod.real, prod.imag))
    fm = (tdemod.fast_atan2(im, re) if mode == 1 else torch.atan2(im, re)).numpy() * np.float32(SCALE)
    return fm.astype(np.float32), rssi, phase1, y[:, -1]


def case(rng, slots: int, bins: int, s: int, mode: int):
    t = np.arange(s) / RATE
    if mode == 2:
        x = 0.1 * (rng.standard_normal((bins, s)) + 1j * rng.standard_normal((bins, s)))
    else:  # NBFM tones at high SNR, clear of the discriminator's branch cut
        tone = rng.uniform(300.0, 2500.0, (bins, 1))
        dev = rng.uniform(1000.0, 4000.0, (bins, 1))
        carrier = rng.uniform(-2000.0, 2000.0, (bins, 1))
        x = rng.uniform(0.1, 0.5, (bins, 1)) * np.exp(
            2j * np.pi * (carrier * t - dev * np.cos(2 * np.pi * tone * t) / (2 * np.pi * tone)))
        x += 1e-3 * (rng.standard_normal((bins, s)) + 1j * rng.standard_normal((bins, s)))
    index = rng.permutation(bins)[:slots].astype(np.int32) if slots < bins else np.arange(slots, dtype=np.int32)
    if slots > 2:
        index[:2] = (bins + 5, bins + 100)  # past the last bin: clamped
    offset = rng.uniform(-1500.0, 1500.0, slots).astype(np.float32)
    p0 = rng.integers(0, 2**32, slots, dtype=np.uint64).astype(np.uint32)
    prev = (0.3 * np.exp(1j * rng.uniform(-np.pi, np.pi, slots))).astype(np.complex64)
    return x.astype(np.complex64), index, offset, p0, prev


SHAPES = [  # (slots, bins, row length, mode): the paths' K3 launches
    (800, 800, 4_920, 1),   # the slice
    (160, 800, 4_920, 2),   # program D's banks
    (100, 100, 4_592, 2),   # a mesh shard of program E
    (50, 50, 12_000, 2),    # a mesh shard of program F
    (50, 400, 12_500, 2),   # program A's banks
    (21, 96, 7_500, 2),     # program B's bank (M = 96)
    (1, 4, 60_000, 0),      # a row past the first design's limit, exact atan2
    (1, 4, 60_000, 1),
    (3, 8, 203, 1),         # a short row whose length is not a multiple of 4
]


@pytest.mark.parametrize("slots,bins,s,mode", SHAPES)
def test_emulated_plan_matches_reference(rng, slots, bins, s, mode):
    x, index, offset, p0, prev = case(rng, slots, bins, s, mode)
    plan = tcb.k3_plan(slots, s, mode)
    # the tuning words: the port's f32 hi/lo split equals the reference's
    dphi = tnco.tuning_word(torch.from_numpy(-offset), RATE).numpy()
    np.testing.assert_array_equal(dphi, np.asarray(jops.tuning_word(jnp.asarray(-offset), RATE)))
    out, rssi, phase1, last = k3_emulate(x, index, dphi, p0, prev, mode, plan)
    sel = jnp.asarray(x)[jnp.asarray(index)]  # the reference's gather (clamped)
    shifted, ref_phase1 = jops.freq_shift(sel, -jnp.asarray(offset)[:, None], RATE, jnp.asarray(p0)[:, None])
    np.testing.assert_array_equal(phase1, np.asarray(ref_phase1).ravel())
    ref_rssi = np.asarray(jops.rssi_dbfs(shifted))
    assert np.max(np.abs(rssi - ref_rssi)) <= 1e-3
    if mode == 2:
        assert rel_l2(np.asarray(shifted), out) <= 1e-6
        return
    ref_fm, ref_last = jops.quadrature_demod(shifted, RATE, jnp.asarray(prev), max_deviation_hz=5_000.0,
                                             atan_impl="fast" if mode == 1 else "exact")
    assert snr_db(np.asarray(ref_fm), out) >= 80.0
    assert rel_l2(np.asarray(ref_last), last) <= 1e-5


@pytest.mark.parametrize("slots,s", [(800, 4_920), (160, 4_920), (100, 4_592), (50, 12_000), (50, 12_500),
                                     (21, 7_500), (1, 60_000), (1, 1), (7, 129), (2, 1_000_000)])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plan_covers_every_sample_once(slots, s, mode):
    """Every sample of a row in exactly one (CTA, pass, thread, slot) place,
    clusters of 8 CTAs or fewer, no empty CTA, rows of any length."""
    plan = tcb.k3_plan(slots, s, mode)
    assert 1 <= plan.cluster <= 8 and plan.seg % 128 == 0 and plan.threads % 32 == 0
    assert 32 <= plan.threads <= 512 and plan.ctas == slots * plan.cluster
    assert (plan.cluster - 1) * plan.seg < s <= plan.cluster * plan.seg
    stride = plan.threads * 4
    taken = []
    for rank in range(plan.cluster):
        lo, hi = rank * plan.seg, min(s, (rank + 1) * plan.seg)
        n = lo + np.arange(plan.passes)[:, None, None] * stride + 4 * np.arange(plan.threads)[None, :, None] \
            + np.arange(4)[None, None, :]
        taken.append(n[n < hi])
        assert lo + plan.passes * stride >= hi
    np.testing.assert_array_equal(np.bincount(np.concatenate(taken), minlength=s), 1)


def test_plan_fills_the_card_on_the_mesh_shards():
    """A shard's 50 or 100 rows are split so the launch has >= 400 CTAs;
    the slice's 800 rows keep a CTA a row."""
    for slots, s in ((50, 12_000), (100, 4_592), (160, 4_920)):
        assert tcb.k3_plan(slots, s, 2).ctas >= 400
    assert tcb.k3_plan(800, 4_920, 1).cluster == 1
