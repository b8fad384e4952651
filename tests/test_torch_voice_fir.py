"""K4's launch plan (``models/channel_bank.py:k4_plan``, ``kernels/csrc/
voice_fir.cu``) emulated in numpy against the JAX package, on the CPU.

The kernel gives each CTA ``whole`` rows of its own first (the slice:
two rows each for 396 CTAs), then cuts each row left into ``cluster``
segments of ``seg`` outputs, one CTA each; a CTA stages, a pass at a time, the inputs of
``threads x 16`` outputs and their 126-sample halo (``hp_z`` at the row's
start, zeros past the pass's inputs); a thread forms 16 consecutive
outputs over the 127 taps from that window alone; each thread's energy is
its outputs' squares in order, then the block sum's shuffle trees, then
(for a cut row) the cluster's CTAs in rank order, and every CTA forms the
gain from that total.  The emulation follows those rules at the slice's shape, on a
60,000-sample row (which the kernel's first design refused), a
150,000-sample row (three passes a segment), rows of 1 and of 100 samples
(shorter than the taps), a zero row and rows whose RMS sits just above and
just below the normalization's 1e-4 floor, and holds them against
``fir_filter`` + ``rms_normalize`` + ``soft_clip`` + ``squelch_gate`` and
the active mask: audio >= 70 dB on open slots (the taps summed as the
kernel does, in f32, against XLA's convolution), shut and inactive slots
silent, the tails bit-exact and the RSSI exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.models import analog as janalog
from wavecap_tpu_torch.models import analog as tanalog
from wavecap_tpu_torch.models import channel_bank as tcb
from tests.conftest import snr_db

torch.set_num_threads(1)

T = 127
R = 16  # outputs a thread
TARGET = np.float32(0.18)
CLIP = np.float32(np.float32(1.0 / np.tanh(1.5)) * np.float32(0.95))


def shuffle_tree(v: np.ndarray) -> np.ndarray:
    """``v += shfl_xor(v, o)`` for o = 16 .. 1 over the last axis (32 lanes)."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lane ^ o]).astype(np.float32)
    return v


def block_sum(v: np.ndarray) -> np.ndarray:
    """``common.cuh:block_sum`` over the last axis (threads, a multiple of 32)."""
    warps = v.shape[-1] // 32
    lanes = shuffle_tree(v.reshape(v.shape[:-1] + (warps, 32)))[..., 0]
    pad = np.zeros(v.shape[:-1] + (32,), np.float32)
    pad[..., :warps] = lanes
    return shuffle_tree(pad)[..., 0]


def voice_taps() -> np.ndarray:
    cfg = tanalog.NbfmConfig(sample_rate=25_000, audio_rate=25_000, filter_impl="fir",
                             enable_highpass=True, enable_lowpass=True)
    taps = tanalog.voice_band_taps(cfg)
    ref = janalog._voice_band_fir(25_000, cfg.highpass_hz, cfg.lowpass_hz)
    assert np.array_equal(taps, np.asarray(ref)) and taps.shape == (T,)
    return taps


def k4_emulate(fm, tail, taps, rssi, squelch, active, plan: tcb.K4Plan):
    """K4 by ``plan``: ``(audio, rssi', tail')``; asserts that every output
    is formed once, from its pass's window alone."""
    c, s = fm.shape
    seg, cluster, threads, passes = plan.seg, plan.cluster, plan.threads, plan.passes
    assert seg % R == 0 and 1 <= cluster <= 8 and threads % 32 == 0 and 32 <= threads <= 384
    assert (cluster - 1) * seg < s <= cluster * seg
    assert (passes - 1) * threads * R < seg <= passes * threads * R
    assert plan.ctas % cluster == 0 and 1 <= plan.ctas // cluster
    n_whole = plan.whole * plan.ctas  # CTA b takes rows b, b + ctas, ... alone
    assert n_whole <= c and (plan.whole == 0 or (passes == 1 and threads * R >= s))
    assert plan.whole > 0 or plan.ctas // cluster <= c
    stride = plan.ctas // cluster  # cluster k takes the left rows k, k + stride, ...
    taken = np.concatenate([np.arange(b, n_whole, plan.ctas) for b in range(plan.ctas)]
                           + [np.arange(n_whole + k, c, stride) for k in range(stride)])
    assert np.array_equal(np.sort(taken), np.arange(c))
    xin = np.concatenate([tail, fm], axis=1)
    y = np.zeros((c, s), np.float32)
    formed = np.zeros((c, s), np.int64)
    tile = threads * R

    def segment(rows, lo, hi):
        """The CTA of segment [lo, hi) of ``rows``: its outputs into y, its energy."""
        energy = np.zeros((rows.size, threads), np.float32)
        for t0 in range(lo, hi, tile):
            n_out = min(tile, hi - t0)
            n_fill = -(-n_out // R) * R + T - 1
            win = np.zeros((rows.size, n_fill), np.float32)  # the staged pass: inputs, then zeros
            win[:, :n_out + T - 1] = xin[rows, t0:t0 + n_out + T - 1]
            e = np.arange(n_fill - (T - 1))  # the outputs of the pass's threads
            acc = np.zeros((rows.size, e.size), np.float32)
            for k in range(T):  # fused multiply-adds on the card
                acc = (acc + taps[k] * win[:, e + T - 1 - k]).astype(np.float32)
            keep = e < n_out
            y[rows[:, None], t0 + e[keep]] = acc[:, keep]
            formed[rows[:, None], t0 + e[keep]] += 1
            sq = np.where(keep, acc * acc, np.float32(0.0)).astype(np.float32)
            sq = sq.reshape(rows.size, -1, R)
            for j in range(R):  # a thread's outputs in order
                energy[:, :sq.shape[1]] = (energy[:, :sq.shape[1]] + sq[:, :, j]).astype(np.float32)
        return block_sum(energy)

    total = np.zeros(c, np.float32)
    whole_rows, cut_rows = np.arange(n_whole), np.arange(n_whole, c)
    if whole_rows.size:
        total[whole_rows] = segment(whole_rows, 0, s)  # one CTA: its block sum is the row's
    if cut_rows.size:
        parts = np.stack([segment(cut_rows, r * seg, min(s, r * seg + seg)) for r in range(cluster)], axis=1)
        acc_t = np.zeros(cut_rows.size, np.float32)
        for rank in range(cluster):  # the cluster's CTAs in rank order
            acc_t = (acc_t + parts[:, rank]).astype(np.float32)
        total[cut_rows] = acc_t
    assert (formed == 1).all()
    rms = np.sqrt(total / np.float32(s)).astype(np.float32)
    gain = np.where(rms > np.float32(1e-4), TARGET / np.maximum(rms, np.float32(1e-4)), np.float32(1.0))
    audio = (np.tanh((y * gain[:, None].astype(np.float32)) * np.float32(1.5)) * CLIP).astype(np.float32)
    open_ = active & (rssi >= squelch)
    audio = np.where(open_[:, None], audio, np.float32(0.0))
    return audio, np.where(active, rssi, np.float32(-200.0)), xin[:, s:]


def reference(fm, tail, taps, rssi, squelch, active):
    """The JAX package's chain: ``(audio, rssi', tail')``."""
    y, new_tail = jax.vmap(lambda x, z: jops.fir_filter(x, jnp.asarray(taps), z))(
        jnp.asarray(fm), jnp.asarray(tail))
    a = jops.soft_clip(jops.rms_normalize(y, float(TARGET)))
    a = jops.squelch_gate(a, jnp.asarray(rssi), jnp.asarray(squelch))
    a = jnp.where(jnp.asarray(active)[:, None], a, 0.0)
    r = jnp.where(jnp.asarray(active), jnp.asarray(rssi), -200.0)
    return np.asarray(a), np.asarray(r), np.asarray(new_tail)


def rows_case(rng, slots: int, s: int):
    """Voice-band tones and noise, random tails, a quarter of the slots shut
    and a tenth inactive (slot 0 open)."""
    t = np.arange(s) / 25_000.0
    fm = (rng.uniform(0.2, 1.0, (slots, 1)) * np.sin(2 * np.pi * rng.uniform(300.0, 3000.0, (slots, 1)) * t)
          + 0.05 * rng.standard_normal((slots, s))).astype(np.float32)
    tail = (0.3 * rng.standard_normal((slots, T - 1))).astype(np.float32)
    rssi = rng.uniform(-80.0, -20.0, slots).astype(np.float32)
    shut = rng.random(slots) < 0.25
    active = rng.random(slots) >= 0.1
    shut[0], active[0] = False, True
    squelch = np.where(shut, rssi + 6.0, rssi - 6.0).astype(np.float32)
    return fm, tail, rssi, squelch, active


def assert_matches(got, ref, rssi, squelch, active):
    audio, r_out, t_out = got
    a_ref, r_ref, t_ref = ref
    open_ = active & (rssi >= squelch)
    for i in np.flatnonzero(open_):
        assert snr_db(a_ref[i], audio[i]) >= 70.0, i
    assert not audio[~open_].any() and not a_ref[~open_].any()
    assert np.array_equal(t_out, t_ref) and np.array_equal(r_out, r_ref)


SHAPES = [(800, 4_920), (1, 60_000), (1, 150_000), (4, 1), (4, 100), (3, 49_152), (2, 49_153)]


@pytest.mark.parametrize("slots,s", SHAPES)
def test_plan_covers_every_output(slots, s):
    """Segments of whole 16-output groups cover the row once, at most 8 CTAs
    a row and 384 threads a CTA; one pass a segment up to 8 x 384 x 16
    outputs, so the outputs stay in registers there."""
    plan = tcb.k4_plan(slots, s)
    assert plan.seg % R == 0 and 1 <= plan.cluster <= 8
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 384
    assert (plan.cluster - 1) * plan.seg < s <= plan.cluster * plan.seg
    assert (plan.passes - 1) * plan.threads * R < plan.seg <= plan.passes * plan.threads * R
    assert plan.passes == 1 or s > 8 * 384 * R
    assert plan.ctas % plan.cluster == 0 and 1 <= plan.ctas // plan.cluster
    assert plan.whole * plan.ctas <= slots
    assert plan.whole > 0 or plan.ctas // plan.cluster <= slots
    assert plan.whole == 0 or (plan.passes == 1 and plan.threads * R >= s)


def test_plan_at_the_slice():
    """800 rows of 4,920: CTAs of 320 threads (one pass a row), three an SM
    of the 132: each of the 396 takes 2 rows alone, and the 8 rows left go
    2 segments of 2,464 a row to 8 clusters of 2."""
    assert tcb.k4_plan(800, 4_920) == tcb.K4Plan(2_464, 2, 320, 1, 396, 2)


@pytest.mark.parametrize("slots,s,whole", [(396, 4_920, 1), (400, 4_920, 1), (1_000, 6_144, 3),
                                           (1_000, 6_145, 0), (160, 4_920, 0)])
def test_plan_takes_whole_rows_where_they_fill_the_card(slots, s, whole):
    """Whole rows only where one pass forms a row and every CTA has one."""
    plan = tcb.k4_plan(slots, s)
    assert plan.whole == whole
    assert plan.whole == 0 or slots - plan.whole * plan.ctas < plan.ctas


def test_plan_forced_cuts_every_row():
    """A forced plan is the cut kind (the slice's earlier plan: a CTA a
    row, 396 CTAs)."""
    assert tcb.k4_plan(800, 4_920, forced=(1, 320, 396)) == tcb.K4Plan(4_928, 1, 320, 1, 396, 0)


def test_plan_refuses_other_filters():
    with pytest.raises(ValueError):
        tcb.k4_plan(8, 1_000, 63)


@pytest.mark.parametrize("slots,s,forced", [(800, 4_920, None), (1, 60_000, None), (1, 150_000, None),
                                            (8, 1, None), (8, 100, None), (800, 4_920, (1, 320, 396))],
                         ids=["slice", "60000", "150000-three-passes", "S1", "S100", "slice-every-row-cut"])
def test_emulation_matches_reference(rng, slots, s, forced):
    fm, tail, rssi, squelch, active = rows_case(rng, slots, s)
    taps = voice_taps()
    got = k4_emulate(fm, tail, taps, rssi, squelch, active, tcb.k4_plan(slots, s, forced=forced))
    assert_matches(got, reference(fm, tail, taps, rssi, squelch, active), rssi, squelch, active)


def test_emulation_zero_row_and_the_rms_floor(rng):
    """A zero row (gain 1, silent) and rows whose filtered RMS is 1.001e-4
    (normalized) and 0.999e-4 (gain 1): the branch falls as the
    reference's does."""
    s = 4_000
    fm, tail, rssi, squelch, active = rows_case(rng, 3, s)
    active[:], squelch[:] = True, rssi - 6.0
    taps = voice_taps()
    fm[0], tail[0] = 0.0, 0.0
    y, _ = jax.vmap(lambda x, z: jops.fir_filter(x, jnp.asarray(taps), z))(
        jnp.asarray(fm[1:]), jnp.asarray(tail[1:]))
    rms = np.sqrt(np.mean(np.asarray(y, np.float64) ** 2, axis=-1))
    scale = np.array([1.001e-4, 0.999e-4]) / rms
    fm[1:] = (fm[1:] * scale[:, None]).astype(np.float32)
    tail[1:] = (tail[1:] * scale[:, None]).astype(np.float32)
    ref = reference(fm, tail, taps, rssi, squelch, active)
    got = k4_emulate(fm, tail, taps, rssi, squelch, active, tcb.k4_plan(3, s))
    assert not got[0][0].any() and not ref[0][0].any()
    peak = np.abs(ref[0][1:]).max(axis=-1)
    assert peak[0] > 0.1 and peak[1] < 1e-3  # one normalized, one left at gain 1
    assert_matches(got, ref, rssi, squelch, active)


def test_wrapper_on_the_cpu_matches_reference(rng):
    """``voice_fir`` (its plain version on the CPU) against the reference at
    a small bank, and on an empty block (shapes, the tail, the mask)."""
    slots, s = 6, 700
    fm, tail, rssi, squelch, active = rows_case(rng, slots, s)
    taps = voice_taps()
    bank = tcb.ChannelBankConfig(
        channelizer=tcb.ChannelizerConfig(sample_rate=1e6, channel_bandwidth=25_000.0),
        mode="nbfm", capacity=slots,
        demod_cfg=tanalog.NbfmConfig(sample_rate=25_000, audio_rate=25_000, filter_impl="fir",
                                     enable_highpass=True, enable_lowpass=True))
    assign = tcb.ChannelAssignment(torch.arange(slots, dtype=torch.int32), torch.zeros(slots),
                                   torch.from_numpy(active), torch.from_numpy(squelch))
    got = [v.numpy() for v in tcb.voice_fir(torch.from_numpy(fm), torch.from_numpy(tail),
                                            torch.from_numpy(rssi), assign, bank)]
    assert_matches(got, reference(fm, tail, taps, rssi, squelch, active), rssi, squelch, active)
    a, r, tl = tcb.voice_fir(torch.zeros((slots, 0)), torch.from_numpy(tail), torch.from_numpy(rssi),
                             assign, bank)
    assert a.shape == (slots, 0) and np.array_equal(tl.numpy(), tail)
    assert np.array_equal(r.numpy(), np.where(active, rssi, np.float32(-200.0)))
