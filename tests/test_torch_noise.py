"""The port's noise blanker and spectral noise reduction (K11a, K11b)
against the JAX package's, on the CPU.

Floors, each with its reason:

* the blanker's output equals the reference's except within the blanking
  width of a sample whose |x| lies within 2 ulp of the reference's
  threshold (the two libraries' |x| of a complex sample may differ by an
  ulp, which flips a comparison there); such samples are <= 0.1 % of the
  input;
* the noise reduction >= 80 dB SNR against the reference: pocketfft
  against torch's CPU FFT, the same f32 gain and overlap-add.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu.ops import noise as jnoise
from wavecap_tpu_torch.kernels import launch_counts
from wavecap_tpu_torch.ops import noise as tnoise
from tests.conftest import snr_db

torch.set_num_threads(1)


def impulsive_rows(rng, shape, cplx: bool) -> np.ndarray:
    """Noise with a tone and a train of strong impulses (2-3 samples wide)."""
    rows, n = shape
    x = 0.05 * rng.standard_normal(shape)
    x = x + 0.2 * np.sin(2 * np.pi * 0.013 * np.arange(n))
    if cplx:
        x = x + 1j * (0.05 * rng.standard_normal(shape) + 0.2 * np.cos(2 * np.pi * 0.013 * np.arange(n)))
    for r in range(rows):
        for at in rng.choice(max(n - 3, 1), size=max(n // 400, 1), replace=False):
            x[r, at:at + rng.integers(1, 4)] *= 40.0
    return x.astype(np.complex64 if cplx else np.float32)


def dilate(mask: np.ndarray, width: int) -> np.ndarray:
    out = mask.copy()
    for d in range(1, width + 1):
        out[..., d:] |= mask[..., :-d]
        out[..., :-d] |= mask[..., d:]
    return out


def assert_blanker_matches(x, threshold_db, width):
    ref = np.asarray(jax.jit(lambda v: jnoise.noise_blanker(v, threshold_db, width))(jnp.asarray(x)))
    got = tnoise.noise_blanker(torch.from_numpy(x), threshold_db, width).numpy()
    assert got.dtype == x.dtype and got.shape == x.shape
    jmag = np.asarray(jnp.abs(jnp.asarray(x)))
    median = np.asarray(jnp.median(jnp.asarray(jmag), axis=-1, keepdims=True))
    thr = median * np.float32(10.0 ** (threshold_db / 20.0))
    ulp = np.spacing(np.abs(thr))
    near = (np.abs(jmag - thr) <= 2 * ulp) | (np.abs(np.abs(x).astype(np.float32) - thr) <= 2 * ulp)
    near &= median >= 1e-10  # a degenerate row is copied whatever its threshold
    assert near.sum() <= 1e-3 * near.size
    differ = ref != got
    assert not (differ & ~dilate(near, width)).any(), int((differ & ~dilate(near, width)).sum())
    return ref, got


@pytest.mark.parametrize("width", [0, 3])
@pytest.mark.parametrize("cplx", [False, True], ids=["float32", "complex64"])
@pytest.mark.parametrize("shape", [(4, 4920), (3, 4919), (2, 12_000)])
def test_noise_blanker_matches(rng, shape, cplx, width):
    x = impulsive_rows(rng, shape, cplx)
    ref, got = assert_blanker_matches(x, 10.0, width)
    # the impulses were blanked, and the quiet samples kept
    assert (got == 0).sum() >= shape[0] * (shape[1] // 400)
    assert (got != 0).mean() > 0.9


def test_noise_blanker_threshold_and_degenerate_rows(rng):
    """Another threshold; an all-zero row (median below 1e-10) and an empty
    row pass through unchanged; the CPU wrapper launches no kernel."""
    before = launch_counts()
    x = impulsive_rows(rng, (3, 3001), True)
    x[1] = 0
    x[2, ::2] = 0  # the median is 0: degenerate
    _, got = assert_blanker_matches(x, 6.0, 3)
    np.testing.assert_array_equal(got[1:], x[1:])
    empty = torch.zeros((2, 0), dtype=torch.float32)
    assert tnoise.noise_blanker(empty) is empty
    assert launch_counts() == before


@pytest.mark.parametrize("db", [6.0, 12.0])
@pytest.mark.parametrize("n", [9447, 1024, 1023])
def test_spectral_noise_reduction_matches(rng, n, db):
    """n = 9,447 (17 frames, a 231-sample tail that passes through), 1,024
    (one frame) and 1,023 (shorter than a frame: the input comes back)."""
    tt = np.arange(n) / 48_000.0
    x = (0.3 * np.sin(2 * np.pi * 1000.0 * tt) + 0.05 * rng.standard_normal((3, n))).astype(np.float32)
    x[2] *= 0.0  # digital silence: every bin's floor and gain at their limits
    ref = np.asarray(jax.jit(lambda v: jnoise.spectral_noise_reduction(v, db))(jnp.asarray(x)))
    got = tnoise.spectral_noise_reduction(torch.from_numpy(x), db).numpy()
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    if n < 1024:
        np.testing.assert_array_equal(got, x)
        return
    for r in range(2):
        assert snr_db(ref[r], got[r]) >= 80.0, r
    assert not got[2].any() and not ref[2].any()
    hop, frames, out_len = tnoise._nr_plan(n, 1024, 0.5)
    assert (hop, frames) == (512, (n - 1024) // 512 + 1)
    np.testing.assert_array_equal(got[:, out_len:], x[:, out_len:])
    # the two agree to float rounding (the 80 dB floor is far from the limit)
    assert np.std(got[0, :out_len] - ref[0, :out_len]) < 1e-5


@pytest.mark.parametrize("frames", [2, 17, 33, 92])
def test_percentile_position_is_the_references(frames):
    """q (F - 1) in float32 as the jitted jnp.percentile computes it (the
    reference's noise reduction runs inside the engine's jitted program;
    op by op, XLA's CPU divide 10 / 100 lands one ulp lower)."""
    pos = tnoise._percentile_pos(frames)
    assert pos == float(np.float32(np.float32(0.1) * np.float32(frames - 1)))
    col = np.arange(frames, dtype=np.float32)[::-1].copy()
    ref = float(jax.jit(lambda v: jnp.percentile(v, 10.0))(jnp.asarray(col)))
    lo = int(np.floor(pos))
    hw = np.float32(np.float32(pos) - np.float32(lo))
    srt = np.sort(col)
    assert ref == float(srt[lo] * (np.float32(1) - hw) + srt[min(lo + 1, frames - 1)] * hw)


# --- K11a's and K11b's launch plans (kernels/csrc/noise_*.cu), emulated in numpy -------
#
# Each emulation follows its kernel step by step on the plan's own numbers
# (CTAs, slices, digits, buckets, tiles) and must reproduce the JAX
# package's values exactly: a select or an order statistic is exact, so
# there is no tolerance.

# n: 1, 2, 3, a row either side of the NBFM rows' 4,920, the wide IF's
# 48,000 (a cluster of 8), and 400,000 (past a cluster's shared memory)
SELECT_NS = [1, 2, 3, 4919, 4920, 48_000, 400_000]


def k11a_select_emulate(mag: np.ndarray, plan) -> tuple:
    """K11a's ranks (n-1)/2 and n/2 and their midpoint (the median) of one
    row's float32 magnitudes: per-CTA slices, each
    pass's partial histograms summed as the cluster sums them, rank
    (n-1)/2 digit by digit, rank n/2 from the last pass (its bucket, or
    the least magnitude above the last prefix's range)."""
    n = mag.size
    bits = mag.astype(np.float32).view(np.uint32).astype(np.int64)
    slices = [bits[r * plan.slice:(r + 1) * plan.slice] for r in range(plan.ctas)]
    assert sum(s.size for s in slices) == n  # every sample in one slice
    lo, hi = (n - 1) // 2, n // 2
    prefix, pmask, k, shift, a_hi = 0, 0, lo, 32, None
    for p, d in enumerate(plan.digits):
        shift -= d
        dmask = (1 << d) - 1
        top = prefix | (~pmask & 0xFFFFFFFF)
        parts, above = [], 0xFFFFFFFF
        for s in slices:
            inn = (s & pmask) == prefix
            parts.append(np.bincount((s[inn] >> shift) & dmask, minlength=1 << d))
            above = min(above, int(s[s > top].min(initial=0xFFFFFFFF)))
        cum = np.cumsum(sum(parts))
        b = int(np.searchsorted(cum, k, side="right"))
        below = int(cum[b - 1]) if b else 0
        if p == len(plan.digits) - 1:
            if hi == lo:
                a_hi = prefix | b
            elif k + 1 < cum[-1]:
                a_hi = prefix | int(np.searchsorted(cum, k + 1, side="right"))
            else:
                a_hi = above
        k -= below
        prefix |= b << shift
        pmask |= dmask << shift
    pair = np.array([prefix, a_hi], np.uint32).view(np.float32)
    return pair, np.float32((pair[0] + pair[1]) * np.float32(0.5))


def select_rows(rng, n: int, cplx: bool) -> dict:
    """The adversarial rows: noise with impulses, magnitudes quantised to
    1/64 (many ties at the median), all equal, all zero, subnormal."""
    base = impulsive_rows(rng, (1, n), cplx)[0]
    rows = {"impulsive": base,
            "ties": (np.round(base.real * 64) / 64).astype(base.dtype),
            "equal": np.full(n, 0.25 + 0.25j if cplx else -0.25, base.dtype),
            "zero": np.zeros(n, base.dtype),
            "subnormal": (base * np.float32(1e-39)).astype(base.dtype)}
    return rows


@pytest.mark.parametrize("cplx", [False, True], ids=["float32", "complex64"])
@pytest.mark.parametrize("n", SELECT_NS)
def test_k11a_select_is_jnp_median(rng, n, cplx):
    """The emulated select finds the sorted magnitudes' ranks (n-1)/2 and
    n/2 and returns jnp.median(|x|) bit for bit.  One exception, stated:
    XLA's CPU flushes a subnormal result to zero, the card does not, so on
    the subnormal row the JAX median is 0 and the select's the exact
    subnormal midpoint; both lie below the 1e-10 degenerate threshold, so
    the row passes unchanged either way."""
    plan = tnoise.k11a_plan(n, cplx)
    assert plan.staged == (n < 400_000)
    for what, x in select_rows(rng, n, cplx).items():
        mag = np.asarray(jnp.abs(jnp.asarray(x)))
        want = np.float32(jnp.median(jnp.asarray(mag)))
        (a_lo, a_hi), got = k11a_select_emulate(mag, plan)
        srt = np.sort(mag)
        assert a_lo.view(np.uint32) == srt[(n - 1) // 2].view(np.uint32), what
        assert a_hi.view(np.uint32) == srt[n // 2].view(np.uint32), what
        if what == "subnormal":
            assert want == 0 and got < np.finfo(np.float32).tiny, (got, want)
            assert got == np.float32((srt[(n - 1) // 2] + srt[n // 2]) * np.float32(0.5))
            continue
        assert got.view(np.uint32) == want.view(np.uint32), (what, got, want)


def k11a_mask_emulate(hit: np.ndarray, width: int, plan) -> np.ndarray:
    """K11a's dilated mask of one row: each CTA's ballot words over its
    slice (bits past n are 0), read from the CTA that holds them (0 outside
    the row); then for each word q, with w < 32, words q-1:q spread to later
    samples and q:q+1 to earlier ones by 0..w (doubling the covered shifts),
    else the OR over d in [-w, w] of the 32 bits from sample 32 q + d, a
    funnel shift of words floor(s / 32) and floor(s / 32) + 1."""
    n = hit.size
    n_words = -(-n // 32)
    wpc = plan.slice // 32
    ctas_words = []
    for r in range(plan.ctas):
        s = hit[r * plan.slice:(r + 1) * plan.slice]
        s = np.concatenate([s, np.zeros(-s.size % 32, bool)]).reshape(-1, 32)
        ctas_words.append((s.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1))

    def word_at(q):
        if q < 0 or q >= n_words:
            return 0
        r = q // wpc
        return int(ctas_words[r][q - r * wpc])

    out = np.zeros(n_words * 32, bool)
    for q in range(n_words):
        if width < 32:
            right = word_at(q) << 32 | word_at(q - 1)
            left = word_at(q + 1) << 32 | word_at(q)
            cover = 1
            while cover <= width:
                step = min(cover, width + 1 - cover)
                right |= (right << step) & 0xFFFFFFFFFFFFFFFF
                left |= left >> step
                cover += step
            acc = (right >> 32 | left) & 0xFFFFFFFF
        else:
            acc = 0
            for d in range(-width, width + 1):
                s = 32 * q + d
                qq = s >> 5
                acc |= ((word_at(qq + 1) << 32 | word_at(qq)) >> (s & 31)) & 0xFFFFFFFF
        out[32 * q:32 * q + 32] = (acc >> np.arange(32)) & 1
    return out[:n]


@pytest.mark.parametrize("width", [0, 1, 3, 31, 32, 40])
@pytest.mark.parametrize("n", [997, 12_345])
def test_k11a_dilation_is_the_max_pool(rng, n, width):
    """The word-wise dilation (both of the kernel's paths: w < 32 and w >=
    32) equals the reference's SAME max-pool of the mask (n not a multiple
    of 32; 12,345 spans a cluster of 3 CTAs)."""
    plan = tnoise.k11a_plan(n, True)
    assert plan.ctas == (1 if n < 6144 else 3)
    hit = rng.random(n) < 0.01
    hit[[0, n - 1]] = True  # both edges of the row
    mask = jnp.asarray(hit.astype(np.float32))[None]
    if width > 0:
        mask = jax.lax.reduce_window(mask, 0.0, jax.lax.max, (1, 2 * width + 1), (1, 1), "SAME")
    want = np.asarray(mask)[0] > 0
    np.testing.assert_array_equal(k11a_mask_emulate(hit, width, plan), want)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("n", SELECT_NS + [6144, 6145, 349_000, 2**30 - 1])
def test_k11a_plan_fits(n, cplx):
    """At most 8 CTAs a row, 32-aligned slices covering the row with none
    empty, digits of 32 bits whose histograms the threads sum in equal
    runs, shared memory as the kernel lays it out within 227 KB, and int32
    offsets within a row."""
    plan = tnoise.k11a_plan(n, cplx)
    assert 1 <= plan.ctas <= 8 and plan.slice % 32 == 0
    assert plan.ctas * plan.slice >= n > (plan.ctas - 1) * plan.slice
    assert plan.ctas == 1 or plan.slice <= tnoise.K11A_SLICE or plan.ctas == 8
    assert sum(plan.digits) == 32
    assert all((1 << d) % plan.threads == 0 for d in plan.digits)  # a thread's run of bins
    assert (1 << max(plan.digits)) <= 4 * plan.threads  # at most the kernel's kMaxPer bins
    assert plan.threads % 32 == 0 and plan.threads <= 512
    # the fewest items a thread that hold a staged slice (one chunk: kept in registers)
    fits = [i for i in tnoise.K11A_ITEMS if plan.slice <= i * plan.threads]
    assert plan.items == (min(fits) if plan.staged and fits else max(tnoise.K11A_ITEMS))
    hists = 4 * (3 if plan.ctas > 1 else 2) * (1 << max(plan.digits))  # two buffers, a cluster's sums
    staged = hists + 4 * (2 * (plan.slice // 32) + plan.slice)
    assert plan.smem == (staged if plan.staged else hists)
    assert plan.smem <= tnoise.SMEM_LIMIT <= 232_448
    assert plan.staged == (staged <= tnoise.SMEM_LIMIT)
    assert n * (2 if cplx else 1) < 2**31  # a row's float offsets in int32
    if n <= 48_000:
        assert plan.staged


def k11b_floor_emulate(mag: np.ndarray, plan, pos: float) -> np.ndarray:
    """K11b's per-bin ranks floor(q) and ceil(q) and its floor, from (F,
    bins) float32 magnitudes: the register variant's compare-exchange
    insertion of the F values (padded with +inf to the bucket) into the
    ``least`` smallest, or the staged variant's ranks by counting (equal
    values in frame order); the floor ``lo lw + hi hw`` rounded after each
    operation, as the kernel and the plain version round it."""
    frames, bins = mag.shape
    lo, hi = min(int(np.floor(pos)), frames - 1), min(int(np.ceil(pos)), frames - 1)
    hw = np.float32(np.float32(pos) - np.float32(np.floor(pos)))
    lw = np.float32(np.float32(1.0) - hw)
    if plan.bucket:
        assert frames <= plan.bucket and hi < plan.least
        padded = np.full((plan.bucket, bins), np.inf, np.float32)
        padded[:frames] = mag
        least = np.full((plan.least, bins), np.inf, np.float32)
        for f in range(plan.bucket):
            c = padded[f]
            for j in range(plan.least):
                least[j], c = np.fmin(least[j], c), np.fmax(least[j], c)
        v_lo, v_hi = least[lo], least[hi]
    else:
        assert 4 * (frames * plan.tile + plan.tile) == plan.smem
        g = np.arange(frames)
        less = (mag[None, :, :] < mag[:, None, :]).sum(1)
        ties = ((mag[None, :, :] == mag[:, None, :]) & (g[None, :] < g[:, None])[..., None]).sum(1)
        rank = less + ties  # (F, bins): a permutation of 0..F-1 in each column
        assert (np.sort(rank, 0) == g[:, None]).all()
        v_lo = np.where(rank == lo, mag, 0).sum(0).astype(np.float32)
        v_hi = np.where(rank == hi, mag, 0).sum(0).astype(np.float32)
    return v_lo, v_hi, lw, hw, (v_lo * lw + v_hi * hw).astype(np.float32)


@pytest.mark.parametrize("frames", [1, 2, 17, 32, 33, 92])
def test_k11b_floor_is_jnp_percentile(rng, frames):
    """The emulated ranks are the sorted magnitudes' and give the jitted
    jnp.percentile(|X|, 10, axis=-2) bit for bit, with ties (magnitudes
    quantised to 1/8) and all-zero columns.  XLA's CPU contracts the
    percentile's ``lo lw + hi hw`` into one fma; the kernel keeps the
    plain version's two roundings (no contraction), so its floor is held
    to the fma form bit for bit through the ranks and to the reference
    within 1 ulp."""
    bins = 129
    mag = np.abs(rng.standard_normal((frames, bins))).astype(np.float32)
    mag[:, 1::3] = np.round(mag[:, 1::3] * 8) / 8
    mag[:, ::7] = 0.0
    want = np.asarray(jax.jit(lambda m: jnp.percentile(m, 10.0, axis=-2))(jnp.asarray(mag)))
    plan = tnoise.k11b_plan(frames)
    assert (plan.bucket > 0) == (frames <= 32)
    pos = tnoise._percentile_pos(frames)
    v_lo, v_hi, lw, hw, got = k11b_floor_emulate(mag, plan, pos)
    srt = np.sort(mag, axis=0)
    np.testing.assert_array_equal(v_lo, srt[int(np.floor(pos))])
    np.testing.assert_array_equal(v_hi, srt[min(int(np.ceil(pos)), frames - 1)])
    # fma(lo, lw, hi hw): the exact product plus the rounded one, rounded once
    fused = (v_lo.astype(np.float64) * lw + (v_hi * hw).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(fused.view(np.uint32), want.view(np.uint32))
    assert np.all(np.abs(got.view(np.int32) - want.view(np.int32)) <= 1)


@pytest.mark.parametrize("frames", [1, 8, 9, 17, 24, 25, 32, 33, 92, 1000, 51_199])
def test_k11b_plan_fits(frames):
    """The register variant's bucket holds the frames and its ``least``
    holds rank ceil(q); the staged variant's tile within 227 KB; the
    gain's thread index (rows x bins) in int32 at 160 rows."""
    plan = tnoise.k11b_plan(frames)
    pos = tnoise._percentile_pos(frames)
    if plan.bucket:
        assert plan.bucket in tnoise.K11B_BUCKETS and frames <= plan.bucket
        assert int(np.ceil(pos)) < plan.least == -(-(plan.bucket - 1) // 10) + 1
    else:
        assert frames > 32 and 1 <= plan.tile <= 32
        assert plan.smem == 4 * (frames * plan.tile + plan.tile) <= tnoise.SMEM_LIMIT
        assert plan.tile == 32 or 4 * (frames * 2 * plan.tile + 2 * plan.tile) > tnoise.SMEM_LIMIT
    assert 160 * 513 < 2**31
    with pytest.raises(ValueError):
        tnoise.k11b_plan(51_200)
