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
