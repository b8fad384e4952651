"""The port's IIR filters against the JAX package's and float64 scipy, on the CPU.

The plain versions (CPU tensors) are log-step doubling scans of the same
affine maps the reference composes with ``associative_scan``; the two
scans round differently.  Floors, each with its reason:

* against float64 scipy: the reference's own floors
  (``tests/test_ops_core.py:137-177``), 70 dB for a one-pole and 55 dB
  for a biquad cascade;
* against the JAX package: 50 dB, two f32 scans of poles near 1.

A carried state is held at the scale of the output it feeds (its error
against the output's power): the DF2T states of a high-pass are small
differences of large terms, so their own relative error says little.
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.ops import iir as jiir
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.kernels import launch_counts
from wavecap_tpu_torch.ops import iir as tiir
from tests.conftest import snr_db

torch.set_num_threads(1)

FS = 48_000.0


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def noise(rng, shape) -> np.ndarray:
    return rng.standard_normal(shape).astype(np.float32)


def state_snr_db(y_ref, z_ref, z_got) -> float:
    """The state's error against the power of the output it feeds."""
    err = np.asarray(z_ref, np.float64).ravel() - np.asarray(z_got, np.float64).ravel()
    return 10 * np.log10(np.mean(np.square(y_ref, dtype=np.float64)) / max(np.mean(err * err), 1e-300))


@pytest.mark.parametrize("b0,a", [(0.3, 0.7), (0.05, 0.95), (1.0 - np.exp(-1 / 3.6), np.exp(-1 / 3.6))])
def test_onepole_matches_lfilter_and_reference(rng, b0, a):
    x = noise(rng, 4000)
    got, last = tops.onepole_filter(t(x), b0, a, tops.onepole_init(device="cpu"))
    ref, ref_last = jops.onepole_filter(jnp.asarray(x), b0, a, jops.onepole_init())
    assert snr_db(sps.lfilter([b0], [1.0, -a], x.astype(np.float64)), got.numpy()) > 70
    assert snr_db(np.asarray(ref), got.numpy()) >= 50
    assert abs(float(last) - float(ref_last)) <= 1e-4 * max(1.0, abs(float(ref_last)))


def test_deemphasis_matches_reference(rng):
    """75 us deemphasis at 48 kHz and at the wide IF rates."""
    for fs in (48_000.0, 240_000.0, 243_902.0):
        x = noise(rng, 3000)
        got, _ = tops.deemphasis(t(x), fs, 75e-6, tops.onepole_init(device="cpu"))
        ref, _ = jops.deemphasis(jnp.asarray(x), fs, 75e-6, jops.onepole_init())
        assert snr_db(np.asarray(ref), got.numpy()) >= 50
        assert tiir.deemphasis_coeffs(fs) == jiir.deemphasis_coeffs(fs)


CASCADES = [(btype, order, cut)
            for order in (2, 3, 4, 5)
            for btype, cut in (("low", (3000.0,)), ("low", (15000.0,)), ("high", (100.0,)),
                               ("high", (300.0,)), ("band", (300.0, 3000.0)))]


@pytest.mark.parametrize("btype,order,cut", CASCADES)
def test_butter_matches_sosfilt_and_reference(rng, btype, order, cut):
    x = noise(rng, 6000)
    sos = tops.butter_sos(btype, cut, order, FS)
    np.testing.assert_array_equal(sos, jops.butter_sos(btype, cut, order, FS))
    assert sos.shape[0] == tops.n_sections(btype, order)
    got, z = tops.sos_filter(t(x), sos, tops.sos_init(sos.shape[0], device="cpu"))
    ref, ref_z = jops.sos_filter(jnp.asarray(x), sos, jops.sos_init(sos.shape[0]))
    assert snr_db(sps.sosfilt(sos, x), got.numpy()) > 55
    assert snr_db(np.asarray(ref), got.numpy()) >= 50
    assert z.shape == (sos.shape[0], 2)
    assert state_snr_db(np.asarray(ref), np.asarray(ref_z), z.numpy()) >= 50


@pytest.mark.parametrize("freq", [60.0, 1000.0, 7000.0])
def test_notch_matches_reference(rng, freq):
    x = noise(rng, 5000)
    sos = tiir.notch_sos(freq, 30.0, FS)
    np.testing.assert_array_equal(sos, jiir.notch_sos(freq, 30.0, FS))
    got, _ = tiir.notch(t(x), FS, freq, tops.sos_init(1, device="cpu"))
    ref, _ = jiir.notch(jnp.asarray(x), FS, freq, jops.sos_init(1))
    assert snr_db(sps.sosfilt(sos, x), got.numpy()) > 55
    assert snr_db(np.asarray(ref), got.numpy()) >= 50


def test_sos_split_at_odd_boundaries_batched(rng):
    """Three rows split at odd block edges, the DF2T state carried: the
    stitched output against the reference's one-shot per row (50 dB), and
    the carried state against scipy's ``sosfilt`` state (55 dB)."""
    sos = tops.butter_sos("high", (100.0,), 5, FS)
    x = noise(rng, (3, 7001))
    z = tops.sos_init(sos.shape[0], device="cpu").expand(3, -1, -1)
    parts = []
    for a, b in [(0, 1), (1, 998), (998, 999), (999, 4321), (4321, 7001)]:
        y, z = tops.sos_filter(t(x[:, a:b]), sos, z)
        parts.append(y.numpy())
    got = np.concatenate(parts, axis=-1)
    for i in range(3):
        ref, _ = jops.sos_filter(jnp.asarray(x[i]), sos, jops.sos_init(sos.shape[0]))
        assert snr_db(np.asarray(ref), got[i]) >= 50
        y64, zf = sps.sosfilt(sos, x[i].astype(np.float64), zi=np.zeros((sos.shape[0], 2)))
        assert state_snr_db(y64, zf, z[i].numpy()) > 55


def test_onepole_split_at_odd_boundaries(rng):
    x = noise(rng, (2, 5003))
    y_prev = torch.zeros(2)
    parts = []
    for a, b in [(0, 7), (7, 2500), (2500, 2501), (2501, 5003)]:
        y, y_prev = tops.onepole_filter(t(x[:, a:b]), 0.05, 0.95, y_prev)
        parts.append(y.numpy())
    got = np.concatenate(parts, axis=-1)
    for i in range(2):
        ref = sps.lfilter([0.05], [1.0, -0.95], x[i].astype(np.float64))
        assert snr_db(ref, got[i]) > 70
        assert abs(float(y_prev[i]) - ref[-1]) < 1e-4


def test_empty_block_returns_state_unchanged():
    sos = tops.butter_sos("low", (3000.0,), 5, FS)
    z = torch.arange(6, dtype=torch.float32).reshape(3, 2)
    y, z1 = tops.sos_filter(torch.zeros(0), sos, z)
    assert y.shape == (0,) and torch.equal(z1, z)
    y, last = tops.onepole_filter(torch.zeros(4, 0), 0.3, 0.7, torch.ones(4))
    assert y.shape == (4, 0) and torch.equal(last, torch.ones(4))


def test_cpu_tensors_never_reach_k9(rng):
    before = launch_counts()
    sos = tops.butter_sos("band", (300.0, 3000.0), 5, FS)
    tops.sos_filter(t(noise(rng, (2, 300))), sos, tops.sos_init(5, device="cpu"))
    tops.onepole_filter(t(noise(rng, 300)), 0.3, 0.7, tops.onepole_init(device="cpu"))
    assert launch_counts() == before


# --- K9's chunked scan: the host-side tables, evaluated in float64 ------------

K9_CASCADES = [  # chip_smoke.py's six cascades at 48 kHz, and the 8-section maximum
    tiir.butter_sos("high", (300.0,), 5, FS),
    tiir.butter_sos("low", (3000.0,), 5, FS),
    tiir.butter_sos("high", (100.0,), 5, FS),
    tiir.butter_sos("band", (300.0, 3000.0), 5, FS),
    tiir.notch_sos(1000.0, 30.0, FS),
    tiir.butter_sos("low", (15000.0,), 5, FS),
    tiir.butter_sos("low", (2000.0,), 16, FS),
]


def k9_cases():
    """(name, coeffs, mode, n_sec, float64 reference filter) per case; the
    coefficients are the f32 values K9's wrappers pass."""
    from wavecap_tpu_torch.ops import agc as tagc

    f32 = lambda v: float(np.float32(v))  # noqa: E731
    cases = []
    for sos in K9_CASCADES:
        n_sec = sos.shape[0]
        coeffs = tuple(f32(sos[i, j]) for i in range(n_sec) for j in (0, 1, 2, 4, 5))
        sos32 = np.array([[coeffs[5 * i], coeffs[5 * i + 1], coeffs[5 * i + 2], 1.0,
                           coeffs[5 * i + 3], coeffs[5 * i + 4]] for i in range(n_sec)])

        def ref(x, z0, sos32=sos32, n_sec=n_sec):
            y, zf = sps.sosfilt(sos32, x, zi=z0.reshape(n_sec, 2))
            return y, zf.ravel()
        cases.append((f"sos{n_sec}", coeffs, tiir._K9_SOS, n_sec, ref))
    b0, a = (f32(v) for v in tiir.deemphasis_coeffs(FS))

    def ref_deemph(x, z0):
        y = sps.lfilter([b0], [1.0, -a], x, zi=[a * z0[0]])[0]
        return y, y[-1:]
    cases.append(("deemphasis", (b0, a), tiir._K9_ONEPOLE, 1, ref_deemph))
    ca, cr = tagc._coef(5.0, FS), tagc._coef(50.0, FS)
    c = tuple(f32(v) for v in (ca, 1.0 - ca, cr, 1.0 - cr))

    def ref_agc(x, z0):
        ea = sps.lfilter([c[0]], [1.0, -c[1]], np.abs(x), zi=[c[1] * z0[0]])[0]
        er = sps.lfilter([c[2]], [1.0, -c[3]], ea, zi=[c[3] * z0[1]])[0]
        return np.maximum(ea, er), np.array([ea[-1], er[-1]])
    cases.append(("agc", c, tiir._K9_ENVELOPE, 2, ref_agc))
    return cases


def chunked_scan(x, coeffs, mode, n_sec, chunk, z0):
    """K9's three passes in float64 over one row: every chunk from a zero
    state (the first from ``z0``), a Kogge-Stone scan of the chunks' end
    states with ``k9_scan_matrices``, every chunk again from its start."""
    n = len(x)
    chunks = -(-n // chunk)
    levels = (chunks - 1).bit_length()
    mats = tiir.k9_scan_matrices(coeffs, mode, n_sec, chunk, levels)
    xp = np.concatenate([x, np.zeros(chunks * chunk - n)]).reshape(chunks, chunk)
    lens = np.minimum(chunk, n - chunk * np.arange(chunks))

    def run(start):
        s, ys, ends = start.copy(), [], start.copy()
        for k in range(chunk):
            s, y = tiir.k9_step(s, xp[:, k], coeffs, mode, n_sec)
            ys.append(y)
            ends[lens == k + 1] = s[lens == k + 1]
        return np.stack(ys, axis=1), ends

    d = tiir.k9_state_size(mode, n_sec)
    start = np.zeros((chunks, d))
    start[0] = z0
    _, e = run(start)
    for j in range(levels):
        step = 1 << j
        e = np.concatenate([e[:step], e[step:] + e[:-step] @ mats[j].T])
    y, ends = run(np.concatenate([z0[None], e[:-1]]))
    return y.ravel()[:n], ends[-1]


@pytest.mark.parametrize("chunk", [1, 64, 256])
@pytest.mark.parametrize("n", [1000, 50])
@pytest.mark.parametrize("case", k9_cases(), ids=lambda c: c[0])
def test_k9_scan_tables_match_scipy(case, n, chunk):
    """The chunked evaluation with the host's matrices equals float64
    scipy to 1e-9 (n not a multiple of the chunk, and n < chunk)."""
    name, coeffs, mode, n_sec, ref = case
    rng = np.random.default_rng(chunk * 7 + n)
    x = 0.3 * np.sin(2 * np.pi * 900.0 * np.arange(n) / FS) + 0.05 * rng.standard_normal(n)
    z0 = 0.1 * rng.standard_normal(tiir.k9_state_size(mode, n_sec))
    if mode == tiir._K9_ENVELOPE:
        z0 = np.abs(z0)
    y_ref, z_ref = ref(x, z0)
    y, z = chunked_scan(x, coeffs, mode, n_sec, chunk, z0)
    scale = np.max(np.abs(y_ref))
    assert np.max(np.abs(y - y_ref)) <= 1e-9 * scale
    assert np.max(np.abs(z - z_ref)) <= 1e-9 * max(scale, np.max(np.abs(z_ref)))


@pytest.mark.parametrize("n", [1, 37, 256, 257, 9_447, 12_288, 12_289, 50_000])
def test_k9_plan_covers_the_row(n):
    chunk, segment = tiir.k9_plan(n)
    chunks = -(-segment // chunk)
    assert chunk % 2 == 1 and chunks <= tiir.K9_THREADS and segment <= tiir.K9_SEGMENT
    assert -(-n // segment) * segment >= n and segment <= n
    assert chunk <= n  # no row is shorter than its chunk
