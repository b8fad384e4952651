"""The port's planar ops and ``conv_valid``'s banded-matmul route against
the JAX package's.

Runs on the CPU, where ``planar_channelize`` takes its plain version and
``_conv_valid_direct`` its plain ``conv1d``.  Each case puts the same
seeded numpy inputs through both packages.
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.ops import channelizer as jchz
from wavecap_tpu.ops import fir as jfir
from wavecap_tpu.ops import planar as jplanar
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.ops import channelizer as tchz
from wavecap_tpu_torch.ops import fir as tfir
from wavecap_tpu_torch.ops import planar as tplanar
from tests.conftest import make_noise, make_tone, snr_db

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def planes(x: np.ndarray) -> tuple:
    return t(x.real.astype(np.float32)), t(x.imag.astype(np.float32))


# --- elementwise ops ---------------------------------------------------------------


@pytest.mark.parametrize("offset,phase0,rows", [
    (5000.0, 0, None),               # the reference test's case
    (-123_456.7, 3_000_000_000, None),
    (777.0, 12345, 3),               # a batch of rows, one word
])
def test_freq_shift_matches(rng, offset, phase0, rows):
    fs = 48_000
    x = make_noise(rng, 4096 * (rows or 1)).reshape((rows, 4096) if rows else (4096,))
    rr, ri, rn = jplanar.planar_freq_shift(jnp.asarray(x.real), jnp.asarray(x.imag), offset, fs, phase0)
    gr, gi, gn = tplanar.planar_freq_shift(*planes(x), offset, fs, phase0)
    np.testing.assert_allclose(gr.numpy(), np.asarray(rr), atol=1e-5)
    np.testing.assert_allclose(gi.numpy(), np.asarray(ri), atol=1e-5)
    assert gn.dtype == torch.uint32
    assert int(gn) == int(np.asarray(rn, np.uint32))
    yc, pc = tops.freq_shift(t(x), offset, fs, phase0)
    np.testing.assert_allclose(gr.numpy(), yc.real.numpy(), atol=1e-5)
    np.testing.assert_allclose(gi.numpy(), yc.imag.numpy(), atol=1e-5)
    assert torch.equal(gn, pc)


def test_freq_shift_streams(rng):
    """Two blocks with the phase carried equal one block of both."""
    x = make_noise(rng, 6000)
    ar, ai, p = tplanar.planar_freq_shift(*planes(x[:2500]), 1234.5, 48_000, 7)
    br, bi, p2 = tplanar.planar_freq_shift(*planes(x[2500:]), 1234.5, 48_000, p)
    cr, ci, p3 = tplanar.planar_freq_shift(*planes(x), 1234.5, 48_000, 7)
    np.testing.assert_allclose(torch.cat([ar, br]).numpy(), cr.numpy(), atol=1e-5)
    np.testing.assert_allclose(torch.cat([ai, bi]).numpy(), ci.numpy(), atol=1e-5)
    assert torch.equal(p2, p3)


def _fm(n: int, fs: float) -> np.ndarray:
    tt = np.arange(n) / fs
    return np.exp(1j * 2 * np.pi * 3000 * np.cumsum(np.sin(2 * np.pi * 5 * tt)) / fs).astype(np.complex64)


@pytest.mark.parametrize("max_dev", [75_000.0, 5_000.0])
def test_quadrature_demod_matches(rng, max_dev):
    fs = 48_000
    iq = _fm(6000, fs)
    prev = np.complex64(0.3 - 0.2j)
    ra, rl_re, rl_im = jplanar.planar_quadrature_demod(
        jnp.asarray(iq.real), jnp.asarray(iq.imag), fs, jnp.float32(prev.real), jnp.float32(prev.imag), max_dev)
    ga, gl_re, gl_im = tplanar.planar_quadrature_demod(
        *planes(iq), fs, torch.tensor(prev.real), torch.tensor(prev.imag), max_dev)
    assert ga.dtype == torch.float32
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), atol=1e-5)
    assert float(gl_re) == float(rl_re) and float(gl_im) == float(rl_im)
    ca, last = tops.quadrature_demod(t(iq), fs, torch.tensor(prev), max_deviation_hz=max_dev)
    np.testing.assert_allclose(ga.numpy(), ca.numpy(), atol=1e-5)
    assert complex(last) == complex(float(gl_re), float(gl_im))


def test_quadrature_demod_rows(rng):
    """A batch of rows with one previous sample each, as the banks carry it."""
    x = make_noise(rng, 3 * 2000).reshape(3, 2000)
    prev = make_noise(rng, 3)
    ra, rr, ri = jplanar.planar_quadrature_demod(jnp.asarray(x.real), jnp.asarray(x.imag), 25_000,
                                                 jnp.asarray(prev.real), jnp.asarray(prev.imag), 5000.0)
    ga, gr, gi = tplanar.planar_quadrature_demod(*planes(x), 25_000, *planes(prev), 5000.0)
    np.testing.assert_allclose(ga.numpy(), np.asarray(ra), atol=1e-5)
    np.testing.assert_array_equal(gr.numpy(), np.asarray(rr))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
def test_rssi_dbfs_matches(rng, scale):
    x = make_noise(rng, 4 * 1000, scale).reshape(4, 1000)
    ref = np.asarray(jplanar.planar_rssi_dbfs(jnp.asarray(x.real), jnp.asarray(x.imag)))
    got = tplanar.planar_rssi_dbfs(*planes(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, tops.rssi_dbfs(t(x)).numpy(), atol=1e-4)


# --- the channelizer -----------------------------------------------------------------


CHANNELIZERS = {
    "M=8": (dict(sample_rate=200_000.0, channel_bandwidth=25_000.0), 8 * 400),  # the reference test's
    "M=800": (dict(sample_rate=10_000_000.0, channel_bandwidth=12_500.0), 800 * 6),  # 6 steps
}


@pytest.mark.parametrize("case", sorted(CHANNELIZERS))
def test_channelize_matches_over_blocks(rng, case):
    """Three blocks with the history carried: >= 120 dB on each plane
    against the reference's planar channelizer, the history equal, and the
    reference's 50 dB against the port's complex ``channelize``."""
    kw, n = CHANNELIZERS[case]
    jcfg, tcfg = jchz.ChannelizerConfig(**kw), tchz.ChannelizerConfig(**kw)
    x = (make_noise(rng, 3 * n) + 0.5 * make_tone(0.0371 * kw["sample_rate"], kw["sample_rate"], 3 * n))
    jst = jplanar.planar_channelizer_init(jcfg)
    tst = tplanar.planar_channelizer_init(tcfg, device="cpu")
    cst = tchz.channelizer_init(tcfg, device="cpu")
    assert tst[0].shape == (tcfg.channel_count * tcfg.taps_per_channel,) and tst[0].dtype == torch.float32
    for b in range(3):
        blk = x[b * n:(b + 1) * n].astype(np.complex64)
        rr, ri, jst = jplanar.planar_channelize(jnp.asarray(blk.real), jnp.asarray(blk.imag), jst, jcfg)
        gr, gi, tst = tplanar.planar_channelize(*planes(blk), tst, tcfg)
        assert gr.shape == (tcfg.channel_count, 2 * n // tcfg.channel_count)
        assert snr_db(np.asarray(rr), gr.numpy()) >= 120.0, (case, b)
        assert snr_db(np.asarray(ri), gi.numpy()) >= 120.0, (case, b)
        np.testing.assert_array_equal(tst[0].numpy(), np.asarray(jst[0]))
        np.testing.assert_array_equal(tst[1].numpy(), np.asarray(jst[1]))
        yc, cst = tchz.channelize(t(blk), cst, tcfg)
        assert snr_db(yc.real.numpy(), gr.numpy()) > 50.0
        assert snr_db(yc.imag.numpy(), gi.numpy()) > 50.0
        np.testing.assert_array_equal(torch.complex(*tst).numpy(), cst.numpy())


def test_channelize_refuses_partial_blocks():
    cfg = tchz.ChannelizerConfig(sample_rate=200_000.0, channel_bandwidth=25_000.0)
    st = tplanar.planar_channelizer_init(cfg, device="cpu")
    with pytest.raises(ValueError, match="multiple of M=8"):
        tplanar.planar_channelize(torch.zeros(100), torch.zeros(100), st, cfg)


def test_channelizer_init_needs_a_device(monkeypatch):
    cfg = tchz.ChannelizerConfig(sample_rate=200_000.0, channel_bandwidth=25_000.0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tplanar.planar_channelizer_init(cfg)
    assert tplanar.planar_channelizer_init(cfg, device="cpu")[0].device.type == "cpu"


# --- the spectrum --------------------------------------------------------------------


@pytest.mark.parametrize("fft_size,rows", [(2048, None), (512, 3)])
def test_power_spectrum_matches(rng, fft_size, rows):
    fs = 1_024_000
    x = make_tone(100_000.0, fs, fft_size) + make_noise(rng, fft_size, 1e-3)
    if rows:
        x = np.stack([x * (0.5 ** k) for k in range(rows)]) + make_noise(rng, rows * fft_size, 1e-4).reshape(rows, -1)
    ref = np.asarray(jplanar.planar_power_spectrum(jnp.asarray(x.real), jnp.asarray(x.imag), fft_size))
    got = tplanar.planar_power_spectrum(*planes(x), fft_size)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    got = got.numpy()
    for r, g in zip(ref.reshape(-1, fft_size), got.reshape(-1, fft_size)):
        assert int(np.argmax(g)) == int(np.argmax(r))
        strong = r > r.max() - 60.0
        np.testing.assert_allclose(g[strong], r[strong], atol=1e-3)
    # the reference test's floor against the FFT spectrum
    lib = tops.power_spectrum(t(x.astype(np.complex64)), fft_size).numpy()
    for lb, g in zip(lib.reshape(-1, fft_size), got.reshape(-1, fft_size)):
        assert int(np.argmax(g)) == int(np.argmax(lb))
        strong = lb > -60
        np.testing.assert_allclose(g[strong], lb[strong], atol=0.5)


def test_spectrum_tables_are_the_references():
    for a, b in zip(tplanar._spectrum_mats(512), jplanar._spectrum_mats(512)):
        np.testing.assert_array_equal(a, b)


# --- conv_valid's banded-matmul route ----------------------------------------------


def rel_err(a: np.ndarray, b: np.ndarray) -> float:
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(a))), 1e-9)


@pytest.mark.parametrize("n_taps", [9, 63, 127, 128])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_matmul_route_matches(rng, monkeypatch, n_taps, kind):
    """The reference's case list: the route against the port's direct path
    and against the reference's route, both at 2e-5 relative."""
    monkeypatch.setenv("WAVECAP_FIR_MATMUL", "1")
    taps = sps.firwin(n_taps, 0.2).astype(np.float32)
    x = rng.standard_normal(5126).astype(np.float32) if kind == "real" else make_noise(rng, 5126)
    direct = tfir._conv_valid_direct(t(x), t(taps)).numpy()
    route = tfir.conv_valid(t(x), t(taps))
    assert route.dtype == (torch.float32 if kind == "real" else torch.complex64)
    route = route.numpy()
    assert rel_err(direct, route) < 2e-5
    ref = np.asarray(jfir.conv_valid(jnp.asarray(x), jnp.asarray(taps)))
    assert rel_err(ref, route) < 2e-5
    np.testing.assert_array_equal(tfir._conv_valid_matmul(t(x), t(taps)).numpy(), route)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("kind", ["real", "complex"])
def test_matmul_route_rows(rng, monkeypatch, per_row, kind):
    """A (3, 5126) batch: each row equal to the 1-D call with its taps."""
    monkeypatch.setenv("WAVECAP_FIR_MATMUL", "1")
    x = rng.standard_normal((3, 5126)).astype(np.float32)
    if kind == "complex":
        x = make_noise(rng, 3 * 5126).reshape(3, 5126)
    taps = np.stack([sps.firwin(63, c).astype(np.float32) for c in (0.1, 0.2, 0.3)])
    tt = t(taps) if per_row else t(taps[1])
    got = tfir.conv_valid(t(x), tt).numpy()
    assert got.shape == (3, 5126 - 62)
    for r in range(3):
        one = tfir.conv_valid(t(x[r]), t(taps[r] if per_row else taps[1])).numpy()
        np.testing.assert_allclose(got[r], one, rtol=0, atol=1e-6 * np.max(np.abs(one)))
        assert rel_err(tfir._conv_valid_direct(t(x[r]), t(taps[r] if per_row else taps[1])).numpy(),
                       got[r]) < 2e-5


@pytest.mark.parametrize("setting", ["1-short", "0", "unset", "1-complex-taps", "1-8-taps"])
def test_direct_path_where_the_route_does_not_apply(rng, monkeypatch, setting):
    """Below the size floor, with 8 taps or fewer, with complex taps, and
    with the variable "0" or unset, the result is the direct path's, bit
    for bit."""
    if setting == "unset":
        monkeypatch.delenv("WAVECAP_FIR_MATMUL", raising=False)
    else:
        monkeypatch.setenv("WAVECAP_FIR_MATMUL", setting.split("-")[0])
    n = 100 if setting == "1-short" else 5126
    x = rng.standard_normal(n).astype(np.float32)
    taps = sps.firwin(8 if setting == "1-8-taps" else 63, 0.2).astype(np.float32)
    tt = t(taps)
    if setting == "1-complex-taps":
        tt = t((taps * np.exp(0.3j * np.arange(63))).astype(np.complex64))
    got = tfir.conv_valid(t(x), tt)
    assert torch.equal(got, tfir._conv_valid_direct(t(x), tt))


def test_matmul_route_streams(rng, monkeypatch):
    """``fir_filter`` over 4 blocks with the tail carried equals the
    one-shot route at 2e-5."""
    monkeypatch.setenv("WAVECAP_FIR_MATMUL", "1")
    taps = t(sps.firwin(127, 0.15).astype(np.float32))
    x = make_noise(rng, 4 * 2000)
    tail = tfir.fir_init(127, device="cpu")
    parts = []
    for b in range(4):
        y, tail = tfir.fir_filter(t(x[b * 2000:(b + 1) * 2000]), taps, tail)
        parts.append(y.numpy())
    whole = tfir.conv_valid(torch.cat([torch.zeros(126, dtype=torch.complex64), t(x)]), taps).numpy()
    assert rel_err(whole, np.concatenate(parts)) < 2e-5
    np.testing.assert_array_equal(tail.numpy(), x[-126:])
