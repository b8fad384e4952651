"""The PyTorch port's channelizer and planar DFTs against the JAX package's.

Runs on the CPU, where the K1/K2 wrappers take their plain versions.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu.ops import channelizer as jchz
from wavecap_tpu.ops import planar as jplanar
from wavecap_tpu_torch.ops import channelizer as tchz
from wavecap_tpu_torch.ops import planar as tplanar
from tests.conftest import snr_db

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def complex_snr_db(ref, got) -> float:
    ref = np.asarray(ref).ravel()
    return min(snr_db(ref.real, np.asarray(got).ravel().real),
               snr_db(ref.imag, np.asarray(got).ravel().imag))


@pytest.mark.parametrize("m,t_", [(800, 9), (80, 9), (96, 9), (38, 9)])
def test_design_taps_equal(m, t_):
    """Both packages design the prototype with scipy: equal, not close."""
    np.testing.assert_array_equal(
        tchz.design_prototype(m, t_), jchz.design_prototype(m, t_)
    )


@pytest.mark.parametrize("m", [800, 96, 80])
@pytest.mark.parametrize("inverse", [False, True])
def test_planar_factored_dft_matches(rng, m, inverse):
    assert tplanar._dft_factor(m) == jplanar._dft_factor(m)
    for a, b in zip(tplanar._factored_mats(m, inverse), jplanar._factored_mats(m, inverse)):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
    x = (rng.standard_normal((3, m)) + 1j * rng.standard_normal((3, m))).astype(np.complex64)
    rr, ri = jplanar.planar_factored_dft(jnp.asarray(x.real), jnp.asarray(x.imag), m, inverse=inverse)
    gr, gi = tplanar.planar_factored_dft(t(x.real), t(x.imag), m, inverse=inverse)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    got = gr.numpy() + 1j * gi.numpy()
    # the reference's own planar floor (test_planar.py): relative L2 <= 1e-5
    assert np.linalg.norm(ref - got) / np.linalg.norm(ref) <= 1e-5


def test_planar_matmul_dft_unfactorable_matches(rng):
    m = 38
    assert tplanar._dft_factor(m) is None
    x = (rng.standard_normal((4, m)) + 1j * rng.standard_normal((4, m))).astype(np.complex64)
    rr, ri = jplanar.planar_matmul_dft(jnp.asarray(x.real), jnp.asarray(x.imag), m)
    gr, gi = tplanar.planar_matmul_dft(t(x.real), t(x.imag), m)
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    assert np.linalg.norm(ref - (gr.numpy() + 1j * gi.numpy())) / np.linalg.norm(ref) <= 1e-5


def _stream(cfg, n_blocks, block, rng):
    x = (rng.standard_normal(n_blocks * block) + 1j * rng.standard_normal(n_blocks * block))
    tone = np.exp(2j * np.pi * 0.0371 * np.arange(n_blocks * block))
    return ((0.2 * x + tone) * 0.3).astype(np.complex64)


@pytest.mark.parametrize("sample_rate,bw,dft_impl", [
    (1_000_000.0, 12_500.0, "auto"),   # M = 80 = 8 x 10: factored matmul DFT (K2's)
    (400_000.0, 12_500.0, "auto"),     # M = 32: power of two, torch.fft route
    (475_000.0, 12_500.0, "matmul"),   # M = 38: unfactorable, one matmul
])
def test_channelize_matches_over_blocks(rng, sample_rate, bw, dft_impl):
    """Three consecutive blocks with the history carried: two f32 paths
    that differ only in summation order sit far above 90 dB."""
    jcfg = jchz.ChannelizerConfig(sample_rate=sample_rate, channel_bandwidth=bw, dft_impl=dft_impl)
    tcfg = tchz.ChannelizerConfig(sample_rate=sample_rate, channel_bandwidth=bw, dft_impl=dft_impl)
    m = tcfg.channel_count
    block = m * 50
    x = _stream(tcfg, 3, block, rng)
    js = jchz.channelizer_init(jcfg)
    ts = tchz.channelizer_init(tcfg, device="cpu")
    for k in range(3):
        xb = x[k * block:(k + 1) * block]
        ry, js = jchz.channelize(jnp.asarray(xb), js, jcfg)
        gy, ts = tchz.channelize(t(xb), ts, tcfg)
        assert gy.shape == (m, 2 * block // m)
        assert complex_snr_db(np.asarray(ry), gy.numpy()) >= 90.0
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("kind", ["i16", "i8", "i4"])
def test_word_input_matches_complex_input(rng, kind):
    """K1's word path (unpack fused with the arms) equals unpacking first,
    for i16 pairs and the adaptive i8 pairs and i4 nibbles with their
    scale; the unpack is the reference's ``_to_complex``, bit for bit."""
    from wavecap_tpu.capture import pipeline as jpipe

    cfg = tchz.ChannelizerConfig(sample_rate=1_000_000.0, channel_bandwidth=12_500.0)
    m = cfg.channel_count
    dtype, hi = {"i16": (np.int32, 2**31), "i8": (np.int16, 2**15), "i4": (np.int8, 2**7)}[kind]
    words = t(rng.integers(-hi, hi, m * 40).astype(dtype))
    scale = None if kind == "i16" else torch.tensor(np.float32(0.0123))
    hist = t((rng.standard_normal(m * 9) + 1j * rng.standard_normal(m * 9)).astype(np.complex64))
    x_w, u_w = tchz.unpack_arms(words, hist, cfg, scale)
    x_c = tchz.unpack_words(words, scale)
    x_c2, u_c = tchz.unpack_arms(x_c, hist, cfg)
    assert torch.equal(x_w, x_c) and torch.equal(u_w, u_c) and x_c2 is x_c
    assert u_w.shape == (2, 40, m)
    jscale = None if scale is None else jnp.asarray(scale.numpy())
    np.testing.assert_array_equal(x_w.numpy(), np.asarray(jpipe._to_complex(jnp.asarray(words.numpy()), jscale)))
    if scale is not None:
        with pytest.raises(ValueError, match="scale"):
            tchz.unpack_arms(words, hist, cfg)


def test_short_block_history_and_bad_length():
    """A block shorter than the M*T history keeps the newest M*T samples;
    a length that is not a multiple of M is refused."""
    cfg = tchz.ChannelizerConfig(sample_rate=1_000_000.0, channel_bandwidth=12_500.0)
    m, tt = cfg.channel_count, cfg.taps_per_channel
    hist = torch.arange(m * tt, dtype=torch.float32).to(torch.complex64)
    x = torch.full((2 * m,), 1 + 1j, dtype=torch.complex64)
    _, new = tchz.channelize(x, hist, cfg)
    np.testing.assert_array_equal(new.numpy(), np.concatenate([hist.numpy(), x.numpy()])[-m * tt:])
    with pytest.raises(ValueError):
        tchz.channelize(x[:-1], hist, cfg)
