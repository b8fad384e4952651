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


# --- K2's tables, in the kernel's layout, evaluated in numpy ------------------


def tf32_trunc(x: np.ndarray) -> np.ndarray:
    """The 10 mantissa bits of an f32 that the tensor cores read."""
    return (np.asarray(x, np.float32).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)


def k2_emulated(u: np.ndarray, m: int, three_tf32: bool) -> np.ndarray:
    """K2's two real GEMMs and epilogues on the host: the table buffer read
    in the kernel's layout, products in float64, each stage's sums rounded
    to f32.  With ``three_tf32`` the products are the kernel's: operands
    split ``x = hi + lo`` (the tables' pairs as stored, the data with
    ``tf32_split``), ``lo`` read to TF32, ``lo hi + hi lo + hi hi`` summed."""
    m1, m2, k1p, n1s, k2p, n2s = tchz._k2_layout(m)
    tab = tchz.k2_tables_np(m)
    b1 = tab[: 2 * k1p * n1s].reshape(k1p, n1s, 2)[:, :k1p]
    tab = tab[2 * k1p * n1s :]
    b2 = tab[: 2 * k2p * n2s].reshape(k2p, n2s, 2)[:, :k2p]
    tab = tab[2 * k2p * n2s :]
    tw = tab[: 2 * m].reshape(m1, m2, 2)
    ch = tab[2 * m :].view(np.complex64)

    def gemm(a, b):
        f = lambda p, q: p.astype(np.float64) @ q.astype(np.float64)  # noqa: E731
        if not three_tf32:
            return f(a, b[..., 0] + b[..., 1]).astype(np.float32)
        ah, al = tchz.tf32_split(a)
        bh, bl = b[..., 0], b[..., 1]
        return (f(tf32_trunc(al), bh) + f(ah, tf32_trunc(bl)) + f(ah, bh)).astype(np.float32)

    s = 2 * u.shape[1]
    x = np.stack([u[0], u[1]], axis=1).reshape(s, m1, m2)  # out column s = 2 step + parity
    x1 = np.zeros((s, m2, k1p), np.float32)
    x1[:, :, 0 : 2 * m1 : 2] = x.real.transpose(0, 2, 1)
    x1[:, :, 1 : 2 * m1 : 2] = x.imag.transpose(0, 2, 1)
    a = gemm(x1, b1)
    a = (a[..., 0 : 2 * m1 : 2] + 1j * a[..., 1 : 2 * m1 : 2]).transpose(0, 2, 1)  # (s, c1, k2)
    bt = (a * (tw[..., 0] + 1j * tw[..., 1])).astype(np.complex64)
    x2 = np.zeros((s, m1, k2p), np.float32)
    x2[..., 0 : 2 * m2 : 2], x2[..., 1 : 2 * m2 : 2] = bt.real, bt.imag
    y = gemm(x2, b2)
    y = y[..., 0 : 2 * m2 : 2] + 1j * y[..., 1 : 2 * m2 : 2]  # (s, c1, c2)
    y = y.transpose(0, 2, 1).reshape(s, m) * ch
    odd = (np.arange(s) % 2 == 1)[:, None] & (np.arange(m) % 2 == 1)[None, :]
    return np.where(odd, -y, y).T.astype(np.complex64)


@pytest.mark.parametrize("m", [800, 400, 96, 80, 38])
def test_k2_tables_in_the_kernels_layout(rng, m):
    """The kernel's table buffer computes the channels: against the FFT
    route in float64 (1e-6, the f32 tables), and with the kernel's 3xTF32
    split against the plain version (the card's floor, 1e-5)."""
    cfg = tchz.ChannelizerConfig(sample_rate=m * 12_500.0, channel_bandwidth=12_500.0,
                                 dft_impl="matmul")
    assert cfg.channel_count == m
    u = (rng.standard_normal((2, 7, m)) + 1j * rng.standard_normal((2, 7, m))).astype(np.complex64)
    ref = tchz._fft_arms(torch.from_numpy(u).to(torch.complex128), cfg).numpy()
    exact = k2_emulated(u, m, three_tf32=False)
    assert np.linalg.norm(exact - ref) / np.linalg.norm(ref) <= 1e-6
    plain = tchz.arm_dft_plain(t(u), cfg).numpy()
    split = k2_emulated(u, m, three_tf32=True)
    assert np.linalg.norm(split - plain) / np.linalg.norm(plain) <= 1e-5


@pytest.mark.parametrize("m", [800, 38])
def test_k2_table_split(m):
    """The tables' (hi, lo) pairs: hi keeps TF32's 10 mantissa bits, and
    hi + lo is the f32 table exactly."""
    m1, m2, k1p, n1s, k2p, n2s = tchz._k2_layout(m)
    pairs = tchz.k2_tables_np(m)[: 2 * (k1p * n1s + k2p * n2s)].reshape(-1, 2)
    hi, lo = pairs[:, 0], pairs[:, 1]
    assert not np.any(hi.view(np.uint32) & np.uint32(0x1FFF))
    w1, w2, _ = tchz.k2_stage_mats(m)
    x = np.concatenate([tchz._real_form(*w1, k1p, n1s).ravel(), tchz._real_form(*w2, k2p, n2s).ravel()])
    np.testing.assert_array_equal(hi + lo, x)
    assert np.all(np.abs(lo) <= np.abs(hi) * 2.0**-11)


@pytest.mark.parametrize("m", [800, 2000, 4800, 6250, 9000])
def test_k2_reach(m):
    """K2 runs every M up to ~9,000 (tiles of one step, the tables read
    from device memory past ~4,700): its least shared memory fits a block."""
    assert tchz._k2_smem_bytes(m) <= tchz._SMEM_LIMIT
