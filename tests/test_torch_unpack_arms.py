"""K1's launch plan (``ops/channelizer.py:k1_plan``, ``kernels/csrc/
unpack_arms.cu``) emulated in numpy against the JAX package, on the CPU.

The kernel reads ``x_ext = [history || block]`` as a grid of position
columns ``X[j][q] = x_ext[1 + j M + q]``: one thread owns a column ``q``
over a tile of ``rows`` rows, loads its window of ``rows + T`` samples
once (history or block chosen there), writes the block samples of its
tile's own rows to ``x_out``, and sums both parities from the window in
registers: the even stack's column ``q`` and the odd stack's column
``q -+ M/2`` (one row later for ``q < M/2``), with fused multiply-adds in
the reference's tap order.  The emulation follows those rules at the
paths' M (800, 400, 96) and plans (and at 5 and 12 taps a channel, the
kernel's instance for any T), for every word kind, over two blocks
with the history carried: every block sample is written exactly once
and equals the reference's ``_to_complex``; the stacks match the port's
plain version within rel L2 1e-6 (float32 sums in another rounding than
torch's products-then-adds) and, through the cross-arm DFT, the JAX
package's ``channelize`` (>= 90 dB, the channelizer tests' floor).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu.capture import pipeline as jpipe
from wavecap_tpu.ops import channelizer as jchz
from wavecap_tpu_torch.ops import channelizer as tchz
from tests.conftest import snr_db

torch.set_num_threads(1)

WORDS = {"i16": np.int32, "i8": np.int16, "i4": np.int8}


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128).ravel()
    got = np.asarray(got).astype(np.complex128).ravel()
    return float(np.linalg.norm(ref - got) / np.linalg.norm(ref))


def unpack(words: np.ndarray, scale: float | None) -> np.ndarray:
    """The kernel's unpack of each word kind (sign by mask, shift)."""
    v = words.astype(np.int64)
    if words.dtype == np.int32:
        re, im, s = ((v & 0xFFFF) ^ 0x8000) - 0x8000, v >> 16, np.float32(1.0 / 32768.0)
    elif words.dtype == np.int16:
        re, im, s = ((v & 0xFF) ^ 0x80) - 0x80, v >> 8, np.float32(scale)
    else:
        re, im, s = ((v & 0xF) ^ 0x8) - 0x8, v >> 4, np.float32(scale)
    return (re.astype(np.float32) * s + 1j * (im.astype(np.float32) * s)).astype(np.complex64)


def fma32(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """float32 fused multiply-add: the product is exact in float64."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def k1_emulate(x_c: np.ndarray, hist: np.ndarray, arms: np.ndarray, m: int, t: int,
               plan: tchz.K1Plan):
    """K1 by ``plan``: ``(x_out, u, writes)``, ``writes`` the number of
    times each block sample is written."""
    n = x_c.shape[0]
    r_steps = n // m
    rows, h = plan.rows, m // 2
    assert plan.window == rows + t and plan.threads == 256
    tiles = -(-r_steps // rows)
    assert plan.ctas == -(-tiles * m // plan.threads)
    x_ext = np.concatenate([hist, x_c])
    length = x_ext.shape[0]
    q = np.arange(m)
    r0 = np.arange(tiles) * rows
    low = q < h
    c1 = np.where(low, q + (m - h), q - h)
    last = r0 + rows >= r_steps
    j = np.arange(rows + t)
    i = 1 + (r0[:, None, None] + j[None, :, None]) * m + q[None, None, :]  # (tiles, window, M)
    need = ((j < rows + t - 1)[None, :, None] | low[None, None, :] | last[:, None, None]) & (i < length)
    w = np.where(need, x_ext[np.minimum(i, length - 1)], 0).astype(np.complex64)
    own = (need & (i >= m * t) & (j >= t - 1)[None, :, None]
           & ((j < rows + t - 1)[None, :, None] | last[:, None, None]))
    writes = np.bincount(i[own] - m * t, minlength=n)
    x_out = np.zeros(n, np.complex64)
    x_out[i[own] - m * t] = w[own]
    u = np.zeros((2, r_steps, m), np.complex64)
    a0, a1 = arms, arms[:, c1]
    for rr in range(rows):
        r = r0 + rr
        ok = r < r_steps
        er = ei = orr = oi = np.zeros((tiles, m), np.float32)
        for k in range(t):
            s0 = w[:, rr + t - 1 - k, :]
            s1 = np.where(low[None, :], w[:, rr + t - k, :], s0)
            er, ei = fma32(s0.real, a0[k], er), fma32(s0.imag, a0[k], ei)
            orr, oi = fma32(s1.real, a1[k], orr), fma32(s1.imag, a1[k], oi)
        u[0, r[ok]] = (er + 1j * ei)[ok]
        u[1, r[ok][:, None], c1[None, :]] = (orr + 1j * oi)[ok]
    return x_out, u, writes


def arms_np(cfg) -> np.ndarray:
    m, t = cfg.channel_count, cfg.taps_per_channel
    return tchz.design_prototype(m, t, cfg.cutoff_scale).reshape(t, m)[:, ::-1].copy()


def block_words(rng, kind: str, n: int):
    if kind == "complex64":
        return (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64), None
    info = np.iinfo(WORDS[kind])
    scale = None if kind == "i16" else np.float32(0.0123)
    return rng.integers(info.min, info.max + 1, n).astype(WORDS[kind]), scale


@pytest.mark.parametrize("m,r_steps,rows,taps", [(800, 37, 16, 9), (800, 23, 4, 9), (400, 75, 4, 9),
                                                 (400, 9, 8, 9), (96, 61, 4, 9), (96, 10, 2, 9), (96, 31, 4, 5),
                                                 (96, 29, 4, 12)])
@pytest.mark.parametrize("kind", ["i16", "i8", "i4", "complex64"])
def test_emulated_plan_matches_reference_over_two_blocks(rng, m, r_steps, rows, taps, kind):
    cfg = tchz.ChannelizerConfig(sample_rate=m * 12_500.0, channel_bandwidth=12_500.0, taps_per_channel=taps)
    jcfg = jchz.ChannelizerConfig(sample_rate=m * 12_500.0, channel_bandwidth=12_500.0, taps_per_channel=taps,
                                  dft_impl="fft")
    t = cfg.taps_per_channel
    assert cfg.channel_count == m
    plan = tchz.k1_plan(m, t, r_steps, 0, forced=rows)
    arms = arms_np(cfg)
    hist = np.zeros(m * t, np.complex64)
    j_state = jchz.channelizer_init(jcfg)
    for _ in range(2):
        words, scale = block_words(rng, kind, m * r_steps)
        x_c = words if kind == "complex64" else unpack(words, scale)
        x_out, u, writes = k1_emulate(x_c, hist, arms, m, t, plan)
        if kind != "complex64":
            np.testing.assert_array_equal(writes, 1)  # every block sample exactly once
            ref_x = np.asarray(jpipe._to_complex(jnp.asarray(words), None if scale is None else jnp.asarray(scale)))
            np.testing.assert_array_equal(x_out, ref_x)
        _, u_plain = tchz.unpack_arms_plain(torch.from_numpy(words), torch.from_numpy(hist), cfg,
                                            None if scale is None else torch.tensor(scale))
        assert rel_l2(u_plain.numpy(), u) <= 1e-6
        chans = tchz._fft_arms(torch.from_numpy(u), cfg).numpy()
        ref, j_state = jchz.channelize(jnp.asarray(x_c), j_state, jcfg)
        ref = np.asarray(ref)
        assert min(snr_db(ref.real, chans.real), snr_db(ref.imag, chans.imag)) >= 90.0
        hist = np.concatenate([hist, x_c])[-m * t:]
        np.testing.assert_array_equal(hist, np.asarray(j_state))


@pytest.mark.parametrize("m,n", [(800, 1_968_000), (800, 229_600), (400, 300_000), (96, 360_000),
                                 (80, 1_000_000), (38, 38 * 301)])
def test_plan_window_covers_every_read(m, n):
    """At the paths' shapes: each (parity, row, column) read of the
    reference's stacks lies in the window of the thread that owns the
    output, and the launch has no idle column block (one thread a pair)."""
    t = 9
    r_steps = n // m
    plan = tchz.k1_plan(m, t, r_steps, 1)
    assert plan.rows in tchz._K1_ROWS and plan.threads == 256
    tiles = -(-r_steps // plan.rows)
    assert plan.ctas * plan.threads - tiles * m < plan.threads
    r = np.arange(r_steps)[:, None]
    c = np.arange(m)[None, :]
    h = m // 2
    r0 = (r // plan.rows) * plan.rows
    for off in (1, 1 + h):
        for k in range(t):
            i = off + (r + t - 1 - k) * m + c  # x_ext index the reference reads
            j, q = (i - 1) // m, (i - 1) % m  # its place in the grid
            # the owner of u[parity, r, c]: column c (even) or c +- M/2 (odd)
            owner = c if off == 1 else np.where(c < m - h, c + h, c - (m - h))
            assert (q == owner).all()
            assert ((j >= r0) & (j < r0 + plan.window)).all()
            assert (i < m * (t + r_steps)).all()


def test_plan_fills_the_card_at_the_shard_shapes():
    """A mesh shard's launch (M = 400 or 800, 230-300K words) has a
    CTA on every SM of the H100; forced plans take only the built tiles."""
    for m, n in ((400, 300_000), (800, 229_600), (800, 1_968_000)):
        plan = tchz.k1_plan(m, 9, n // m, 1)
        assert plan.rows == 4 and plan.ctas >= 132
    with pytest.raises(ValueError, match="rows a tile"):
        tchz.k1_plan(800, 9, 2460, 1, forced=3)
