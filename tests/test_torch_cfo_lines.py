"""K13's CFO estimate (``models/p25/cqpsk.py:_estimate_cfo_residual``:
K13_cfo_power, cuFFT, K13_cfo_lines in ``kernels/csrc/cfo_lines.cu``)
against the JAX package's, and K13_cfo_lines' launch plan
(``cfo_lines_plan``) emulated in numpy against its plain version, on the
CPU.

The plain route runs here: ``cfo_power_plain`` (x^4 padded to the FFT's
size), ``torch.fft.fft`` and ``cfo_lines_plain`` (the search over |X|).
Held against the reference's ``_estimate_cfo_residual`` row by row at
program B's shape (4,800 baud, 50 kHz, 7,500 samples, size 8,192) and
program C's Phase 2 bank (6,000 baud, alpha 1.0), on rows at -1,100 ..
+1,100 Hz, a noise row and an all-zero row, at n = 7,500, 8,192 (no
padding), 700 (size 1,024) and 0: the residuals equal, exactly.

The kernel's plan: a row over a cluster of CTAs; rank ``c`` sums |X| over
bins ``[c bins, (c + 1) bins)`` and searches candidates ``[c per, (c +
1) per)``, whose two bins come from the wrap split (at most three
contiguous ranges, an offset pair each); rank 0 merges the CTAs' sums and
(value, index) pairs in rank order, the lower index winning a tie.  The
emulation follows that plan over ``torch.abs(X)`` and must give the
plain version's ``j`` and residual exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu.models.p25 import cqpsk as jq
from wavecap_tpu_torch.models.p25 import cqpsk as tq
from tests.test_torch_p25 import cqpsk_iq, normalized_filt

torch.set_num_threads(1)

F = np.float32
FS = 50_000  # program B's and C's channel rate (2.4 Msps over M = 96, two samples a channel)
CFOS = (-1100.0, -600.0, 0.0, 250.0, 600.0, 1100.0)
# (symbol rate, RRC alpha): program B's LSM bank and program C's Phase 2 bank
SHAPES = {"B": (4800.0, 0.2), "C-phase2": (6000.0, 1.0)}
# program B's and C's rows and candidates at n = 7,500: (rows, size, k4, off)
LAUNCHES = {"B": (21, 8192, 724, 393), "C-control": (2, 8192, 724, 393), "C-phase2": (20, 8192, 904, 492)}
K13_THREADS = 256  # kernels/csrc/cfo_lines.cu: kThreads
K13_POWER_BINS = 512  # kernels/csrc/cfo_lines.cu: a K13_cfo_power CTA's bins


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def configs(shape: str):
    rs, alpha = SHAPES[shape]
    kw = dict(sample_rate=FS, symbol_rate=rs, rrc_alpha=alpha)
    return jq.CqpskConfig(**kw), tq.CqpskConfig(**kw)


def stage_rows(rng, shape: str, n: int) -> np.ndarray:
    """Matched-filtered, normalized rows at ``CFOS``, then one of noise and
    one of zeros, ``n`` samples each."""
    if n == 0:
        return np.zeros((len(CFOS) + 2, 0), np.complex64)
    rs, alpha = SHAPES[shape]
    _, tcfg = configs(shape)
    rows = [cqpsk_iq(rng, FS, n, rs, alpha, f) for f in CFOS]
    rows.append((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64))
    filt = normalized_filt(np.stack(rows), tcfg)
    return np.concatenate([filt, np.zeros((1, n), np.complex64)])


@pytest.mark.parametrize("n", [7500, 8192, 700, 0], ids=["n7500", "n8192", "n700", "n0"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_stage_matches_reference(rng, shape, n):
    jcfg, tcfg = configs(shape)
    filt = stage_rows(rng, shape, n)
    got = tq._estimate_cfo_residual(t(filt), tcfg).numpy()
    ref = np.array([float(jq._estimate_cfo_residual(jnp.asarray(r), jcfg)) for r in filt], F)
    np.testing.assert_array_equal(got, ref)
    assert got[-1] == 0.0  # the all-zero row: no line
    if n >= 7500:  # the line rows: within two bins of the offset
        size, _, _, df = tq._cfo_search(tcfg, n)
        assert np.all(np.abs(got[: len(CFOS)] - np.array(CFOS)) <= 2 * df), got


@pytest.mark.parametrize("n", [7500, 700, 0], ids=["n7500", "n700", "n0"])
def test_stage_matches_parent_sequence(rng, n):
    """``cfo_power_plain`` then an FFT without ``n=`` gives the bits of the
    padded FFT of ``x^4`` (the sequence before K13_cfo_power), and the
    search over complex X the residual and ``j`` of a search over |X|."""
    _, tcfg = configs("B")
    filt = t(stage_rows(rng, "B", n))
    size, k4, off, df = tq._cfo_search(tcfg, n)
    p4 = filt * filt
    p4 = p4 * p4
    x_old = torch.fft.fft(p4, n=size, dim=-1)
    buf = tq.cfo_power_plain(filt, size)
    assert buf.shape == (filt.shape[0], size) and not buf[:, n:].any()
    x_new = torch.fft.fft(buf, dim=-1)
    assert torch.equal(torch.view_as_real(x_new), torch.view_as_real(x_old))
    r_new, j_new = tq.cfo_lines_plain(x_new, k4, off, df)
    r_old, j_old = old_search(torch.abs(x_old), k4, off, df)
    assert torch.equal(r_new, r_old) and torch.equal(j_new, j_old)
    if n == 0:
        assert not x_new.any() and not j_new.any() and not r_new.any()


def old_search(spec: torch.Tensor, k4: int, off: int, df_step: float):
    """The line search over |X| as it stood before it took complex X."""
    size = spec.shape[-1]
    k = torch.arange(-k4, k4 + 1)
    m = spec[:, (k + off) % size] + spec[:, (k - off) % size]
    j = torch.argmax(m, dim=-1)
    mj = m.gather(1, j[:, None])[:, 0]
    df = (j - k4).to(torch.float32) * df_step
    sig = (mj > 8.0 * spec.mean(-1)) & (mj > 1.5 * m[:, k4])
    return torch.where(sig, df, torch.zeros_like(df)), j.to(torch.int32)


# --- the kernel's plan, emulated ---------------------------------------------------


def keep_max(v, i, v2, i2):
    """The kernel's merge: the larger value, NaN above every number, then
    the lower index."""
    above = (np.isnan(v2) and not np.isnan(v)) or v2 > v
    same = (np.isnan(v) and np.isnan(v2)) or v2 == v
    return (v2, i2) if above or (same and i2 < i) else (v, i)


def emulate(mag: np.ndarray, k4: int, off: int, df_step: float, plan: tq.CfoLinesPlan):
    """K13_cfo_lines over ``mag = |X|`` ``(R, size)`` f32, CTA by CTA as the
    plan cuts a row: ``(resid, j)``."""
    rows, size = mag.shape
    n = 2 * k4 + 1
    b1, b2, dp0, dm0, dp1, dm1, dp2, dm2 = plan.split
    resid, jout = np.zeros(rows, F), np.zeros(rows, np.int32)
    for r in range(rows):
        a = mag[r]
        parts = []
        for c in range(plan.cluster):
            s = F(np.sum(a[c * plan.bins:(c + 1) * plan.bins], dtype=F))
            v, i = F(-np.inf), np.iinfo(np.int32).max
            for j in range(c * plan.per, min((c + 1) * plan.per, n)):
                dp, dm = (dp2, dm2) if j >= b2 else (dp1, dm1) if j >= b1 else (dp0, dm0)
                v, i = keep_max(v, i, F(a[j + dp] + a[j + dm]), j)
            parts.append((s, v, i))
        tot, v, i = parts[0]
        for s, v2, i2 in parts[1:]:  # rank 0 merges in rank order
            tot = F(tot + s)
            v, i = keep_max(v, i, v2, i2)
        mean = F(tot / F(size))
        centre = F(a[plan.centre[0]] + a[plan.centre[1]])
        sig = v > F(8.0) * mean and v > F(1.5) * centre
        resid[r] = F(F(i - k4) * F(df_step)) if sig else F(0.0)
        jout[r] = i
    return resid, jout


@pytest.mark.parametrize("size,k4,off", [(8192, 724, 393), (8192, 904, 492), (1024, 91, 49),
                                         (1024, 10, 300), (1024, 511, 0), (1024, 511, 511),
                                         (2048, 300, 1500), (1024, 5, 1030)],
                         ids=["B", "C-phase2", "n700", "off>k4", "widest", "widest-off", "off>size/2",
                              "off>size"])
def test_wrap_split_covers_every_candidate(size, k4, off):
    ranges = tq.cfo_wrap_split(size, k4, off)
    n = 2 * k4 + 1
    assert 1 <= len(ranges) <= 3
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(a < b and b == ranges[q + 1][0] for q, (a, b, _, _) in enumerate(ranges[:-1]))
    for a, b, dp, dm in ranges:
        j = np.arange(a, b)
        np.testing.assert_array_equal(j + dp, (j - k4 + off) % size)
        np.testing.assert_array_equal(j + dm, (j - k4 - off) % size)
    plan = tq.cfo_lines_plan(1, size, k4, off)
    assert plan.split[:2] == (ranges[1][0] if len(ranges) > 1 else n, ranges[2][0] if len(ranges) > 2 else n)
    assert plan.centre == ((k4 - k4 + off) % size, (k4 - k4 - off) % size)
    # the rank slices: every bin summed once, every candidate searched once
    assert plan.bins * plan.cluster == size
    assert plan.per == -(-n // plan.cluster) and plan.ctas == plan.cluster


@pytest.mark.parametrize("shape", list(SHAPES))
def test_emulated_plan_matches_plain(rng, shape):
    _, tcfg = configs(shape)
    filt = stage_rows(rng, shape, 7500)
    size, k4, off, df = tq._cfo_search(tcfg, 7500)
    x = torch.fft.fft(tq.cfo_power_plain(t(filt), size), dim=-1)
    r_p, j_p = tq.cfo_lines_plain(x, k4, off, df)
    r_e, j_e = emulate(torch.abs(x).numpy(), k4, off, df, tq.cfo_lines_plan(filt.shape[0], size, k4, off))
    np.testing.assert_array_equal(j_e, j_p.numpy())
    np.testing.assert_array_equal(r_e, r_p.numpy())


@pytest.mark.parametrize("size,k4,off", [(1024, 91, 49), (1024, 10, 300), (2048, 300, 1500)],
                         ids=["n700", "off>k4", "off>size/2"])
def test_emulated_plan_matches_plain_on_noise(rng, size, k4, off):
    """Rows of noise with one strong bin pair each, at the split's edge cases."""
    x = (rng.standard_normal((6, size)) + 1j * rng.standard_normal((6, size))).astype(np.complex64)
    for r, j in enumerate((0, k4, 2 * k4, 1, 2 * k4 - 1, k4 // 3)):
        x[r, (j - k4 + off) % size] += 40.0
        x[r, (j - k4 - off) % size] += 40.0
    r_p, j_p = tq.cfo_lines_plain(t(x), k4, off, 1.5)
    r_e, j_e = emulate(torch.abs(t(x)).numpy(), k4, off, 1.5, tq.cfo_lines_plan(6, size, k4, off))
    np.testing.assert_array_equal(j_e, j_p.numpy())
    np.testing.assert_array_equal(r_e, r_p.numpy())
    np.testing.assert_array_equal(j_p.numpy(), [0, k4, 2 * k4, 1, 2 * k4 - 1, k4 // 3])


@pytest.mark.parametrize("first,second", [(100, 600), (181, 182), (5, 1448)],
                         ids=["ranks-0-3", "ranks-0-1-adjacent", "ranks-0-7"])
def test_tie_across_ctas_takes_the_lower_candidate(first, second):
    """Two candidates of B's search in different CTAs with the same M, the
    largest: the lower ``j`` wins, in the plan's merge as in the plain
    version."""
    size, k4, off, df = 8192, 724, 393, 1.52587890625
    plan = tq.cfo_lines_plan(1, size, k4, off)
    assert first // plan.per != second // plan.per
    x = np.full((1, size), 0.01, np.complex64)
    for j in (first, second):
        x[0, (j - k4 + off) % size] = 5.0
        x[0, (j - k4 - off) % size] = 5.0
    r_p, j_p = tq.cfo_lines_plain(t(x), k4, off, df)
    r_e, j_e = emulate(np.abs(x).astype(F), k4, off, df, plan)
    assert int(j_p[0]) == int(j_e[0]) == first
    assert float(r_p[0]) == float(r_e[0]) == F(F(first - k4) * F(df))


def test_nan_takes_the_argmax_as_torch_does():
    size, k4, off = 1024, 91, 49
    x = np.full((1, size), 0.5, np.complex64)
    x[0, (150 - k4 + off) % size] = np.nan
    x[0, (30 - k4 - off) % size] = np.nan
    r_p, j_p = tq.cfo_lines_plain(t(x), k4, off, 1.5)
    r_e, j_e = emulate(np.abs(x).astype(F), k4, off, 1.5, tq.cfo_lines_plan(1, size, k4, off))
    assert int(j_p[0]) == int(j_e[0]) == 30 and float(r_p[0]) == float(r_e[0]) == 0.0


@pytest.mark.parametrize("name", list(LAUNCHES))
def test_launch_shapes(name):
    """Clusters of 8 CTAs a row: 168 CTAs at B, 16 for C's two control
    rows, 160 for its Phase 2 bank; one candidate a thread at most, so
    each CTA's loads are all in flight at once; K13_cfo_power's rows x
    chunks of 512 bins."""
    rows, size, k4, off = LAUNCHES[name]
    plan = tq.cfo_lines_plan(rows, size, k4, off)
    assert plan.cluster == 8 and plan.ctas == rows * 8
    assert plan.ctas == {"B": 168, "C-control": 16, "C-phase2": 160}[name]
    assert plan.per <= K13_THREADS and plan.bins == 1024
    assert plan.per == {"B": 182, "C-control": 182, "C-phase2": 227}[name]
    assert rows * -(-size // K13_POWER_BINS) == {"B": 336, "C-control": 32, "C-phase2": 320}[name]


def test_wrappers_take_the_plain_versions_on_the_cpu():
    x = t((np.arange(12).reshape(2, 6) * (1 + 1j)).astype(np.complex64))
    np.testing.assert_array_equal(tq.cfo_power(x, 8).numpy(), tq.cfo_power_plain(x, 8).numpy())
    s = torch.fft.fft(tq.cfo_power(x, 1024))
    assert all(torch.equal(a, b) for a, b in zip(tq.cfo_lines(s, 5, 3, 1.0), tq.cfo_lines_plain(s, 5, 3, 1.0)))
