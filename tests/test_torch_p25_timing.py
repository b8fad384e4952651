"""K12 and K13's block timing by their launch plan (``models/p25/c4fm.py:
k12_plan``, ``kernels/csrc/p25_timing.cu``) emulated in numpy against the
JAX package, on the CPU.

The kernel splits a row over a cluster of CTAs: CTA ``rank`` takes the
symbols ``[rank mseg, (rank + 1) mseg)`` and, for the row passes (dc, the
O&M line), the samples from its first symbol's position to the next
CTA's; it stages only the window those passes and its gathers can read
(``k12_window_room`` samples at most) and reads nothing else.  Each step's
sums go a thread's items in order, the block's shuffle trees, then the
cluster's CTAs in rank order; every CTA then runs the same f32 scalar
chain.  CQPSK's detection gathers a CTA's symbol ``m0 - 1`` again.

Held here: the plan's symbol segments cover each symbol once; each CTA's
window, as the kernel computes it, holds every index its gathers can read
across the legal ranges of the carried position and clock, the phase
offsets and the slope, and fits the plan's room, at programs A, B, C, F's
shard and 2 s rows; and the emulation, reading only its windows, through
the port's demodulators against the reference's ``c4fm_demodulate`` and
``cqpsk_demodulate`` (block timing) over consecutive blocks: dibits equal,
soft >= 60 dB, the carried timing state within 1e-3.
"""

import numpy as np
import pytest
import torch

from wavecap_tpu.models.p25 import c4fm as jc
from wavecap_tpu.models.p25 import cqpsk as jq
from wavecap_tpu_torch.models.p25 import c4fm as tc
from wavecap_tpu_torch.models.p25 import cqpsk as tq
from tests.conftest import snr_db
from tests.test_torch_p25 import c4fm_iq, cqpsk_iq, run_both

torch.set_num_threads(1)

F = np.float32
TAIL = 64
NEG_TWO_PI = F(-2.0 * np.pi)
TWO_PI = F(2.0 * np.pi)
QPI = F(0.7853981633974483)


def shuffle_tree(v: np.ndarray) -> np.ndarray:
    """``v += shfl_xor(v, o)`` for o = 16 .. 1 over the last axis (32 lanes)."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = (v + v[..., lane ^ o]).astype(F)
    return v


def cta_sums(vals: np.ndarray, threads: int) -> np.ndarray:
    """A CTA's sums of ``vals`` ``(items, K)``: item i to thread i % threads,
    in order, then each warp's shuffle tree, then the warps in order."""
    rows = max(-(-vals.shape[0] // threads), 1)
    pad = np.zeros((rows * threads, vals.shape[1]), F)
    pad[:vals.shape[0]] = vals
    acc = np.zeros((threads, vals.shape[1]), F)
    for row in pad.reshape(rows, threads, -1):
        acc = (acc + row).astype(F)
    warps = shuffle_tree(acc.T.reshape(vals.shape[1], threads // 32, 32))[..., 0]
    out = np.zeros(vals.shape[1], F)
    for w in range(threads // 32):
        out = (out + warps[:, w]).astype(F)
    return out


def cluster_sums(per_rank: list) -> np.ndarray:
    out = np.zeros_like(per_rank[0])
    for v in per_rank:
        out = (out + v).astype(F)
    return out


def floor_mod(x, y):
    r = F(np.fmod(x, y))
    return F(r + y) if r != 0 and ((r < 0) != (y < 0)) else r


class Window:
    """A CTA's staged samples ``[lo, hi)`` of a row; reading past them fails."""

    def __init__(self, row: np.ndarray, lo: int, hi: int):
        self.lo, self.hi, self.data = lo, hi, row[lo:hi]

    def __getitem__(self, i):
        i = np.asarray(i)
        assert ((i >= self.lo) & (i < self.hi)).all(), (int(i.min()), int(i.max()), self.lo, self.hi)
        return self.data[i - self.lo]


def windows(length: int, n_sym: int, pos, freq, c, plan) -> list:
    """Each CTA's ``(m0, m1, b_lo, b_hi, w_lo, w_hi)`` as the kernel computes them."""
    hi = F(length - 2)

    def base(m):
        return F(pos + F(F(m) * freq))

    def bound(m):
        return int(min(max(np.floor(base(m)), F(TAIL)), F(length)))

    extra = F(F(F(c.half) + F(2.5)) + F(F(0.0025) * F(n_sym)))
    out = []
    for rank in range(plan.cluster):
        m0, m1 = rank * plan.mseg, min(n_sym, (rank + 1) * plan.mseg)
        b_lo = TAIL if rank == 0 else bound(m0)
        b_hi = length if rank == plan.cluster - 1 else bound(m1)
        g_lo = int(np.floor(np.clip(F(base(max(m0 - 1, 0)) - extra), F(0), hi)))
        g_hi = int(np.floor(np.clip(F(base(min(m1, n_sym - 1)) + extra), F(0), hi))) + 2
        out.append((m0, m1, b_lo, b_hi, min(b_lo, g_lo), max(b_hi, g_hi)))
    return out


def lerp(a, b, fr):
    if np.iscomplexobj(a):
        return (lerp(a.real, b.real, fr) + 1j * lerp(a.imag, b.imag, fr)).astype(np.complex64)
    return ((a * (F(1) - fr).astype(F)).astype(F) + (b * fr).astype(F)).astype(F)


def power(y):
    if np.iscomplexobj(y):
        m = np.hypot(y.real, y.imag).astype(F)
        return (m * m).astype(F)
    return (y * y).astype(F)


def emulate_row(row: np.ndarray, st: np.ndarray, n_sym: int, c, cqpsk: bool, plan) -> tuple:
    """K12 / K13 on one row by ``plan``, each CTA reading only its window:
    ``(soft, dibits, out)`` as the kernel writes them."""
    length = row.shape[0]
    n = length - TAIL
    hi = F(length - 2)
    pos, freq_in, integ_in, s3, s4, s5 = (F(v) for v in st)
    sps, half = F(c.sps), F(c.half)
    freq = sps if freq_in < 1 else freq_in
    if not cqpsk:
        freq = F(np.clip(freq, F(c.fmin), F(c.fmax)))
    ctas = windows(length, n_sym, pos, freq, c, plan)
    wins = [Window(row, w_lo, w_hi) for (_, _, _, _, w_lo, w_hi) in ctas]
    if plan.cap:
        assert all(w.hi - w.lo <= plan.cap for w in wins)

    def base(m):
        return (pos + (np.asarray(m).astype(F) * freq).astype(F)).astype(F)

    def sample(win, p, dc):
        p = np.clip(p, F(0), hi).astype(F)
        fl = np.floor(p)
        i0 = fl.astype(np.int64)
        y = lerp(win[i0], win[i0 + 1], (p - fl).astype(F))
        return y if cqpsk else (y - dc).astype(F)

    def step(fn, k):  # one cluster-wide sum of k values: fn(rank) -> (items, k)
        return cluster_sums([cta_sums(fn(r).reshape(-1, k), plan.threads) for r in range(plan.cluster)])

    dc0 = F(0)
    if not cqpsk:
        s = step(lambda r: wins[r][np.arange(ctas[r][2], ctas[r][3])].astype(F), 1)[0]
        dc0 = F(F(s4 * F(0.9)) + F(F(s / F(n)) * F(0.1)))
    half_n = n // 2

    def om(r):
        i = np.arange(ctas[r][2], ctas[r][3])
        x = wins[r][i]
        u = power(x) if cqpsk else power((x - dc0).astype(F))
        idx = i - TAIL
        ang = ((NEG_TWO_PI * idx.astype(F)).astype(F) / sps).astype(F)
        ur, ui = (u * np.cos(ang)).astype(F), (u * np.sin(ang)).astype(F)
        first = idx < half_n
        z = np.zeros_like(u)
        return np.stack([np.where(first, ur, z), np.where(first, ui, z), np.where(first, z, ur),
                         np.where(first, z, ui), np.abs(u)], axis=-1)

    a1r, a1i, a2r, a2i, den = step(om, 5)
    sr, si = F(a1r + a2r), F(a1i + a2i)
    lock = F(F(np.hypot(sr, si)) / max(den, F(1e-9)))
    dre = F(F(a2r * a1r) + F(a2i * a1i))
    dim = F(F(a2i * a1r) - F(a2r * a1i))
    slope = F(F(F(F(np.arctan2(dim, dre)) / TWO_PI) * sps) * F(sps / F(max(half_n, 1))))
    slope = F(np.clip(slope, F(-0.005), F(0.005)))
    tau_om = F(F(F(-np.arctan2(si, sr)) / TWO_PI) * sps)
    pos_mod = floor_mod(F(pos - F(TAIL)), sps)
    delta_om = F(floor_mod(F(F(tau_om - pos_mod) + half), sps) - half)
    half_freq = F(freq * F(0.5))

    def terms(off):
        def fn(r):
            m = np.arange(ctas[r][0], ctas[r][1])
            p = (base(m) + off).astype(F)
            y = sample(wins[r], p, dc0)
            pw = power(y)
            num = np.zeros_like(pw)
            nx = m + 1 < n_sym
            pn = (base(m[nx] + 1) + off).astype(F)
            d = y[nx] - sample(wins[r], pn, dc0)  # per component in f32
            ym = sample(wins[r], (pn - half_freq).astype(F), dc0)
            if cqpsk:
                num[nx] = ((ym.real * d.real).astype(F) + (ym.imag * d.imag).astype(F)).astype(F)
            else:
                num[nx] = (d * ym).astype(F)
            return np.stack([num, pw], axis=-1)
        return fn

    def gardner(num, pw):
        g = F(num / F(n_sym - 1))
        return F(g / max(F(pw / F(n_sym)), F(1e-6)))

    d0 = delta_om if abs(delta_om) > F(0.75) else F(0)
    d1 = F(d0 + F(0.5))
    g01 = step(lambda r: np.concatenate([terms(d0)(r), terms(d1)(r)], axis=-1), 4)
    g0, g1 = gardner(g01[0], g01[1]), gardner(g01[2], g01[3])
    k = F(F(g1 - g0) / F(0.5))
    ok = abs(k) > F(1e-3)
    delta = F(np.clip(F(d0 - F(g0 / k)) if ok else d0, -half, half))
    g2 = gardner(*step(terms(delta), 2))
    delta = F(np.clip(F(delta - F(g2 / k)) if ok else delta, -half, half))
    if not lock > F(c.lock):
        delta, slope = F(0), F(0)
    integ = F(np.clip(F(F(integ_in + F(F(0.5) * slope)) + F(F(0.05) * F(delta / F(max(n_sym, 1))))),
                      F(c.integ_lo), F(c.integ_hi)))
    freq_next = F(np.clip(F(sps + integ), F(c.fmin), F(c.fmax)))
    mid = F(F(0.5) * F(n_sym))

    def symbol(r, m):
        ramp = (delta + (slope * (m.astype(F) - mid).astype(F)).astype(F)).astype(F)
        return sample(wins[r], (base(m) + ramp).astype(F), dc0)

    pos_end = F(F(pos + delta) + F(F(n_sym) * freq_next))
    p = F(pos_end - F(length - TAIL))
    p = F(p + sps) if p < F(4) else p
    pos_next = F(p - sps) if p > F(c.recenter_hi) else p
    raw = [symbol(r, np.arange(ctas[r][0], ctas[r][1])) for r in range(plan.cluster)]
    if not cqpsk:
        acc = step(lambda r: np.abs(raw[r]).astype(F), 1)[0]
        scale = F(F(2) / max(F(acc / F(n_sym)), F(0.05)))
        gain = scale if s3 < F(0.01) else F(F(F(0.95) * s3) + F(F(0.05) * scale))
        gain = F(np.clip(gain, F(0.05), F(40)))
        soft = (np.concatenate(raw) * gain).astype(F)
        out = [pos_next, freq_next, integ, gain, dc0, raw[-1][-1]]
    else:
        dph = []
        for r in range(plan.cluster):
            m0 = ctas[r][0]
            before = np.array([s4 + 1j * s5], np.complex64) if m0 == 0 else symbol(r, np.array([m0 - 1]))
            prev = np.concatenate([before, raw[r][:-1]])
            s = raw[r]
            zr = (s.real * prev.real).astype(F) + (s.imag * prev.imag).astype(F)
            zi = (s.imag * prev.real).astype(F) - (s.real * prev.imag).astype(F)
            dph.append(np.arctan2(zi.astype(F), zr.astype(F)).astype(F))

        def resid(r):
            e = (dph[r] - s3).astype(F)
            q = np.clip(np.rint((e / QPI).astype(F)), F(-3), F(3)).astype(F)
            return (e - (q * QPI).astype(F)).astype(F)

        acc = step(resid, 1)[0]
        bias = F(s3 + F(F(0.02) * F(acc / F(n_sym))))
        soft = ((np.concatenate(dph) - bias).astype(F) / QPI).astype(F)
        out = [pos_next, freq_next, integ, bias, F(raw[-1][-1].real), F(raw[-1][-1].imag)]
    dibits = np.where(soft >= 0, np.where(np.abs(soft) >= 2, 1, 0), np.where(np.abs(soft) >= 2, 3, 2))
    return soft, dibits.astype(np.uint8), np.array(out, F)


def emulate(buf, st, n_sym: int, c, cqpsk: bool):
    """The kernel's launch over rows ``buf`` by the wrapper's own plan."""
    buf, st = buf.numpy(), st.numpy()
    plan = tc.k12_plan(buf.shape[0], n_sym, c, buf.itemsize)
    rows = [emulate_row(buf[r], st[:, r], n_sym, c, cqpsk, plan) for r in range(buf.shape[0])]
    return (torch.from_numpy(np.stack([r[0] for r in rows])), torch.from_numpy(np.stack([r[1] for r in rows])),
            torch.from_numpy(np.stack([r[2] for r in rows], axis=1)))


def c4fm_emulated(buf, st, n_sym, cfg):
    return emulate(buf, st, n_sym, tc.timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005), False)


def cqpsk_emulated(buf, st, n_sym, cfg):
    return emulate(buf, st, n_sym, tc.timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002), True)


# the paths' shapes: (modulation, rows, length, symbols, sample rate, symbol rate)
SHAPES = {
    "A": ("c4fm", 50, 12_564, 1_200, 50_000, 4800.0),
    "F-shard": ("c4fm", 50, 12_064, 1_152, 50_000, 4800.0),
    "B": ("lsm", 21, 7_564, 720, 50_000, 4800.0),
    "C": ("p2", 20, 7_564, 900, 50_000, 6000.0),
    "2s-c4fm": ("c4fm", 4, 100_064, 9_600, 50_000, 4800.0),
    "2s-lsm": ("lsm", 4, 100_064, 9_600, 50_000, 4800.0),
    "2s-p2": ("p2", 4, 100_064, 12_000, 50_000, 6000.0),
}


def consts(kind: str, fs: float, rs: float):
    return tc.timing_consts(fs / rs, 2000.0, 0.005 if kind == "c4fm" else 0.002)


@pytest.mark.parametrize("name", SHAPES)
def test_plan_covers_each_symbol_once(name):
    kind, rows, length, n_sym, fs, rs = SHAPES[name]
    c = consts(kind, fs, rs)
    plan = tc.k12_plan(rows, n_sym, c, 4 if kind == "c4fm" else 8)
    assert 1 <= plan.cluster <= 8 and plan.threads % 32 == 0 and plan.threads <= 512
    assert plan.ctas == rows * plan.cluster and plan.cap > 0
    seen = np.zeros(n_sym, np.int64)
    for rank in range(plan.cluster):
        seen[rank * plan.mseg:min(n_sym, (rank + 1) * plan.mseg)] += 1
    assert (seen == 1).all()
    assert plan.mseg >= 64 or plan.cluster == 1


@pytest.mark.parametrize("name", SHAPES)
def test_windows_hold_every_gather(name):
    """Across the carried position (0 .. 64 + sps), the clock (fmin ..
    fmax), the phase offsets (+-sps/2, d0 + 0.5) and the slope (+-0.005):
    every index a CTA's gathers can read (floor and floor + 1 of each
    clipped position: the Gardner samples, the mid samples, the ramp, the
    symbol before the CTA's first) and its row-pass samples lie in its
    window, and the windows fit the plan's room; the row-pass samples
    cover the row once."""
    kind, rows, length, n_sym, fs, rs = SHAPES[name]
    c = consts(kind, fs, rs)
    plan = tc.k12_plan(rows, n_sym, c, 4 if kind == "c4fm" else 8)
    hi = F(length - 2)
    sps, half = F(c.sps), F(c.half)
    offs = [F(-half), F(0), half, F(half + F(0.5))]
    for pos in (F(0), F(4), F(TAIL), F(TAIL + 0.37 * sps), F(TAIL + sps)):
        for freq in (F(c.fmin), sps, F(c.fmax)):
            ctas = windows(length, n_sym, pos, freq, c, plan)
            covered = np.zeros(length, np.int64)
            for m0, m1, b_lo, b_hi, w_lo, w_hi in ctas:
                assert w_hi - w_lo <= plan.cap
                assert w_lo <= b_lo <= b_hi <= w_hi
                covered[b_lo:b_hi] += 1
                m = np.arange(max(m0 - 1, 0), m1)
                base = (pos + (m.astype(F) * freq).astype(F)).astype(F)
                ps = [(base + o).astype(F) for o in offs]
                nxt = m[m + 1 < n_sym] + 1
                base_n = (pos + (nxt.astype(F) * freq).astype(F)).astype(F)
                ps += [((base_n + o).astype(F) - F(freq * F(0.5))).astype(F) for o in offs]
                ps += [(base_n + o).astype(F) for o in offs]
                for sl in (F(-0.005), F(0.005)):
                    for d in (-half, half):
                        ramp = (d + (sl * (m.astype(F) - F(F(0.5) * F(n_sym)))).astype(F)).astype(F)
                        ps.append((base + ramp).astype(F))
                for p in ps:
                    i0 = np.floor(np.clip(p, F(0), hi)).astype(np.int64)
                    assert (i0 >= w_lo).all() and (i0 + 1 < w_hi).all(), (name, pos, freq)
            assert (covered[TAIL:] == 1).all() and not covered[:TAIL].any()


def timing_state_close(jst, tst, what: str):
    for f in ("pos", "freq", "integrator") + (("gain", "dc") if hasattr(tst, "gain") else ("bias",)):
        ref = np.stack([np.asarray(getattr(s, f)) for s in jst])
        err = float(np.max(np.abs(getattr(tst, f).numpy() - ref)))
        assert err <= 1e-3, (what, f, err)


def assert_emulation_matches(out, what: str):
    for b, (js, jd, ts, td, jst, tst) in enumerate(out):
        np.testing.assert_array_equal(td, jd, err_msg=f"{what} block {b}: dibits")
        for r in range(js.shape[0]):
            assert snr_db(js[r], ts[r]) >= 60.0, (what, b, r)
        timing_state_close(jst, tst, f"{what} block {b}")


@pytest.mark.parametrize("fs,block", [(50_000, 5_000), (50_000, 100_000)], ids=["0.1s", "2s"])
def test_c4fm_emulation_matches_reference(rng, monkeypatch, fs, block):
    """Two C4FM rows (clock offset 120 ppm) over consecutive blocks through
    the port's demodulator with K12 emulated, against the reference's."""
    n_blocks = 3 if block < 50_000 else 1
    rows = np.stack([c4fm_iq(rng, fs, n_blocks * block), c4fm_iq(rng, fs, n_blocks * block)])
    monkeypatch.setattr(tc, "c4fm_timing", c4fm_emulated)
    out = run_both(jc.c4fm_demodulate, jc.c4fm_init, jc.C4fmConfig(sample_rate=fs),
                   tc.c4fm_demodulate, tc.c4fm_init, tc.C4fmConfig(sample_rate=fs), rows, block)
    assert_emulation_matches(out, f"c4fm {block}")


@pytest.mark.parametrize("rs,alpha,block", [(4800.0, 0.2, 5_000), (6000.0, 1.0, 5_000), (4800.0, 0.2, 100_000)],
                         ids=["lsm-0.1s", "phase2-0.1s", "lsm-2s"])
def test_cqpsk_emulation_matches_reference(rng, monkeypatch, rs, alpha, block):
    """Two CQPSK rows (+600 and -300 Hz of CFO) over consecutive blocks
    through the port's demodulator with K13's timing emulated, against the
    reference's block branch."""
    fs = 50_000
    n_blocks = 3 if block < 50_000 else 1
    rows = np.stack([cqpsk_iq(rng, fs, n_blocks * block, rs, alpha, 600.0),
                     cqpsk_iq(rng, fs, n_blocks * block, rs, alpha, -300.0)])
    monkeypatch.setattr(tq, "cqpsk_timing", cqpsk_emulated)
    kw = dict(sample_rate=fs, symbol_rate=rs, rrc_alpha=alpha)
    out = run_both(jq.cqpsk_demodulate, jq.cqpsk_init, jq.CqpskConfig(**kw), tq.cqpsk_demodulate,
                   tq.cqpsk_init, tq.CqpskConfig(**kw), rows, block)
    assert_emulation_matches(out, f"cqpsk {rs} {block}")
