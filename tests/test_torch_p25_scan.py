"""K12s and K13s, the P25 per-symbol timing scans (``kernels/csrc/
p25_scan.cu``, plan ``models/p25/c4fm.py:k12s_plan``), emulated in numpy
against the JAX package, on the CPU.

The kernel streams a row through a ring of chunks in shared memory (a
producer warp refills a slot once the walker's published low mark is a
chunk past it); one thread walks the symbols in groups (128 steps, the
first ending at 32, where the plan does not shorten them: before a group
it publishes its low mark and waits for the chunks the group can reach),
each step's samples loaded a step ahead from windows whose lower ends
follow from the position by the loop's legal ranges.  Where the plan
finds those windows narrow enough, steps whose windows stay inside the
row run unchecked (an unchecked run that meets a division out of range
is walked again checked); the other steps check their windows and read
the row where one does not hold or the reference's clamp acts.  C4FM's
division by the block's
den = amp^2 is a multiply by RN(1/den) and two fused multiply-adds,
guarded; from the second step the error's clip merges into the
integrator's and the clock's clip is dropped where it is idle; a helper
warp sums C4FM's |y| or CQPSK's detector residuals in the order of
``p25_common.cuh``'s epilogues (a block of 256 threads).

Held here: the plan at every shape the port runs, long rows and long
symbols (a wider ring, shorter groups) included, and its refusals; the
windows, computed as the kernel computes them, hold floor of every
next position and mid point across the legal ranges of the position, the
clock, the integrator and the error, and select the reference's samples
at the clamps; the guarded division equals IEEE f32 division (fused
operations emulated exactly, by round-to-odd); the merged clips equal the
reference's three; and the emulated walk, reading only samples the ring
holds and finding every position in its window wherever it runs
unchecked, through the port's demodulators against the reference's
``timing_impl="scan"`` over consecutive blocks (at 48 kHz, at 240 kHz,
and with a clock range too wide for unchecked steps), and on one LSM
block of 4 s (past the first design's limit): dibits equal, soft >= 50 dB, the
carried state within ``test_torch_p25.py``'s bound.
"""

import numpy as np
import pytest
import torch

from wavecap_tpu.models.p25 import c4fm as jc
from wavecap_tpu.models.p25 import cqpsk as jq
from wavecap_tpu_torch.models.p25 import c4fm as tc
from wavecap_tpu_torch.models.p25 import cqpsk as tq
from tests.test_torch_p25 import assert_blocks_match, c4fm_iq, cqpsk_iq, run_both
from tests.test_torch_p25_timing import shuffle_tree
from tests.test_torch_pll import fma32

torch.set_num_threads(1)

F = np.float32
TAIL = 64
FAR = F(2.0 ** 21)  # positions past it are read from the row
QPI = F(0.7853981633974483)
DIV_LO, DIV_HI = F(2.0 ** -80), F(2.0 ** 80)
DEN_LO, DEN_HI = F(2.0 ** -30), F(2.0 ** 30)
VIRTUAL = 256  # the block of p25_common.cuh's epilogue sums: symbol m to thread m % 256

# (modulation, rows, row length, symbols, sample rate, symbol rate): the
# programs' shapes, the long rows the first design refused, and channels
# of 240 and 960 kHz (50 to 200 samples a symbol: a wider ring, shorter groups)
SHAPES = {
    "A": ("c4fm", 50, 12_564, 1_200, 50_000, 4800.0),
    "B": ("lsm", 21, 7_564, 720, 50_000, 4800.0),
    "C": ("p2", 20, 7_564, 900, 50_000, 6000.0),
    "4s-lsm": ("lsm", 2, 200_064, 19_200, 50_000, 4800.0),
    "3s-p2": ("p2", 2, 150_064, 18_000, 50_000, 6000.0),
    "11s-c4fm": ("c4fm", 1, 550_064, 52_800, 50_000, 4800.0),
    "240k-c4fm": ("c4fm", 4, 48_064, 960, 240_000, 4800.0),
    "240k-lsm": ("lsm", 4, 48_064, 960, 240_000, 4800.0),
    "960k-c4fm": ("c4fm", 1, 192_064, 960, 960_000, 4800.0),
    "960k-p2": ("p2", 1, 192_064, 1_200, 960_000, 6000.0),
}


def consts(kind: str, fs: float, rs: float, ppm: float = 2000.0):
    return tc.timing_consts(fs / rs, ppm, 0.005 if kind == "c4fm" else 0.002)


def gains(kind: str):
    cfg = tc.C4fmConfig() if kind == "c4fm" else tq.CqpskConfig()
    return tuple(F(g) for g in tc._loop_gains(cfg))


def lowest_next(p, c, a2):
    return F(F(p + F(c.fmin)) - a2)


def window_floor(lo):
    """The window's lower floor as the kernel takes it (``__float2int_rd``)."""
    return int(np.floor(lo))


class Ring:
    """The producer's ring and the walker's view of it: chunks land in
    order as fast as the low mark lets the producer reuse a slot (the
    earliest a slot can be overwritten); a read must be of a chunk the
    walker waited for and the producer has not yet overwritten."""

    def __init__(self, row: np.ndarray, plan):
        self.row, self.chunk, self.slots = row, plan.chunk, plan.slots
        self.chunks = -(-row.shape[0] // plan.chunk)
        self.produced = self.waited = self.ready = 0
        self.low = -(1 << 30)
        self.fill()

    def fill(self):
        while self.produced < self.chunks and (
                self.produced < self.slots or self.low >= (self.produced - self.slots + 1) * self.chunk):
            self.produced += 1

    def publish_low(self, low: int):
        self.low = low
        self.fill()

    def wait(self, top: int):
        while top >= self.ready:
            assert self.waited < self.produced, "the walker waits for a chunk the producer cannot issue"
            self.waited += 1
            self.ready = min(self.waited * self.chunk, self.row.shape[0])

    def read(self, i: int):
        k = i // self.chunk
        assert k < self.waited and k >= self.produced - self.slots, (i, self.waited, self.produced)
        return self.row[i]


class Window:
    """Three consecutive samples from the floor ``at`` of a window's lower
    end, as loaded (unclamped: a step whose window lies past the row's
    ends is redone from the row)."""

    def __init__(self, ring, lo, last: int):
        self.at = window_floor(lo)  # the kernel's floor by a rounded-down add onto 1.5 2^23: |lo| < 2^22 here
        self.b = F(self.at)
        self.b1 = F(self.b + F(1))
        self.s = [ring.read(self.at + k) for k in range(3)] if 0 <= self.at < last else None

    def sample(self, p, last: int):
        """``(interp(p), ok)``: ok only if p lies in the window and the
        reference's clamp is idle there."""
        d = F(p - self.b)
        up = p >= self.b1
        fr = F(p - self.b1) if up else d
        ok = bool(d >= F(0) and d < F(2) and p < FAR) and 0 <= self.at < last
        if not ok:
            return None, False
        return lerp(self.s[1] if up else self.s[0], self.s[2] if up else self.s[1], fr), True


def lerp(a, b, fr):
    if np.iscomplexobj(a):
        return np.complex64(complex(lerp(F(a.real), F(b.real), fr), lerp(F(a.imag), F(b.imag), fr)))
    return F(F(a * F(F(1) - fr)) + F(b * fr))


def interp_row(row, p, last: int):
    f = F(np.floor(p))
    fr = F(p - f)
    i0 = int(min(max(f, F(0)), F(last))) if not np.isnan(f) else 0
    return lerp(row[i0], row[i0 + 1], fr)


def clip(x, lo, hi):
    """fminf(fmaxf(x, lo), hi): a NaN goes to lo."""
    x = lo if np.isnan(x) else max(x, lo)
    return F(min(x, hi))


def divide(x, den, rden, div_lo):
    """The kernel's guarded division: the multiply by RN(1/den) and two
    fused multiply-adds, or IEEE division off its range."""
    ax = F(abs(x))
    if not (ax >= div_lo and ax <= DIV_HI):
        return F(np.divide(x, den, dtype=F))
    q0 = F(x * rden)
    return F(fma32(fma32(-q0, den, x), rden, q0))


def block_sum(vals: np.ndarray) -> F:
    """``block_sum`` over a block of 256 threads, symbol m to thread m % 256: each
    thread's values in order, each warp's shuffle tree, then the 8 warps'
    sums over 32 lanes."""
    acc = np.zeros(VIRTUAL, F)
    for m in range(0, len(vals), VIRTUAL):
        part = vals[m:m + VIRTUAL]
        acc[:len(part)] = (acc[:len(part)] + part).astype(F)
    warps = shuffle_tree(acc.reshape(VIRTUAL // 32, 32))[:, 0]
    lanes = np.zeros(32, F)
    lanes[:VIRTUAL // 32] = warps
    return F(shuffle_tree(lanes)[0])


def emulate_row(row: np.ndarray, st: np.ndarray, n_sym: int, c, g, cqpsk: bool, dc0, plan) -> tuple:
    """K12s / K13s on one row: ``(soft, dibits, out)`` as the kernel writes them."""
    length = row.shape[0]
    last = length - 2
    alpha, beta = g
    a2, b2 = F(F(2) * alpha), F(F(2) * beta)
    hmax = F(F(c.fmax) * F(0.5))
    pos, freq, integ, s3, s4, s5 = (F(v) for v in st)
    if cqpsk and freq < F(1):
        freq = F(c.sps)
    clip_freq = not (F(F(c.sps) + F(c.integ_lo)) >= F(c.fmin) and F(F(c.sps) + F(c.integ_hi)) <= F(c.fmax))
    ring = Ring(row, plan)
    group, first = plan.group, plan.first
    den = rden = div_lo = None
    if not cqpsk:
        amp = F(2) if s3 < F(0.01) else F(F(2) / max(s3, F(0.05)))
        den = F(amp * amp)
        rden = F(np.float64(1) / np.float64(den))  # RN(1/den): the double rounding is innocuous here
        div_lo = DIV_LO if DEN_LO <= den <= DEN_HI else F(np.inf)
    prev = np.complex64(complex(s4, s5)) if cqpsk else s5
    redone = []

    reach = F(F(c.fmax) + F(1))

    def await_(steps):
        need = min(int(F(pos + F(F(steps + 1) * reach))) + 3, length - 1)
        if need >= ring.ready:
            ring.publish_low(int(F(pos - hmax)) - 1 - plan.chunk)
            ring.wait(need)
        return need

    def fetch(ly):
        return Window(ring, ly, last), Window(ring, F(ly - hmax), last)

    def centred(v):
        return v if cqpsk else F(v - dc0)

    def numerator(y, ym, prev):
        if cqpsk:
            d = np.complex64(prev - y)
            return F(F(F(ym.real) * F(d.real)) + F(F(ym.imag) * F(d.imag)))
        return F(F(prev - y) * ym)

    # step 0 from the row, as the reference writes it
    await_(min(first - 1, n_sym - 1))
    y = centred(interp_row(row, pos, last))
    ym = centred(interp_row(row, F(pos - F(freq * F(0.5))), last))
    x = numerator(y, ym, prev)
    err = clip(x if cqpsk else F(np.divide(x, den, dtype=F)), F(-2), F(2))
    integ = clip(F(integ + F(beta * err)), F(c.integ_lo), F(c.integ_hi))
    freq = clip(F(F(c.sps) + integ), F(c.fmin), F(c.fmax))
    pos = F(F(pos + freq) + F(alpha * err))
    prev = y
    raw = [y]
    wins = fetch(pos)  # step 1's windows from its own position

    def run(state, wins, start, end, checked):
        """Steps [start, end) from ``state``: ``(state, wins, symbols, bad)``;
        a checked step whose window or division range fails is redone from
        the row, an unchecked one marks the run bad."""
        pos, freq, integ, prev = state
        h = F(freq * F(0.5))
        bad, out = False, []
        for k in range(start, end):
            pm = F(pos - h)
            (wy, wm) = wins
            y, ok_y = wy.sample(pos, last)
            ym, ok_m = wm.sample(pm, last)
            assert checked or (ok_y and ok_m), ("a position left its window", k, pos)
            wins = fetch(lowest_next(pos, c, a2))
            ok = ok_y and ok_m
            if ok:
                y, ym = centred(y), centred(ym)
                x = numerator(y, ym, prev)
                ok = cqpsk or bool(F(abs(x)) >= div_lo and F(abs(x)) <= DIV_HI)
                q = x if cqpsk else divide(x, den, rden, div_lo)
            if not ok:
                if not checked:
                    return None, wins, out, True
                y = centred(interp_row(row, pos, last))
                ym = centred(interp_row(row, pm, last))
                x = numerator(y, ym, prev)
                q = x if cqpsk else F(np.divide(x, den, dtype=F))
                redone.append(k)
            lo_i = max(F(integ - b2), F(c.integ_lo))
            hi_i = min(F(integ + b2), F(c.integ_hi))
            integ = clip(F(integ + F(beta * q)), lo_i, hi_i)
            t = F(F(c.sps) + integ)
            freq = clip(t, F(c.fmin), F(c.fmax)) if clip_freq else t
            pos = F(F(pos + freq) + clip(F(alpha * q), -a2, a2))
            h = F(freq * F(0.5))
            prev = y
            out.append(y)
        return (pos, freq, integ, prev), wins, out, bad

    m = 1
    while m < n_sym:
        end = min(first if m < first else (m | (group - 1)) + 1, n_sym)
        need = await_(end - m)
        split = m
        if (plan.narrow and wins[1].at >= 0 and wins[0].at < last and int(F(pos - hmax)) >= 2
                and need < int(FAR)):
            room = int(F(F(F(last - 3) - F(pos + F(c.fmin))) / reach))
            split = end if need < last else min(end, m + max(0, room))
        state = (pos, freq, integ, prev)
        if split > m:
            got, wins2, out, bad = run(state, wins, m, split, False)
            if bad:  # again from the group's start, each step checked
                got, wins2, out, _ = run(state, fetch(pos), m, split, True)
            state, wins = got, wins2
            raw += out
        if split < end:
            state, wins, out, _ = run(state, wins, split, end, True)
            raw += out
        pos, freq, integ, prev = state
        m = end
    p = F(pos - F(length - TAIL))
    p = F(p + F(c.sps)) if p < F(4) else p
    pos_next = F(p - F(c.sps)) if p > F(c.recenter_hi) else p
    if not cqpsk:
        raw = np.array(raw, F)
        acc = block_sum(np.abs(raw).astype(F))
        scale = F(F(2) / max(F(acc / F(n_sym)), F(0.05)))
        gain = scale if s3 < F(0.01) else F(F(F(0.95) * s3) + F(F(0.05) * scale))
        gain = clip(gain, F(0.05), F(40))
        soft = (raw * gain).astype(F)
        out = [pos_next, freq, integ, gain, dc0, raw[-1]]
    else:
        raw = np.array(raw, np.complex64)
        before = np.concatenate([[np.complex64(complex(s4, s5))], raw[:-1]])
        zr = ((raw.real * before.real).astype(F) + (raw.imag * before.imag).astype(F)).astype(F)
        zi = ((raw.imag * before.real).astype(F) - (raw.real * before.imag).astype(F)).astype(F)
        dph = np.arctan2(zi, zr).astype(F)
        e = (dph - s3).astype(F)
        qn = np.clip(np.rint((e / QPI).astype(F)), F(-3), F(3)).astype(F)
        acc = block_sum((e - (qn * QPI).astype(F)).astype(F))
        bias = F(s3 + F(F(0.02) * F(acc / F(n_sym))))
        soft = ((dph - bias).astype(F) / QPI).astype(F)
        out = [pos_next, freq, integ, bias, F(raw[-1].real), F(raw[-1].imag)]
    dibits = np.where(soft >= 0, np.where(np.abs(soft) >= 2, 1, 0), np.where(np.abs(soft) >= 2, 3, 2))
    return soft, dibits.astype(np.uint8), np.array(out, F)


def emulate(buf, st, n_sym: int, c, g, cqpsk: bool, dc0=None):
    """The kernel's launch over rows ``buf`` by the wrapper's own plan."""
    b, s = buf.numpy(), st.numpy()
    plan = tc.k12s_plan(c, g[0], b.itemsize)
    dc = None if dc0 is None else dc0.numpy()
    rows = [emulate_row(b[r], s[:, r], n_sym, c, g, cqpsk, None if dc is None else F(dc[r]), plan)
            for r in range(b.shape[0])]
    return (torch.from_numpy(np.stack([r[0] for r in rows])), torch.from_numpy(np.stack([r[1] for r in rows])),
            torch.from_numpy(np.stack([r[2] for r in rows], axis=1)))


def c4fm_emulated(buf, st, n_sym, cfg):
    g = tuple(F(v) for v in tc._loop_gains(cfg))
    return emulate(buf, st, n_sym, tc.timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005), g, False,
                   tc._scan_dc(buf, st))


def cqpsk_emulated(buf, st, n_sym, cfg):
    g = tuple(F(v) for v in tc._loop_gains(cfg))
    return emulate(buf, st, n_sym, tc.timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002), g, True)


# --- the plan -------------------------------------------------------------------------


def group_need(pos, steps: int, c, length: int) -> int:
    """The highest sample the walker waits for before ``steps`` steps from ``pos``."""
    reach = F(F(c.fmax) + F(1))
    return min(int(F(pos + F(F(steps + 1) * reach))) + 3, length - 1)


def low_mark(pos, c, chunk: int) -> int:
    return int(F(pos - F(F(c.fmax) * F(0.5)))) - 1 - chunk


def group_ends(plan, n: int):
    """The symbols before which the walker waits, and each group's end:
    step 0's wait, then the groups from symbol 1 (the first ending at
    ``plan.first``, the others at multiples of ``plan.group``)."""
    yield 0, plan.first
    m = 1
    while m < n:
        end = plan.first if m < plan.first else (m | (plan.group - 1)) + 1
        yield m, end
        m = end


@pytest.mark.parametrize("name", SHAPES)
def test_plan_runs_every_shape(name):
    """The plan at every shape, the long rows and long symbols included:
    powers of two, at least three slots, a symbol ring with a group and
    the helper's 32 symbols to spare, shared memory within a CTA's 227 KB
    that holds the kernel's layout, and a ring in which a group's reads
    (``k12s_reach``, checked against the walker's own bounds) fit beside
    the slot being refilled; narrow windows at the default clock range
    up to 240 kHz (at 960 kHz its 2,000 ppm span 0.64-0.8 samples a
    symbol: every step checked)."""
    kind, rows, length, n_sym, fs, rs = SHAPES[name]
    item = 4 if kind == "c4fm" else 8
    c = consts(kind, fs, rs)
    plan = tc.k12s_plan(c, gains(kind)[0], item)
    for v in (plan.chunk, plan.slots, plan.group, plan.sym_ring):
        assert v & (v - 1) == 0
    assert plan.slots >= 3 and plan.chunk >= 64 and 1 <= plan.first <= plan.group
    assert plan.group + 64 <= plan.sym_ring and plan.narrow == (fs <= 240_000)
    assert plan.smem == item * (plan.chunk * plan.slots + plan.sym_ring + 4) + 8 * plan.slots <= 227 * 1024
    reach = tc.k12s_reach(c, plan.group)
    assert reach <= (plan.slots - 2) * plan.chunk
    for pos in np.linspace(0.0, length + 5.0, 4001).astype(F):
        assert group_need(pos, plan.group, c, length) - (low_mark(pos, c, 0) + 1) <= reach
    if fs == 50_000:  # the programs' channels: the ring and groups as designed
        assert (plan.chunk, plan.slots, plan.group, plan.first, plan.sym_ring) == (1024, 8, 128, 32, 1024)


def test_plan_widens_then_refuses():
    """Longer symbols widen the chunks, then shorten the groups (C4FM at
    960 kHz, 200 samples a symbol: chunks of 4,096 and groups of 64); a
    clock range or loop gain that leaves the windows wide keeps the
    plan but marks it not narrow (every step checked); a loop whose step
    may stand still, or a symbol too long for a group of one, is refused."""
    c4, g4 = consts("c4fm", 240_000, 4800.0), gains("c4fm")[0]
    assert tc.k12s_plan(c4, g4, 4)[:3] == (2048, 8, 128)
    assert tc.k12s_plan(consts("c4fm", 960_000, 4800.0), g4, 4)[:3] == (4096, 8, 64)
    assert tc.k12s_plan(consts("p2", 960_000, 6000.0), gains("p2")[0], 8)[:3] == (2048, 8, 64)
    assert not tc.k12s_plan(consts("lsm", 48_000, 4800.0, 30_000.0), gains("lsm")[0], 8).narrow
    assert tc.k12s_plan(consts("c4fm", 50_000, 4800.0, 18_000.0), g4, 4).narrow
    assert not tc.k12s_plan(c4, 0.2, 4).narrow
    with pytest.raises(NotImplementedError):
        tc.k12s_plan(c4, 0.25, 4)
    with pytest.raises(NotImplementedError):
        tc.k12s_plan(consts("c4fm", 120_000_000, 4800.0), g4, 4)


@pytest.mark.parametrize("name", SHAPES)
def test_ring_protocol_reads_only_what_it_holds(name):
    """The walker's low marks and waits along a walk through the row at
    the fastest clock (at the plan's group ends): every window read is of
    a landed chunk not yet overwritten, and the producer never waits on a
    walker that waits on it."""
    kind, rows, length, n_sym, fs, rs = SHAPES[name]
    c = consts(kind, fs, rs)
    plan = tc.k12s_plan(c, gains(kind)[0], 4 if kind == "c4fm" else 8)
    ring = Ring(np.zeros(length, F), plan)
    a2 = F(F(2) * gains(kind)[0])
    hmax = F(F(c.fmax) * F(0.5))
    last = length - 2
    waits = dict(group_ends(plan, int(length / c.fmin) + 2))
    pos, m = F(TAIL + 3.3), 0
    while pos < length:
        if m in waits:
            need = group_need(pos, waits[m] - m, c, length)
            if need >= ring.ready:
                ring.publish_low(low_mark(pos, c, plan.chunk))
                ring.wait(need)
        ly = lowest_next(pos, c, a2)
        Window(ring, ly, last), Window(ring, F(ly - hmax), last)
        pos, m = F(F(pos + F(c.fmax)) + a2), m + 1


# --- the windows ----------------------------------------------------------------------


@pytest.mark.parametrize("kind,fs,rs,length,ppm", [
    ("c4fm", 50_000, 4800.0, 300, 2000.0), ("lsm", 50_000, 4800.0, 300, 2000.0),
    ("p2", 50_000, 6000.0, 300, 2000.0), ("c4fm", 50_000, 4800.0, 550_064, 2000.0),
    ("p2", 50_000, 6000.0, 150_064, 2000.0), ("c4fm", 240_000, 4800.0, 48_064, 2000.0),
    ("c4fm", 50_000, 4800.0, 550_064, 18_000.0)],
    ids=["c4fm", "lsm", "p2", "c4fm-11s", "p2-3s", "c4fm-240k", "c4fm-11s-18000ppm"])
def test_windows_hold_the_next_reads(kind, fs, rs, length, ppm):
    """Across the position (below the first sample, through the row, past
    len - 2), the clock (fmin .. fmax), the integrator and the error (+-2
    and between): the windows computed from a position hold floor of the
    next position and of its mid point wherever the reference's clamp is
    idle, and there select its samples bit for bit; where a window's floor
    lies past [0, len - 2) the step is redone from the row.  Each case is
    one the plan marks narrow (18,000 ppm: near its bound)."""
    c = consts(kind, fs, rs, ppm)
    alpha, beta = gains(kind)
    assert tc.k12s_plan(c, alpha, 4 if kind == "c4fm" else 8).narrow
    a2 = F(F(2) * alpha)
    hmax = F(F(c.fmax) * F(0.5))
    last = length - 2
    rng = np.random.default_rng(7)
    row = rng.standard_normal(length).astype(F)
    if kind != "c4fm":
        row = (row + 1j * rng.standard_normal(length).astype(F)).astype(np.complex64)

    class Whole:
        @staticmethod
        def read(i):
            return row[i]

    starts = np.concatenate([np.linspace(-25.0, 12.0, 301), np.linspace(last - 25.0, last + 6.0, 301),
                             rng.uniform(0, length, 400)]).astype(F)
    errs = np.array([-2.0, -1.3, -0.01, 0.0, 0.4, 1.99, 2.0], F)
    integs = np.array([c.integ_lo, -1e-3, 0.0, 7e-4, c.integ_hi], F)
    checked = redone = 0
    for pos in starts:
        ly = lowest_next(pos, c, a2)
        wy, wm = Window(Whole, ly, last), Window(Whole, F(ly - hmax), last)
        inside = 0 <= wm.at and wy.at + 2 < last
        for integ in integs:
            for e in errs:
                i1 = clip(F(integ + F(beta * e)), F(c.integ_lo), F(c.integ_hi))
                f1 = clip(F(F(c.sps) + i1), F(c.fmin), F(c.fmax))
                p1 = F(F(pos + f1) + F(alpha * e))
                pm1 = F(p1 - F(f1 * F(0.5)))
                for p, w in ((p1, wy), (pm1, wm)):
                    y, ok = w.sample(p, last)
                    assert ok or not inside, (kind, pos, integ, e, p, w.b)
                    if ok:
                        ref = interp_row(row, p, last)
                        assert np.asarray(y).tobytes() == np.asarray(ref).tobytes(), (p, y, ref)
                        checked += 1
                    else:
                        redone += 1
    assert checked > 40_000 and redone < checked


# --- the arithmetic -------------------------------------------------------------------


def test_division_equals_ieee():
    """The multiply by RN(1/den) and two fused multiply-adds, guarded,
    against IEEE f32 division over numerators from 1e-30 to 1e30 (both
    signs, 0 and -0, the guard's edges, inf and NaN) and den across
    [0.0025, 1600] (the carried gain's range), bit for bit."""
    rng = np.random.default_rng(11)
    n = 400_000
    den = np.concatenate([np.exp(rng.uniform(np.log(0.0025), np.log(1600.0), n)),
                          [0.0025, 1600.0, 4.0, 1.0, 0.04, 2.0 / 3.0]]).astype(F)
    x = (rng.choice([-1.0, 1.0], den.size) * np.exp(rng.uniform(np.log(1e-30), np.log(1e30), den.size))).astype(F)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, DIV_LO, np.nextafter(DIV_LO, F(0)), DIV_HI,
                        np.nextafter(DIV_HI, F(np.inf)), 1e-45, -3e-39, 1.0, -2.0], F)
    x[:special.size] = special
    rden = (np.float64(1) / den.astype(np.float64)).astype(F)
    with np.errstate(all="ignore"):  # the fused path on inf and NaN: discarded by the guard
        q0 = (x * rden).astype(F)
        q = fma32(fma32(-q0, den, x), rden, q0)
        ax = np.abs(x)
        q = np.where((ax >= DIV_LO) & (ax <= DIV_HI), q, np.divide(x, den, dtype=F))
        ref = np.divide(x, den, dtype=F)
    nan = np.isnan(ref)
    assert np.array_equal(np.isnan(q), nan)
    assert np.array_equal(q[~nan].view(np.uint32), ref[~nan].view(np.uint32))
    # numerators across one binade finely, against a den with an all-ones mantissa
    d = np.array([np.nextafter(F(2.0), F(0)), F(0.0025), F(1599.9999)], F)
    for dv in d:
        xs = np.nextafter(F(1.0), F(2.0)) + np.arange(200_000, dtype=F) * F(2.0 ** -23)
        r1 = F(np.float64(1) / np.float64(dv))
        q0 = (xs * r1).astype(F)
        qq = fma32(fma32(-q0, np.full_like(xs, dv), xs), np.full_like(xs, r1), q0)
        assert np.array_equal(qq.view(np.uint32), np.divide(xs, dv, dtype=F).view(np.uint32))


@pytest.mark.parametrize("kind", ["c4fm", "cqpsk"])
def test_merged_clips_equal_the_reference(kind):
    """From the second step: clip(RN(integ + RN(beta q)), max(RN(integ -
    2 beta), integ_lo), min(RN(integ + 2 beta), integ_hi)) and clip(RN(alpha
    q), +-RN(2 alpha)) against the reference's err = clip(q, +-2), integ =
    clip(RN(integ + RN(beta err))), RN(alpha err), for integ in range and q
    anywhere (NaN and +-inf too), bit for bit; and the clock's clip idle
    at every shape where the kernel drops it."""
    c = consts("c4fm" if kind == "c4fm" else "lsm", 50_000, 4800.0)
    alpha, beta = gains("c4fm" if kind == "c4fm" else "lsm")
    a2, b2 = F(F(2) * alpha), F(F(2) * beta)
    rng = np.random.default_rng(5)
    integs = np.concatenate([[c.integ_lo, c.integ_hi, 0.0, -0.0], rng.uniform(c.integ_lo, c.integ_hi, 400)])
    qs = np.concatenate([[np.nan, np.inf, -np.inf, 2.0, -2.0, 0.0, -0.0, 1e30, -1e30],
                         rng.uniform(-3, 3, 300), rng.standard_normal(100) * 1e-3]).astype(F)
    for integ in integs.astype(F):
        lo_i, hi_i = max(F(integ - b2), F(c.integ_lo)), min(F(integ + b2), F(c.integ_hi))
        for q in qs:
            err = clip(q, F(-2), F(2))
            ref_i = clip(F(integ + F(beta * err)), F(c.integ_lo), F(c.integ_hi))
            ref_a = F(alpha * err)
            got_i = clip(F(integ + F(beta * q)), lo_i, hi_i)
            got_a = clip(F(alpha * q), -a2, a2)
            assert np.asarray(got_i).view(np.uint32) == np.asarray(ref_i).view(np.uint32), (integ, q)
            assert np.asarray(got_a).view(np.uint32) == np.asarray(ref_a).view(np.uint32), (q,)
    for kind_, _, _, _, fs, rs in SHAPES.values():
        cc = consts(kind_, fs, rs)
        assert F(F(cc.sps) + F(cc.integ_lo)) >= F(cc.fmin) and F(F(cc.sps) + F(cc.integ_hi)) <= F(cc.fmax)


# --- the walk through the demodulators --------------------------------------------------


@pytest.mark.parametrize("kind", ["c4fm", "lsm", "phase2", "c4fm-240k", "lsm-30000ppm"])
def test_emulation_matches_reference(rng, monkeypatch, kind):
    """Two rows over 3 consecutive 0.1 s blocks at 48 kHz through the
    port's demodulator with K12s / K13s emulated, against the reference's
    scan: C4FM, LSM (+600 and -300 Hz of CFO), Phase 2 at 6000 baud; C4FM
    at 240 kHz (50 samples a symbol: chunks of 2,048), and LSM with a
    clock range of 30,000 ppm (windows too wide: every step checked)."""
    fs = 240_000 if kind == "c4fm-240k" else 48_000
    block = fs // 10
    if kind.startswith("c4fm"):
        rows = np.stack([c4fm_iq(rng, fs, 3 * block), c4fm_iq(rng, fs, 3 * block)])
        monkeypatch.setattr(tc, "c4fm_scan", c4fm_emulated)
        args = (jc.c4fm_demodulate, jc.c4fm_init, jc.C4fmConfig(sample_rate=fs, timing_impl="scan"),
                tc.c4fm_demodulate, tc.c4fm_init, tc.C4fmConfig(sample_rate=fs, timing_impl="scan"))
    else:
        rs, alpha = (4800.0, 0.2) if kind.startswith("lsm") else (6000.0, 1.0)
        rows = np.stack([cqpsk_iq(rng, fs, 3 * block, rs, alpha, 600.0),
                         cqpsk_iq(rng, fs, 3 * block, rs, alpha, -300.0)])
        monkeypatch.setattr(tq, "cqpsk_scan", cqpsk_emulated)
        kw = dict(sample_rate=fs, symbol_rate=rs, rrc_alpha=alpha, timing_impl="scan")
        if kind == "lsm-30000ppm":
            kw["max_clock_ppm"] = 30_000.0
        args = (jq.cqpsk_demodulate, jq.cqpsk_init, jq.CqpskConfig(**kw),
                tq.cqpsk_demodulate, tq.cqpsk_init, tq.CqpskConfig(**kw))
    out = run_both(*args, rows, block)
    assert_blocks_match(out, f"scan emulated {kind}")


def test_long_lsm_block_matches_reference(rng, monkeypatch):
    """One LSM row in one 4 s block (19,200 symbols: the first design
    staged every symbol in shared memory and refused past 17,066) through
    the port's demodulator with K13s emulated, against the reference."""
    fs, block = 48_000, 192_000
    rows = cqpsk_iq(rng, fs, block, 4800.0, 0.2, 400.0)[None, :]
    monkeypatch.setattr(tq, "cqpsk_scan", cqpsk_emulated)
    kw = dict(sample_rate=fs, timing_impl="scan")
    out = run_both(jq.cqpsk_demodulate, jq.cqpsk_init, jq.CqpskConfig(**kw), tq.cqpsk_demodulate,
                   tq.cqpsk_init, tq.CqpskConfig(**kw), rows, block)
    assert out[0][2].shape == (1, 19_200)
    assert_blocks_match(out, "scan emulated, a 4 s LSM block")
