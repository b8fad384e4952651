"""The port's P25 modems against the JAX package's, on the CPU.

The plain versions of K12 (C4FM block timing), K13 (CQPSK block timing
and the 4th-power line search), K12s / K13s (the per-symbol timing scans
of ``timing_impl="scan"``) and K14 (the echo fit) run here, with K7's
plain ``conv1d`` for the filters and the equaliser.  The same numpy
inputs go through the reference's (unbatched) functions row by row and
the port's batched ones.  Tolerances, each with its reason: hard
decisions (dibits) equal; soft symbols >= 50 dB and carried float state
within 1e-4 of the larger of 1 and its size (f32 sums taken in another
order; the timing's Newton steps amplify an ulp a little); CFO words,
NCO phases, candidate indices and ``eq_hits`` exact; host designs,
modulators and candidate tables bit-equal.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import signal as sps

import jax.numpy as jnp

from wavecap_tpu.decoders.p25_frames import DIBIT_SYMBOLS as J_DIBIT_SYMBOLS
from wavecap_tpu.models.p25 import c4fm as jc
from wavecap_tpu.models.p25 import cqpsk as jq
from wavecap_tpu.models.p25 import equalizer as jeqz
from wavecap_tpu_torch.models.channel_bank import _stack_states
from wavecap_tpu_torch.models.p25 import c4fm as tc
from wavecap_tpu_torch.models.p25 import cqpsk as tq
from wavecap_tpu_torch.models.p25 import equalizer as teqz
from tests.conftest import snr_db
from tests.test_reference_parity import _dibit_agreement

torch.set_num_threads(1)
CPU = torch.device("cpu")
GOLDEN = Path(__file__).parent / "golden"


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128).ravel()
    got = np.asarray(got).astype(np.complex128).ravel()
    return float(np.linalg.norm(ref - got) / max(np.linalg.norm(ref), 1e-30))


def resample(x: np.ndarray, fs: int, ppm: float = 0.0) -> np.ndarray:
    """48 kHz -> ``fs`` with a clock offset of ``ppm`` (FFT resampling)."""
    return sps.resample(x, int(round(len(x) * fs / 48_000 * (1 + ppm * 1e-6)))).astype(np.complex64)


def c4fm_iq(rng, fs: int, n: int, echo: bool = False) -> np.ndarray:
    d = rng.integers(0, 4, n * 48_000 // fs // 10 + 200).astype(np.uint8)
    x = resample(jc.modulate_c4fm(d, 48_000.0), fs, ppm=120.0)[300:300 + n]
    if echo:  # a 70 us simulcast echo at -1.9 dB
        k = int(round(70e-6 * fs))
        x = x + np.concatenate([np.zeros(k, np.complex64), x[:-k]]) * (0.8 * np.exp(2.98j))
    x = x * np.exp(1j * rng.uniform(-np.pi, np.pi))
    return (x + 0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def cqpsk_iq(rng, fs: int, n: int, rs: float, alpha: float, cfo: float, echo: bool = False):
    d = rng.integers(0, 4, int(n * rs / fs) + 300).astype(np.uint8)
    x = resample(jq.modulate_cqpsk(d, 48_000.0, rs, alpha), fs, ppm=-150.0)[400:400 + n]
    if echo:
        k = int(round(70e-6 * fs))
        x = x + np.concatenate([np.zeros(k, np.complex64), x[:-k]]) * (0.8 * np.exp(2.98j))
    x = x * np.exp(2j * np.pi * cfo * np.arange(n) / fs + 1j * rng.uniform(-np.pi, np.pi))
    return (x + 0.03 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def assert_state_close(jstates, tstate, what: str):
    """Each leaf of the port's batched state against the reference's row states."""
    for f in tstate._fields:
        got = getattr(tstate, f).numpy()
        ref = np.stack([np.asarray(getattr(js, f)) for js in jstates])
        assert got.shape == ref.shape, (what, f)
        if got.dtype in (np.uint32, np.int32):
            np.testing.assert_array_equal(got, ref, err_msg=f"{what}: {f}")
        elif got.size:
            err = float(np.max(np.abs(got.astype(np.complex128) - ref)))
            assert err <= 1e-4 * max(1.0, float(np.max(np.abs(ref)))), (what, f, err)


def run_both(jdemod, jinit, jcfg, tdemod, tinit, tcfg, rows: np.ndarray, block: int,
             eq_enable=None):
    """Consecutive blocks of ``rows`` through both packages; per block the
    reference's (soft, dibits) per row, the port's, and the states."""
    n_rows = rows.shape[0]
    jst = [jinit(jcfg) for _ in range(n_rows)]
    tst = _stack_states(tinit(tcfg, device="cpu"), n_rows)
    out = []
    for b in range(rows.shape[1] // block):
        seg = rows[:, b * block:(b + 1) * block]
        js, jd = [], []
        for r in range(n_rows):
            kw = {} if eq_enable is None else {"eq_enable": jnp.bool_(eq_enable[r])}
            s, d, jst[r] = jdemod(jnp.asarray(seg[r]), jst[r], jcfg, **kw)
            js.append(np.asarray(s))
            jd.append(np.asarray(d))
        en = None if eq_enable is None else t(eq_enable)
        ts, td, tst = tdemod(t(seg), tst, tcfg, en)
        out.append((np.stack(js), np.stack(jd), ts.numpy(), td.numpy(), list(jst), tst))
    return out


def assert_blocks_match(out, what: str):
    for b, (js, jd, ts, td, jst, tst) in enumerate(out):
        np.testing.assert_array_equal(td, jd, err_msg=f"{what} block {b}: dibits")
        for r in range(js.shape[0]):
            if np.any(js[r]):
                assert snr_db(js[r], ts[r]) >= 50.0, (what, b, r)
            else:
                assert not np.any(ts[r]), (what, b, r)
        assert_state_close(jst, tst, f"{what} block {b}")


# --- host pieces, bit-equal -------------------------------------------------------


@pytest.mark.parametrize("fs", [48_000.0, 50_000.0])
def test_filter_designs_and_symbols_bit_equal(fs):
    np.testing.assert_array_equal(tc.DIBIT_SYMBOLS, J_DIBIT_SYMBOLS)
    np.testing.assert_array_equal(tc.design_rrc(fs), jc.design_rrc(fs))
    np.testing.assert_array_equal(tc.design_baseband_lpf(fs), jc.design_baseband_lpf(fs))
    for rs, alpha in ((4800.0, 0.2), (6000.0, 1.0)):
        np.testing.assert_array_equal(tq.design_rrc_cqpsk(fs, rs, alpha), jq.design_rrc_cqpsk(fs, rs, alpha))
    assert tc._loop_gains(tc.C4fmConfig()) == jc._loop_gains(jc.C4fmConfig())


@pytest.mark.parametrize("name", ["modulate_c4fm", "modulate_c4fm_cyclic", "modulate_cqpsk",
                                  "modulate_cqpsk_cyclic"])
def test_modulators_bit_equal(rng, name):
    d = rng.integers(0, 4, 601).astype(np.uint8)
    mod = tc if "c4fm" in name else tq
    ref = jc if "c4fm" in name else jq
    np.testing.assert_array_equal(getattr(mod, name)(d, 48_000.0), getattr(ref, name)(d, 48_000.0))


@pytest.mark.parametrize("kind", ["c4fm", "cqpsk"])
def test_candidate_tables_bit_equal(kind):
    if kind == "c4fm":
        got, ref = tc._c4fm_eq_candidates(50_000, 16), jc._c4fm_eq_candidates(50_000, 16)
    else:
        got, ref = tq._eq_candidates(48_000.0, 4800.0, 0.2, 16), jq._eq_candidates(48_000.0, 4800.0, 0.2, 16)
    assert got[2] == ref[2] == 28
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert got[0].shape == (12_289, 29)


# --- the demodulators over consecutive blocks -------------------------------------------


@pytest.mark.parametrize("fs,taps", [(48_000, 0), (50_000, 0), (48_000, 41)],
                         ids=["48k", "50k", "48k-equalizer-echo"])
def test_c4fm_demodulate_matches(rng, fs, taps):
    """4 consecutive blocks of two C4FM rows (clock offset 120 ppm); with
    the equalizer the first row carries a 70 us echo and the second is
    held off by ``eq_enable``."""
    block = fs // 10
    rows = np.stack([c4fm_iq(rng, fs, 4 * block, echo=taps > 0), c4fm_iq(rng, fs, 4 * block)])
    jcfg = jc.C4fmConfig(sample_rate=fs, equalizer_taps=taps)
    tcfg = tc.C4fmConfig(sample_rate=fs, equalizer_taps=taps)
    enable = np.array([True, False]) if taps else None
    out = run_both(jc.c4fm_demodulate, jc.c4fm_init, jcfg, tc.c4fm_demodulate, tc.c4fm_init, tcfg,
                   rows, block, enable)
    assert_blocks_match(out, f"c4fm {fs} taps={taps}")
    if taps:
        tst = out[-1][5]
        assert int(tst.eq_hits[0]) >= 2 and int(tst.eq_hits[1]) == 0
        assert not np.array_equal(tst.eq_taps[0].numpy(), tst.eq_taps[1].numpy())


@pytest.mark.parametrize("rs,alpha,cfo,taps,echo", [
    (4800.0, 0.2, 600.0, 0, False),
    (4800.0, 0.2, 600.0, 41, True),
    (6000.0, 1.0, 0.0, 0, False),
], ids=["lsm-cfo600", "lsm-cfo600-equalizer-echo", "phase2-6000"])
def test_cqpsk_demodulate_matches(rng, rs, alpha, cfo, taps, echo):
    """4 consecutive 0.1 s blocks at 48 kHz of two rows: the station (CFO
    acquired by the 4th-power search) and a second one at -300 Hz."""
    fs, block = 48_000, 4_800
    rows = np.stack([cqpsk_iq(rng, fs, 4 * block, rs, alpha, cfo, echo),
                     cqpsk_iq(rng, fs, 4 * block, rs, alpha, -300.0)])
    jcfg = jq.CqpskConfig(sample_rate=fs, symbol_rate=rs, rrc_alpha=alpha, equalizer_taps=taps)
    tcfg = tq.CqpskConfig(sample_rate=fs, symbol_rate=rs, rrc_alpha=alpha, equalizer_taps=taps)
    out = run_both(jq.cqpsk_demodulate, jq.cqpsk_init, jcfg, tq.cqpsk_demodulate, tq.cqpsk_init, tcfg,
                   rows, block)
    assert_blocks_match(out, f"cqpsk {rs} taps={taps}")
    tst = out[-1][5]
    assert abs(float(tst.cfo_hz[0]) - cfo) <= 25.0
    if echo:
        assert int(tst.eq_hits[0]) >= 2


@pytest.mark.parametrize("kind", ["c4fm", "cqpsk", "cqpsk-phase2"])
def test_dead_air_freezes_timing(rng, kind):
    """A signal block, then two blocks of dead air (digital silence): on the
    second the O&M line is gone (lock 0), and both packages take the
    frozen-timing branch: no phase step, no clock change."""
    fs, block = 48_000, 4_800
    if kind == "c4fm":
        sig = c4fm_iq(rng, fs, block)
        args = (jc.c4fm_demodulate, jc.c4fm_init, jc.C4fmConfig(), tc.c4fm_demodulate, tc.c4fm_init,
                tc.C4fmConfig())
    else:
        rs, alpha = (4800.0, 0.2) if kind == "cqpsk" else (6000.0, 1.0)
        sig = cqpsk_iq(rng, fs, block, rs, alpha, 0.0)
        args = (jq.cqpsk_demodulate, jq.cqpsk_init, jq.CqpskConfig(symbol_rate=rs, rrc_alpha=alpha),
                tq.cqpsk_demodulate, tq.cqpsk_init, tq.CqpskConfig(symbol_rate=rs, rrc_alpha=alpha))
    rows = np.concatenate([sig, np.zeros(2 * block, np.complex64)])[None]
    out = run_both(*args, rows, block)
    assert_blocks_match(out, f"dead air {kind}")
    before, after = out[1][5], out[2][5]
    sps_ = np.float32(args[5].sps)
    n_sym = out[2][2].shape[-1]
    pos = (np.float32(before.pos[0]) + np.float32(n_sym) * np.float32(after.freq[0])) - np.float32(block)
    pos = pos + sps_ if pos < 4.0 else pos
    pos = pos - sps_ if pos > np.float32(64.0 + float(sps_)) else pos
    assert float(after.pos[0]) == float(pos)
    assert float(after.integrator[0]) == float(before.integrator[0])


# --- the CFO search and the echo fit ------------------------------------------------------


def normalized_filt(rows: np.ndarray, cfg) -> np.ndarray:
    rrc = tq.design_rrc_cqpsk(float(cfg.sample_rate), cfg.symbol_rate, cfg.rrc_alpha)
    f = np.stack([np.convolve(r, rrc, mode="same") for r in rows])
    return (f / np.sqrt(np.mean(np.abs(f) ** 2, axis=-1, keepdims=True))).astype(np.complex64)


def test_estimate_cfo_residual_matches(rng):
    """The 4th-power line search (K13's plain version) on rows at -600, 0,
    +600 and +250 Hz and one of noise (where the reference, too, may find a
    line): the same residual, exactly."""
    cfo = (-600.0, 0.0, 600.0, 250.0)
    rows = [cqpsk_iq(rng, 48_000, 4_800, 4800.0, 0.2, f) for f in cfo]
    rows.append((rng.standard_normal(4_800) + 1j * rng.standard_normal(4_800)).astype(np.complex64))
    jcfg, tcfg = jq.CqpskConfig(), tq.CqpskConfig()
    filt = normalized_filt(np.stack(rows), tcfg)
    got = tq._estimate_cfo_residual(t(filt), tcfg).numpy()
    ref = np.array([float(jq._estimate_cfo_residual(jnp.asarray(r), jcfg)) for r in filt], np.float32)
    np.testing.assert_array_equal(got, ref)
    assert np.all(np.abs(got[:4] - np.array(cfo)) <= 2.0)


def echo_rows(rng) -> np.ndarray:
    """CQPSK matched-filter rows: an echo (4 samples, a 0.8, theta 2.98),
    a clean row, a weak echo (a 0.4, 9 samples)."""
    cfg = tq.CqpskConfig()
    clean = normalized_filt(np.stack([cqpsk_iq(rng, 48_000, 4_800, 4800.0, 0.2, 0.0) for _ in range(3)]), cfg)
    clean[0] = clean[0] + 0.8 * np.exp(2.98j) * np.roll(clean[0], 4)
    clean[2] = clean[2] + 0.4 * np.exp(-1.1j) * np.roll(clean[2], 9)
    return clean.astype(np.complex64)


def test_block_acf_and_fit_and_invert_match(rng):
    """K14's plain version: the block acf (rel. L2 <= 1e-5), and the fit
    with a carried acf on one row and the guard off on another: the same
    significance, acf and taps (rel. L2 <= 1e-4)."""
    x = echo_rows(rng)
    table = tq._eq_candidates(48_000.0, 4800.0, 0.2, 16)
    preds, params, n_tau = jq._eq_candidates(48_000.0, 4800.0, 0.2, 16)
    grid = teqz.grid_on(table, CPU)
    got = teqz.block_acf(t(x), n_tau).numpy()
    for r in range(3):
        assert rel_l2(np.asarray(jeqz.block_acf(jnp.asarray(x[r]), n_tau)), got[r]) <= 1e-5
    acc = np.zeros((3, n_tau + 1), np.complex64)
    acc[1] = got[2]
    enable = np.array([True, True, False])
    taps, acf, sig = teqz.fit_and_invert(t(x), t(acc), grid, 41, 0.01, enable=t(enable))
    for r in range(3):
        jt, ja, js = jeqz.fit_and_invert(jnp.asarray(x[r]), jnp.asarray(acc[r]), preds, params, n_tau,
                                         41, 0.01, enable=jnp.bool_(enable[r]))
        assert bool(js) == bool(sig[r]), r
        assert rel_l2(np.asarray(ja), acf[r].numpy()) <= 1e-5 if np.any(np.asarray(ja)) else not acf[r].any()
        assert rel_l2(np.asarray(jt), taps[r].numpy()) <= 1e-4, r
    assert bool(sig[0]) and not bool(sig[2])
    # the static early return on a block too small to fit
    small = teqz.fit_and_invert(t(x[:, :100]), t(acc), grid, 41, 0.01)
    assert not small[2].any() and torch.equal(small[1], t(acc))


def test_resolve_cfo_alias_matches(rng):
    """The alias resolution under a 70 us echo: from a guess off by -Rs/4,
    by +Rs/4 and right, both packages pick the same candidate."""
    fs, rs = 48_000, 4800.0
    iq = cqpsk_iq(rng, fs, 4_800, rs, 0.2, 1000.0, echo=True)
    rows = np.stack([iq, iq, iq])
    df = np.array([1000.0 - rs / 4, 1000.0 + rs / 4, 1000.0], np.float32)
    rrc = tq.design_rrc_cqpsk(float(fs), rs, 0.2)
    preds, _, n_tau = jq._eq_candidates(float(fs), rs, 0.2, 16)
    grid = teqz.grid_on(tq._eq_candidates(float(fs), rs, 0.2, 16), CPU)
    got = teqz.resolve_cfo_alias(t(rows), t(rrc), t(df), rs / 4.0, float(fs), grid).numpy()
    ref = [float(jeqz.resolve_cfo_alias(jnp.asarray(rows[r]), jnp.asarray(rrc), jnp.float32(df[r]),
                                        rs / 4.0, float(fs), preds, n_tau)) for r in range(3)]
    np.testing.assert_array_equal(got, np.array(ref, np.float32))
    assert got[2] == np.float32(1000.0)


@pytest.mark.parametrize("kind", ["c4fm", "lsm-cfo600", "phase2-6000", "lsm-equalizer-echo"])
def test_scan_timing_matches(rng, kind):
    """``timing_impl="scan"`` (K12s / K13s' plain versions) over 4
    consecutive 0.1 s blocks at 48 kHz against the reference's scan: C4FM,
    CQPSK at 4800 baud (+600 Hz CFO) and 6000 baud, and LSM behind a 70 us
    echo with the equalizer.  Dibits equal; soft >= 50 dB and the state
    within the file's bound (the serial loop feeds each symbol's error into
    the next position, so the mean's other summation order walks a little)."""
    fs, block = 48_000, 4_800
    if kind == "c4fm":
        rows = np.stack([c4fm_iq(rng, fs, 4 * block), c4fm_iq(rng, fs, 4 * block)])
        args = (jc.c4fm_demodulate, jc.c4fm_init, jc.C4fmConfig(timing_impl="scan"),
                tc.c4fm_demodulate, tc.c4fm_init, tc.C4fmConfig(timing_impl="scan"))
    else:
        rs, alpha, cfo, taps = {"lsm-cfo600": (4800.0, 0.2, 600.0, 0), "phase2-6000": (6000.0, 1.0, 0.0, 0),
                                "lsm-equalizer-echo": (4800.0, 0.2, 600.0, 41)}[kind]
        rows = np.stack([cqpsk_iq(rng, fs, 4 * block, rs, alpha, cfo, echo=taps > 0),
                         cqpsk_iq(rng, fs, 4 * block, rs, alpha, -300.0)])
        kw = dict(sample_rate=fs, symbol_rate=rs, rrc_alpha=alpha, equalizer_taps=taps, timing_impl="scan")
        args = (jq.cqpsk_demodulate, jq.cqpsk_init, jq.CqpskConfig(**kw),
                tq.cqpsk_demodulate, tq.cqpsk_init, tq.CqpskConfig(**kw))
    out = run_both(*args, rows, block)
    assert_blocks_match(out, f"scan {kind}")
    # the loop acquired: the last block's decisions are a clean constellation
    soft = out[-1][2]
    assert np.mean(np.abs(np.abs(soft) - np.round(np.abs(soft))) < 0.5) == 1.0
    if kind == "lsm-equalizer-echo":
        assert int(out[-1][5].eq_hits[0]) >= 2


@pytest.mark.parametrize("kind", ["c4fm", "cqpsk"])
def test_scan_timing_streams_like_the_reference(rng, kind):
    """The scan over odd block sizes (4,799 + 4,801 + 4,800) against one
    shot of the same 14,400 samples: where the reference's split stream
    agrees with its one-shot decisions, the port's does, symbol for
    symbol (both packages' split and one-shot dibits equal)."""
    fs, sizes = 48_000, (4_799, 4_801, 4_800)
    n = sum(sizes)
    if kind == "c4fm":
        x = c4fm_iq(rng, fs, n)
        jfn, jinit, jcfg = jc.c4fm_demodulate, jc.c4fm_init, jc.C4fmConfig(timing_impl="scan")
        tfn, tinit, tcfg = tc.c4fm_demodulate, tc.c4fm_init, tc.C4fmConfig(timing_impl="scan")
    else:
        x = cqpsk_iq(rng, fs, n, 4800.0, 0.2, 0.0)
        jfn, jinit, jcfg = jq.cqpsk_demodulate, jq.cqpsk_init, jq.CqpskConfig(timing_impl="scan")
        tfn, tinit, tcfg = tq.cqpsk_demodulate, tq.cqpsk_init, tq.CqpskConfig(timing_impl="scan")
    jst, tst, jd, td, at = jinit(jcfg), tinit(tcfg, device="cpu"), [], [], 0
    for size in sizes:
        _, d, jst = jfn(jnp.asarray(x[at:at + size]), jst, jcfg)
        jd.append(np.asarray(d))
        _, d, tst = tfn(t(x[at:at + size]), tst, tcfg)
        td.append(d.numpy())
        at += size
    j_split, t_split = np.concatenate(jd), np.concatenate(td)
    np.testing.assert_array_equal(t_split, j_split)
    j_one = np.asarray(jfn(jnp.asarray(x), jinit(jcfg), jcfg)[1])
    t_one = tfn(t(x), tinit(tcfg, device="cpu"), tcfg)[1].numpy()
    np.testing.assert_array_equal(t_one, j_one)
    k = min(len(j_one), len(j_split))
    assert np.mean(j_split[k // 3:k] == j_one[k // 3:k]) >= 0.99


def test_one_unbatched_row_matches_a_batch(rng):
    """``(n,)`` with unbatched state gives the batched row's output."""
    x = c4fm_iq(rng, 48_000, 4_800)
    cfg = tc.C4fmConfig()
    s1, d1, st1 = tc.c4fm_demodulate(t(x), tc.c4fm_init(cfg, device="cpu"), cfg)
    s2, d2, st2 = tc.c4fm_demodulate(t(x[None]), _stack_states(tc.c4fm_init(cfg, device="cpu"), 1), cfg)
    assert torch.equal(s1, s2[0]) and torch.equal(d1, d2[0])
    assert all(torch.equal(a, b[0]) for a, b in zip(st1, st2))


@pytest.mark.parametrize("name", ["c4fm_parity", "cqpsk_parity", "cqpsk_lsm_parity"])
def test_golden_parity_files(name):
    """The golden IQ of ``tests/golden`` in one block: the port's decisions
    equal the JAX package's, and meet the reference's floors
    (``tests/test_reference_parity.py``): C4FM >= 0.99 against the original
    demodulator's dibits, CQPSK (12000-baud Phase 2 and 4800-baud LSM)
    >= 0.99 against the transmitted ones."""
    d = np.load(GOLDEN / f"{name}.npz")
    fs = int(d["sample_rate"])
    if name == "c4fm_parity":
        jcfg, tcfg = jc.C4fmConfig(sample_rate=fs), tc.C4fmConfig(sample_rate=fs)
        jfn, tfn, tinit = jc.c4fm_demodulate, tc.c4fm_demodulate, tc.c4fm_init
        jinit = jc.c4fm_init
    else:
        kw = dict(sample_rate=fs, symbol_rate=float(d["symbol_rate"]), rrc_alpha=float(d["rrc_alpha"]))
        jcfg, tcfg = jq.CqpskConfig(**kw), tq.CqpskConfig(**kw)
        jfn, tfn, tinit, jinit = jq.cqpsk_demodulate, tq.cqpsk_demodulate, tq.cqpsk_init, jq.cqpsk_init
    _, mine, _ = tfn(t(d["iq"]), tinit(tcfg, device="cpu"), tcfg)
    _, ref, _ = jfn(jnp.asarray(d["iq"]), jinit(jcfg), jcfg)
    mine = mine.numpy().astype(np.int32)
    np.testing.assert_array_equal(mine, np.asarray(ref).astype(np.int32))
    if name == "c4fm_parity":
        agree, lag = _dibit_agreement(d["ref_dibits"].astype(np.int32), mine, max_lag=30, trim=24)
    else:
        agree, lag = _dibit_agreement(d["tx_dibits"].astype(np.int32), mine, max_lag=40, trim=64)
    assert agree >= 0.99, (name, agree, lag)
