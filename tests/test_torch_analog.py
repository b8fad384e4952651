"""The port's analog demodulators, PLLs and AGC against the JAX package's, on the CPU.

Every mode runs batched over rows (the bank's layout) for 3 blocks with
its state carried, against the reference per row.  Floors, each with its
reason: audio >= 50 dB SNR (two f32 IIR scans of poles near 1, the AGC's
envelope and the exact atan2 of two libraries); coherent PLL output
>= 50 dB with the final phase within 1e-3 rad (the loop's cos, sin and
atan2 from two libraries); the golden files at the reference tests' own
bound, correlation > 0.95 (``tests/test_reference_parity.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu import models as jmodels
from wavecap_tpu import ops as jops
from wavecap_tpu.ops import pll as jpll
from wavecap_tpu_torch import models as tmodels
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.models.channel_bank import _stack_states
from wavecap_tpu_torch.ops import pll as tpll
from tests.conftest import snr_db
from tests.test_reference_parity import best_lag_metrics

torch.set_num_threads(1)

GOLDEN = Path(__file__).parent / "golden"
RATE = 25_000


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def station(kind: str, n: int, fs: float, k0: int, carrier: float = 0.0, amp: float = 0.3):
    """One row of a 1 kHz-tone station at high SNR, from sample ``k0``."""
    tt = (k0 + np.arange(n)) / fs
    if kind == "fm":
        dev = 4000.0 if fs < 100_000 else 75_000.0
        x = np.exp(2j * np.pi * (carrier * tt - dev * np.cos(2 * np.pi * 1000.0 * tt) / (2 * np.pi * 1000.0)))
    elif kind == "am":
        x = (1.0 + 0.6 * np.sin(2 * np.pi * 1000.0 * tt)) * np.exp(2j * np.pi * carrier * tt)
    else:  # a plain carrier: SSB detects it as a tone
        x = np.exp(2j * np.pi * carrier * tt)
    return amp * x


# mode -> (station kind, per-row carrier offsets Hz, input rate, config overrides)
MODES = {
    "nbfm": ("fm", (0.0, 700.0), RATE, dict(enable_highpass=True, enable_lowpass=True)),
    "nbfm-deemph-notch": ("fm", (0.0, -300.0), RATE,
                          dict(enable_deemphasis=True, notch_frequencies=(2000.0, 60.0))),
    "nbfm-fir": ("fm", (0.0, 500.0), RATE,
                 dict(filter_impl="fir", enable_highpass=True, enable_lowpass=True)),
    "am": ("am", (0.0, 200.0), RATE, {}),
    "sam": ("am", (30.0, -20.0), RATE, {}),
    "usb": ("carrier", (-500.0, -700.0), RATE, {}),
    "lsb": ("carrier", (500.0, 900.0), RATE, {}),
    "wbfm": ("fm", (0.0, 5000.0), 240_000, {}),
}


def mode_pair(name: str, fs: int):
    mode = name.split("-")[0]
    kw = MODES[name][3]
    tcfg = tmodels.make_config(mode, fs, **kw)  # usb/lsb take their mode by default
    jcfg = jmodels.make_config(mode, fs, **kw)
    assert tcfg.__dict__ == jcfg.__dict__
    return jmodels.get_demod(mode), jcfg, tmodels.get_demod(mode), tcfg


@pytest.mark.parametrize("n", [500, 506])
@pytest.mark.parametrize("name", sorted(MODES))
def test_demod_matches_reference_over_blocks(name, n):
    """n = 500 at 25 kHz streams the 48/25 resampler, 506 takes its
    one-shot fallback (the wide rate's 1/5 streams at 5 x n)."""
    kind, carriers, fs, _ = MODES[name]
    if fs != RATE:
        n *= 5
    jspec, jcfg, tspec, tcfg = mode_pair(name, fs)
    rows = len(carriers)
    tstate = _stack_states(tspec.init(tcfg, device="cpu"), rows)
    jstates = [jspec.init(jcfg)] * rows
    demod = jax.jit(lambda x, s: jspec.demod(x, s, jcfg))
    for k in range(3):
        x = np.stack([station(kind, n, fs, k * n, c) for c in carriers]).astype(np.complex64)
        got, tstate = tspec.demod(t(x), tstate, tcfg)
        for i in range(rows):
            ref, jstates[i] = demod(jnp.asarray(x[i]), jstates[i])
            assert got.shape[-1] == ref.shape[-1]
            assert snr_db(np.asarray(ref), got[i].numpy()) >= 50.0, (k, i)
    ref_leaves = jax.tree.leaves(jax.device_get(jstates[-1]))
    got_leaves = [v[-1] for v in jax.tree.leaves(tstate, is_leaf=lambda v: isinstance(v, torch.Tensor))]
    assert [np.shape(v) for v in ref_leaves] == [tuple(v.shape) for v in got_leaves]


def test_ssb_bfo_phase_is_bit_exact():
    """The BFO's tuning word takes the exact host branch; its carried
    phase equals the reference's after every block."""
    _, jcfg, tspec, tcfg = mode_pair("usb", RATE)
    x = np.ones((1, 777), np.complex64)
    tstate = _stack_states(tspec.init(tcfg, device="cpu"), 1)
    jstate = jmodels.ssb_init(jcfg)
    for _ in range(3):
        _, tstate = tspec.demod(t(x), tstate, tcfg)
        _, jstate = jmodels.ssb_demod(jnp.asarray(x[0]), jstate, jcfg)
        assert int(tstate.nco_phase[0]) == int(jstate.nco_phase)
    assert int(tops.tuning_word(1500.0, RATE, device="cpu")) == int(jops.tuning_word(1500.0, RATE))


@pytest.mark.parametrize("detector", ["pll", "costas"])
def test_pll_and_costas_match_reference(rng, detector):
    fs, n = 25_000.0, 2000
    tt = np.arange(n) / fs
    if detector == "pll":
        rows = [0.5 * (1 + 0.5 * np.sin(2 * np.pi * 700 * tt)) * np.exp(1j * (2 * np.pi * f * tt + 0.4))
                for f in (20.0, -35.0)]
    else:
        sym = rng.integers(0, 4, (2, n // 10)).repeat(10, axis=1)
        rows = [np.exp(1j * (np.pi / 4 + np.pi / 2 * sym[i] + 2 * np.pi * f * tt + 0.2))
                for i, f in enumerate((15.0, -10.0))]
    x = np.stack(rows).astype(np.complex64)
    alpha, beta = tpll.pll_coeffs(50.0, fs)
    state = tpll.PllState(torch.tensor([0.1, -3.1]), torch.tensor([0.0, 0.001]))
    parts = []
    for a, b in [(0, 777), (777, n)]:  # the state carried across an odd split
        if detector == "pll":
            y, state = tpll.carrier_recovery_pll(t(x[:, a:b]), fs, state)
        else:
            y, state = tpll.costas_loop_qpsk(t(x[:, a:b]), state, alpha, beta)
        parts.append(y.numpy())
    got = np.concatenate(parts, axis=-1)
    for i in range(2):
        s0 = jpll.PllState(jnp.float32([0.1, -3.1][i]), jnp.float32([0.0, 0.001][i]))
        if detector == "pll":
            ref, rs = jpll.carrier_recovery_pll(jnp.asarray(x[i]), fs, s0)
        else:
            ref, rs = jpll.costas_loop_qpsk(jnp.asarray(x[i]), s0, alpha, beta)
        ref = np.asarray(ref)
        assert snr_db(ref.real, got[i].real) >= 50 and snr_db(ref.imag, got[i].imag) >= 50
        d_phase = np.angle(np.exp(1j * (float(rs.phase) - float(state.phase[i]))))
        assert abs(d_phase) <= 1e-3
        assert abs(float(rs.freq) - float(state.freq[i])) <= 1e-4
    # an empty block carries the state through, as the reference's scan does
    empty = t(x[:, :0])
    if detector == "pll":
        y0, s0 = tpll.carrier_recovery_pll(empty, fs, state)
    else:
        y0, s0 = tpll.costas_loop_qpsk(empty, state, alpha, beta)
    assert y0.shape == (2, 0)
    assert torch.equal(s0.phase, state.phase) and torch.equal(s0.freq, state.freq)


def test_agc_matches_reference_over_blocks(rng):
    fs = 48_000.0
    x = (rng.standard_normal((2, 3, 1500)) * np.array([[[0.01]], [[0.5]]])).astype(np.float32)
    state = tops.AgcState(torch.zeros(2), torch.zeros(2))
    jstates = [jops.agc_init()] * 2
    for k in range(3):
        got, state = tops.apply_agc(t(x[:, k]), fs, state)
        for i in range(2):
            ref, jstates[i] = jops.apply_agc(jnp.asarray(x[i, k]), fs, jstates[i])
            assert snr_db(np.asarray(ref), got[i].numpy()) >= 50
            assert abs(float(jstates[i].env_release) - float(state.env_release[i])) <= 1e-5
    ref = np.asarray(jops.simple_agc(jnp.asarray(x[0, 0])))
    assert snr_db(ref, tops.simple_agc(t(x[0, 0])).numpy()) >= 50


@pytest.mark.parametrize("name", ["wbfm", "nbfm", "am"])
def test_golden_parity(name):
    """The port's demod against the original's audio in ``tests/golden``,
    at the reference tests' own bound and settings."""
    d = np.load(GOLDEN / f"{name}_parity.npz")
    fs, ar = int(d["sample_rate"]), int(d["audio_rate"])
    kw = dict(enable_agc=False) if name == "am" else {}
    cfg = tmodels.make_config(name, fs, audio_rate=ar, **kw)
    spec = tmodels.get_demod(name)
    audio, _ = spec.demod(t(d["iq"]), spec.init(cfg, device="cpu"), cfg)
    audio = audio.numpy()
    ref = d["ref_audio"]
    n = min(len(audio), len(ref))
    a, r = audio[4000:n - 4000], ref[4000:n - 4000]
    corr, lag = best_lag_metrics(r - r.mean(), a - a.mean(), max_lag=400)
    assert corr > 0.95, f"{name} corr {corr:.4f} @ lag {lag}"


def impulsive_station(kind: str, n: int, fs: float, k0: int, carrier: float) -> np.ndarray:
    """``station`` plus a train of strong impulses, 1-3 samples wide, that
    the noise blanker must take out (fixed positions in the stream)."""
    x = station(kind, n, fs, k0, carrier)
    pos = k0 + np.arange(n)
    hit = (pos % 173 < 1 + (pos // 173) % 3)
    return x + hit * (3.0 + 2.0j)


# mode -> its noise options (the reference's fields: AM, SSB and SAM have
# the blanker only)
NOISE_OPTIONS = {
    "nbfm": dict(enable_noise_blanker=True, enable_noise_reduction=True),
    "wbfm": dict(enable_noise_blanker=True, enable_noise_reduction=True),
    "am": dict(enable_noise_blanker=True),
    "sam": dict(enable_noise_blanker=True),
    "usb": dict(enable_noise_blanker=True),
    "lsb": dict(enable_noise_blanker=True),
}


def assert_noise_mode_matches(mode: str, opts: dict, n: int = 1100):
    """3 blocks through both packages with ``opts`` set: >= 50 dB per row
    (the floor of the modes with IIR scans); n = 1,100 at 25 kHz gives
    2,112 audio samples a block, two noise-reduction frames."""
    kind, carriers, fs, kw = MODES[mode]
    mode = mode.split("-")[0]
    if fs != RATE:
        n *= 5
    kw = {**kw, **opts}
    tcfg = tmodels.make_config(mode, fs, **kw)
    jcfg = jmodels.make_config(mode, fs, **kw)
    assert tcfg.__dict__ == jcfg.__dict__
    jspec, tspec = jmodels.get_demod(mode), tmodels.get_demod(mode)
    rows = len(carriers)
    tstate = _stack_states(tspec.init(tcfg, device="cpu"), rows)
    jstates = [jspec.init(jcfg)] * rows
    demod = jax.jit(lambda x, s: jspec.demod(x, s, jcfg))
    for k in range(3):
        x = np.stack([impulsive_station(kind, n, fs, k * n, c) for c in carriers]).astype(np.complex64)
        got, tstate = tspec.demod(t(x), tstate, tcfg)
        for i in range(rows):
            ref, jstates[i] = demod(jnp.asarray(x[i]), jstates[i])
            assert got.shape[-1] == ref.shape[-1]
            assert snr_db(np.asarray(ref), got[i].numpy()) >= 50.0, (k, i)


@pytest.mark.parametrize("mode", ["wbfm", "nbfm", "am", "sam", "usb", "lsb"])
def test_noise_options_raise_naming_k11(mode):
    """The noise options (K11) no longer raise: every mode with all of its
    options on matches the reference over 3 blocks of impulsive input."""
    assert_noise_mode_matches(mode, NOISE_OPTIONS[mode])


@pytest.mark.parametrize("mode,option", [
    ("nbfm", "enable_noise_blanker"), ("nbfm-fir", "enable_noise_reduction"),
    ("wbfm", "enable_noise_blanker"), ("wbfm", "enable_noise_reduction"),
])
def test_single_noise_option_matches(mode, option):
    """The blanker and the noise reduction of the FM modes one at a time,
    with a threshold and a reduction other than the defaults.  NBFM's noise
    reduction alone runs behind the voice FIR: behind the IIR filters its
    input already differs from the reference's by 55-60 dB (two f32 scans),
    and its gain, clamped at 0.1 where ``|X|`` is near the floor, amplifies
    that ~18x in those bins (37 dB on this impulsive scene); the FIR gives
    it equal input (100 dB out)."""
    extra = ({"noise_blanker_threshold_db": 6.0} if option == "enable_noise_blanker"
             else {"noise_reduction_db": 6.0})
    assert_noise_mode_matches(mode, {option: True, **extra})


def test_blanker_takes_the_impulses_out():
    """The AM envelope of an impulsive station: the blanked audio is
    closer to the clean station's than the unblanked one."""
    cfg_nb = tmodels.make_config("am", RATE, enable_noise_blanker=True, enable_agc=False)
    cfg = tmodels.make_config("am", RATE, enable_agc=False)
    spec = tmodels.get_demod("am")
    clean = t(station("am", 2000, RATE, 0)[None].astype(np.complex64))
    dirty = t(impulsive_station("am", 2000, RATE, 0, 0.0)[None].astype(np.complex64))
    ref, _ = spec.demod(clean, spec.init(cfg, device="cpu"), cfg)
    nb, _ = spec.demod(dirty, spec.init(cfg_nb, device="cpu"), cfg_nb)
    raw, _ = spec.demod(dirty, spec.init(cfg, device="cpu"), cfg)
    assert snr_db(ref.numpy()[0], nb.numpy()[0]) > snr_db(ref.numpy()[0], raw.numpy()[0]) + 6.0
