"""Empty and short blocks through the port's stateful ops and demods, against the JAX package's, on the CPU.

Mirrors ``tests/test_empty_blocks.py``: a 0-sample block is a legal
no-op (output empty, carried state returned bitwise unchanged), and a
stream with an empty block between two others is bit-equal to the
stream without it.  The port's streams are also held against the
reference's on the same seeded input: audio >= 50 dB SNR, the floor of
``tests/test_torch_analog.py`` (f32 IIR scans of poles near 1, the AGC's
envelope and two libraries' atan2).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.models import analog as janalog
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.models import analog as tanalog
from tests.conftest import snr_db

torch.set_num_threads(1)

FS = 48_000.0
CPU = "cpu"


def bit_equal(a, b) -> bool:
    """Two state trees (torch or JAX leaves) hold the same bits."""
    la = jax.tree_util.tree_leaves(a)
    lb = jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb)
    )


def t_empty(dtype=torch.float32) -> torch.Tensor:
    return torch.zeros(0, dtype=dtype)


class TestEmptyOps:
    def test_fir_filter(self):
        taps = tops.design_lowpass_fir(64, 0.2)
        st = tops.fir_init(len(taps), torch.float32, device=CPU)
        y, st2 = tops.fir_filter(t_empty(), torch.from_numpy(taps), st)
        jy, _ = jops.fir_filter(jnp.zeros(0, jnp.float32), jnp.asarray(taps),
                                jops.fir_init(len(taps), jnp.float32))
        assert y.shape == jy.shape == (0,) and bit_equal(st, st2)

    def test_sos_filter(self):
        sos = tops.butter_sos("low", (3000.0,), 4, FS)
        st = tops.sos_init(len(sos), device=CPU)
        y, st2 = tops.sos_filter(t_empty(), sos, st)
        assert y.shape == (0,) and bit_equal(st, st2)

    def test_agc(self):
        st = tops.agc_init(device=CPU)
        y, st2 = tops.apply_agc(t_empty(), FS, st)
        assert y.shape == (0,) and bit_equal(st, st2)

    @pytest.mark.parametrize("in_rate,out_rate", [(160, 441), (96_000, 48_000), (240_000, 48_000)])
    def test_resampler(self, in_rate, out_rate):
        st = tops.resample_stream_init(in_rate, out_rate, device=CPU)
        y, st2 = tops.resample_poly_stream(t_empty(), in_rate, out_rate, st)
        jst = jops.resample_stream_init(in_rate, out_rate)
        jy, jst2 = jops.resample_poly_stream(jnp.zeros(0, jnp.float32), in_rate, out_rate, jst)
        assert y.shape[-1] == jy.shape[-1] == 0
        assert bit_equal(st, st2) and np.array_equal(np.asarray(jst2), st2.numpy())

    def test_freq_shift(self):
        y, ph = tops.freq_shift(t_empty(torch.complex64), 5e3, FS, torch.tensor(7, dtype=torch.uint32))
        assert y.shape == (0,) and int(ph) == 7

    def test_onepole(self):
        st = tops.onepole_init(device=CPU)
        y, st2 = tops.onepole_filter(t_empty(), 0.1, 0.9, st)
        assert y.shape == (0,) and bit_equal(st, st2)

    def test_quadrature_demod(self):
        st = tops.fm_discriminator_init(device=CPU)
        y, st2 = tops.quadrature_demod(t_empty(torch.complex64), FS, st)
        assert y.shape == (0,) and bit_equal(st, st2)

    def test_power_spectrum_short_and_empty(self):
        short = torch.ones(100, dtype=torch.complex64)
        assert tops.power_spectrum(short, 256).shape == (256,)
        assert tops.power_spectrum(t_empty(torch.complex64), 256).shape == (256,)

    @pytest.mark.parametrize("n", [0, 10, 40])
    def test_conv_valid_shorter_than_taps(self, n):
        """A row shorter than its 41 taps has no valid output."""
        x = np.zeros(n, np.float32)
        taps = np.ones(41, np.float32)
        y = tops.conv_valid(torch.from_numpy(x), torch.from_numpy(taps))
        jy = jops.conv_valid(jnp.asarray(x), jnp.asarray(taps))
        assert y.shape == jy.shape == (0,)

    def test_strided_fir_short_block_carries_tail(self):
        """K7's plain route with head + block shorter than the taps: no
        output, the tail is the last T-1 samples of head ++ block, the NCO
        phase advances over the block."""
        from wavecap_tpu_torch.ops import fir as tfir

        rng = np.random.default_rng(5)
        head = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
        x = torch.from_numpy(rng.standard_normal(0).astype(np.float32))
        y, tail, ph = tfir.strided_fir(x.expand(3, 0), torch.ones(41), 2, head=head)
        assert y.shape == (3, 0) and torch.equal(tail, head) and ph is None
        xc = torch.from_numpy((rng.standard_normal(5) + 1j * rng.standard_normal(5)).astype(np.complex64))
        dphi = torch.tensor([123456, 7], dtype=torch.uint32)
        p0 = torch.tensor([9, 10], dtype=torch.uint32)
        headc = torch.zeros((2, 3), dtype=torch.complex64)
        y, tail, ph = tfir.strided_fir(xc, torch.ones(41), 1, head=headc, nco=(dphi, p0))
        assert y.shape == (2, 0) and tail.shape == (2, 8)
        assert torch.equal(tail[:, :3], headc) and ph.tolist() == [9 + 5 * 123456, 10 + 5 * 7]


DEMODS = [
    ("wbfm", janalog.WbfmConfig, janalog.wbfm_init, janalog.wbfm_demod,
     tanalog.WbfmConfig, tanalog.wbfm_init, tanalog.wbfm_demod),
    ("nbfm", janalog.NbfmConfig, janalog.nbfm_init, janalog.nbfm_demod,
     tanalog.NbfmConfig, tanalog.nbfm_init, tanalog.nbfm_demod),
    ("am", janalog.AmConfig, janalog.am_init, janalog.am_demod,
     tanalog.AmConfig, tanalog.am_init, tanalog.am_demod),
    ("ssb", janalog.SsbConfig, janalog.ssb_init, janalog.ssb_demod,
     tanalog.SsbConfig, tanalog.ssb_init, tanalog.ssb_demod),
    ("sam", janalog.SamConfig, janalog.sam_init, janalog.sam_demod,
     tanalog.SamConfig, tanalog.sam_init, tanalog.sam_demod),
]
IDS = [d[0] for d in DEMODS]


class TestEmptyDemods:
    @pytest.mark.parametrize("demod", DEMODS, ids=IDS)
    def test_empty_block_is_identity(self, demod):
        name, jcfg_cls, jinit, jdemod, tcfg_cls, tinit, tdemod = demod
        cfg = tcfg_cls(sample_rate=96_000)
        st = tinit(cfg, device=CPU)
        audio, st2 = tdemod(t_empty(torch.complex64), st, cfg)[:2]
        jcfg = jcfg_cls(sample_rate=96_000)
        jaudio = jdemod(jnp.zeros(0, jnp.complex64), jinit(jcfg), jcfg)[0]
        assert audio.shape[-1] == jaudio.shape[-1] == 0, f"{name}: non-empty audio from empty IQ"
        assert bit_equal(st, st2), f"{name}: state mutated by empty block"

    @pytest.mark.parametrize("demod", DEMODS, ids=IDS)
    def test_empty_then_signal_matches_oneshot(self, demod):
        """An interleaved empty block does not perturb the stream, and the
        stream matches the reference's."""
        name, jcfg_cls, jinit, jdemod, tcfg_cls, tinit, tdemod = demod
        rng = np.random.default_rng(3)
        n = 9600
        iq = np.exp(1j * 0.3 * np.cumsum(rng.normal(size=n))).astype(np.complex64)
        cfg = tcfg_cls(sample_rate=96_000)

        def run(blocks):
            st = tinit(cfg, device=CPU)
            parts = []
            for blk in blocks:
                a, st = tdemod(torch.from_numpy(blk), st, cfg)[:2]
                parts.append(a.numpy())
            return np.concatenate(parts, axis=-1)

        plain = run([iq[:4800], iq[4800:]])
        with_empty = run([iq[:4800], iq[:0], iq[4800:]])
        assert with_empty.shape == plain.shape
        np.testing.assert_array_equal(with_empty, plain)

        jcfg = jcfg_cls(sample_rate=96_000)
        jst = jinit(jcfg)
        ref = []
        for blk in (iq[:4800], iq[4800:]):
            a, jst = jdemod(jnp.asarray(blk), jst, jcfg)[:2]
            ref.append(np.asarray(a))
        ref = np.concatenate(ref, axis=-1)
        assert ref.shape == plain.shape
        assert snr_db(ref, plain) >= 50.0, f"{name}: {snr_db(ref, plain):.1f} dB against the reference"


# --- the channelizer and the slot banks (K1-K4's wrappers) -------------------------

from wavecap_tpu import models as jmodels  # noqa: E402
from wavecap_tpu.models import channel_bank as jcb  # noqa: E402
from wavecap_tpu.ops import channelizer as jchz  # noqa: E402
from wavecap_tpu_torch import models as tmodels  # noqa: E402
from wavecap_tpu_torch.models import channel_bank as tcb  # noqa: E402
from wavecap_tpu_torch.ops import channelizer as tchz  # noqa: E402

BANK_FS = 1_000_000.0  # M = 80 bins of 12.5 kHz
BANKS = {
    "nbfm-iir": ("nbfm", "NbfmConfig", dict(enable_highpass=True, enable_lowpass=True)),
    "nbfm-fir": ("nbfm", "NbfmConfig", dict(enable_highpass=True, enable_lowpass=True, filter_impl="fir")),
    "am": ("am", "AmConfig", {}),
}
# four slots: (bin, fine offset Hz, active); slot 2 inactive
BANK_SLOTS = ((3, 0.0, True), (10, 700.0, True), (20, 0.0, False), (30, -300.0, True))


def bank_pair(name: str):
    mode, cls, opts = BANKS[name]
    kw = dict(sample_rate=25_000, audio_rate=25_000, **opts)
    jcfg = jcb.ChannelBankConfig(
        channelizer=jchz.ChannelizerConfig(sample_rate=BANK_FS, channel_bandwidth=12_500.0),
        mode=mode, demod_cfg=getattr(jmodels, cls)(**kw), capacity=len(BANK_SLOTS))
    tcfg = tcb.ChannelBankConfig(
        channelizer=tchz.ChannelizerConfig(sample_rate=BANK_FS, channel_bandwidth=12_500.0),
        mode=mode, demod_cfg=getattr(tmodels, cls)(**kw), capacity=len(BANK_SLOTS))
    cols = list(zip(*BANK_SLOTS))
    jas = jcb.ChannelAssignment(jnp.asarray(cols[0], jnp.int32), jnp.asarray(cols[1], jnp.float32),
                                jnp.asarray(cols[2], bool), jnp.full(len(BANK_SLOTS), -45.0, jnp.float32))
    tas = tcb.ChannelAssignment(*(torch.from_numpy(np.array(a)) for a in jas))
    return jcfg, tcfg, jas, tas


def bank_signal(n: int) -> np.ndarray:
    rng = np.random.default_rng(11)
    t = np.arange(n) / BANK_FS
    x = 0.1 * np.exp(2j * np.pi * (3 * 12_500.0 * t + 0.5 * np.sin(2 * np.pi * 1000.0 * t)))
    return (x + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


class TestEmptyBanks:
    def test_channelize(self):
        """A 0-sample block: channels (M, 0), the history bitwise unchanged."""
        jcfg, tcfg, _, _ = bank_pair("nbfm-iir")
        x = bank_signal(80 * 40)
        jst = jchz.channelize(jnp.asarray(x), jchz.channelizer_init(jcfg.channelizer), jcfg.channelizer)[1]
        tst = tchz.channelize(torch.from_numpy(x), tchz.channelizer_init(tcfg.channelizer, device=CPU),
                              tcfg.channelizer)[1]
        jch, jst2 = jchz.channelize(jnp.zeros(0, jnp.complex64), jst, jcfg.channelizer)
        tch, tst2 = tchz.channelize(t_empty(torch.complex64), tst, tcfg.channelizer)
        assert tuple(tch.shape) == jch.shape == (80, 0) and tch.dtype == torch.complex64
        assert bit_equal(tst, tst2) and np.array_equal(np.asarray(jst), np.asarray(jst2))

    @pytest.mark.parametrize("name", list(BANKS))
    def test_bank_step(self, name):
        """A 0-sample block through ``bank_step`` (the port's after a block of
        signal, the reference's from its initial state): audio (4, 0), RSSI
        NaN on the active slots (the mean power of no samples) and -200 on
        the inactive one, as the reference has them, and every carry
        (channelizer history, NCO phases, the demod's state) bitwise
        unchanged."""
        jcfg, tcfg, jas, tas = bank_pair(name)
        x = bank_signal(80 * 40)
        jst = jcb.bank_init(jcfg)
        tst = tcb.bank_step(torch.from_numpy(x), tcb.bank_init(tcfg, device=CPU), tas, tcfg)[1]
        jo, jst2 = jcb.bank_step(jnp.zeros(0, jnp.complex64), jst, jas, jcfg)
        to, tst2 = tcb.bank_step(t_empty(torch.complex64), tst, tas, tcfg)
        assert tuple(to["audio"].shape) == jo["audio"].shape == (len(BANK_SLOTS), 0)
        rssi = to["rssi"].numpy()
        np.testing.assert_array_equal(rssi, np.asarray(jo["rssi"]))  # NaN compared as equal
        assert np.isnan(rssi[[0, 1, 3]]).all() and rssi[2] == -200.0
        assert bit_equal(tst, tst2) and bit_equal(jst, jst2)
