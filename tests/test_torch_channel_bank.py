"""The PyTorch port's channel bank against the JAX package's, on the CPU.

NBFM with the voice-band FIR and the fast discriminator, M = 80
(1 Msps / 12.5 kHz), 8 slots, 3 blocks: nonzero fine offsets, open and
shut squelch, inactive slots.  The K3/K4 wrappers take their plain
versions here (CPU tensors).  The other modes' banks are held against
the reference through the capture step (``test_torch_pipeline.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu import models as jmodels
from wavecap_tpu.models import channel_bank as jcb
from wavecap_tpu.ops.channelizer import ChannelizerConfig as JChannelizerConfig
from wavecap_tpu_torch import models as tmodels
from wavecap_tpu_torch.kernels import launch_counts
from wavecap_tpu_torch.models import channel_bank as tcb
from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig as TChannelizerConfig
from tests.conftest import snr_db

torch.set_num_threads(1)

FS = 1_000_000.0
BW = 12_500.0
DEMOD = dict(sample_rate=25_000, audio_rate=25_000, max_deviation_hz=4000.0,
             enable_highpass=True, enable_lowpass=True, filter_impl="fir",
             fast_discriminator=True)
# slot -> (bin, fine offset Hz, active, squelch dB)
SLOTS = [
    (3, 0.0, True, -45.0),      # station, open
    (10, 700.0, True, -45.0),   # station off-center by 700 Hz, open
    (73, -300.0, True, -45.0),  # station at a negative bin, open
    (3, 0.0, True, 0.0),        # station, squelch shut (threshold above it)
    (20, 0.0, False, -45.0),    # inactive
    (10, 700.0, True, -1e9),    # station, squelch wide open
    (30, 0.0, True, -45.0),     # empty bin, squelch shut by the noise floor
    (3, 0.0, False, -1e9),      # inactive on a station
]
STATIONS = [(3, 0.0), (10, 700.0), (-7, -300.0)]


def scene(rng, n):
    m = 80
    t = np.arange(n) / FS
    x = np.zeros(n, np.complex128)
    for b, fine in STATIONS:
        f0 = b * FS / m + fine
        x += 0.1 * np.exp(2j * np.pi * (f0 * t - 4000.0 * np.cos(2 * np.pi * 1000.0 * t) / (2 * np.pi * 1000.0)))
    x += 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return x.astype(np.complex64)


def configs():
    jcfg = jcb.ChannelBankConfig(
        channelizer=JChannelizerConfig(sample_rate=FS, channel_bandwidth=BW),
        mode="nbfm", demod_cfg=jmodels.NbfmConfig(**DEMOD), capacity=len(SLOTS),
    )
    tcfg = tcb.ChannelBankConfig(
        channelizer=TChannelizerConfig(sample_rate=FS, channel_bandwidth=BW),
        mode="nbfm", demod_cfg=tmodels.NbfmConfig(**DEMOD), capacity=len(SLOTS),
    )
    return jcfg, tcfg


def assignments():
    cols = list(zip(*SLOTS))
    j = jcb.ChannelAssignment(
        channel_index=jnp.asarray(cols[0], jnp.int32),
        fine_offset_hz=jnp.asarray(cols[1], jnp.float32),
        active=jnp.asarray(cols[2], bool),
        squelch_db=jnp.asarray(cols[3], jnp.float32),
    )
    tt = tcb.ChannelAssignment(*(torch.from_numpy(np.array(a)) for a in j))
    return j, tt


def test_bank_step_matches_over_blocks(rng):
    jcfg, tcfg = configs()
    jas, tas = assignments()
    m, block = 80, 80 * 200
    x = scene(rng, 3 * block)
    jstate = jcb.bank_init(jcfg)
    tstate = tcb.bank_init(tcfg, device="cpu")
    before = launch_counts()
    step = jax.jit(lambda xb, s: jcb.bank_step(xb, s, jas, jcfg))
    for k in range(3):
        xb = x[k * block:(k + 1) * block]
        jo, jstate = step(jnp.asarray(xb), jstate)
        to, tstate = tcb.bank_step(torch.from_numpy(xb), tstate, tas, tcfg)
        ra, ga = np.asarray(jo["audio"]), to["audio"].numpy()
        rr, gr = np.asarray(jo["rssi"]), to["rssi"].numpy()
        # RSSI: |dB| <= 1e-3 (mean power summed in another order)
        np.testing.assert_allclose(gr, rr, rtol=0, atol=1e-3)
        for i, (_, _, active, thr) in enumerate(SLOTS):
            if active and rr[i] >= thr:
                # audio after the FIR, normalize and clip: >= 70 dB per open slot
                assert snr_db(ra[i], ga[i]) >= 70.0, (k, i)
                assert np.abs(ga[i]).max() > 0.1
            else:
                assert not ga[i].any() and not ra[i].any(), (k, i)
        assert gr[4] == -200.0 and gr[7] == -200.0
        # NCO accumulators: bit-exact
        np.testing.assert_array_equal(tstate.nco_phase.numpy(), np.asarray(jstate.nco_phase))
        np.testing.assert_array_equal(tstate.chan_state.numpy(), np.asarray(jstate.chan_state))
        np.testing.assert_allclose(
            tstate.demod_states.disc_prev.numpy(), np.asarray(jstate.demod_states.disc_prev),
            rtol=0, atol=1e-6,  # the last mixed sample: a few ulp
        )
        np.testing.assert_allclose(
            tstate.demod_states.hp_z.numpy(), np.asarray(jstate.demod_states.hp_z),
            rtol=0, atol=1e-4,  # the last 126 discriminator samples (|x| <= ~1.3)
        )
    assert launch_counts() == before  # CPU tensors never reach a kernel


def test_nbfm_demod_matches(rng):
    """The per-channel model function (batched over channels)."""
    jcfg, tcfg = configs()
    n, fs = 6000, 25_000
    tt = np.arange(n) / fs
    x = np.stack([
        0.5 * np.exp(2j * np.pi * (f0 * tt - 3000.0 * np.cos(2 * np.pi * 800.0 * tt) / (2 * np.pi * 800.0)))
        for f0 in (0.0, 1500.0)
    ]).astype(np.complex64)
    tstate = tmodels.nbfm_init(tcfg.demod_cfg, device="cpu")
    tstate = tcb._stack_states(tstate, 2)
    got, _ = tmodels.nbfm_demod(torch.from_numpy(x), tstate, tcfg.demod_cfg)
    for i in range(2):
        ref, _ = jmodels.nbfm_demod(jnp.asarray(x[i]), jmodels.nbfm_init(jcfg.demod_cfg), jcfg.demod_cfg)
        assert snr_db(np.asarray(ref), got[i].numpy()) >= 70.0


@pytest.mark.parametrize("override,kernel", [
    (dict(filter_impl="iir"), "K9"),
    (dict(enable_deemphasis=True), "K9"),
    (dict(notch_frequencies=(1000.0,)), "K9"),
    (dict(enable_noise_blanker=True), "K11"),
    (dict(audio_rate=48_000), "K5"),
])
def test_unported_nbfm_options_raise(override, kernel):
    """The NBFM options the first slice refused: those of K9 (IIR filters,
    deemphasis, notches), K5 (48 kHz audio) and K11 (the noise blanker)
    now run and match the reference (>= 50 dB, two f32 IIR scans)."""
    cfg = tmodels.NbfmConfig(**{**DEMOD, **override})
    jcfg = jmodels.NbfmConfig(**{**DEMOD, **override})
    n, fs = 5000, 25_000
    tt = np.arange(n) / fs
    x = (0.5 * np.exp(2j * np.pi * (300.0 * tt - 3000.0 * np.cos(2 * np.pi * 800.0 * tt)
                                    / (2 * np.pi * 800.0)))).astype(np.complex64)
    got, _ = tmodels.nbfm_demod(torch.from_numpy(x), tmodels.nbfm_init(cfg, device="cpu"), cfg)
    ref, _ = jmodels.nbfm_demod(jnp.asarray(x), jmodels.nbfm_init(jcfg), jcfg)
    assert got.shape == ref.shape
    assert snr_db(np.asarray(ref), got.numpy()) >= 50.0


def test_unported_modes_raise():
    """Every mode of the reference's registry is ported (the six analog
    modes and the two P25 soft-symbol modes); a mode neither knows raises."""
    from wavecap_tpu.models.registry import REGISTRY as JAX_REGISTRY
    from wavecap_tpu_torch.models.registry import REGISTRY, get_demod

    assert set(REGISTRY) == set(JAX_REGISTRY) == {"wbfm", "nbfm", "am", "sam", "usb", "lsb",
                                                  "p25-soft", "p25-cqpsk-soft"}
    with pytest.raises(ValueError):
        get_demod("nonsense")
