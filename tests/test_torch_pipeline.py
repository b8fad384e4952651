"""The slice as a whole: the port's capture step against the JAX package's.

1 Msps / 12.5 kHz (M = 80), 8 NBFM slots with the voice-band FIR and the
fast discriminator, audio at the 25 kHz channel rate, i16 word transport,
3 blocks; then a stream handed from the JAX package to the port
mid-flight through ``convert.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu.capture import pipeline as jpipe
from wavecap_tpu_torch import convert
from wavecap_tpu_torch.capture import pipeline as tpipe
from wavecap_tpu_torch.capture.engine import pack_i16_words
from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
from tests.conftest import snr_db

torch.set_num_threads(1)

MODE = ("nbfm", (("filter_impl", "fir"), ("fast_discriminator", True)))
FS = 1_000_000
BLOCK = 80 * 200
CFG_KW = dict(sample_rate=FS, block_size=BLOCK, narrow_modes=(MODE,), narrow_capacity=8,
              channel_bandwidth=12_500.0, audio_rate=25_000, fft_size=2048, spectrum_frames=2)
# slot -> (bin, fine offset Hz, active, squelch dB)
SLOTS = [(3, 0.0, True, -45.0), (10, 700.0, True, -45.0), (73, -300.0, True, -45.0),
         (3, 0.0, True, 0.0), (20, 0.0, False, -45.0), (10, 700.0, True, -1e9),
         (30, 0.0, True, -45.0), (3, 0.0, False, -1e9)]
STATIONS = [(3, 0.0), (10, 700.0), (-7, -300.0)]


def blocks(n_blocks):
    stations = [FakeStation(offset_hz=b * FS / 80 + f, kind="nbfm", tone_hz=1000.0,
                            deviation_hz=4000.0, amplitude=0.1) for b, f in STATIONS]
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(sample_rate=FS))
    stream = dev.start_stream()
    return [stream.read(BLOCK)[0] for _ in range(n_blocks)]


def controls(jcfg, tcfg):
    cols = list(zip(*SLOTS))
    jctl = jpipe.control_init(jcfg)
    jbank = jctl.banks[MODE]._replace(
        channel_index=jnp.asarray(cols[0], jnp.int32),
        fine_offset_hz=jnp.asarray(cols[1], jnp.float32),
        active=jnp.asarray(cols[2], bool),
        squelch_db=jnp.asarray(cols[3], jnp.float32),
    )
    jctl = jctl._replace(banks={MODE: jbank})
    tctl = convert.capture_control_from_numpy(tcfg, jax.device_get(jctl), device="cpu")
    return jctl, tctl


def assert_outputs_match(jo, to, block_axis: bool):
    """spectrum |dB| <= 0.05 within 60 dB of the peak; rssi |dB| <= 1e-3;
    audio >= 70 dB per open slot; unpacked wire audio within 1 LSB."""
    ja, ta = np.asarray(jo["banks"][MODE]["audio"]), to["banks"][MODE]["audio"].numpy()
    jr, tr = np.asarray(jo["banks"][MODE]["rssi"]), to["banks"][MODE]["rssi"].numpy()
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-3)
    np.testing.assert_allclose(to["rssi"].numpy(), np.asarray(jo["rssi"]), rtol=0, atol=1e-3)
    js, ts = np.asarray(jo["spectrum"]), to["spectrum"].numpy()
    strong = js >= js.max() - 60.0
    assert float(np.max(np.abs(ts - js)[strong])) <= 0.05
    if not block_axis:
        ja, ta, jr = ja[None], ta[None], jr[None]
    n_open = 0
    for k in range(ja.shape[0]):
        for i in range(len(SLOTS)):
            if np.abs(ja[k, i]).max() > 0:
                assert snr_db(ja[k, i], ta[k, i]) >= 70.0, (k, i)
                n_open += 1
            else:
                assert not ta[k, i].any(), (k, i)
    assert n_open >= 4 * ja.shape[0]
    # the packed wire buffers, unpacked on the host, agree within 1 LSB
    jp, tp = np.asarray(jo["_packed"]), to["_packed"].numpy()
    assert jp.shape == tp.shape and tp.dtype == np.uint8
    if not block_axis:
        jp, tp = jp[None], tp[None]
    jmeta = {k: v for k, v in jo.items() if k != "_packed"}
    tmeta = {k: v for k, v in to.items() if k != "_packed"}
    if not block_axis:
        jmeta = jax.tree.map(lambda v: v[None], jmeta)
        tmeta = {"banks": {MODE: {k: v[None] for k, v in to["banks"][MODE].items()}},
                 "rssi": to["rssi"][None], "spectrum": to["spectrum"][None]}
    jw = jpipe.unpack_wire(jmeta, jp)
    tw = tpipe.unpack_wire(tmeta, tp)
    assert float(np.max(np.abs(tw["banks"][MODE]["audio"] - jw["banks"][MODE]["audio"]))) <= 1.0 / 32767 + 1e-7
    np.testing.assert_allclose(tw["banks"][MODE]["rssi"], jw["banks"][MODE]["rssi"], rtol=0, atol=1e-3)
    jsw = jw["spectrum"]
    strong_w = jsw >= jsw.max(axis=(-2, -1), keepdims=True) - 60.0
    assert float(np.max(np.abs(tw["spectrum"] - jsw)[strong_w])) <= 0.05


@pytest.fixture(scope="module")
def reference_run():
    """The JAX package's capture over 3 blocks of i16 words."""
    jcfg = jpipe.CapturePipelineConfig(**CFG_KW)
    tcfg = tpipe.CapturePipelineConfig(**CFG_KW)
    words = pack_i16_words(blocks(3))
    jctl, tctl = controls(jcfg, tcfg)
    jouts, jstate = jpipe.jit_capture_multi(jcfg, 3)(jnp.asarray(words), jpipe.pipeline_init(jcfg), jctl)
    return jcfg, tcfg, words, jctl, tctl, jouts, jstate


def test_capture_multi_matches(reference_run):
    jcfg, tcfg, words, jctl, tctl, jouts, jstate = reference_run
    touts, tstate = tpipe.capture_multi(
        torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg
    )
    assert_outputs_match(jouts, touts, block_axis=True)
    np.testing.assert_array_equal(tstate.chan_state.numpy(), np.asarray(jstate.chan_state))
    np.testing.assert_array_equal(
        tstate.banks[MODE].nco_phase.numpy(), np.asarray(jstate.banks[MODE].nco_phase)
    )


def test_capture_step_complex_input_matches(reference_run):
    """One step on complex64 input (the reference's ``capture_step``)."""
    jcfg, tcfg, words, jctl, tctl, _, _ = reference_run
    x = np.array(jpipe._to_complex(jnp.asarray(words[0])))
    jo, _ = jax.jit(lambda xx, s: jpipe.capture_step(xx, s, jctl, jcfg))(
        jnp.asarray(x), jpipe.pipeline_init(jcfg))
    to, _ = tpipe.capture_step(torch.from_numpy(x), tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg)
    assert_outputs_match(jo, to, block_axis=False)


def test_mid_stream_handover_through_convert(reference_run):
    """The JAX package runs blocks 1-2; its state moves to the port,
    which runs block 3 and matches the reference's block 3."""
    jcfg, tcfg, words, jctl, tctl, jouts, _ = reference_run
    _, jstate2 = jpipe.jit_capture_multi(jcfg, 2)(
        jnp.asarray(words[:2]), jpipe.pipeline_init(jcfg), jctl)
    tstate = convert.capture_state_from_numpy(tcfg, jax.device_get(jstate2), device="cpu")
    assert tstate.banks[MODE].nco_phase.dtype == torch.uint32
    assert tstate.banks[MODE].demod_states.hp_z.shape == (8, 126)
    to, _ = tpipe.capture_step(torch.from_numpy(words[2]), tstate, tctl, tcfg)
    jo3 = jax.tree.map(lambda v: v[2], jouts)
    assert_outputs_match(jo3, to, block_axis=False)


def test_audio_fetch_slots_raises():
    """The listener-selected audio fetch is the engine's (ROADMAP item 9):
    the port refuses the option and a reference control that carries it."""
    kw = {**CFG_KW, "audio_fetch_slots": 3}
    cfg = tpipe.CapturePipelineConfig(**kw)
    for entry in (tpipe.pipeline_init, tpipe.control_init):
        with pytest.raises(NotImplementedError, match="item 9"):
            entry(cfg, device="cpu")
    jctl = jax.device_get(jpipe.control_init(jpipe.CapturePipelineConfig(**kw)))
    assert jctl.audio_sel is not None
    with pytest.raises(NotImplementedError, match="item 9"):
        convert.capture_control_from_numpy(tpipe.CapturePipelineConfig(**CFG_KW), jctl, device="cpu")


@pytest.mark.parametrize("override,item", [
    (dict(wide_capacity=2, wide_groups=((),)), "item 7"),
    (dict(p25_capacity=2), "item 8"),
    (dict(p25p2_capacity=2), "item 8"),
])
def test_unported_banks_raise(override, item):
    cfg = tpipe.CapturePipelineConfig(**{**CFG_KW, **override})
    with pytest.raises(NotImplementedError, match=item):
        tpipe.pipeline_init(cfg, device="cpu")


def test_unported_transport_raises():
    with pytest.raises(NotImplementedError, match="i16"):
        tpipe._to_complex(torch.zeros(8, dtype=torch.int16))
