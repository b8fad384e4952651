"""The slices as a whole: the port's capture step against the JAX package's.

1 Msps / 12.5 kHz (M = 80), i16 word transport, 3 blocks, then a stream
handed from the JAX package to the port mid-flight through
``convert.py``, for two configurations:

* 8 NBFM slots with the voice-band FIR and the fast discriminator, audio
  at the 25 kHz channel rate (the first slice);
* the mixed-analog capture at the server's default channel settings:
  five banks of 4 slots (``am``, ``lsb``, ``nbfm``, ``sam``, ``usb`` at
  their config defaults), one WBFM group of 2 wide slots with the wide
  baseband exported, 48 kHz audio.  Blocks of 20,000 samples stream every
  resampler; blocks of 20,240 send both the narrow (48/25) and the wide
  (24/125) resampler to the reference's one-shot fallback;
* the three P25 programs at small width (1.2 Msps, 25 kHz bins), with
  the block timing and with the scan timing (``WAVECAP_P25_TIMING=scan``): C4FM
  beside an NBFM bank, LSM with the simulcast equalizer, and Phase 2's
  dual-rate capture (see the P25 section below).
"""

import numpy as np
import pytest
import torch
from scipy import signal as sps

import jax
import jax.numpy as jnp

from wavecap_tpu.capture import pipeline as jpipe
from wavecap_tpu_torch import convert
from wavecap_tpu_torch.capture import pipeline as tpipe
from wavecap_tpu_torch.capture.engine import pack_i16_words, pack_i4_words, pack_i8_words
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
    """The listener-selected audio fetch (the engine's ``audio_fetch_slots``)
    no longer raises: with 2 fetch slots of 8, the reference's control
    (its ``audio_sel``) moves to the port through ``convert.py`` and the
    gated audio rows, rssi and wire match the reference over 3 blocks."""
    kw = {**CFG_KW, "audio_fetch_slots": 2}
    jcfg, tcfg = jpipe.CapturePipelineConfig(**kw), tpipe.CapturePipelineConfig(**kw)
    for entry in (tpipe.pipeline_init, tpipe.control_init):
        entry(tcfg, device="cpu")
    assert tpipe.control_init(tcfg, device="cpu").audio_sel[MODE].dtype == torch.int32
    jctl, _ = controls(jcfg, tcfg)
    jctl = jctl._replace(audio_sel={MODE: jnp.asarray([1, 2], jnp.int32)})
    tctl = convert.capture_control_from_numpy(tcfg, jax.device_get(jctl), device="cpu")
    np.testing.assert_array_equal(tctl.audio_sel[MODE].numpy(), [1, 2])
    words = pack_i16_words(blocks(3))
    jo, _ = jpipe.jit_capture_multi(jcfg, 3)(jnp.asarray(words), jpipe.pipeline_init(jcfg), jctl)
    to, _ = tpipe.capture_multi(torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg)
    ja, ta = np.asarray(jo["banks"][MODE]["audio"]), to["banks"][MODE]["audio"].numpy()
    assert ja.shape == ta.shape == (3, 2, 2 * BLOCK // 80)
    for k in range(3):
        for i in range(2):
            assert snr_db(ja[k, i], ta[k, i]) >= 70.0, (k, i)
    np.testing.assert_allclose(to["banks"][MODE]["rssi"].numpy(), np.asarray(jo["banks"][MODE]["rssi"]),
                               rtol=0, atol=1e-3)
    assert to["_packed"].shape == tuple(np.asarray(jo["_packed"]).shape)
    # the gated rows are the selected slots' rows of the ungated program
    full, _ = tpipe.capture_multi(torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"),
                                  tctl._replace(audio_sel=None), tcfg)
    np.testing.assert_array_equal(ta, full["banks"][MODE]["audio"].numpy()[:, [1, 2]])


@pytest.mark.parametrize("override,item", [
    # the wide slots run, and a group with the noise blanker and the noise
    # reduction (K11) runs too
    (dict(wide_capacity=2, wide_groups=((("enable_noise_blanker", True),
                                         ("enable_noise_reduction", True)),)), "item 7"),
])
def test_unported_banks_raise(override, item):
    """No bank of the reference raises any more (this case was ``item``'s):
    the wide group with both noise options matches the reference over 3
    blocks (>= 50 dB, the IIR floor)."""
    kw = {**CFG_KW, **override, "block_size": 20_000}
    jcfg, tcfg = jpipe.CapturePipelineConfig(**kw), tpipe.CapturePipelineConfig(**kw)
    g = tcfg.wide_groups[0]
    jctl = jpipe.control_init(jcfg)
    jctl = jctl._replace(wide={g: jctl.wide[g]._replace(
        offset_hz=jnp.asarray(WIDE_OFFSETS, jnp.float32), active=jnp.asarray([True, True]))})
    tctl = convert.capture_control_from_numpy(tcfg, jax.device_get(jctl), device="cpu")
    words = pack_i16_words(mixed_blocks(20_000, 3))
    jo, _ = jpipe.jit_capture_multi(jcfg, 3)(jnp.asarray(words), jpipe.pipeline_init(jcfg), jctl)
    to, _ = tpipe.capture_multi(torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg)
    ja, ta = np.asarray(jo["wide"][g]["audio"]), to["wide"][g]["audio"].numpy()
    assert ja.shape == ta.shape
    for k in range(3):
        assert snr_db(ja[k, 0], ta[k, 0]) >= 50.0, k  # the WBFM station
        assert snr_db(ja[k, 1], ta[k, 1]) >= 50.0, k  # noise, the squelch open


def _reference_words(transport: str, blocks_):
    """The reference engine's host conversion of ``blocks_``: its batch,
    caught at the step."""
    from wavecap_tpu import capture as jcapture
    from wavecap_tpu.devices import FakeDriver as JFakeDriver

    cap = jcapture.Capture(JFakeDriver(1).open("fake0"), jcapture.CaptureConfig(
        sample_rate=FS, channel_bandwidth=12_500.0, adaptive_transport=False,
        narrow_capacity=1, wide_capacity=0))
    cap.block_size = len(blocks_[0])
    seen = []

    class Stop(Exception):
        pass

    def step(batch, state, ctl):
        seen.append(jax.tree_util.tree_map(np.asarray, batch))
        raise Stop

    cap._jit_step, cap._pipe_cfg, cap._ctl = step, object(), object()
    cap._ctl_dirty, cap.transport_active = False, transport
    with pytest.raises(Stop):
        cap._dispatch_blocks(list(blocks_))
    return seen[0]


@pytest.mark.parametrize("transport", ["i8", "i4"])
def test_unported_transport_raises(transport):
    """The adaptive i8 and i4 transports no longer raise: the port's host
    conversion gives the reference engine's words and scales bit for bit,
    and ``_to_complex`` unpacks them bit-equal to the reference's."""
    bl = blocks(2)
    jwords, jscales = _reference_words(transport, bl)
    pack = pack_i8_words if transport == "i8" else pack_i4_words
    words, scales = pack(bl)
    assert words.dtype == (np.int16 if transport == "i8" else np.int8)
    np.testing.assert_array_equal(words, jwords)
    np.testing.assert_array_equal(scales, jscales)
    for k in range(2):
        ref = np.asarray(jax.jit(jpipe._to_complex)(jnp.asarray(words[k]), jnp.asarray(scales[k])))
        got = tpipe._to_complex(torch.from_numpy(words[k]), torch.from_numpy(scales[k:k + 1])[0]).numpy()
        np.testing.assert_array_equal(got, ref)
    # every word value: the sign extension of both halves
    every = np.arange(-2**15, 2**15, dtype=np.int16) if transport == "i8" else np.arange(-128, 128, dtype=np.int8)
    s = np.float32(0.37)
    ref = np.asarray(jax.jit(jpipe._to_complex)(jnp.asarray(every), jnp.asarray(s)))
    got = tpipe._to_complex(torch.from_numpy(every), torch.tensor(s)).numpy()
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="scale"):
        tpipe._to_complex(torch.from_numpy(every))


# --- the mixed-analog capture ---------------------------------------------------

MIXED_MODES = ("am", "lsb", "nbfm", "sam", "usb")
# bank -> (station bin, station kind, carrier offset from the bin centre Hz):
# every detector hears a 1 kHz tone
MIXED_STATIONS = {"nbfm": (3, "nbfm", 0.0), "am": (10, "am", 0.0), "sam": (20, "am", 0.0),
                  "usb": (30, "carrier", -500.0), "lsb": (-30, "carrier", 500.0)}
EMPTY_BIN = 37
WIDE_OFFSETS = (-250_000.0, 120_000.0)  # a WBFM station; the band near the AM stations


def mixed_kw(block: int) -> dict:
    return dict(sample_rate=FS, block_size=block, narrow_modes=MIXED_MODES, narrow_capacity=4,
                channel_bandwidth=12_500.0, wide_capacity=2, wide_groups=((),),
                export_wide_baseband=True, fft_size=2048, spectrum_frames=2)


def mixed_blocks(block: int, n_blocks: int):
    stations = [FakeStation(offset_hz=b * FS / 80 + f, kind=k, tone_hz=1000.0, deviation_hz=4000.0,
                            amplitude=0.1) for b, k, f in MIXED_STATIONS.values()]
    stations.append(FakeStation(offset_hz=WIDE_OFFSETS[0], kind="wbfm", tone_hz=1000.0,
                                deviation_hz=75_000.0, amplitude=0.1))
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(sample_rate=FS))
    stream = dev.start_stream()
    return [stream.read(block)[0] for _ in range(n_blocks)]


def mixed_controls(jcfg, tcfg):
    """Per bank: the station (open), an empty bin (shut by the squelch),
    the station 150 Hz off its centre with the squelch open, an inactive
    slot; the wide slots on the WBFM station and elsewhere."""
    jctl = jpipe.control_init(jcfg)
    banks = {}
    for mode in MIXED_MODES:
        b = MIXED_STATIONS[mode][0] % 80
        banks[mode] = jctl.banks[mode]._replace(
            channel_index=jnp.asarray([b, EMPTY_BIN, b, 60], jnp.int32),
            fine_offset_hz=jnp.asarray([0.0, 0.0, 150.0, 0.0], jnp.float32),
            active=jnp.asarray([True, True, True, False]),
            squelch_db=jnp.asarray([-45.0, -45.0, -1e9, -1e9], jnp.float32),
        )
    wide = {(): jctl.wide[()]._replace(
        offset_hz=jnp.asarray(WIDE_OFFSETS, jnp.float32), active=jnp.asarray([True, True]),
        squelch_db=jnp.asarray([-45.0, -1e9], jnp.float32))}
    jctl = jctl._replace(banks=banks, wide=wide)
    return jctl, convert.capture_control_from_numpy(tcfg, jax.device_get(jctl), device="cpu")


def assert_mixed_match(jo, to):
    """One block: audio >= 50 dB per open slot (IIR scans, AGC and PLL in
    two libraries) and silent where the reference is; rssi |dB| <= 1e-3;
    spectrum |dB| <= 0.05 within 60 dB of the peak; wide baseband rel. L2
    <= 1e-5; the port's unpacked wire buffer within 1 LSB of its own
    outputs, and against the reference's at the floors above."""
    n_open = 0
    groups = [(("banks", m), 4) for m in MIXED_MODES] + [(("wide", ()), 2)]
    for (top, key), slots in groups:
        jg, tg = jo[top][key], to[top][key]
        np.testing.assert_allclose(tg["rssi"].numpy(), np.asarray(jg["rssi"]), rtol=0, atol=1e-3)
        ja, ta = np.asarray(jg["audio"]), tg["audio"].numpy()
        assert ja.shape == ta.shape
        for i in range(slots):
            if np.abs(ja[i]).max() > 0:
                assert snr_db(ja[i], ta[i]) >= 50.0, (key, i)
                n_open += 1
            else:
                assert not ta[i].any(), (key, i)
    jb, tb = np.asarray(jo["wide"][()]["baseband"]), to["wide"][()]["baseband"].numpy()
    assert np.linalg.norm(jb - tb) <= 1e-5 * np.linalg.norm(jb)
    assert n_open == 2 * len(MIXED_MODES) + 2
    js, ts = np.asarray(jo["spectrum"]), to["spectrum"].numpy()
    strong = js >= js.max() - 60.0
    assert float(np.max(np.abs(ts - js)[strong])) <= 0.05
    np.testing.assert_allclose(to["rssi"].numpy(), np.asarray(jo["rssi"]), rtol=0, atol=1e-3)
    jmeta = jax.tree.map(lambda v: np.asarray(v)[None], {k: v for k, v in jo.items() if k != "_packed"})
    tmeta = {k: v for k, v in to.items() if k != "_packed"}
    tmeta = tpipe._rebuild(tmeta, iter(v[None] for _, v in tpipe._leaves(tmeta)))
    jp, tp = np.asarray(jo["_packed"]), to["_packed"].numpy()
    assert jp.shape == tp.shape
    jw = jax.tree_util.tree_leaves_with_path(jpipe.unpack_wire(jmeta, jp[None]))
    tw = list(tpipe._leaves(tpipe.unpack_wire(tmeta, tp[None])))
    own = [v.numpy() for _, v in tpipe._leaves(tmeta)]
    assert len(jw) == len(tw) == len(own)
    for (path, jv), (name, tv), ov in zip(jw, tw, own):
        assert str(getattr(path[-1], "key", path[-1])) == name
        if name in ("audio", "baseband"):
            # the wire rounds to 1/scale and clips at +-32767/scale (AGC'd
            # audio reaches 1.105, soft_clip's ceiling at headroom 1)
            scale = tpipe.wire_spec(name)[1]
            ov = np.clip(ov, -32767 / scale, 32767 / scale)
            assert float(np.max(np.abs(tv - ov))) <= 0.5 / scale + 1e-6, name  # + f32 rounding
            assert snr_db(jv.ravel(), tv.ravel()) >= 50.0, name
        elif name == "spectrum":
            assert float(np.max(np.abs(tv - jv)[jv >= jv.max() - 60.0])) <= 0.05
        else:
            np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-3)


@pytest.fixture(scope="module", params=[20_000, 20_240], ids=["streaming", "fallback"])
def mixed_run(request):
    """The JAX package's mixed capture, block by block (its jitted
    ``capture_step``), and its state after block 2."""
    block = request.param
    jcfg = jpipe.CapturePipelineConfig(**mixed_kw(block))
    tcfg = tpipe.CapturePipelineConfig(**mixed_kw(block))
    words = pack_i16_words(mixed_blocks(block, 3))
    jctl, tctl = mixed_controls(jcfg, tcfg)
    step = jpipe.jit_capture_step(jcfg)
    jstate = jpipe.pipeline_init(jcfg)
    jouts, jstate2 = [], None
    for k in range(3):
        jo, jstate = step(jnp.asarray(words[k]), jstate, jctl)
        jouts.append(jax.device_get(jo))
        if k == 1:
            jstate2 = jax.device_get(jstate)
    return tcfg, words, tctl, jouts, jstate2


def test_mixed_capture_multi_matches(mixed_run):
    tcfg, words, tctl, jouts, _ = mixed_run
    touts, tstate = tpipe.capture_multi(
        torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg
    )
    for k in range(3):
        tk = tpipe._rebuild(touts, iter(v[k] for _, v in tpipe._leaves(touts)))
        assert_mixed_match(jouts[k], tk)
    assert tstate.wide[()].fir_tail.shape == (2, len(tpipe._wide_taps(tcfg.wide_cfg())) - 1)


@pytest.mark.parametrize("transport", ["i8", "i4"])
def test_mixed_capture_multi_scaled_transports_match(transport):
    """The mixed capture on the adaptive transports: ``(rows, scales)``
    through the port's ``capture_multi`` against the reference's
    ``jit_capture_multi``, 3 blocks, the mixed capture's floors."""
    kw = mixed_kw(20_000)
    jcfg, tcfg = jpipe.CapturePipelineConfig(**kw), tpipe.CapturePipelineConfig(**kw)
    pack = pack_i8_words if transport == "i8" else pack_i4_words
    words, scales = pack(mixed_blocks(20_000, 3))
    jctl, tctl = mixed_controls(jcfg, tcfg)
    jouts, _ = jpipe.jit_capture_multi(jcfg, 3)((jnp.asarray(words), jnp.asarray(scales)),
                                                jpipe.pipeline_init(jcfg), jctl)
    touts, _ = tpipe.capture_multi((torch.from_numpy(words), torch.from_numpy(scales)),
                                   tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg)
    jouts = jax.device_get(jouts)
    for k in range(3):
        jk = jax.tree.map(lambda v: v[k], jouts)
        assert_mixed_match(jk, tpipe._rebuild(touts, iter(v[k] for _, v in tpipe._leaves(touts))))


def test_mixed_mid_stream_handover_through_convert(mixed_run):
    """The JAX package runs blocks 1-2 of the mixed capture; its state
    (IIR sections, AGC envelopes, PLLs, BFO phases, resampler and FIR
    tails) moves to the port, which runs block 3 and matches."""
    tcfg, words, tctl, jouts, jstate2 = mixed_run
    tstate = convert.capture_state_from_numpy(tcfg, jstate2, device="cpu")
    assert tstate.banks["sam"].demod_states.pll.phase.shape == (4,)
    assert tstate.banks["usb"].demod_states.nco_phase.dtype == torch.uint32
    np.testing.assert_array_equal(tstate.wide[()].nco_phase.numpy(), jstate2.wide[()].nco_phase)
    to, _ = tpipe.capture_step(torch.from_numpy(words[2]), tstate, tctl, tcfg)
    assert_mixed_match(jouts[2], to)


# --- the P25 banks ---------------------------------------------------------------
#
# 1.2 Msps / 25 kHz bins (M = 48, 50 kHz channels), 0.1 s blocks (5,000
# channel samples: 480 symbols at 4800 baud, 600 at 6000; 5,000 mod 25 = 0,
# so the NBFM bank's 50 -> 48 kHz resampler streams), i16 words, 3 blocks.
# The three programs of the slice at small width:
#   * C4FM beside an NBFM bank (the BASELINE capture's mix),
#   * LSM (CQPSK) with the 41-tap simulcast equalizer,
#   * Phase 2 dual rate: a CQPSK control-channel bank and a 6000-baud bank.

P25_FS = 1_200_000
P25_BLOCK = 120_000
# program -> (overrides, stations); a station is (bank, slot, bin, fine Hz,
# carrier offset Hz, kind, 70 us echo); empty slots sit on empty bins
P25_PROGRAMS = {
    "c4fm-nbfm": (
        dict(narrow_modes=("nbfm",), narrow_capacity=3, p25_capacity=3, p25_modulation="c4fm"),
        [("p25", 0, 5, 0.0, 0.0, "c4fm", False), ("p25", 1, 38, 1500.0, 0.0, "c4fm", False)],
    ),
    "lsm-equalizer": (
        dict(p25_capacity=3, p25_modulation="cqpsk", p25_equalizer_taps=41),
        [("p25", 0, 5, 0.0, 0.0, "lsm", True), ("p25", 1, 38, 0.0, 600.0, "lsm", False)],
    ),
    "dual-rate": (
        dict(p25_capacity=2, p25_modulation="cqpsk", p25p2_capacity=3),
        [("p25", 0, 5, 0.0, 0.0, "lsm", False), ("p25p2", 0, 12, 0.0, 0.0, "phase2", False),
         ("p25p2", 1, 38, -800.0, 0.0, "phase2", False)],
    ),
}
P25_BINS = {"p25": [5, 38, 14], "p25p2": [12, 38, 22]}
NBFM_P25 = (20, 30, 20)  # the NBFM bank's bins: a station, an empty bin, the station squelch-open


def p25_kw(name: str) -> dict:
    over, _ = P25_PROGRAMS[name]
    return dict(sample_rate=P25_FS, block_size=P25_BLOCK, channel_bandwidth=25_000.0,
                fft_size=2048, spectrum_frames=2, **over)


def p25_blocks(name: str, n_blocks: int):
    from wavecap_tpu.models.p25 import c4fm as jc
    from wavecap_tpu.models.p25 import cqpsk as jq

    rng = np.random.default_rng(7)
    n48 = n_blocks * P25_BLOCK // 25
    stations = []
    for bank, slot, b, fine, carrier, kind, echo in P25_PROGRAMS[name][1]:
        if kind == "c4fm":
            x = jc.modulate_c4fm(rng.integers(0, 4, n48 // 10 + 1).astype(np.uint8), 48_000.0)
        else:
            rs, alpha = (4800.0, 0.2) if kind == "lsm" else (6000.0, 1.0)
            x = jq.modulate_cqpsk(rng.integers(0, 4, int(n48 * rs / 48_000) + 1).astype(np.uint8),
                                  48_000.0, rs, alpha)
        x = sps.resample_poly(x[:n48], 25, 1)
        if echo:
            k = int(round(70e-6 * P25_FS))
            x = x + 0.8 * np.exp(2.98j) * np.concatenate([np.zeros(k), x[:-k]])
        stations.append(FakeStation(offset_hz=b * P25_FS / 48 + fine + carrier, kind="iq_loop",
                                    iq_loop=x.astype(np.complex64), amplitude=0.1))
    if "narrow_modes" in P25_PROGRAMS[name][0]:
        stations.append(FakeStation(offset_hz=NBFM_P25[0] * P25_FS / 48, kind="nbfm", tone_hz=1000.0,
                                    deviation_hz=4000.0, amplitude=0.1))
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(sample_rate=P25_FS))
    stream = dev.start_stream()
    return [stream.read(P25_BLOCK)[0] for _ in range(n_blocks)]


def p25_controls(name: str, jcfg, tcfg):
    jctl = jpipe.control_init(jcfg)
    fine = {bank: np.zeros(3, np.float32) for bank in P25_BINS}
    for bank, slot, _, f, _, _, _ in P25_PROGRAMS[name][1]:
        fine[bank][slot] = f
    repl = {}
    for bank in ("p25", "p25p2"):
        a = getattr(jctl, bank)
        if a is None:
            continue
        n = a.channel_index.shape[0]
        repl[bank] = a._replace(channel_index=jnp.asarray(P25_BINS[bank][:n], jnp.int32),
                                fine_offset_hz=jnp.asarray(fine[bank][:n]),
                                active=jnp.asarray([True] * (n - 1) + [False]))
    if jcfg.narrow_modes:
        repl["banks"] = {"nbfm": jctl.banks["nbfm"]._replace(
            channel_index=jnp.asarray(NBFM_P25, jnp.int32), active=jnp.asarray([True] * 3),
            squelch_db=jnp.asarray([-45.0, -45.0, -1e9], jnp.float32))}
    jctl = jctl._replace(**repl)
    return jctl, convert.capture_control_from_numpy(tcfg, jax.device_get(jctl), device="cpu")


def soft_dibits(soft: np.ndarray) -> np.ndarray:
    outer = np.abs(soft) >= 2.0
    return np.where(soft >= 0, np.where(outer, 1, 0), np.where(outer, 3, 2))


def assert_p25_match(jo, to):
    """One block: per P25 bank, dibits equal and soft >= 50 dB on every
    slot, rssi |dB| <= 1e-3; the NBFM bank's audio >= 50 dB; spectrum
    |dB| <= 0.05 within 60 dB of the peak; the port's unpacked wire soft
    within half an i8 LSB (1/32) of its own output, and within one LSB
    (1/16) of the reference's unpacked wire."""
    banks = [b for b in ("p25", "p25p2") if b in jo]
    assert banks and set(banks) == {b for b in ("p25", "p25p2") if b in to}
    for bank in banks:
        js, ts = np.asarray(jo[bank]["soft"]), to[bank]["soft"].numpy()
        assert js.shape == ts.shape
        np.testing.assert_array_equal(soft_dibits(ts), soft_dibits(js), err_msg=bank)
        for i in range(js.shape[0]):
            assert snr_db(js[i], ts[i]) >= 50.0, (bank, i)
        np.testing.assert_allclose(to[bank]["rssi"].numpy(), np.asarray(jo[bank]["rssi"]), rtol=0, atol=1e-3)
    if jo["banks"]:
        ja, ta = np.asarray(jo["banks"]["nbfm"]["audio"]), to["banks"]["nbfm"]["audio"].numpy()
        for i in range(3):
            if np.abs(ja[i]).max() > 0:
                assert snr_db(ja[i], ta[i]) >= 50.0, i
            else:
                assert not ta[i].any(), i
    js, ts = np.asarray(jo["spectrum"]), to["spectrum"].numpy()
    assert float(np.max(np.abs(ts - js)[js >= js.max() - 60.0])) <= 0.05
    jmeta = jax.tree.map(lambda v: np.asarray(v)[None], {k: v for k, v in jo.items() if k != "_packed"})
    tmeta = {k: v for k, v in to.items() if k != "_packed"}
    tmeta = tpipe._rebuild(tmeta, iter(v[None] for _, v in tpipe._leaves(tmeta)))
    jp, tp = np.asarray(jo["_packed"]), to["_packed"].numpy()
    assert jp.shape == tp.shape
    jw, tw = jpipe.unpack_wire(jmeta, jp[None]), tpipe.unpack_wire(tmeta, tp[None])
    for bank in banks:
        own = np.clip(to[bank]["soft"].numpy(), -127 / 16, 127 / 16)
        assert tw[bank]["soft"].dtype == np.float32
        assert float(np.max(np.abs(tw[bank]["soft"][0] - own))) <= 1 / 32 + 1e-6
        assert float(np.max(np.abs(tw[bank]["soft"] - jw[bank]["soft"]))) <= 1 / 16 + 1e-6


def assert_phases_close(got, ref):
    """uint32 NCO phases after 3 blocks: the port's tuning words equal the
    reference's eager ones; jitted, XLA divides an offset by the constant
    rate through its reciprocal, which moves some words by one ulp of
    ``offset / fs`` (<= 8 counts at 50 kHz), so the phases may differ by up
    to 16 counts a sample."""
    d = (np.asarray(got, np.int64) - np.asarray(ref, np.int64)) % 2**32
    d = np.where(d >= 2**31, d - 2**32, d)
    assert np.abs(d).max() <= 16 * 3 * 2 * P25_BLOCK // 48, d


@pytest.fixture(scope="module", params=list(P25_PROGRAMS))
def p25_run(request):
    """The JAX package's capture of one P25 program, block by block (its
    jitted ``capture_step``), and its state after block 2."""
    name = request.param
    jcfg = jpipe.CapturePipelineConfig(**p25_kw(name))
    tcfg = tpipe.CapturePipelineConfig(**p25_kw(name))
    words = pack_i16_words(p25_blocks(name, 3))
    jctl, tctl = p25_controls(name, jcfg, tcfg)
    step = jpipe.jit_capture_step(jcfg)
    jstate = jpipe.pipeline_init(jcfg)
    jouts, jstate2 = [], None
    for k in range(3):
        jo, jstate = step(jnp.asarray(words[k]), jstate, jctl)
        jouts.append(jax.device_get(jo))
        if k == 1:
            jstate2 = jax.device_get(jstate)
    return name, tcfg, words, tctl, jouts, jstate2, jax.device_get(jstate)


def test_p25_capture_multi_matches(p25_run):
    """Each program over 3 blocks of i16 words against the reference, and
    the carried P25 state after them."""
    name, tcfg, words, tctl, jouts, _, jstate3 = p25_run
    touts, tstate = tpipe.capture_multi(
        torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"), tctl, tcfg
    )
    for k in range(3):
        assert_p25_match(jouts[k], tpipe._rebuild(touts, iter(v[k] for _, v in tpipe._leaves(touts))))
    for bank in ("p25", "p25p2"):
        jb, tb = getattr(jstate3, bank), getattr(tstate, bank)
        if jb is None:
            assert tb is None
            continue
        assert_phases_close(tb.nco_phase.numpy(), jb.nco_phase)
        # relative 1e-4: the timing's Newton steps carry the channelizer's f32 differences
        for f in ("pos", "freq", "integrator"):
            np.testing.assert_allclose(getattr(tb.c4fm, f).numpy(), np.asarray(getattr(jb.c4fm, f)),
                                       rtol=1e-4, atol=1e-4)
        if name != "c4fm-nbfm":
            assert_phases_close(tb.c4fm.cfo_phase.numpy(), jb.c4fm.cfo_phase)
            np.testing.assert_array_equal(tb.c4fm.eq_hits.numpy(), np.asarray(jb.c4fm.eq_hits))
    if name == "lsm-equalizer":
        assert int(tstate.p25.c4fm.eq_hits[0]) >= 2  # the equalizer engaged on the echo


@pytest.mark.parametrize("name", list(P25_PROGRAMS))
def test_p25_scan_timing_capture_matches(name, monkeypatch):
    """``WAVECAP_P25_TIMING=scan`` picks the per-symbol timing loops (K12s,
    K13s) for every P25 bank of both packages: each program over 3 blocks
    of i16 words against the reference's jitted ``capture_step``."""
    monkeypatch.setenv("WAVECAP_P25_TIMING", "scan")
    jcfg = jpipe.CapturePipelineConfig(**p25_kw(name))
    tcfg = tpipe.CapturePipelineConfig(**p25_kw(name))
    assert tpipe.p25_cfg_for(tcfg).timing_impl == "scan"
    words = pack_i16_words(p25_blocks(name, 3))
    jctl, tctl = p25_controls(name, jcfg, tcfg)
    step = jpipe.jit_capture_step(jcfg)
    jstate = jpipe.pipeline_init(jcfg)
    touts, _ = tpipe.capture_multi(torch.from_numpy(words), tpipe.pipeline_init(tcfg, device="cpu"), tctl,
                                   tcfg)
    for k in range(3):
        jo, jstate = step(jnp.asarray(words[k]), jstate, jctl)
        assert_p25_match(jax.device_get(jo), tpipe._rebuild(touts, iter(v[k] for _, v in tpipe._leaves(touts))))


def test_p25_mid_stream_handover_through_convert(p25_run):
    """The JAX package runs blocks 1-2; its P25 bank state (timing,
    carrier NCO, equalizer) moves to the port, which runs block 3 and
    matches the reference's block 3."""
    name, tcfg, words, tctl, jouts, jstate2, _ = p25_run
    tstate = convert.capture_state_from_numpy(tcfg, jstate2, device="cpu")
    assert tstate.p25.nco_phase.dtype == torch.uint32
    if name != "c4fm-nbfm":
        assert tstate.p25.c4fm.cfo_phase.dtype == torch.uint32
        assert tstate.p25.c4fm.eq_hits.dtype == torch.int32
    to, _ = tpipe.capture_step(torch.from_numpy(words[2]), tstate, tctl, tcfg)
    assert_p25_match(jouts[2], to)


def test_p25_soft_wire_round_trip():
    """The soft leaf rides the wire as i8 at 1/16: rounding half to even,
    clipped to +-127/16, and unpacked back to f32."""
    soft = torch.tensor([[0.0, 1.03, -2.97, 3.0, 8.5, -9.0, 0.03125, -0.09375]])
    out = {"p25": {"soft": soft, "rssi": torch.tensor([-20.0])}}
    assert tpipe.wire_spec("soft") == (torch.int8, 16.0)
    packed = tpipe.pack_wire(out)
    assert packed.dtype == torch.uint8 and packed.numel() == 8 + 4
    meta = {"p25": {"soft": soft[None], "rssi": torch.tensor([[-20.0]])}}
    back = tpipe.unpack_wire(meta, packed.numpy()[None])["p25"]["soft"][0]
    want = np.clip(np.round(soft.numpy() * 16), -127, 127) / 16
    np.testing.assert_array_equal(back, want.astype(np.float32))
    jback = jpipe.unpack_wire({"p25": {"soft": np.zeros((1, 1, 8), np.float32), "rssi": np.zeros((1, 1))}},
                              np.asarray(jpipe.pack_wire({"p25": {"soft": jnp.asarray(soft.numpy()),
                                                                  "rssi": jnp.asarray([-20.0])}}))[None])
    np.testing.assert_array_equal(back, jback["p25"]["soft"][0])
