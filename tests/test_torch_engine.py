"""The port's capture engine on the CPU (``device="cpu"``), with the port's
fake driver, at 1 Msps / 12.5 kHz (M = 80).

The cases follow ``tests/test_capture_engine.py`` (end-to-end audio,
channel lifecycle and limits, spectrum, the snapshot cache, manager
limits, mixed modes, overflow reset, the transports, multi-block
dispatch, pipelined against sync, warmup, the rebuild race, the
listener-gated audio fetch, live retune) and the controller cases of
``tests/test_adaptive_transport.py``.  Then the slice as a whole: the
reference engine and the port's engine on one seeded scene, 3 blocks
per transport, every channel's published audio >= 50 dB against the
reference's (the floor of the modes with IIR scans), and the host
conversion's words bit-equal to the reference's.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax

from wavecap_tpu import capture as jcapture
from wavecap_tpu.devices import FakeDriver as JFakeDriver
from wavecap_tpu_torch.capture import engine as teng
from wavecap_tpu_torch.capture import Capture, CaptureConfig, CaptureManager, ChannelSpec
from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
from wavecap_tpu_torch.devices.base import DeviceInfo
from wavecap_tpu_torch.devices.fake import FakeDevice, FakeStream
from tests.conftest import snr_db

torch.set_num_threads(1)

CENTER = 155_000_000.0
RATE = 1_000_000
BASE = dict(center_hz=CENTER, sample_rate=RATE, channel_bandwidth=12_500.0, block_seconds=0.1,
            narrow_capacity=2, wide_capacity=1)


def wait_for(pred, timeout=60.0, dt=0.02):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if pred():
            return True
        time.sleep(dt)
    return False


def make_manager(stations, n_devices=2, **kw):
    return CaptureManager(FakeDriver(n_devices=n_devices, stations=stations), device="cpu", **kw)


def drain(sub) -> np.ndarray:
    chunks = []
    while (c := sub.get_nowait()) is not None:
        chunks.append(c)
    return np.concatenate(chunks) if chunks else np.zeros(0, np.float32)


def peak_hz(audio: np.ndarray) -> float:
    seg = audio[len(audio) // 2:]
    seg = seg - seg.mean()
    s = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float(np.fft.rfftfreq(len(seg), 1 / 48_000)[np.argmax(s)])


def nbfm_station(offset=100_000.0, tone=900.0):
    return FakeStation(offset_hz=offset, kind="nbfm", tone_hz=tone, deviation_hz=4000.0)


class TestCaptureEngine:
    def test_end_to_end_nbfm_audio(self):
        mgr = make_manager([nbfm_station()])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        assert cap.block_size == 100_000 and cap.torch_device.type == "cpu"
        ch = cap.create_channel(ChannelSpec(id="ch1", mode="nbfm", frequency_hz=CENTER + 100_000.0))
        sub = ch.audio.subscribe()
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 3)
            assert cap.state == "running"
            audio = drain(sub)
            assert len(audio) >= 3 * 4800
            assert abs(peak_hz(audio) - 900.0) < 20
            assert ch.rssi_db > -40
            perf = cap.status()["perf"]
            assert {"conv_ms", "upload_ms", "dispatch_ms", "wait_ms", "fetch_ms", "fanout_ms"} <= set(perf)
            assert len(cap.block_latency_ms) >= 3
        finally:
            cap.stop()

    def test_channel_lifecycle_and_limits(self):
        mgr = make_manager([])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        cap.create_channel(ChannelSpec(id="a", mode="nbfm", frequency_hz=CENTER + 50e3))
        cap.create_channel(ChannelSpec(id="b", mode="nbfm", frequency_hz=CENTER - 50e3))
        with pytest.raises(RuntimeError):
            cap.create_channel(ChannelSpec(id="c", mode="nbfm", frequency_hz=CENTER))
        cap.remove_channel("a")
        cap.create_channel(ChannelSpec(id="c", mode="nbfm", frequency_hz=CENTER))
        with pytest.raises(ValueError):
            cap.create_channel(ChannelSpec(id="dup", mode="nbfm", frequency_hz=CENTER + 10e9))
        with pytest.raises(ValueError):
            cap.create_channel(ChannelSpec(id="c", mode="nbfm", frequency_hz=CENTER))
        with pytest.raises(ValueError, match="unknown dsp"):
            cap.create_channel(ChannelSpec(id="d", mode="am", frequency_hz=CENTER, dsp={"nope": 1}))
        # a DSP change re-slots the channel into the (mode, dsp) bank
        gen = cap._pipe_gen
        ch = cap.update_channel("c", dsp={"enable_noise_blanker": True})
        assert ch.mode_group == ("nbfm", (("enable_noise_blanker", True),)) and cap._pipe_gen == gen + 1
        with pytest.raises(ValueError):
            cap.update_channel("c", frequency_hz=CENTER + 2e6)

    def test_spectrum_subscription(self):
        mgr = make_manager([FakeStation(offset_hz=5000.0, kind="tone")])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        sub = cap.spectrum_subs.subscribe()
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 1)
            spec = sub.get(timeout=30)
            assert spec.shape[-1] == 2048
            frame = spec[0] if spec.ndim == 2 else spec
            expected = 2048 // 2 + round(5000.0 / (RATE / 2048))
            assert abs(int(np.argmax(frame)) - expected) <= 2
        finally:
            cap.stop()

    def test_snapshot_cache_invalidated_on_retune_and_stop(self):
        mgr = make_manager([FakeStation(offset_hz=5000.0, kind="tone")])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        cap.start()
        try:
            assert wait_for(lambda: cap.last_spectrum is not None)
            cap.update_config(gain_db=20.0)  # front-end only: the cache survives
            assert cap.last_spectrum is not None
            cap.update_config(center_hz=CENTER + 1e5)
            assert cap.last_spectrum is None
            assert wait_for(lambda: cap.last_spectrum is not None)
        finally:
            cap.stop()
        assert cap.last_spectrum is None

    def test_manager_limits_and_removal(self):
        mgr = CaptureManager(FakeDriver(n_devices=1), max_captures=1, device="cpu")
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        with pytest.raises(RuntimeError):
            mgr.create_capture()
        mgr.remove_capture(cap.id)
        assert cap.state in ("stopped", "created")
        assert mgr.create_capture(config=CaptureConfig(**BASE)).torch_device.type == "cpu"

    def test_mixed_modes_same_capture(self):
        stations = [FakeStation(offset_hz=-100_000.0, kind="am", tone_hz=600.0, amplitude=0.5),
                    nbfm_station(150_000.0, 1200.0),
                    FakeStation(offset_hz=300_000.0, kind="wbfm", tone_hz=1000.0,
                                deviation_hz=75_000.0)]
        mgr = make_manager(stations)
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        subs = {
            cid: cap.create_channel(ChannelSpec(id=cid, mode=mode, frequency_hz=CENTER + off, dsp=dsp))
            .audio.subscribe()
            for cid, mode, off, dsp in [
                ("am1", "am", -100_000.0, {"enable_noise_blanker": True}),
                ("fm1", "nbfm", 150_000.0, {"enable_noise_blanker": True, "enable_noise_reduction": True}),
                ("w1", "wbfm", 300_000.0, {"enable_noise_blanker": True}),
            ]
        }
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 3)
            assert abs(peak_hz(drain(subs["am1"])) - 600.0) < 20
            assert abs(peak_hz(drain(subs["fm1"])) - 1200.0) < 20
            assert abs(peak_hz(drain(subs["w1"])) - 1000.0) < 25
        finally:
            cap.stop()


class TestResilience:
    def test_overflow_resets_state_and_continues(self):
        class OverflowingStream(FakeStream):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.reads = 0

            def read(self, n):
                self.reads += 1
                samples, _ = super().read(n)
                return samples, self.reads == 5  # one overflow mid-stream

        class OverflowingDevice(FakeDevice):
            def start_stream(self):
                return OverflowingStream(self.config, self.stations)

        dev = OverflowingDevice(DeviceInfo(id="f", driver="fake", label=""), stations=[nbfm_station()])
        cap = Capture(dev, CaptureConfig(**BASE), torch_device="cpu")
        ch = cap.create_channel(ChannelSpec(id="c", mode="nbfm", frequency_hz=CENTER + 100_000.0))
        sub = ch.audio.subscribe()
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 4)
            assert cap.overflow_count >= 1
            assert cap.state == "running"
            assert sub.get_nowait() is not None
        finally:
            cap.stop()

    def test_watchdog_restarts_dead_thread(self):
        crash_once = {"armed": True}

        class CrashingStream(FakeStream):
            def read(self, n):
                if crash_once["armed"] and self._pos > RATE // 4:
                    crash_once["armed"] = False
                    raise RuntimeError("simulated device fault")
                return super().read(n)

        class CrashingDevice(FakeDevice):
            def start_stream(self):
                return CrashingStream(self.config, self.stations)

        cap = Capture(CrashingDevice(DeviceInfo(id="f", driver="fake", label=""), stations=[]),
                      CaptureConfig(**BASE), torch_device="cpu")
        cap.watchdog_timeout_s = 2.0
        cap.start()
        try:
            assert wait_for(lambda: cap.restart_count >= 1 and cap.state == "running", timeout=30)
            b0 = cap.blocks_processed
            assert wait_for(lambda: cap.blocks_processed > b0)
        finally:
            cap.auto_restart = False
            cap.stop()


class TestDispatchModes:
    def _run_capture(self, **cfg_kw):
        mgr = make_manager([nbfm_station()])
        cap = mgr.create_capture(config=CaptureConfig(**{**BASE, **cfg_kw}))
        ch = cap.create_channel(ChannelSpec(id="ch1", mode="nbfm", frequency_hz=CENTER + 100_000.0))
        sub = ch.audio.subscribe()
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 4)
            audio = drain(sub)
        finally:
            cap.stop()
        assert cap.state != "failed", cap.error
        return peak_hz(audio)

    @pytest.mark.parametrize("transport", ["i16", "i8", "i4", "f32"])
    def test_transport_demodulates(self, transport):
        assert abs(self._run_capture(transport=transport) - 900.0) < 20

    def test_multi_block_dispatch_demodulates(self):
        assert abs(self._run_capture(blocks_per_dispatch=2) - 900.0) < 20

    def test_pipelined_depth_matches_sync(self):
        assert abs(self._run_capture(pipeline_depth=0) - 900.0) < 20

    def test_mesh_demodulates(self, monkeypatch):
        """``CaptureConfig.mesh`` through the reader and fetch threads: the
        grid on 8 shards of the CPU (``WAVECAP_TORCH_DEVICE_COUNT``)."""
        monkeypatch.setenv("WAVECAP_TORCH_DEVICE_COUNT", "8")
        assert abs(self._run_capture(mesh="stream=1,time=8") - 900.0) < 20


class TestLiveRetune:
    def test_center_retune_without_stream_teardown(self):
        mgr = make_manager([nbfm_station()])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        ch = cap.create_channel(ChannelSpec(id="ch1", mode="nbfm", frequency_hz=CENTER + 100_000.0))
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 2)
            thread_before = cap._thread
            blocks_before = cap.blocks_processed
            # retune down 150 kHz: the station moves to +250 kHz in the passband
            cap.update_config(center_hz=CENTER - 150_000.0)
            assert cap.state == "running"
            assert wait_for(lambda: cap.blocks_processed >= blocks_before + 3)
            sub = ch.audio.subscribe()
            assert wait_for(lambda: sub.queue.qsize() >= 2)
            assert abs(peak_hz(drain(sub)) - 900.0) < 20
            assert ch.rssi_db > -40
            assert cap._thread is thread_before
        finally:
            cap.stop()

    def test_rate_change_still_restarts(self):
        mgr = make_manager([FakeStation(offset_hz=5000.0, kind="tone")])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 1)
            thread_before = cap._thread
            cap.update_config(sample_rate=800_000)
            assert cap._thread is not thread_before
            # lcm(M = 64, decimation 3, 4800- and 6000-baud symbols) = 24,000
            assert cap.config.sample_rate == 800_000 and cap.block_size == 72_000
            assert wait_for(lambda: cap.blocks_processed >= 1)
        finally:
            cap.stop()


class TestPipelineRebuildRace:
    def test_inflight_dispatch_cannot_clobber_rebuilt_state(self):
        """A batch in flight across a rebuild must not write its
        (old-structure) state back over the fresh one."""
        mgr = make_manager([FakeStation(offset_hz=200_000.0, kind="wbfm")])
        cap = mgr.create_capture(config=CaptureConfig(**BASE))
        cap.create_channel(ChannelSpec(id="w", mode="wbfm", frequency_hz=CENTER + 200_000.0))
        real_step = cap._step
        entered, release = threading.Event(), threading.Event()

        def gated_step(batch, state, ctl):
            entered.set()
            assert release.wait(60)
            return real_step(batch, state, ctl)

        cap._step = gated_step
        blocks = [np.zeros(cap.block_size, np.complex64)]
        t = threading.Thread(target=cap._dispatch_blocks, args=(blocks,))
        t.start()
        assert entered.wait(60)
        cap.create_channel(ChannelSpec(id="n", mode="nbfm", frequency_hz=CENTER - 100_000.0))
        assert ("nbfm", ()) in cap._dev_state.banks
        release.set()
        t.join(60)
        assert not t.is_alive()
        assert ("nbfm", ()) in cap._dev_state.banks  # the old write-back was dropped
        cap._dispatch_blocks(blocks)
        assert cap.state != "failed", cap.error


class TestWarmup:
    def test_warmup_builds_before_start(self):
        mgr = make_manager([])
        cap = mgr.create_capture(config=CaptureConfig(**{**BASE, "wide_capacity": 0}))
        cap.create_channel(ChannelSpec(id="a", mode="nbfm", frequency_hz=CENTER + 20e3))
        t = cap.warmup()
        t.join(timeout=120)
        assert not t.is_alive() and cap.warmup_error is None
        assert cap._program_warm and cap._step is not None
        gen = cap._pipe_gen
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 2)
            assert cap._pipe_gen == gen  # start() reused the warmed program
        finally:
            cap.stop()


class TestAudioFetchSlots:
    def test_listener_gated_audio_fetch(self):
        """Only channels with live listeners get audio rows fetched; every
        slot still demodulates; a later subscriber is picked up without a
        rebuild, and the published rows are the listened slots'."""
        stations = [nbfm_station(25_000.0 * (i + 1), 600.0 + 300.0 * i) for i in range(3)]
        mgr = make_manager(stations)
        cap = mgr.create_capture(config=CaptureConfig(**{**BASE, "narrow_capacity": 4,
                                                         "wide_capacity": 0, "audio_fetch_slots": 2}))
        chans = [cap.create_channel(ChannelSpec(id=f"c{i}", mode="nbfm",
                                                frequency_hz=CENTER + 25e3 * (i + 1)))
                 for i in range(3)]
        sub0 = chans[0].audio.subscribe()
        cap.start()
        try:
            assert wait_for(lambda: cap.blocks_processed >= 4)
            gen = cap._pipe_gen
            assert sub0.queue.qsize() > 0, "subscribed channel got no audio"
            assert all(c.rssi_db > -200.0 for c in chans)
            assert abs(peak_hz(drain(sub0)) - 600.0) < 20
            sub2 = chans[2].audio.subscribe()
            n0 = cap.blocks_processed
            assert wait_for(lambda: cap.blocks_processed >= n0 + 4)
            assert sub2.queue.qsize() > 0, "late subscriber got no audio"
            assert abs(peak_hz(drain(sub2)) - 1200.0) < 20
            assert cap._pipe_gen == gen, "listener change rebuilt the program"
            assert cap._audio_pos == {(chans[0].mode_group, 0): 0, (chans[2].mode_group, 2): 1}
        finally:
            cap.stop()


class TestController:
    """The adaptive transport's ladder, driven directly."""

    def _cap(self, transport="i16", adaptive=True) -> Capture:
        mgr = CaptureManager(FakeDriver(n_devices=1), device="cpu")
        return mgr.create_capture(config=CaptureConfig(
            center_hz=CENTER, sample_rate=800_000, transport=transport, adaptive_transport=adaptive))

    def test_degrades_under_sustained_load(self):
        cap = self._cap("i16")
        cap._adapt_transport(busy_ms=95.0, budget_ms=100.0)
        assert cap.transport_active == "i16"
        for _ in range(12):
            cap._adapt_transport(busy_ms=95.0, budget_ms=100.0)
        assert cap.transport_active == "i8"
        cap._adapt_transport(busy_ms=120.0, budget_ms=100.0)
        assert cap.transport_active == "i8"
        for _ in range(12):
            cap._adapt_transport(busy_ms=120.0, budget_ms=100.0)
        assert cap.transport_active == "i4"
        for _ in range(15):
            cap._adapt_transport(busy_ms=200.0, budget_ms=100.0)
        assert cap.transport_active == "i4"

    def test_hard_overload_degrades_on_first_sample(self):
        cap = self._cap("i16")
        cap._adapt_transport(busy_ms=400.0, budget_ms=100.0)
        assert cap.transport_active == "i8"

    def test_recovers_with_patience_and_never_exceeds_ceiling(self):
        cap = self._cap("i8")
        for _ in range(13):
            cap._adapt_transport(busy_ms=95.0, budget_ms=100.0)
        assert cap.transport_active == "i4"
        for _ in range(30):
            cap._adapt_transport(busy_ms=20.0, budget_ms=100.0)
        assert cap.transport_active == "i4"
        for _ in range(50):
            cap._adapt_transport(busy_ms=20.0, budget_ms=100.0)
        assert cap.transport_active == "i8"
        for _ in range(100):
            cap._adapt_transport(busy_ms=1.0, budget_ms=100.0)
        assert cap.transport_active == "i8"

    def test_moderate_load_resets_recovery_patience(self):
        cap = self._cap("i16")
        for _ in range(13):
            cap._adapt_transport(busy_ms=95.0, budget_ms=100.0)
        assert cap.transport_active == "i8"
        for _ in range(35):
            cap._adapt_transport(busy_ms=20.0, budget_ms=100.0)
        for _ in range(5):
            cap._adapt_transport(busy_ms=60.0, budget_ms=100.0)
        for _ in range(30):
            cap._adapt_transport(busy_ms=20.0, budget_ms=100.0)
        assert cap.transport_active == "i8"

    @pytest.mark.parametrize("transport", ["f32", "i4"])
    def test_explicit_fidelity_and_floor_never_adapt(self, transport):
        cap = self._cap(transport)
        for _ in range(10):
            cap._adapt_transport(busy_ms=500.0, budget_ms=100.0)
        assert cap.transport_active == transport

    def test_disabled_never_adapts(self):
        cap = self._cap("i16", adaptive=False)
        for _ in range(10):
            cap._adapt_transport(busy_ms=500.0, budget_ms=100.0)
        assert cap.transport_active == "i16"

    def test_non_realtime_stream_never_adapts(self):
        cap = self._cap("i16")
        cap._stream_realtime = False
        cap._adapt_transport(busy_ms=400.0, budget_ms=100.0)
        assert cap.transport_active == "i16"


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CaptureManager(FakeDriver(n_devices=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        Capture(FakeDriver(n_devices=1).open("fake0"), CaptureConfig(**BASE))
    cap = Capture(FakeDriver(n_devices=1).open("fake0"), CaptureConfig(**BASE), torch_device="cpu")
    assert cap.status()["device"] == "cpu"


# --- the slice as a whole: the reference engine against the port's ----------

# (channel id, mode, offset from the centre Hz, dsp): the same voice-like
# NBFM station in the default bank and in a bank with both noise options,
# an AM station behind the blanker, an empty NBFM slot
PARITY_CHANNELS = [
    ("fm", "nbfm", 100_000.0, {}),
    ("fm_nb_nr", "nbfm", 100_000.0, {"enable_noise_blanker": True, "enable_noise_reduction": True}),
    ("am_nb", "am", -150_000.0, {"enable_noise_blanker": True}),
    ("fm_empty", "nbfm", 250_000.0, {}),
]
TRANSPORTS = ("i16", "i8", "i4")


def parity_scene(n_blocks: int, block: int) -> list:
    """A voice-like NBFM station (a 1 kHz tone gated 50 ms on, 30 ms off:
    the noise reduction keeps it, where a steady tone is what it takes
    out), an AM station and a train of wideband impulses, plus noise."""
    n = RATE // 2
    t = np.arange(n) / RATE
    audio = ((t % 0.08) < 0.05) * np.sin(2 * np.pi * 1000.0 * t)
    voice = np.exp(2j * np.pi * 4000.0 * np.cumsum(audio) / RATE).astype(np.complex64)
    impulses = np.zeros(5003, np.complex64)
    impulses[100:103] = 0.6 + 0.3j
    stations = [FakeStation(offset_hz=100_000.0, kind="iq_loop", iq_loop=voice, amplitude=0.1),
                FakeStation(offset_hz=-150_000.0, kind="am", tone_hz=700.0, amplitude=0.1),
                FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=impulses, amplitude=1.0)]
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(center_hz=CENTER, sample_rate=RATE))
    stream = dev.start_stream()
    return [stream.read(block)[0] for _ in range(n_blocks)]


def run_engine(pkg, cap, blocks, record):
    """Each block through ``_dispatch_blocks`` (no reader or fetch thread:
    the batch drains inline), the transport set between dispatches as the
    controller does; returns each channel's published audio per block."""
    subs = {cid: cap.create_channel(pkg.ChannelSpec(id=cid, mode=mode, frequency_hz=CENTER + off, dsp=dsp))
            .audio.subscribe(maxsize=64)
            for cid, mode, off, dsp in PARITY_CHANNELS}
    record(cap)
    audio = {cid: [] for cid in subs}
    for k, block in enumerate(blocks):
        cap.transport_active = TRANSPORTS[k // 3]
        cap._dispatch_blocks([block])
        for cid, sub in subs.items():
            audio[cid].append(sub.get_nowait())
    assert cap.blocks_processed == len(blocks) and cap.state != "failed"
    return audio


def test_engine_matches_reference_engine_per_transport():
    cfg = dict(BASE, wide_capacity=0, adaptive_transport=False)
    jcap = jcapture.Capture(JFakeDriver(1).open("fake0"), jcapture.CaptureConfig(**cfg))
    tcap = Capture(FakeDriver(1).open("fake0"), CaptureConfig(**cfg), torch_device="cpu")
    assert jcap.block_size == tcap.block_size
    blocks = parity_scene(3 * len(TRANSPORTS), tcap.block_size)
    jbatches, tbatches = [], []

    def record_j(cap):
        real = cap._jit_step

        def step(batch, state, ctl):
            jbatches.append(jax.tree_util.tree_map(np.asarray, batch))
            return real(batch, state, ctl)
        cap._jit_step = step

    def record_t(cap):
        real = cap._step

        def step(batch, state, ctl):
            parts = batch if isinstance(batch, tuple) else (batch,)
            tbatches.append(tuple(p.numpy().copy() for p in parts))  # the staging ring is reused
            return real(batch, state, ctl)
        cap._step = step

    ref = run_engine(jcapture, jcap, blocks, record_j)
    got = run_engine(teng, tcap, blocks, record_t)
    # the host conversion: the same words (and scales), bit for bit
    for jb, tb in zip(jbatches, tbatches):
        jparts = jb if isinstance(jb, tuple) else (jb,)
        assert len(jparts) == len(tb)
        for a, b in zip(jparts, tb):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert [b[0].dtype for b in tbatches] == [np.int32] * 3 + [np.int16] * 3 + [np.int8] * 3
    for cid in ref:
        for k, (r, g) in enumerate(zip(ref[cid], got[cid])):
            assert r.shape == g.shape == (4800,), (cid, k)
            assert snr_db(r, g) >= 50.0, (cid, k, TRANSPORTS[k // 3], snr_db(r, g))
