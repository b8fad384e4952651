"""The port's capture engine on the mesh (``CaptureConfig.mesh``) against
the JAX package's, on the CPU.

The case list is ``tests/test_mesh_capture.py``'s (without the trunking
and DMR cases, whose host layers are not ported): the spec, a mesh too
big, a bin collision, the block geometry, the mode constraints; then the
engines on one seeded scene through ``_dispatch_blocks``: NBFM and AM in
one grid on the i4 words, a wide (WBFM) channel
beside an NBFM one, and a P25 control channel beside an NBFM station;
and the overflow reset against a fresh capture.  The reference runs its ``stream=1,time=8`` mesh over
the 8 virtual CPU devices, the port over ``WAVECAP_TORCH_DEVICE_COUNT=8``
copies of the CPU.  Tolerances, each with its reason: every channel's
published audio >= 50 dB against the reference's (the IIR banks' f32
sums in another order), silent where the reference's is; P25 decisions
equal and soft >= 50 dB; the host conversion's words bit-equal.
"""

import numpy as np
import pytest
import torch

from wavecap_tpu import capture as jcapture
from wavecap_tpu.devices import FakeDriver as JFakeDriver
from wavecap_tpu_torch.capture import engine as teng
from wavecap_tpu_torch.capture import Capture, CaptureConfig, CaptureManager, ChannelSpec
from wavecap_tpu_torch.capture.mesh import build_mesh, parse_mesh_spec
from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
from wavecap_tpu_torch.models.p25.c4fm import soft_to_dibits
from wavecap_tpu_torch.parallel import copy_counts, reset_copy_counts
from tests.conftest import snr_db

torch.set_num_threads(1)
CENTER = 155e6
RATE = 800_000  # 25 kHz bins: M = 32, 4 a shard at time=8
MESH = "stream=1,time=8"


@pytest.fixture(autouse=True)
def eight_cpus(monkeypatch):
    monkeypatch.setenv("WAVECAP_TORCH_DEVICE_COUNT", "8")


def mesh_capture(**kw):
    cfg = dict(center_hz=CENTER, sample_rate=RATE, mesh=MESH, wide_capacity=0, p25_capacity=0)
    cfg.update(kw)
    return CaptureManager(FakeDriver(), device="cpu").create_capture(config=CaptureConfig(**cfg))


# --- the spec, the constraints, the geometry --------------------------------------------


def test_parse_mesh_spec():
    assert parse_mesh_spec("stream=1,time=8") == {"stream": 1, "time": 8}
    assert parse_mesh_spec("stream=2, time=4") == {"stream": 2, "time": 4}
    for bad in ("time=8", "stream=1,time=0", "stream=1,time=x"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad)


def test_build_mesh_too_big():
    with pytest.raises(ValueError, match="needs 4096 devices; only 8"):
        build_mesh("stream=64,time=64", "cpu")
    mesh = build_mesh(MESH, "cpu")
    assert mesh.shape == {"stream": 1, "time": 8} and len(mesh.shards[0]) == 8


def test_accepts_wide_and_p25_with_their_capacities():
    cap = mesh_capture()
    with pytest.raises(RuntimeError, match="wide"):
        cap.create_channel(ChannelSpec(id="w", mode="wbfm", frequency_hz=155.1e6))
    with pytest.raises(ValueError, match="p25_capacity"):
        cap.create_channel(ChannelSpec(id="p", mode="p25", frequency_hz=155.1e6))
    cap2 = mesh_capture(p25_capacity=1, p25p2_capacity=1)
    cap2.create_channel(ChannelSpec(id="a", mode="nbfm", frequency_hz=155.1e6))
    assert cap2.create_channel(ChannelSpec(id="p", mode="p25", frequency_hz=155.3e6)).mode_group == "p25"
    ch2 = cap2.create_channel(ChannelSpec(id="p2", mode="p25p2", frequency_hz=155.35e6))
    assert ch2.mode_group == "p25p2" and ch2.slot == cap2._channelizer.channel_index(350_000.0)
    # the three-output program runs: analog audio + 4800 soft + 6000 soft over every bin
    rng = np.random.default_rng(0)
    batch = torch.from_numpy((rng.standard_normal((1, 2 * cap2.block_size)) * 0.1).astype(np.float32))
    out, _ = cap2._step(batch, cap2._dev_state, cap2._build_control())
    m = cap2._channelizer.channel_count
    assert next(iter(out["banks"].values()))["audio"].shape[-2] == m
    assert out["p25"]["soft"].shape[-2] == out["p25p2"]["soft"].shape[-2] == m
    assert out["p25"]["soft"].shape[-1] != out["p25p2"]["soft"].shape[-1]
    assert cap2.status()["mesh"] == MESH


def test_rejects_bin_collision_and_rebins_on_retune():
    cap = mesh_capture()
    a = cap.create_channel(ChannelSpec(id="a", mode="nbfm", frequency_hz=155.1e6))
    with pytest.raises(ValueError, match="bin"):
        cap.create_channel(ChannelSpec(id="b", mode="nbfm", frequency_hz=155.102e6))  # 2 kHz away
    same = cap.create_channel(ChannelSpec(id="c", mode="am", frequency_hz=155.1e6))
    assert same.slot == a.slot  # one frequency may be heard twice
    cap.update_channel("a", frequency_hz=154.95e6)
    assert a.slot == cap._channelizer.channel_index(-50_000.0)


def test_block_geometry_covers_halo():
    for kw in ({}, {"p25_capacity": 1}, {"sample_rate": 10_000_000, "channel_bandwidth": 12_500.0}):
        cap = mesh_capture(**kw)
        jcap = jcapture.Capture(JFakeDriver(1).open("fake0"), jcapture.CaptureConfig(
            center_hz=CENTER, mesh=MESH, **{"sample_rate": RATE, "wide_capacity": 0, "p25_capacity": 0, **kw}))
        m, t = cap._channelizer.channel_count, cap._channelizer.taps_per_channel
        assert cap.block_size % (m * 8) == 0 and cap.block_size >= m * t * 8
        assert cap.block_size == jcap.block_size


# --- the engines on one scene ---------------------------------------------------------------


def scene(stations, n_blocks: int, block: int) -> list:
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(center_hz=CENTER, sample_rate=RATE))
    stream = dev.start_stream()
    return [stream.read(block)[0] for _ in range(n_blocks)]


def run_engine(pkg, cap, blocks, channels, transports, reset_after=None):
    """Each block through ``_dispatch_blocks`` (the batch drains inline)
    with its transport; the carried state reset after block
    ``reset_after`` as the reader does on an overflow.  Returns each
    channel's published audio (or soft symbols) per block and the batches'
    words."""
    handles = {cid: cap.create_channel(pkg.ChannelSpec(id=cid, mode=mode, frequency_hz=CENTER + off))
               for cid, mode, off in channels}
    subs = {cid: (h.symbols if h.mode_group in ("p25", "p25p2") else h.audio).subscribe(maxsize=64)
            for cid, h in handles.items()}
    words = []
    real = cap._jit_step if pkg is jcapture else cap._step

    def step(batch, state, ctl):
        parts = batch if isinstance(batch, tuple) else (batch,)
        words.append(tuple(np.array(p) for p in parts))
        return real(batch, state, ctl)

    if pkg is jcapture:
        cap._jit_step = step
    else:
        cap._step = step
    got = {cid: [] for cid in subs}
    for k, block in enumerate(blocks):
        cap.transport_active = transports[k]
        cap._dispatch_blocks([block])
        if k == reset_after:
            cap._flush_pending()
            if pkg is jcapture:
                cap._dev_state = cap._init_state()
            else:
                cap._reset_state()
        for cid, sub in subs.items():
            item = sub.get_nowait()
            got[cid].append(np.asarray(item["soft"] if isinstance(item, dict) else item))
    assert cap.blocks_processed == len(blocks) and cap.state != "failed", cap.error
    return got, words


def assert_engines_match(ref, got, p25=()):
    for cid in ref:
        for k, (r, g) in enumerate(zip(ref[cid], got[cid])):
            assert r.shape == g.shape, (cid, k)
            if cid in p25:
                np.testing.assert_array_equal(soft_to_dibits(torch.from_numpy(g)).numpy(),
                                              soft_to_dibits(torch.from_numpy(r.astype(np.float32))).numpy())
            if np.abs(r).max() == 0:
                assert not g.any(), (cid, k)
            else:
                assert snr_db(r, g) >= 50.0, (cid, k, snr_db(r, g))


def both_engines(cfg_kw, stations, channels, transports, reset_after=None, p25=()):
    cfg = dict(center_hz=CENTER, sample_rate=RATE, mesh=MESH, wide_capacity=0, p25_capacity=0,
               adaptive_transport=False, block_seconds=0.05)
    cfg.update(cfg_kw)
    jcap = jcapture.Capture(JFakeDriver(1).open("fake0"), jcapture.CaptureConfig(**cfg))
    tcap = Capture(FakeDriver(1).open("fake0"), CaptureConfig(**cfg), torch_device="cpu")
    assert jcap.block_size == tcap.block_size
    blocks = scene(stations, len(transports), tcap.block_size)
    ref, jwords = run_engine(jcapture, jcap, blocks, channels, transports, reset_after)
    reset_copy_counts()
    got, twords = run_engine(teng, tcap, blocks, channels, transports, reset_after)
    for jb, tb in zip(jwords, twords):  # the host conversion, bit for bit
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(a, b)
    assert_engines_match(ref, got, p25)
    return tcap, got


def peak_hz(audio: np.ndarray) -> float:
    seg = audio - audio.mean()
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    return float(np.fft.rfftfreq(len(seg), 1 / 48_000)[int(np.argmax(spec))])


def test_nbfm_and_am_grid_through_i4_matches_reference():
    """An NBFM and an AM station in one grid (``bank_idx`` selects each
    bin's bank), plus an empty listened bin, on the i4 words (with their
    scale on every shard; the other cases run i16): the published audio
    against the reference engine's, the tones, and the exchanges' copies
    and bytes a block."""
    stations = [FakeStation(offset_hz=100_000.0, kind="nbfm", tone_hz=1000.0, deviation_hz=4000.0),
                FakeStation(offset_hz=-150_000.0, kind="am", tone_hz=700.0, amplitude=0.8)]
    channels = [("fm", "nbfm", 100_000.0), ("am", "am", -150_000.0), ("quiet", "nbfm", 250_000.0)]
    cap, got = both_engines({}, stations, channels, ("i4",) * 3)
    assert abs(peak_hz(np.concatenate(got["fm"][1:])) - 1000.0) < 25.0
    assert abs(peak_hz(np.concatenate(got["am"][1:])) - 700.0) < 25.0
    m, h = cap._channelizer.channel_count, cap._channelizer.channel_count * cap._channelizer.taps_per_channel
    counts = copy_counts()
    assert counts["halo"] == {"copies": 3 * 7, "bytes": 3 * 7 * h * 8}
    assert counts["history"] == {"copies": 3, "bytes": 3 * h * 8}
    assert counts["reshard"]["copies"] == 3 * 64
    assert counts["reshard"]["bytes"] == 3 * m * (2 * cap.block_size // m) * 8
    assert counts["scatter"]["copies"] == 3 * 16  # the words and the scale to every shard


def test_wide_wbfm_beside_nbfm_matches_reference():
    stations = [FakeStation(offset_hz=200_000.0, kind="wbfm", tone_hz=1000.0),
                FakeStation(offset_hz=-150_000.0, kind="nbfm", tone_hz=700.0, deviation_hz=4000.0)]
    channels = [("wb", "wbfm", 200_000.0), ("nb", "nbfm", -150_000.0)]
    _, got = both_engines({"wide_capacity": 2}, stations, channels, ("i16",) * 3)
    assert abs(peak_hz(np.concatenate(got["nb"][1:])) - 700.0) < 25.0
    assert got["wb"][-1].ndim == 1 and np.isfinite(got["wb"][-1]).all()
    counts = copy_counts()
    assert counts["wide_if"]["copies"] == 3 * 8


def test_overflow_reset_restarts_the_grid_state():
    """The overflow contract: the reader flushes and re-initialises the
    carried grid state (history, demod carries, NCO phases) after block 2;
    the blocks after it come out as from a fresh capture, sample for
    sample, and the tone goes on."""
    stations = [FakeStation(offset_hz=100_000.0, kind="nbfm", tone_hz=1000.0, deviation_hz=4000.0)]
    cfg = dict(center_hz=CENTER, sample_rate=RATE, mesh=MESH, wide_capacity=0, p25_capacity=0,
               adaptive_transport=False, block_seconds=0.05)
    channels = [("c1", "nbfm", 100_000.0)]
    cap = Capture(FakeDriver(1).open("fake0"), CaptureConfig(**cfg), torch_device="cpu")
    blocks = scene(stations, 4, cap.block_size)
    got, _ = run_engine(teng, cap, blocks, channels, ("i16",) * 4, reset_after=1)
    fresh_cap = Capture(FakeDriver(1).open("fake0"), CaptureConfig(**cfg), torch_device="cpu")
    fresh, _ = run_engine(teng, fresh_cap, blocks[2:], channels, ("i16",) * 2)
    for a, b in zip(got["c1"][2:], fresh["c1"]):
        np.testing.assert_array_equal(a, b)
    cap._reset_state()
    assert not cap._dev_state.hist[0].any() and not any(p.any() for p in cap._dev_state.nco_phase[0])
    assert abs(peak_hz(np.concatenate(got["c1"][2:])) - 1000.0) < 25.0


def test_p25_control_channel_beside_nbfm_matches_reference():
    """A C4FM control channel (``make_p25_cc_iq``) on a bin centre beside an
    NBFM station: the grid's base bank is NBFM and the P25 bank rides its
    own output over every bin; 3 blocks."""
    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig
    from tests.test_trunking import make_p25_cc_iq

    off = ChannelizerConfig(sample_rate=float(RATE), channel_bandwidth=25_000.0).channel_offset_hz(5)
    stations = [FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=make_p25_cc_iq(RATE, off, n_frames=6),
                            amplitude=1.0),
                FakeStation(offset_hz=-100_000.0, kind="nbfm", tone_hz=1000.0, deviation_hz=4000.0)]
    channels = [("cc", "p25", off), ("fm", "nbfm", -100_000.0)]
    _, got = both_engines({"p25_capacity": 1}, stations, channels, ("i16",) * 3, p25=("cc",))
    mag = np.abs(got["cc"][-1])
    # a 4-level constellation: the decisions clear of the thresholds at 0 and +-2
    assert np.mean((mag > 0.25) & (np.abs(mag - 2.0) > 0.25)) >= 0.95
