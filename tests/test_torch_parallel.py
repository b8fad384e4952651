"""The port's sharded grid (``wavecap_tpu_torch.parallel``) against the
JAX package's on the 8-device virtual CPU mesh, on the CPU.

The reference runs its ``shard_map`` over the virtual devices
``tests/conftest.py`` makes; the port runs its single-controller mesh over
``WAVECAP_TORCH_DEVICE_COUNT`` copies of the CPU, the plain versions of
the kernels, and its exchanges (K15) as copies.  The case list is
``tests/test_parallel.py``'s: two streams by four time shards, one by
four against one by one, the state across blocks, the asymmetric
meshes; then mixed ``extra_modes`` with ``bank_idx``, a wide (WBFM) group
and the two own-output P25 banks.  Tolerances, each with its reason:
audio of the IIR banks >= 50 dB against the reference (f32 sums in
another order through the recursive filters), silent bins exactly
silent, RSSI within 1e-3 dB; P25 decisions equal and soft >= 50 dB; the
channelizer history bit-equal; the three collectives equal to numpy
exactly (they are copies).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from wavecap_tpu import models as jmodels
from wavecap_tpu import parallel as jpar
from wavecap_tpu.capture.pipeline import WideSlotConfig as JWide
from wavecap_tpu.ops.channelizer import ChannelizerConfig as JCh
from wavecap_tpu_torch import parallel as tpar
from wavecap_tpu_torch.capture.pipeline import WideSlotConfig as TWide
from wavecap_tpu_torch.models import analog as tanalog
from wavecap_tpu_torch.models.p25 import c4fm as tc
from wavecap_tpu_torch.models.p25 import cqpsk as tq
from wavecap_tpu_torch.models.registry import make_config
from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig as TCh
from wavecap_tpu_torch.parallel import collectives
from tests.conftest import snr_db

torch.set_num_threads(1)
FS = 200_000  # M = 8 bins of 25 kHz, channel rate 50 kHz
JCH, TCH = JCh(sample_rate=float(FS), channel_bandwidth=25_000.0), TCh(sample_rate=float(FS),
                                                                      channel_bandwidth=25_000.0)
J_NBFM = jmodels.NbfmConfig(sample_rate=50_000, max_deviation_hz=4000.0)
T_NBFM = tanalog.NbfmConfig(sample_rate=50_000, max_deviation_hz=4000.0)


@pytest.fixture(autouse=True)
def eight_cpus(monkeypatch):
    monkeypatch.setenv("WAVECAP_TORCH_DEVICE_COUNT", "8")


def station(n, offset, tone, fs=FS, dev=4000.0, kind="fm"):
    t = np.arange(n) / fs
    if kind == "am":
        return ((1.0 + 0.5 * np.sin(2 * np.pi * tone * t)) * np.exp(2j * np.pi * offset * t)).astype(np.complex64)
    phase = 2 * np.pi * (offset * t + dev * np.cumsum(np.sin(2 * np.pi * tone * t)) / fs)
    return np.exp(1j * phase).astype(np.complex64)


def noise(rng, n, level=0.01):
    return (level * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)


def peak_freq(audio, rate=48_000):
    a = np.asarray(audio)[len(audio) // 2:]
    a = a - a.mean()
    s = np.abs(np.fft.rfft(a * np.hanning(len(a))))
    return np.fft.rfftfreq(len(a), 1.0 / rate)[np.argmax(s)]


def run_reference(jcfg, n_streams, n_time, blocks, active, bank_idx=None, wide_ctl=None, fine=None):
    mesh = jpar.make_mesh(n_streams=n_streams, n_time=n_time)
    step = jpar.sharded_grid_step(mesh, jcfg)
    state = jpar.grid_init(jcfg, n_streams)
    ctl = jpar.control_init(jcfg, n_streams)._replace(active=jnp.asarray(active))
    if bank_idx is not None:
        ctl = ctl._replace(bank_idx=jnp.asarray(bank_idx))
    if fine is not None:
        ctl = ctl._replace(fine_offset_hz=jnp.asarray(fine))
    if wide_ctl is not None:
        ctl = ctl._replace(wide=jax.tree.map(jnp.asarray, wide_ctl))
    outs = []
    with jax.set_mesh(mesh):
        for x in blocks:
            out, state = step(jnp.asarray(x), state, ctl)
            outs.append(jax.device_get(out))
    return outs, jax.device_get(state)


def run_port(tcfg, n_streams, n_time, blocks, active, bank_idx=None, wide_ctl=None, fine=None):
    mesh = tpar.make_mesh(n_streams=n_streams, n_time=n_time, device="cpu")
    step = tpar.sharded_grid_step(mesh, tcfg)
    state = tpar.grid_init(tcfg, mesh)
    m = tcfg.channelizer.channel_count
    ctl = tpar.sharded.control_from_numpy(
        tcfg, mesh, np.zeros((n_streams, m)) if fine is None else fine, active,
        np.full((n_streams, m), -1e9, np.float32), bank_idx, wide_ctl)
    outs = []
    for x in blocks:
        out, state = step(torch.from_numpy(np.asarray(x)), state, ctl)
        outs.append(out)
    return outs, state


def assert_audio_match(ref, got, what):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape, what
    for idx in np.ndindex(ref.shape[:-1]):
        if np.abs(ref[idx]).max() == 0:
            assert not got[idx].any(), (what, idx)
        else:
            assert snr_db(ref[idx], got[idx]) >= 50.0, (what, idx, snr_db(ref[idx], got[idx]))


def assert_grid_match(jout, tout, what):
    assert_audio_match(jout["audio"], tout["audio"], f"{what} audio")
    np.testing.assert_allclose(tout["rssi"].numpy(), np.asarray(jout["rssi"]), rtol=0, atol=1e-3)


def nbfm_grid(**kw):
    return (jpar.ShardedGridConfig(channelizer=JCH, mode="nbfm", demod_cfg=J_NBFM, **kw.get("j", {})),
            tpar.ShardedGridConfig(channelizer=TCH, mode="nbfm", demod_cfg=T_NBFM, **kw.get("t", {})))


# --- the collectives (K15), exactly numpy's ------------------------------------------------


def test_collectives_equal_numpy(rng):
    shards = tpar.make_mesh(1, 4, device="cpu").shards[0]
    parts = [torch.from_numpy(rng.standard_normal((8, 6)).astype(np.float32)) for _ in range(4)]
    collectives.reset_copy_counts()
    got = tpar.ppermute(parts, shards, [(i, i + 1) for i in range(3)], label="halo")
    assert got[0] is None
    for j in range(1, 4):
        np.testing.assert_array_equal(got[j].numpy(), parts[j - 1].numpy())
        assert got[j].data_ptr() != parts[j - 1].data_ptr()  # a copy, not a view
    full = np.concatenate([p.numpy() for p in parts], axis=1)  # (8, 24): time along axis 1
    a2a = tpar.all_to_all_tiled(parts, shards, label="reshard")
    for d in range(4):  # shard d: rows [2d, 2d+2) of every shard, in time order
        np.testing.assert_array_equal(a2a[d].numpy(), full[2 * d:2 * d + 2])
    gathered = tpar.all_gather(parts, shards, label="gather")
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), np.stack([p.numpy() for p in parts]))
    one = tpar.all_gather(parts, shards, to=shards[2], label="gather_to")
    np.testing.assert_array_equal(one.numpy(), np.stack([p.numpy() for p in parts]))
    counts = tpar.copy_counts()
    assert counts["halo"] == {"copies": 3, "bytes": 3 * 8 * 6 * 4}
    assert counts["reshard"] == {"copies": 16, "bytes": 4 * 8 * 6 * 4}
    assert counts["gather"]["copies"] == 16 and counts["gather_to"]["copies"] == 4


def test_make_mesh_over_repeated_devices(monkeypatch):
    mesh = tpar.make_mesh(n_streams=2, n_time=4, device="cpu")
    assert mesh.shape == {"stream": 2, "time": 4} and mesh.devices.size == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.ravel())
    with pytest.raises(ValueError, match="needs 16 devices"):
        tpar.make_mesh(n_streams=2, n_time=8, device="cpu")
    monkeypatch.delenv("WAVECAP_TORCH_DEVICE_COUNT")
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        tpar.make_mesh(n_streams=1, n_time=4, device="cpu")


# --- the NBFM grid, test_parallel.py's cases ------------------------------------------------


def test_two_streams_demod_matches():
    n = 8 * 4000
    x = np.stack([station(n, TCH.channel_offset_hz(2), 700.0), station(n, TCH.channel_offset_hz(6), 1200.0)])
    active = np.zeros((2, 8), bool)
    active[0, 2] = active[1, 6] = True
    jcfg, tcfg = nbfm_grid()
    jouts, _ = run_reference(jcfg, 2, 4, [x], active)
    touts, _ = run_port(tcfg, 2, 4, [x], active)
    assert_grid_match(jouts[0], touts[0], "2x4")
    audio = touts[0]["audio"].numpy()
    assert abs(peak_freq(audio[0, 2]) - 700.0) < 15 and abs(peak_freq(audio[1, 6]) - 1200.0) < 15
    assert np.abs(audio[0, 3]).max() == 0.0


def test_one_by_four_matches_one_by_one_and_the_reference():
    """The halo and the re-shard leave no seam: 1 x 4 against the port's
    own 1 x 1 mesh (no exchange but the history) and the reference's 1 x 4."""
    n = 8 * 4000
    x = station(n, TCH.channel_offset_hz(2), 700.0)[None]
    active = np.ones((1, 8), bool)
    jcfg, tcfg = nbfm_grid()
    jouts, _ = run_reference(jcfg, 1, 4, [x], active)
    t4, _ = run_port(tcfg, 1, 4, [x], active)
    t1, _ = run_port(tcfg, 1, 1, [x], active)
    assert_grid_match(jouts[0], t4[0], "1x4")
    assert_audio_match(t1[0]["audio"], t4[0]["audio"], "1x4 vs 1x1")


def test_state_carries_across_three_blocks():
    """Three consecutive blocks on 2 x 4: each block's audio, and the
    channelizer history (the last shard's tail, bit-equal) and NCO phases
    after them."""
    n = 8 * 2000
    x = station(3 * n, TCH.channel_offset_hz(5), 900.0)
    blocks = [np.stack([x[i * n:(i + 1) * n]] * 2) for i in range(3)]
    active = np.zeros((2, 8), bool)
    active[:, 5] = True
    fine = np.zeros((2, 8), np.float32)
    fine[:, 5] = 700.0
    jcfg, tcfg = nbfm_grid()
    jouts, jst = run_reference(jcfg, 2, 4, blocks, active, fine=fine)
    touts, tst = run_port(tcfg, 2, 4, blocks, active, fine=fine)
    for k in range(3):
        assert_grid_match(jouts[k], touts[k], f"block {k}")
    for r in range(2):
        np.testing.assert_array_equal(tst.hist[r].numpy(), np.asarray(jst.hist[r]))
        np.testing.assert_array_equal(torch.cat(tst.nco_phase[r]).numpy(), np.asarray(jst.nco_phase[r]))
    audio = np.concatenate([o["audio"][0, 5].numpy() for o in touts])
    assert abs(peak_freq(audio) - 900.0) < 15


@pytest.mark.parametrize("ablation", ["debug_skip_halo", "debug_skip_reshard"])
def test_ablations_drop_their_exchange(rng, ablation):
    """The benchmark ablations: the same output shapes with the exchange
    they name gone (the halo and the history, or the re-shard), and wrong
    output where the exchange mattered (noise: no shard repeats another)."""
    n = 8 * 4000
    x = (station(n, TCH.channel_offset_hz(2), 700.0) + noise(rng, n))[None]
    active = np.ones((1, 8), bool)
    _, tcfg = nbfm_grid()
    whole, _ = run_port(tcfg, 1, 4, [x], active)
    collectives.reset_copy_counts()
    cut, _ = run_port(tcfg.__class__(**{**tcfg.__dict__, ablation: True}), 1, 4, [x], active)
    dropped = {"debug_skip_halo": ("halo", "history"), "debug_skip_reshard": ("reshard",)}[ablation]
    counts = tpar.copy_counts()
    assert not set(dropped) & set(counts) and counts["scatter"]["copies"] == 4
    assert cut[0]["audio"].shape == whole[0]["audio"].shape
    assert not torch.equal(cut[0]["audio"], whole[0]["audio"])


@pytest.mark.parametrize("n_streams,n_time", [(2, 4), (4, 2)])
def test_asymmetric_mesh_matches(n_streams, n_time):
    n = 8 * 4000
    tones, bins = [700.0, 1200.0, 500.0, 1600.0][:n_streams], [2, 6, 3, 5][:n_streams]
    x = np.stack([station(n, TCH.channel_offset_hz(b), f) for b, f in zip(bins, tones)])
    active = np.ones((n_streams, 8), bool)
    jcfg, tcfg = nbfm_grid()
    jouts, _ = run_reference(jcfg, n_streams, n_time, [x], active)
    touts, _ = run_port(tcfg, n_streams, n_time, [x], active)
    assert_grid_match(jouts[0], touts[0], f"{n_streams}x{n_time}")


# --- mixed banks, a wide group, the own-output P25 banks ----------------------------------


def test_mixed_extra_modes_select_by_bank_idx(rng):
    """``nbfm`` base + ``am`` and ``usb`` extras: every bin runs every bank
    and ``bank_idx`` picks each bin's audio; 8 time shards (one bin each),
    two blocks."""
    n = 8 * 4000
    x = (station(2 * n, TCH.channel_offset_hz(1), 700.0) + station(2 * n, TCH.channel_offset_hz(3), 900.0, kind="am")
         + 0.5 * station(2 * n, TCH.channel_offset_hz(6) - 500.0, 0.0, kind="am") + noise(rng, 2 * n))[None]
    blocks = [x[:, :n], x[:, n:]]
    active = np.zeros((1, 8), bool)
    active[0, [1, 3, 6, 7]] = True
    bank_idx = np.zeros((1, 8), np.int32)
    bank_idx[0, 3], bank_idx[0, 6], bank_idx[0, 7] = 1, 2, 1
    jam, jusb = jmodels.AmConfig(sample_rate=50_000), jmodels.SsbConfig(sample_rate=50_000, mode="usb")
    tam, tusb = make_config("am", 50_000), make_config("usb", 50_000)
    jcfg = jpar.ShardedGridConfig(channelizer=JCH, mode="nbfm", demod_cfg=J_NBFM, extra_modes=("am", "usb"),
                                  extra_demod_cfgs=(jam, jusb))
    tcfg = tpar.ShardedGridConfig(channelizer=TCH, mode="nbfm", demod_cfg=T_NBFM, extra_modes=("am", "usb"),
                                  extra_demod_cfgs=(tam, tusb))
    jouts, _ = run_reference(jcfg, 1, 8, blocks, active, bank_idx=bank_idx)
    touts, _ = run_port(tcfg, 1, 8, blocks, active, bank_idx=bank_idx)
    for k in range(2):
        assert_grid_match(jouts[k], touts[k], f"mixed block {k}")
    assert abs(peak_freq(touts[1]["audio"][0, 3].numpy()) - 900.0) < 15
    assert abs(peak_freq(touts[1]["audio"][0, 6].numpy()) - 1000.0) < 15


def test_wide_group_matches(rng):
    """One WBFM group of 2 wide slots at 800 kHz (decimation 3, the
    decimator's head from the halo'd history), one station: the gathered
    IF's audio and RSSI over two blocks, and the wide NCO phases."""
    fs, n = 800_000, 8 * 3840
    x = (0.5 * station(2 * n, 200_000.0, 1000.0, fs=fs, dev=75_000.0) + noise(rng, 2 * n))[None]
    blocks = [x[:, :n], x[:, n:]]
    jch, tch = JCh(sample_rate=float(fs), channel_bandwidth=25_000.0), TCh(sample_rate=float(fs),
                                                                           channel_bandwidth=25_000.0)
    jw, tw = JWide(sample_rate=fs, capacity=2), TWide(sample_rate=fs, capacity=2)
    m = tch.channel_count
    jcfg = jpar.ShardedGridConfig(channelizer=jch, mode="nbfm",
                                  demod_cfg=jmodels.NbfmConfig(sample_rate=int(jch.channel_rate)),
                                  wide_groups=((),), wide_cfgs=(jw,), wide_export_baseband=True)
    tcfg = tpar.ShardedGridConfig(channelizer=tch, mode="nbfm", demod_cfg=make_config("nbfm", int(tch.channel_rate)),
                                  wide_groups=((),), wide_cfgs=(tw,), wide_export_baseband=True)
    wide = {(): {"offset_hz": np.array([[200_000.0, -250_000.0]], np.float32),
                 "active": np.array([[True, True]]), "squelch_db": np.full((1, 2), -1e9, np.float32)}}
    active = np.zeros((1, m), bool)
    jouts, jst = run_reference(jcfg, 1, 8, blocks, active, wide_ctl=wide)
    touts, tst = run_port(tcfg, 1, 8, blocks, active, wide_ctl=wide)
    for k in range(2):
        for leaf in ("audio", "baseband"):
            assert_audio_match(jouts[k]["wide"][()][leaf], touts[k]["wide"][()][leaf], f"wide {leaf} {k}")
        np.testing.assert_allclose(touts[k]["wide"][()]["rssi"].numpy(), np.asarray(jouts[k]["wide"][()]["rssi"]),
                                   rtol=0, atol=1e-3)
    for t in range(8):
        np.testing.assert_array_equal(tst.wide[0][()]["nco"][t].numpy(), np.asarray(jst.wide[()]["nco"][0]))
    assert abs(peak_freq(touts[1]["wide"][()]["audio"][0, 0].numpy()) - 1000.0) < 15


def test_own_output_p25_banks_match(rng):
    """``modes2`` with ``p25-soft`` and ``p25-cqpsk-soft`` over every bin at
    1.2 Msps (M = 48) on 1 x 8, 0.08 s blocks: a C4FM and a CQPSK station, 3 blocks; the
    soft symbols of both banks on the station bins: decisions equal,
    soft >= 50 dB; the NBFM base bank's audio as the rest."""
    from wavecap_tpu.models.p25 import c4fm as jc
    from wavecap_tpu.models.p25 import cqpsk as jq

    fs, n = 1_200_000, 96_000  # a multiple of M x 8 shards and of whole symbols
    jch, tch = JCh(sample_rate=float(fs), channel_bandwidth=25_000.0), TCh(sample_rate=float(fs),
                                                                           channel_bandwidth=25_000.0)
    m, rate = tch.channel_count, int(tch.channel_rate)
    n48 = 3 * n // 25 + 4_800
    from scipy import signal as sps

    c4 = sps.resample(jc.modulate_c4fm(rng.integers(0, 4, n48 // 10).astype(np.uint8), 48_000.0), 25 * n48)
    cq = sps.resample(jq.modulate_cqpsk(rng.integers(0, 4, n48 // 10).astype(np.uint8), 48_000.0), 25 * n48)
    t = np.arange(3 * n) / fs
    x = (0.3 * c4[:3 * n] * np.exp(2j * np.pi * tch.channel_offset_hz(5) * t)
         + 0.3 * cq[:3 * n] * np.exp(2j * np.pi * tch.channel_offset_hz(13) * t) + noise(rng, 3 * n, 0.003))
    blocks = [x[None, k * n:(k + 1) * n].astype(np.complex64) for k in range(3)]
    active = np.zeros((1, m), bool)
    active[0, [5, 13, 20]] = True
    jcfg = jpar.ShardedGridConfig(channelizer=jch, mode="nbfm", demod_cfg=jmodels.NbfmConfig(sample_rate=rate),
                                  modes2=("p25-soft", "p25-cqpsk-soft"),
                                  demod_cfgs2=(jc.C4fmConfig(sample_rate=rate), jq.CqpskConfig(sample_rate=rate)))
    tcfg = tpar.ShardedGridConfig(channelizer=tch, mode="nbfm", demod_cfg=make_config("nbfm", rate),
                                  modes2=("p25-soft", "p25-cqpsk-soft"),
                                  demod_cfgs2=(tc.C4fmConfig(sample_rate=rate), tq.CqpskConfig(sample_rate=rate)))
    jouts, _ = run_reference(jcfg, 1, 8, blocks, active)
    touts, _ = run_port(tcfg, 1, 8, blocks, active)
    for k in range(3):
        assert_grid_match(jouts[k], touts[k], f"p25 grid block {k}")
        for bank, b in ((0, 5), (1, 13)):
            js, ts = np.asarray(jouts[k]["audio2"][bank])[0, b], touts[k]["audio2"][bank][0, b].numpy()
            np.testing.assert_array_equal(tc.soft_to_dibits(torch.from_numpy(ts)).numpy(),
                                          np.asarray(jc.soft_to_dibits(jnp.asarray(js))))
            assert snr_db(js, ts) >= 50.0, (k, bank)
        # an inactive bin's soft is zeroed, as the reference's
        assert not touts[k]["audio2"][0][0, 7].numpy().any()


def test_mid_stream_handover_through_convert(rng):
    """The reference runs block 1 of the mixed grid with a wide group on
    1 x 8; its ``GridState`` and ``GridControl`` move to the port's
    per-shard layout (``convert``), which runs block 2 and matches the
    reference's block 2."""
    from wavecap_tpu_torch import convert

    fs, n = 800_000, 8 * 3840
    x = (0.5 * station(2 * n, 200_000.0, 1000.0, fs=fs, dev=75_000.0)
         + station(2 * n, -150_000.0, 700.0, fs=fs) + noise(rng, 2 * n))[None]
    jch, tch = JCh(sample_rate=float(fs), channel_bandwidth=25_000.0), TCh(sample_rate=float(fs),
                                                                           channel_bandwidth=25_000.0)
    m, rate = tch.channel_count, int(tch.channel_rate)
    jcfg = jpar.ShardedGridConfig(channelizer=jch, mode="nbfm", demod_cfg=jmodels.NbfmConfig(sample_rate=rate),
                                  extra_modes=("am",), extra_demod_cfgs=(jmodels.AmConfig(sample_rate=rate),),
                                  wide_groups=((),), wide_cfgs=(JWide(sample_rate=fs, capacity=1),))
    tcfg = tpar.ShardedGridConfig(channelizer=tch, mode="nbfm", demod_cfg=make_config("nbfm", rate),
                                  extra_modes=("am",), extra_demod_cfgs=(make_config("am", rate),),
                                  wide_groups=((),), wide_cfgs=(TWide(sample_rate=fs, capacity=1),))
    active = np.zeros((1, m), bool)
    bin_fm = tch.channel_index(-150_000.0)
    active[0, [bin_fm, 3]] = True
    bank_idx = np.zeros((1, m), np.int32)
    bank_idx[0, 3] = 1
    wide = {(): {"offset_hz": np.array([[200_000.0]], np.float32), "active": np.array([[True]]),
                 "squelch_db": np.full((1, 1), -1e9, np.float32)}}
    jmesh = jpar.make_mesh(1, 8)
    jstep = jpar.sharded_grid_step(jmesh, jcfg)
    jctl = jpar.control_init(jcfg, 1)._replace(active=jnp.asarray(active), bank_idx=jnp.asarray(bank_idx),
                                               wide=jax.tree.map(jnp.asarray, wide))
    with jax.set_mesh(jmesh):
        _, jst1 = jstep(jnp.asarray(x[:, :n]), jpar.grid_init(jcfg, 1), jctl)
        jout2 = jax.device_get(jstep(jnp.asarray(x[:, n:]), jst1, jctl)[0])
    mesh = tpar.make_mesh(1, 8, device="cpu")
    tst = convert.grid_state_from_numpy(tcfg, mesh, jax.device_get(jst1))
    tctl = convert.grid_control_from_numpy(tcfg, mesh, jax.device_get(jctl))
    assert tst.nco_phase[0][0].dtype == torch.uint32 and len(tst.wide[0][()]["nco"]) == 8
    tout, _ = tpar.sharded_grid_step(mesh, tcfg)(torch.from_numpy(x[:, n:]), tst, tctl)
    assert_grid_match(jout2, tout, "after the hand-over")
    assert_audio_match(jout2["wide"][()]["audio"], tout["wide"][()]["audio"], "wide after the hand-over")
