#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``wavecap_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It drives the port's main path, the 800-channel NBFM capture step
(i16 words -> K1 unpack + polyphase arms -> K2 cross-arm DFT -> K3 slot
front end -> K4 voice FIR -> wire buffer), at full width:

0. identity: the card's name and power limit, torch and CUDA versions;
1. build: every kernel from ``wavecap_tpu_torch/kernels/csrc`` with nvcc;
2. kernel checks: each kernel against its plain PyTorch version on the
   card, at the slice's shapes, with inputs from a numpy seed; the
   kernel's, the plain version's and the yardstick library call's time on
   the card (CUPTI, through torch.profiler) beside the kernel's bound, and
   the wrapper's wall time between CUDA events; then K1 on complex input
   and K2 at M = 80 and M = 38 (unfactorable) against their plain versions;
3. the slice: a fake 10 Msps receiver with NBFM stations on known bins,
   8 consecutive 1,968,000-sample blocks through ``pack_i16_words`` ->
   upload -> ``capture_multi`` (800 active slots) -> ``unpack_wire``:
   each station's 1 kHz tone, the squelch of empty slots, one launch of
   each kernel per block, and the first block against the plain path on
   the card;
4. a JSON line of the kernels and the final ``{"ok": true, ...}`` line.

Any failed check exits non-zero before the last line.  Without a CUDA
card, or outside the repository, it exits non-zero and prints no result.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SEED = 20261016
N_BLOCKS = 8
MODE = ("nbfm", (("filter_impl", "fir"), ("fast_discriminator", True)))
# (bin, fine offset Hz) of the fake receiver's NBFM stations: 1 kHz tone,
# 4 kHz deviation, amplitude 0.1 each
STATIONS = ((7, 0.0), (40, 0.0), (123, 800.0), (399, -500.0), (520, 0.0), (777, 300.0))
SQUELCH_DB = -45.0  # between the noise floor (~-86 dBFS) and a station (-20 dBFS)


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def snr_db(ref: np.ndarray, got: np.ndarray) -> float:
    ref = np.asarray(ref, np.float64).ravel()
    err = ref - np.asarray(got, np.float64).ravel()
    p_err = float(np.sum(err * err))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * np.log10(float(np.sum(ref * ref)) / p_err)


def rel_l2(ref, got) -> float:
    ref = np.asarray(ref).astype(np.complex128).ravel()
    got = np.asarray(got).astype(np.complex128).ravel()
    return float(np.linalg.norm(ref - got) / np.linalg.norm(ref))


def max_abs(ref, got) -> float:
    return float(np.max(np.abs(np.asarray(ref).astype(np.complex128) - np.asarray(got))))


def host(t):
    return t.detach().cpu().numpy()


def time_ms(fn, reps: int = 20) -> float:
    """Warm median wall time of one call, between two CUDA events: the
    card's time plus any host time the call keeps the card waiting."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel: str = "", reps: int = 20) -> float:
    """Warm mean time on the card of one call: the kernels and copies it
    ran (only those whose name holds ``kernel``, when given), as CUPTI
    traced them through torch.profiler, without the host's gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA and kernel in e.key)
    return float(us) / reps / 1e3


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def slice_config():
    from wavecap_tpu_torch.capture.pipeline import CapturePipelineConfig

    return CapturePipelineConfig(
        sample_rate=10_000_000,
        block_size=1_968_000,
        narrow_modes=(MODE,),
        narrow_capacity=800,
        channel_bandwidth=12_500.0,
        audio_rate=25_000,
        fft_size=2048,
        spectrum_frames=2,
    )


# --- phase 2: each kernel against its plain version --------------------------


def fm_rows(rng, rows: int, n: int, rate: float) -> np.ndarray:
    """One NBFM tone per row (random tone, deviation, carrier offset,
    amplitude) at high SNR: the discriminator stays clear of its +-pi
    branch cut, where one ulp flips a sample by 2 pi."""
    t = np.arange(n) / rate
    tone = rng.uniform(300.0, 2500.0, (rows, 1))
    dev = rng.uniform(1000.0, 4000.0, (rows, 1))
    carrier = rng.uniform(-2000.0, 2000.0, (rows, 1))
    amp = rng.uniform(0.1, 0.5, (rows, 1))
    phase = 2 * np.pi * (carrier * t - dev * np.cos(2 * np.pi * tone * t) / (2 * np.pi * tone))
    x = amp * np.exp(1j * phase)
    x += 1e-3 * (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n)))
    return x.astype(np.complex64)


def kernel_checks(cfg, device, timer=device_ms, wall_timer=time_ms) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.models.channel_bank import ChannelAssignment
    from wavecap_tpu_torch.ops import channelizer as chz

    rng = np.random.default_rng(SEED)
    ch = cfg.channelizer()
    bank = cfg.bank_cfg(MODE)
    m, t, n = ch.channel_count, ch.taps_per_channel, cfg.block_size
    r_steps, s = n // m, 2 * n // m
    c = cfg.narrow_capacity
    results = []

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    # K1: random i16 pairs and a random history (the arms are linear)
    iq16 = rng.integers(-32768, 32768, (n, 2)).astype(np.int16)
    words = dev(iq16.view(np.int32).ravel())
    hist = dev((rng.standard_normal(m * t) + 1j * rng.standard_normal(m * t)).astype(np.complex64) * 0.1)
    x_k, u_k = chz.unpack_arms(words, hist, ch)
    x_p, u_p = chz.unpack_arms_plain(words, hist, ch)
    check(torch.equal(x_k, x_p), "K1 unpacked block differs from the plain version")
    err = rel_l2(host(u_p), host(u_k))
    # 9-term f32 sums of products; the kernel fuses multiply-adds: ~1e-7
    check(err <= 1e-6, f"K1 arms rel L2 {err:.3g} > 1e-6")
    b, f = bound(n * 4 + m * t * 12 + 2 * r_steps * m * 8 + n * 8, 2 * r_steps * m * t * 4)
    results.append(dict(
        name="K1_unpack_arms", route="cuda",
        source="wavecap_tpu_torch/kernels/csrc/unpack_arms.cu",
        replaces="wavecap_tpu/capture/pipeline.py:561 (+ ops/channelizer.py:140)",
        max_abs_err=max_abs(host(u_p), host(u_k)), rel_l2=err,
        ms=timer(lambda: chz.unpack_arms(words, hist, ch), "unpack_arms_kernel"),
        wrapper_ms=wall_timer(lambda: chz.unpack_arms(words, hist, ch)),
        plain_ms=timer(lambda: chz.unpack_arms_plain(words, hist, ch)),
        bound_ms=b, bound_by=f, library_ms=None,
    ))

    # K2: the stacks of K1's plain version
    y_k = chz.arm_dft(u_p, ch)
    y_p = chz.arm_dft_plain(u_p, ch)
    err = rel_l2(host(y_p), host(y_k))
    check(err <= 1e-5, f"K2 rel L2 {err:.3g} > 1e-5")  # the reference's planar floor
    # the function's own work per row: an M-point DFT at an FFT's
    # 5 M log2 M real operations, plus the channel twiddle (6 per sample);
    # the 25 x 32 matmul factoring K2 runs does ~10x more, by its choice
    flops_row = 5.0 * m * np.log2(m) + 6.0 * m
    tables = chz._k2_tables(m, device)
    b, f = bound(2 * (2 * r_steps * m * 8) + tables.numel() * 4, 2 * r_steps * flops_row)
    results.append(dict(
        name="K2_arm_dft", route="cuda", source="wavecap_tpu_torch/kernels/csrc/arm_dft.cu",
        replaces="wavecap_tpu/ops/planar.py:106 (+ ops/channelizer.py:173)",
        max_abs_err=max_abs(host(y_p), host(y_k)), rel_l2=err,
        ms=timer(lambda: chz.arm_dft(u_p, ch), "arm_dft_kernel"),
        wrapper_ms=wall_timer(lambda: chz.arm_dft(u_p, ch)),
        plain_ms=timer(lambda: chz.arm_dft_plain(u_p, ch)),
        bound_ms=b, bound_by=f,
        # yardstick: torch.fft across arms with the same epilogue
        library_ms=timer(lambda: chz._fft_arms(u_p, ch)),
    ))

    # K3: an NBFM tone on every row, every slot on a shuffled row
    chans = dev(fm_rows(rng, m, s, ch.channel_rate))
    assign = ChannelAssignment(
        channel_index=dev(rng.permutation(m)[:c].astype(np.int32)),
        fine_offset_hz=dev(rng.uniform(-1500.0, 1500.0, c).astype(np.float32)),
        active=dev(np.ones(c, bool)),
        squelch_db=dev(np.full(c, -1e9, np.float32)),
    )
    phase0 = dev(rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32))
    prev = dev(np.exp(1j * rng.uniform(-np.pi, np.pi, c)).astype(np.complex64) * 0.3)
    out_k = cb.slot_frontend(chans, assign, phase0, prev, bank)
    out_p = cb.slot_frontend_plain(chans, assign, phase0, prev, bank)
    fm_k, rssi_k, ph_k, last_k = (host(v) for v in out_k)
    fm_p, rssi_p, ph_p, last_p = (host(v) for v in out_p)
    check(np.array_equal(ph_k, ph_p), "K3 NCO phases are not bit-exact")
    # the card's tuning words and carried phases equal the CPU's, bit for bit
    from wavecap_tpu_torch.ops.nco import _next_phase, tuning_word

    neg = -assign.fine_offset_hz
    dphi_cpu = tuning_word(neg.cpu(), ch.channel_rate)
    check(np.array_equal(host(tuning_word(neg, ch.channel_rate)), host(dphi_cpu)),
          "tuning words differ between the card and the CPU")
    check(np.array_equal(ph_k, host(_next_phase(phase0.cpu(), s, dphi_cpu))),
          "K3 carried phase differs from the CPU's accumulator")
    fm_snr = snr_db(fm_p, fm_k)
    check(fm_snr >= 80.0, f"K3 discriminator SNR {fm_snr:.1f} dB < 80")
    d_rssi = float(np.max(np.abs(rssi_k - rssi_p)))
    check(d_rssi <= 1e-3, f"K3 RSSI differs by {d_rssi:.3g} dB > 1e-3")
    check(rel_l2(last_p, last_k) <= 1e-5, "K3 last sample differs")
    # per sample: NCO 3, cos 1, sin 1, mix 6, power 3, product 6, fast atan2 ~12, scale 1
    b, f = bound(c * s * 8 + c * 20 + c * s * 4 + c * 16, 33.0 * c * s)
    results.append(dict(
        name="K3_slot_frontend", route="cuda",
        source="wavecap_tpu_torch/kernels/csrc/slot_frontend.cu",
        replaces="wavecap_tpu/models/channel_bank.py:99 (+ ops/nco.py:51, ops/demod.py:37)",
        max_abs_err=float(np.max(np.abs(fm_k - fm_p))), fm_snr_db=fm_snr, rssi_max_abs_db=d_rssi,
        ms=timer(lambda: cb.slot_frontend(chans, assign, phase0, prev, bank),
                 "slot_frontend_kernel"),
        wrapper_ms=wall_timer(lambda: cb.slot_frontend(chans, assign, phase0, prev, bank)),
        plain_ms=timer(lambda: cb.slot_frontend_plain(chans, assign, phase0, prev, bank)),
        bound_ms=b, bound_by=f, library_ms=None,
    ))

    # K4: K3's plain output; open, shut and inactive slots
    fm = out_p[0]
    rssi = out_p[1]
    taps = cb._taps(bank.demod_cfg, device)
    nt = taps.shape[0]
    tail = dev(host(fm)[:, -(nt - 1):][rng.permutation(c)])
    sq = np.where(rng.random(c) < 0.75, host(rssi) - 6.0, host(rssi) + 6.0).astype(np.float32)
    act = rng.random(c) < 0.9
    assign4 = assign._replace(squelch_db=dev(sq), active=dev(act))
    a_k, r_k, t_k = (host(v) for v in cb.voice_fir(fm, tail, rssi, assign4, bank))
    a_p, r_p, t_p = (host(v) for v in cb.voice_fir_plain(fm, tail, rssi, assign4, bank))
    open_ = act & (host(rssi) >= sq)
    check(open_.any() and (~open_).any(), "K4 check needs open and shut slots")
    worst = min(snr_db(a_p[i], a_k[i]) for i in np.flatnonzero(open_))
    check(worst >= 70.0, f"K4 audio SNR {worst:.1f} dB < 70 on an open slot")
    check(not a_k[~open_].any() and not a_p[~open_].any(), "K4 shut slots are not silent")
    check(np.array_equal(r_k, r_p) and np.array_equal(t_k, t_p), "K4 rssi or tail differs")
    kern = taps.flip(0).reshape(1, 1, -1)
    xin = torch.cat([tail, fm], dim=-1).unsqueeze(1).contiguous()
    b, f = bound(2 * c * s * 4 + 2 * c * (nt - 1) * 4 + nt * 4 + c * 13, c * s * (2.0 * nt + 6))
    results.append(dict(
        name="K4_voice_fir", route="cuda", source="wavecap_tpu_torch/kernels/csrc/voice_fir.cu",
        replaces="wavecap_tpu/ops/fir.py:187 (+ ops/clip.py:17-38, models/channel_bank.py:109)",
        max_abs_err=float(np.max(np.abs(a_k - a_p))), worst_open_snr_db=worst,
        ms=timer(lambda: cb.voice_fir(fm, tail, rssi, assign4, bank), "voice_fir_kernel"),
        wrapper_ms=wall_timer(lambda: cb.voice_fir(fm, tail, rssi, assign4, bank)),
        plain_ms=timer(lambda: cb.voice_fir_plain(fm, tail, rssi, assign4, bank)),
        bound_ms=b, bound_by=f,
        # yardstick: cuDNN's conv1d of the same FIR (TF32 off), no epilogue
        library_ms=timer(lambda: F.conv1d(xin, kern)),
    ))
    return results


def other_geometry_checks(device) -> list[dict]:
    """K1 on complex input and K2 at other M than the slice's: 80 = 8 x 10
    (1 Msps / 12.5 kHz) and 38, which does not factor and runs 1 x 38."""
    import torch

    from wavecap_tpu_torch.ops import channelizer as chz

    rng = np.random.default_rng(SEED + 1)
    results = []
    for fs in (1_000_000.0, 475_000.0):
        ch = chz.ChannelizerConfig(sample_rate=fs, channel_bandwidth=12_500.0, dft_impl="matmul")
        m, t = ch.channel_count, ch.taps_per_channel
        n = m * 301
        x = torch.from_numpy((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                             .astype(np.complex64)).to(device)
        hist = torch.from_numpy((rng.standard_normal(m * t) + 1j * rng.standard_normal(m * t))
                                .astype(np.complex64)).to(device)
        _, u_k = chz.unpack_arms(x, hist, ch)
        _, u_p = chz.unpack_arms_plain(x, hist, ch)
        err_u = rel_l2(host(u_p), host(u_k))
        err_y = rel_l2(host(chz.arm_dft_plain(u_p, ch)), host(chz.arm_dft(u_p, ch)))
        check(err_u <= 1e-6, f"K1 (complex input, M={m}) rel L2 {err_u:.3g} > 1e-6")
        check(err_y <= 1e-5, f"K2 (M={m}, factors {chz._k2_factors(m)}) rel L2 {err_y:.3g} > 1e-5")
        results.append(dict(phase="geometry", channels=m, factors=list(chz._k2_factors(m)),
                            k1_complex_rel_l2=err_u, k2_rel_l2=err_y))
    return results


# --- phase 3: the slice at full width ----------------------------------------


def station_scene(cfg):
    from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation

    ch = cfg.channelizer()
    stations = [
        FakeStation(offset_hz=ch.channel_offset_hz(b) + fine, kind="nbfm",
                    tone_hz=1000.0, deviation_hz=4000.0, amplitude=0.1)
        for b, fine in STATIONS
    ]
    device = FakeDriver(1, stations).open("fake0")
    device.configure(DeviceConfig(sample_rate=cfg.sample_rate))
    return device.start_stream()


def slice_control(cfg, device):
    import torch

    from wavecap_tpu_torch.capture.pipeline import control_init

    m = cfg.channelizer().channel_count
    c = cfg.narrow_capacity
    index = np.arange(c, dtype=np.int32) % m
    fine = np.zeros(c, np.float32)
    for b, f in STATIONS:
        fine[b] = f
    ctl = control_init(cfg, device=device)
    bank = ctl.banks[MODE]._replace(
        channel_index=torch.from_numpy(index).to(device),
        fine_offset_hz=torch.from_numpy(fine).to(device),
        active=torch.ones(c, dtype=torch.bool, device=device),
        squelch_db=torch.full((c,), SQUELCH_DB, dtype=torch.float32, device=device),
    )
    return ctl._replace(banks={MODE: bank})


def plain_capture_step(words, state, ctl, cfg):
    """The same capture step with every kernel swapped for its plain
    version (the reference for the first block)."""
    from wavecap_tpu_torch.capture.pipeline import capture_step
    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.ops import channelizer as chz

    with mock.patch.object(chz, "unpack_arms", chz.unpack_arms_plain), \
            mock.patch.object(chz, "arm_dft", chz.arm_dft_plain), \
            mock.patch.object(cb, "slot_frontend", cb.slot_frontend_plain), \
            mock.patch.object(cb, "voice_fir", cb.voice_fir_plain):
        return capture_step(words, state, ctl, cfg)


def tone_margin_db(audio: np.ndarray, rate: float, tone: float = 1000.0) -> float:
    """dB of the tone's line above the strongest other bin of the spectrum."""
    win = np.hanning(len(audio))
    p = np.abs(np.fft.rfft(audio * win)) ** 2
    f = np.fft.rfftfreq(len(audio), 1.0 / rate)
    near = np.abs(f - tone) <= 100.0
    return float(10 * np.log10(p[near].max() / max(p[~near].max(), 1e-30)))


def run_slice(cfg, device, sync=None) -> dict:
    import torch

    from wavecap_tpu_torch.capture.engine import pack_i16_words
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init, unpack_wire
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    sync = sync or torch.cuda.synchronize
    ch = cfg.channelizer()
    m = ch.channel_count
    stream = station_scene(cfg)
    blocks = [stream.read(cfg.block_size)[0] for _ in range(N_BLOCKS)]
    words_np = pack_i16_words(blocks)
    ctl = slice_control(cfg, device)
    state0 = pipeline_init(cfg, device=device)

    reset_launch_counts()
    t0 = time.perf_counter()
    words = torch.from_numpy(words_np).to(device)
    outs, _ = capture_multi(words, state0, ctl, cfg)
    packed = host(outs["_packed"])
    sync()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    meta = {k: v for k, v in outs.items() if k != "_packed"}
    wire = unpack_wire(meta, packed)

    audio_dev = host(outs["banks"][MODE]["audio"])
    audio = wire["banks"][MODE]["audio"]  # (blocks, slots, S)
    check(audio.shape == (N_BLOCKS, cfg.narrow_capacity, 2 * cfg.block_size // m), "audio shape")
    check(np.isfinite(audio).all() and np.isfinite(wire["spectrum"]).all(), "non-finite output")
    lsb = float(np.max(np.abs(audio - audio_dev)))
    check(lsb <= 1.0 / 32767 + 1e-7, f"unpacked wire audio off by {lsb:.3g} > 1 LSB")

    rssi = wire["banks"][MODE]["rssi"]
    station_bins = [b for b, _ in STATIONS]
    margins = {}
    for b in station_bins:
        row = audio[1:, b].ravel()  # blocks after the first: carries settled
        margins[b] = tone_margin_db(row, ch.channel_rate)
        check(margins[b] >= 20.0, f"station bin {b}: 1 kHz line only {margins[b]:.1f} dB up")
    near = {(b + d) % m for b in station_bins for d in (-1, 0, 1)}
    empty = [i for i in range(cfg.narrow_capacity) if i % m not in near]
    check(not audio[:, empty].any(), "an empty slot's squelch opened")
    check(rssi[:, empty].max() < SQUELCH_DB, "an empty slot's RSSI is above the squelch")
    expected = {name: N_BLOCKS for name in counts}
    check(counts == expected, f"launch counts {counts} != one per block {expected}")

    # first block against the plain path on the card
    reset_launch_counts()
    out_p, _ = plain_capture_step(words[0], pipeline_init(cfg, device=device), ctl, cfg)
    check(sum(launch_counts().values()) == 0, "the plain path launched a kernel")
    a_p = host(out_p["banks"][MODE]["audio"])
    a_k = audio_dev[0]
    worst = min(snr_db(a_p[b], a_k[b]) for b in station_bins)
    check(worst >= 60.0, f"first block audio SNR {worst:.1f} dB < 60 against the plain path")
    check(not a_p[empty].any(), "the plain path opened an empty slot")
    d_rssi = float(np.max(np.abs(host(out_p["banks"][MODE]["rssi"]) - rssi[0])))
    check(d_rssi <= 1e-3, f"first block slot RSSI differs by {d_rssi:.3g} dB")
    spec_p = host(out_p["spectrum"])
    strong = spec_p >= spec_p.max() - 60.0
    d_spec = float(np.max(np.abs(spec_p - wire["spectrum"][0])[strong]))
    check(d_spec <= 0.05, f"first block spectrum differs by {d_spec:.3g} dB")

    # warm time per block: resident words, output fetched to the host
    def one_pass():
        o, _ = capture_multi(words, pipeline_init(cfg, device=device), ctl, cfg)
        host(o["_packed"])

    one_pass()
    sync()
    t0 = time.perf_counter()
    one_pass()
    sync()
    ms_block = (time.perf_counter() - t0) * 1e3 / N_BLOCKS
    return dict(
        phase="slice", blocks=N_BLOCKS, block_size=cfg.block_size, channels=m,
        slots=cfg.narrow_capacity, launches=counts, first_run_s=first_s,
        warm_ms_per_block=ms_block, msps=cfg.block_size / ms_block / 1e3,
        tone_margin_db={str(k): v for k, v in margins.items()},
        station_rssi_dbfs=[float(rssi[0, b]) for b in station_bins],
        empty_rssi_max_dbfs=float(rssi[:, empty].max()),
        first_block_audio_snr_db=worst, first_block_rssi_max_abs_db=d_rssi,
        first_block_spectrum_max_abs_db=d_spec, wire_audio_max_abs=lsb,
    )


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from wavecap_tpu_torch.kernels import build_all, launch_counts
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    card = card_line()
    log(card)
    log(dict(phase="identity", torch=torch.__version__, cuda=torch.version.cuda,
             device=torch.cuda.get_device_name(0), count=torch.cuda.device_count()))

    t0 = time.perf_counter()
    reports = build_all()
    log(dict(phase="build", seconds=time.perf_counter() - t0, compiled=sorted(reports)))
    for stem, text in sorted(reports.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {stem}: {line.strip()}")

    cfg = slice_config()
    try:
        kernels = kernel_checks(cfg, device)
        for k in kernels:
            log(dict(phase="kernel", **k))
        for g in other_geometry_checks(device):
            log(g)
        sl = run_slice(cfg, device)
        log(sl)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        k["launches"] = sl["launches"][k["name"]]
    check_names = set(launch_counts())
    if {k["name"] for k in kernels} != check_names:
        print("chip_smoke: FAILED: a kernel was not checked", file=sys.stderr)
        return 1
    log({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
