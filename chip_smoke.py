#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``wavecap_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It drives the port's two paths at full width (10 Msps, 12.5 kHz
channels: M = 800, 1,968,000-sample blocks):

* the 800-channel NBFM capture of the first slice (i16 words -> K1 unpack
  + polyphase arms -> K2 cross-arm DFT -> K3 slot front end -> K4 voice
  FIR -> wire buffer), audio at the 25 kHz channel rate;
* the mixed-analog capture at the server's default channel settings:
  five banks of 160 slots (``am``, ``lsb``, ``nbfm``, ``sam``, ``usb``, one
  slot per channelizer bin) with 48 kHz audio, K3 -> the mode's detector
  (K10 for SAM) -> K5 resampler -> K9 IIR filters and AGC, plus one group
  of 2 WBFM wide slots (K7 shift and decimate -> discriminator -> K5 -> K9
  deemphasis and MPX low-pass).

Phases:

0. identity: the card's name and power limit, torch and CUDA versions;
1. build: every kernel from ``wavecap_tpu_torch/kernels/csrc`` with nvcc;
2. kernel checks: each kernel against its plain PyTorch version on the
   card, at the paths' shapes, with inputs from a numpy seed; the
   kernel's, the plain version's and the yardstick library call's time on
   the card (CUPTI, through torch.profiler) beside the kernel's bound, and
   the wrapper's wall time between CUDA events; then K1 on complex input
   and K2 at M = 80 and M = 38 (unfactorable) against their plain versions;
3. the first slice: a fake 10 Msps receiver with NBFM stations on known
   bins, 8 consecutive blocks through ``pack_i16_words`` -> upload ->
   ``capture_multi`` (800 active slots) -> ``unpack_wire``: each station's
   1 kHz tone, the squelch of empty slots, one launch of each of K1-K4
   per block, and the first block against the plain path on the card;
4. the mixed-analog capture: two stations per narrow mode and one WBFM
   station, 8 blocks the same way: every station's 1 kHz tone, the
   squelch of empty slots, the launch count of each kernel that the
   configuration implies, the first two blocks against the plain path on
   the card, the wire within 1 LSB; warm ms per block;
5. a JSON line of the kernels and the final ``{"ok": true, ...}`` line.

Any failed check exits non-zero before the last line.  Without a CUDA
card, or outside the repository, it exits non-zero and prints no result.
It imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
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
FMA_CYCLES = 4  # latency of a dependent f32 multiply-add on Hopper, in SM cycles

# --- the mixed-analog capture (phase 4) ---
MIXED_MODES = ("am", "lsb", "nbfm", "sam", "usb")  # engine._narrow_modes(), sorted
MIXED_CAPACITY = 160  # five banks x 160 slots = one slot per bin; bank k takes 160k..160k+159
# bank -> (FakeStation kind, carrier offset from the bin centre Hz): every
# detector hears a 1 kHz tone (USB/LSB: the +-1.5 kHz BFO moves the carrier
# to 1 kHz)
MIXED_KINDS = {"am": ("am", 0.0), "lsb": ("carrier", 500.0), "nbfm": ("nbfm", 0.0),
               "sam": ("am", 0.0), "usb": ("carrier", -500.0)}
MIXED_STATION_SLOTS = (17, 101)  # slots (= bins within the bank) with a station
MIXED_AMPLITUDE = 0.05  # 11 stations: the sum stays inside the i16 range
WIDE_OFFSETS = (700_000.0, -1_200_000.0)  # the WBFM station (bin 56); empty spectrum
WIDE_CLEAR_BINS = range(44, 69)  # narrow bins the WBFM station's +-150 kHz covers
# kernel launches per block of the mixed capture, one bank per mode and one
# wide group: K3 and K5 once per bank, K5 and K7 once per wide group; K9 per
# bank: nbfm high- and low-pass 2, am and sam high-pass, low-pass and AGC
# envelope 3 each, usb and lsb band-pass and envelope 2 each; per wide group
# deemphasis and MPX low-pass 2; K10 once for the sam bank
MIXED_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 5,
                  "K4_voice_fir": 0, "K5_resample_poly": 5 + 1, "K7_strided_fir": 1,
                  "K9_iir_cascade": 2 + 3 + 3 + 2 + 2 + 2, "K10_pll": 1}


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


def device_ms(fn, kernel: str = "", reps: int = 20, warm: int = 3) -> float:
    """Warm mean time on the card of one call: the kernels and copies it
    ran (only those whose name holds ``kernel``, when given), as CUPTI
    traced them through torch.profiler, without the host's gaps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warm):
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


def sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), for the serial-chain bounds."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


@contextlib.contextmanager
def plain_kernels():
    """Every kernel wrapper swapped for its plain version (the reference
    path on the card)."""
    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.ops import agc, channelizer as chz, fir, iir, pll

    with contextlib.ExitStack() as stack:
        for module, name, plain in (
            (chz, "unpack_arms", chz.unpack_arms_plain), (chz, "arm_dft", chz.arm_dft_plain),
            (cb, "slot_frontend", cb.slot_frontend_plain), (cb, "voice_fir", cb.voice_fir_plain),
            (fir, "polyphase_resample", fir.polyphase_resample_plain),
            (fir, "strided_fir", fir.strided_fir_plain),
            (iir, "sos_filter", iir.sos_filter_plain), (iir, "onepole_filter", iir.onepole_filter_plain),
            (agc, "envelope", agc.envelope_plain), (pll, "_loop", pll._loop_plain),
        ):
            stack.enter_context(mock.patch.object(module, name, plain))
        yield


def plain_call(fn):
    def call():
        with plain_kernels():
            return fn()
    return call


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
    version (the reference for the first blocks)."""
    from wavecap_tpu_torch.capture.pipeline import capture_step

    with plain_kernels():
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
    path = ("K1_unpack_arms", "K2_arm_dft", "K3_slot_frontend", "K4_voice_fir")
    expected = {name: N_BLOCKS if name in path else 0 for name in counts}
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


# --- phase 2, continued: the mixed capture's kernels -----------------------------


def mixed_config():
    from wavecap_tpu_torch.capture.pipeline import CapturePipelineConfig

    return CapturePipelineConfig(
        sample_rate=10_000_000,
        block_size=1_968_000,
        narrow_modes=MIXED_MODES,
        narrow_capacity=MIXED_CAPACITY,
        channel_bandwidth=12_500.0,
        audio_rate=48_000,
        fft_size=2048,
        spectrum_frames=2,
        wide_capacity=2,
        wide_groups=((),),
    )


def chain_ms(steps: float, cycles_per_step: float, clock_hz: float) -> float:
    """A serial dependency chain's least time: steps x cycles at the clock."""
    return steps * cycles_per_step / clock_hz * 1e3


def mixed_kernel_checks(cfg, device, timer=device_ms, wall_timer=time_ms, clock_hz=None):
    """K3's exact discriminator and row output, K5, K7, K9 and K10 against
    their plain versions at the mixed capture's shapes.  Returns
    ``(lines, cases)``: one line per kernel for the kernels record (the
    case the mixed capture runs most) and every case checked."""
    import torch
    import torch.nn.functional as F
    from scipy import signal as sps

    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.models.channel_bank import ChannelAssignment
    from wavecap_tpu_torch.ops import agc, fir, iir, pll
    from wavecap_tpu_torch.ops.nco import tuning_word

    clock_hz = clock_hz or sm_clock_hz()
    rng = np.random.default_rng(SEED + 2)
    ch = cfg.channelizer()
    m, n = ch.channel_count, cfg.block_size
    s = 2 * n // m
    c = cfg.narrow_capacity
    ar = cfg.audio_rate
    lines, cases = {}, []

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def record(name, case, source, replaces, lib, **k):
        k.update(name=name, case=case, route="cuda", source=source, replaces=replaces,
                 library_ms=lib)
        cases.append(k)
        if name not in lines:  # the first case of a kernel is its line
            lines[name] = k

    # K3: the exact discriminator (the default NBFM bank) and the rows
    chans = dev(fm_rows(rng, m, s, ch.channel_rate))
    assign = ChannelAssignment(
        channel_index=dev(rng.permutation(m)[:c].astype(np.int32)),
        fine_offset_hz=dev(rng.uniform(-1500.0, 1500.0, c).astype(np.float32)),
        active=dev(np.ones(c, bool)), squelch_db=dev(np.full(c, -1e9, np.float32)),
    )
    phase0 = dev(rng.integers(0, 2**32, c, dtype=np.uint64).astype(np.uint32))
    prev = dev(np.exp(1j * rng.uniform(-np.pi, np.pi, c)).astype(np.complex64) * 0.3)
    for mode in ("nbfm", "am"):
        bank = cfg.bank_cfg(mode)
        k_out = [host(v) for v in cb.slot_frontend(chans, assign, phase0, prev, bank)]
        p_out = [host(v) for v in cb.slot_frontend_plain(chans, assign, phase0, prev, bank)]
        check(np.array_equal(k_out[2], p_out[2]), f"K3 ({mode}) NCO phases are not bit-exact")
        d_rssi = float(np.max(np.abs(k_out[1] - p_out[1])))
        check(d_rssi <= 1e-3, f"K3 ({mode}) RSSI differs by {d_rssi:.3g} dB > 1e-3")
        if mode == "nbfm":
            err = snr_db(p_out[0], k_out[0])
            # atan2f against torch's atan2 on the same products: a few ulp
            check(err >= 80.0, f"K3 exact discriminator SNR {err:.1f} dB < 80")
            check(rel_l2(p_out[3], k_out[3]) <= 1e-5, "K3 last sample differs")
            b, f = bound(c * s * 8 + c * s * 4 + c * 36, 40.0 * c * s)
            extra = dict(fm_snr_db=err, case_note="exact atan2f (mode 0), never run by the first slice")
        else:
            err = rel_l2(p_out[0], k_out[0])
            # the same f32 mix on both sides; cos/sin and the product may differ by an ulp
            check(err <= 1e-6, f"K3 shifted rows rel L2 {err:.3g} > 1e-6")
            b, f = bound(c * s * 8 * 2 + c * 24, 16.0 * c * s)
            extra = dict(rows_rel_l2=err, case_note="complex-row output (mode 2) for am/ssb/sam")
        cases.append(dict(
            name="K3_slot_frontend", case=f"{mode} bank", max_abs_err=max_abs(p_out[0], k_out[0]),
            rssi_max_abs_db=d_rssi, bound_ms=b, bound_by=f,
            ms=timer(lambda: cb.slot_frontend(chans, assign, phase0, prev, bank), "slot_frontend_kernel"),
            wrapper_ms=wall_timer(lambda: cb.slot_frontend(chans, assign, phase0, prev, bank)),
            plain_ms=timer(lambda: cb.slot_frontend_plain(chans, assign, phase0, prev, bank)),
            library_ms=None, **extra,
        ))

    k5_src, k5_rep = ("wavecap_tpu_torch/kernels/csrc/resample_poly.cu",
                      "wavecap_tpu/ops/fir.py:285 resample_poly_stream (+ :331 resample_poly)")
    wide = cfg.wide_cfg()
    if_rate = wide.if_rate
    n_if = n // wide.decim
    # K5: narrow one-shot 48/25 at (800, S), wide one-shot at (2, n_if),
    # streaming 24/25 at (96, 10000) over 3 blocks (the engine's default
    # 2.4 Msps / 25 kHz geometry)
    for case, rows, n_in, rate_in in (("narrow one-shot", m, s, int(ch.channel_rate)),
                                      ("wide one-shot", 2, n_if, if_rate)):
        x = dev(rng.standard_normal((rows, n_in)).astype(np.float32))
        y_k = host(fir.resample_poly(x, rate_in, ar))
        y_p = host(plain_call(lambda: fir.resample_poly(x, rate_in, ar))())
        err = rel_l2(y_p, y_k)
        check(err <= 1e-5, f"K5 {case} rel L2 {err:.3g} > 1e-5")
        up, down, taps = fir._resample_plan(rate_in, ar)
        ph_len = -(-len(taps) // up)
        n_out = y_k.shape[-1]
        used_rows = len(np.unique(((len(taps) - 1) // 2 + np.arange(n_out, dtype=np.int64) * down) % up))
        b, f = bound(rows * n_in * 4 + rows * n_out * 4 + used_rows * ph_len * 4,
                     2.0 * rows * n_out * ph_len)
        record("K5_resample_poly", f"{case} {up}/{down} ({rows}, {n_in}) -> ({rows}, {n_out})",
               k5_src, k5_rep, None, max_abs_err=max_abs(y_p, y_k), rel_l2=err,
               ms=timer(lambda: fir.resample_poly(x, rate_in, ar), "resample_poly_kernel"),
               wrapper_ms=wall_timer(lambda: fir.resample_poly(x, rate_in, ar)),
               plain_ms=timer(plain_call(lambda: fir.resample_poly(x, rate_in, ar))),
               bound_ms=b, bound_by=f,
               library_note="no single PyTorch call computes a rational resample with up > 1")
    x3 = dev(rng.standard_normal((3, 96, 10_000)).astype(np.float32))
    tail_k = tail_p = fir.resample_stream_init(50_000, 48_000, device=device).expand(96, -1)
    errs = []
    for k in range(3):
        y_k, tail_k = fir.resample_poly_stream(x3[k], 50_000, 48_000, tail_k)
        with plain_kernels():
            y_p, tail_p = fir.resample_poly_stream(x3[k], 50_000, 48_000, tail_p)
        errs.append(rel_l2(host(y_p), host(y_k)))
        check(torch.equal(tail_k, tail_p), "K5 streaming tail differs")
    check(max(errs) <= 1e-5, f"K5 streaming rel L2 {max(errs):.3g} > 1e-5")
    up, down, taps = fir._resample_plan(50_000, 48_000)
    ph_len = -(-len(taps) // up)
    n_out = 10_000 * up // down
    b, f = bound(96 * (10_000 + 2 * (ph_len - 1) + n_out) * 4 + up * ph_len * 4,
                 2.0 * 96 * n_out * ph_len)

    def k5_stream():
        return fir.resample_poly_stream(x3[0], 50_000, 48_000, tail_k)

    cases.append(dict(name="K5_resample_poly", case="streaming 24/25 (96, 10000) x 3 blocks",
                      rel_l2=max(errs), bound_ms=b, bound_by=f,
                      ms=timer(k5_stream, "resample_poly_kernel"), wrapper_ms=wall_timer(k5_stream),
                      plain_ms=timer(plain_call(k5_stream)), library_ms=None))

    # K7: the wide slots' shift and decimate; resample_poly_stream's up == 1
    k7_src, k7_rep = ("wavecap_tpu_torch/kernels/csrc/strided_fir.cu",
                      "wavecap_tpu/ops/fir.py:52 _conv_valid_direct, :202 fir_decimate "
                      "(+ ops/nco.py:51 in capture/pipeline.py:415-416)")
    from wavecap_tpu_torch.capture.pipeline import _wide_taps_on

    taps = _wide_taps_on(wide, device)
    t_len = taps.shape[0]
    xw = dev((rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64) * 0.1)
    head = dev((rng.standard_normal((2, t_len - 1)) + 1j * rng.standard_normal((2, t_len - 1)))
               .astype(np.complex64) * 0.1)
    dphi = tuning_word(-dev(np.array(WIDE_OFFSETS, np.float32)), cfg.sample_rate)
    p0 = dev(rng.integers(0, 2**32, 2, dtype=np.uint64).astype(np.uint32))

    def k7_wide():
        return fir.strided_fir(xw, taps, wide.decim, head=head, nco=(dphi, p0))

    out_k = [host(v) for v in k7_wide()]
    out_p = [host(v) for v in fir.strided_fir_plain(xw, taps, wide.decim, head, (dphi, p0))]
    err = rel_l2(out_p[0], out_k[0])
    check(err <= 1e-5, f"K7 wide rel L2 {err:.3g} > 1e-5")
    check(rel_l2(out_p[1], out_k[1]) <= 1e-6, "K7 wide tail differs")
    check(np.array_equal(out_p[2], out_k[2]), "K7 NCO phases are not bit-exact")
    n_out = out_k[0].shape[-1]
    # the input read once, the heads, outputs and tails; per input sample and
    # slot the NCO (3), cos and sin (2) and the mix (6), per output tap 4
    b, f = bound(n * 8 + 2 * (t_len - 1) * 8 * 2 + t_len * 4 + 2 * n_out * 8,
                 2.0 * n * 11 + 2.0 * n_out * t_len * 4)
    mixed = host(fir.strided_fir_plain(xw, taps, 1, None, (dphi, p0))[0])
    planes = dev(np.concatenate([np.concatenate([host(head), mixed], -1).real,
                                 np.concatenate([host(head), mixed], -1).imag]).astype(np.float32))
    kern = taps.flip(0).reshape(1, 1, -1)
    record("K7_strided_fir", f"wide: NCO + decimate by {wide.decim}, {t_len} taps, 2 x {n} complex",
           k7_src, k7_rep,
           # yardstick: cuDNN's strided conv1d of the four mixed planes (TF32 off), no NCO
           timer(lambda: F.conv1d(planes.unsqueeze(1), kern, stride=wide.decim)),
           max_abs_err=max_abs(out_p[0], out_k[0]), rel_l2=err,
           ms=timer(k7_wide, "strided_fir_kernel"), wrapper_ms=wall_timer(k7_wide),
           plain_ms=timer(lambda: fir.strided_fir_plain(xw, taps, wide.decim, head, (dphi, p0))),
           bound_ms=b, bound_by=f)
    x5 = dev(rng.standard_normal((2, 48_000)).astype(np.float32))
    tail5 = dev(rng.standard_normal((2, 100)).astype(np.float32))
    y_k, t_k = fir.resample_poly_stream(x5, 240_000, 48_000, tail5)
    with plain_kernels():
        y_p, t_p = fir.resample_poly_stream(x5, 240_000, 48_000, tail5)
    err = rel_l2(host(y_p), host(y_k))
    check(err <= 1e-5 and torch.equal(t_k, t_p), f"K7 stride-5 rel L2 {err:.3g} > 1e-5")
    taps5 = fir._resample_taps(1, 5, device)
    b, f = bound(2 * 48_000 * 4 + 2 * 100 * 4 * 2 + 101 * 4 + 2 * 9600 * 4, 2.0 * 2 * 9600 * 101)
    xin5 = torch.cat([tail5, x5], -1).unsqueeze(1)
    cases.append(dict(
        name="K7_strided_fir", case="up == 1: 1/5, 101 taps, (2, 48000) real", rel_l2=err,
        max_abs_err=max_abs(host(y_p), host(y_k)), bound_ms=b, bound_by=f,
        ms=timer(lambda: fir.resample_poly_stream(x5, 240_000, 48_000, tail5), "strided_fir_kernel"),
        wrapper_ms=wall_timer(lambda: fir.resample_poly_stream(x5, 240_000, 48_000, tail5)),
        plain_ms=timer(plain_call(lambda: fir.resample_poly_stream(x5, 240_000, 48_000, tail5))),
        library_ms=timer(lambda: F.conv1d(xin5, taps5.flip(0).reshape(1, 1, -1), stride=5)),
    ))

    # K9: the mixed capture's cascades at their shapes
    k9_src, k9_rep = ("wavecap_tpu_torch/kernels/csrc/iir_cascade.cu",
                      "wavecap_tpu/ops/iir.py:88 _biquad_scan / :130 sos_filter, :40 onepole_filter "
                      "(+ ops/agc.py:38 envelope)")
    n_audio = -(-s * 48 // 25)
    tt = np.arange(2 * n_audio) / ar
    tone = np.sin(2 * np.pi * rng.uniform(200, 4000, (c, 1)) * tt)
    # a tone per row in noise; the first half only sets each cascade's
    # carried state (float64 scipy, cast to f32 as a block boundary leaves it)
    both = (0.3 * tone + 0.05 * rng.standard_normal((c, 2 * n_audio))).astype(np.float32)
    prev_np, xa_np = both[:, :n_audio], both[:, n_audio:]
    xa = dev(xa_np)
    xw2 = xa[:2].contiguous()

    def carried(sos, rows):
        zi = np.zeros((sos.shape[0], rows, 2))
        zf = sps.sosfilt(sos, prev_np[:rows].astype(np.float64), axis=-1, zi=zi)[1]
        return dev(zf.transpose(1, 0, 2).astype(np.float32))
    k9_cases = [
        ("nbfm high-pass 300 Hz", xa, iir.butter_sos("high", (300.0,), 5, ar)),
        ("nbfm low-pass 3 kHz", xa, iir.butter_sos("low", (3000.0,), 5, ar)),
        ("am/sam high-pass 100 Hz", xa, iir.butter_sos("high", (100.0,), 5, ar)),
        ("ssb band-pass 300-3000 Hz", xa, iir.butter_sos("band", (300.0, 3000.0), 5, ar)),
        ("notch 1 kHz", xa, iir.notch_sos(1000.0, 30.0, ar)),
        ("wide MPX low-pass 15 kHz", xw2, iir.butter_sos("low", (15000.0,), 5, ar)),
    ]
    for case, x, sos in k9_cases:
        rows, n_sec = x.shape[0], sos.shape[0]
        z0 = carried(sos, rows)
        y_k, z_k = (host(v) for v in iir.sos_filter(x, sos, z0))
        y_p, _ = (host(v) for v in iir.sos_filter_plain(x, sos, z0))
        err = snr_db(y_p, y_k)
        check(err >= 50.0, f"K9 {case}: {err:.1f} dB < 50 against the plain scan")
        xs = host(x)[:4].astype(np.float64)
        ref64 = np.stack([sps.sosfilt(sos, xs[i], zi=host(z0)[i].astype(np.float64))[0] for i in range(len(xs))])
        err64 = snr_db(ref64, y_k[:4])
        check(err64 >= 55.0, f"K9 {case}: {err64:.1f} dB < 55 against float64 scipy")
        b, f = bound(2 * rows * n_audio * 4 + 2 * rows * n_sec * 8 + n_sec * 20, 10.0 * rows * n_audio * n_sec)
        record("K9_iir_cascade", f"{case}: {n_sec} sections, ({rows}, {n_audio})", k9_src, k9_rep,
               None, max_abs_err=float(np.max(np.abs(y_k - y_p))), snr_vs_plain_db=err,
               snr_vs_float64_db=err64, bound_ms=b, bound_by=f,
               chain_ms=chain_ms(n_audio * n_sec, FMA_CYCLES, clock_hz),
               ms=timer(lambda: iir.sos_filter(x, sos, z0), "iir_cascade_kernel"),
               wrapper_ms=wall_timer(lambda: iir.sos_filter(x, sos, z0)),
               plain_ms=timer(lambda: iir.sos_filter_plain(x, sos, z0)),
               library_note="no torch op runs an IIR recurrence")
    b0, a = iir.deemphasis_coeffs(ar)
    y0 = dev(np.array([0.1, -0.2], np.float32))
    y_k, l_k = (host(v) for v in iir.onepole_filter(xw2, b0, a, y0))
    y_p, _ = (host(v) for v in iir.onepole_filter_plain(xw2, b0, a, y0))
    ref64 = np.stack([sps.lfilter([b0], [1.0, -a], host(xw2)[i].astype(np.float64),
                                  zi=[a * host(y0)[i]])[0] for i in range(2)])
    err, err64 = snr_db(y_p, y_k), snr_db(ref64, y_k)
    check(err >= 50.0 and err64 >= 70.0, f"K9 deemphasis: {err:.1f} / {err64:.1f} dB")
    b, f = bound(2 * 2 * n_audio * 4 + 2 * 2 * 4, 2.0 * 2 * n_audio * 2)
    cases.append(dict(name="K9_iir_cascade", case="deemphasis 75 us one-pole, (2, %d)" % n_audio,
                      snr_vs_plain_db=err, snr_vs_float64_db=err64,
                      max_abs_err=float(np.max(np.abs(y_k - y_p))), bound_ms=b, bound_by=f,
                      ms=timer(lambda: iir.onepole_filter(xw2, b0, a, y0), "iir_cascade_kernel"),
                      wrapper_ms=wall_timer(lambda: iir.onepole_filter(xw2, b0, a, y0)),
                      plain_ms=timer(lambda: iir.onepole_filter_plain(xw2, b0, a, y0)),
                      library_ms=None, chain_ms=chain_ms(n_audio, FMA_CYCLES, clock_hz)))
    ca, cr = agc._coef(5.0, ar), agc._coef(50.0, ar)
    st = agc.AgcState(dev(np.full(c, 0.1, np.float32)), dev(np.full(c, 0.2, np.float32)))
    e_k, s_k = agc.envelope(xa, ca, cr, st)
    e_p, s_p = agc.envelope_plain(xa, ca, cr, st)
    err = snr_db(host(e_p), host(e_k))
    check(err >= 50.0, f"K9 AGC envelope: {err:.1f} dB < 50 against the plain scans")
    check(float(torch.max(torch.abs(s_k.env_release - s_p.env_release))) <= 1e-4, "K9 AGC carry differs")
    # |x|, two one-poles (2 each) and the max per sample
    b, f = bound(2 * c * n_audio * 4 + 4 * c * 4, 6.0 * c * n_audio)
    cases.append(dict(name="K9_iir_cascade", case=f"AGC envelope, two one-poles + max, ({c}, {n_audio})",
                      snr_vs_plain_db=err, max_abs_err=float(torch.max(torch.abs(e_k - e_p))),
                      bound_ms=b, bound_by=f,
                      ms=timer(lambda: agc.envelope(xa, ca, cr, st), "iir_cascade_kernel"),
                      wrapper_ms=wall_timer(lambda: agc.envelope(xa, ca, cr, st)),
                      plain_ms=timer(lambda: agc.envelope_plain(xa, ca, cr, st)),
                      library_ms=None, chain_ms=chain_ms(2 * n_audio, FMA_CYCLES, clock_hz)))

    # K10: SAM's carrier PLL and the Costas loop at (160, S)
    k10_src, k10_rep = ("wavecap_tpu_torch/kernels/csrc/pll.cu",
                        "wavecap_tpu/ops/pll.py:36 carrier_recovery_pll, :70 costas_loop_qpsk")
    ts = np.arange(s) / ch.channel_rate
    f_off = rng.uniform(-40, 40, (c, 1))
    am = 0.3 * (1 + 0.6 * np.sin(2 * np.pi * 1000 * ts)) * np.exp(1j * (2 * np.pi * f_off * ts + rng.uniform(-3, 3, (c, 1))))
    sym = rng.integers(0, 4, (c, s // 5 + 1)).repeat(5, axis=1)[:, :s]
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * sym + 2 * np.pi * f_off * ts))
    st0 = pll.PllState(dev(rng.uniform(-3, 3, c).astype(np.float32)), dev(np.zeros(c, np.float32)))
    alpha, beta = pll.pll_coeffs(50.0, ch.channel_rate)
    for case, sig, fn in (
        ("SAM carrier PLL", am, lambda z: pll.carrier_recovery_pll(z, ch.channel_rate, st0)),
        ("Costas QPSK", qpsk, lambda z: pll.costas_loop_qpsk(z, st0, alpha, beta)),
    ):
        z = dev((sig + 1e-3 * (rng.standard_normal((c, s)) + 1j * rng.standard_normal((c, s))))
                .astype(np.complex64))
        o_k, st_k = fn(z)
        with plain_kernels():
            o_p, st_p = fn(z)
        o_k, o_p = host(o_k), host(o_p)
        err = min(snr_db(o_p.real, o_k.real), snr_db(o_p.imag, o_k.imag))
        d_ph = float(np.max(np.abs(np.angle(np.exp(1j * (host(st_k.phase) - host(st_p.phase)))))))
        check(err >= 50.0, f"K10 {case}: coherent output {err:.1f} dB < 50")
        check(d_ph <= 1e-3, f"K10 {case}: final phase differs by {d_ph:.3g} rad")
        # per sample: cos, sin, the mix (6), the detector (~4), the loop (6)
        b, f = bound(2 * c * s * 8 + 4 * c * 4, 18.0 * c * s)
        record("K10_pll", f"{case} ({c}, {s})", k10_src, k10_rep, None,
               max_abs_err=float(np.max(np.abs(o_k - o_p))), coherent_snr_db=err,
               final_phase_max_abs_rad=d_ph, bound_ms=b, bound_by=f,
               # ~60 dependent f32 operations a step: cosf and sinf (range
               # reduction + polynomial) then the mix, atan2f, the loop
               chain_ms=chain_ms(s * 60, FMA_CYCLES, clock_hz),
               ms=timer(lambda: fn(z), "pll_kernel"), wrapper_ms=wall_timer(lambda: fn(z)),
               plain_ms=timer(plain_call(lambda: fn(z)), reps=1, warm=1),
               library_note="no torch op runs a phase-locked loop")
    return [lines[k] for k in ("K5_resample_poly", "K7_strided_fir", "K9_iir_cascade", "K10_pll")], cases


# --- phase 4: the mixed-analog capture at full width --------------------------------


def mixed_station_bins(cfg) -> dict:
    """bank -> the channelizer bins of its stations."""
    return {mode: [k * cfg.narrow_capacity + i for i in MIXED_STATION_SLOTS]
            for k, mode in enumerate(cfg.narrow_modes)}


def mixed_scene(cfg):
    from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation

    ch = cfg.channelizer()
    stations = []
    for mode, bins in mixed_station_bins(cfg).items():
        kind, carrier = MIXED_KINDS[mode]
        stations += [FakeStation(offset_hz=ch.channel_offset_hz(b) + carrier, kind=kind,
                                 tone_hz=1000.0, deviation_hz=4000.0, amplitude=MIXED_AMPLITUDE)
                     for b in bins]
    stations.append(FakeStation(offset_hz=WIDE_OFFSETS[0], kind="wbfm", tone_hz=1000.0,
                                deviation_hz=75_000.0, amplitude=MIXED_AMPLITUDE))
    device = FakeDriver(1, stations).open("fake0")
    device.configure(DeviceConfig(sample_rate=cfg.sample_rate))
    return device.start_stream()


def mixed_control(cfg, device):
    """Bank k's slot i on bin 160k + i, all active, squelch at SQUELCH_DB;
    wide slot 0 on the WBFM station, slot 1 on empty spectrum."""
    import torch

    from wavecap_tpu_torch.capture.pipeline import control_init

    c = cfg.narrow_capacity
    ctl = control_init(cfg, device=device)
    banks = {}
    for k, mode in enumerate(cfg.narrow_modes):
        banks[mode] = ctl.banks[mode]._replace(
            channel_index=torch.arange(k * c, (k + 1) * c, dtype=torch.int32, device=device),
            active=torch.ones(c, dtype=torch.bool, device=device),
            squelch_db=torch.full((c,), SQUELCH_DB, dtype=torch.float32, device=device),
        )
    g = cfg.wide_groups[0]
    wide = {g: ctl.wide[g]._replace(
        offset_hz=torch.tensor(WIDE_OFFSETS, dtype=torch.float32, device=device),
        active=torch.ones(2, dtype=torch.bool, device=device),
        squelch_db=torch.full((2,), SQUELCH_DB, dtype=torch.float32, device=device),
    )}
    return ctl._replace(banks=banks, wide=wide)


def run_mixed(cfg, device, sync=None) -> dict:
    import torch

    from wavecap_tpu_torch.capture.engine import pack_i16_words
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init, unpack_wire
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    sync = sync or torch.cuda.synchronize
    g = cfg.wide_groups[0]
    c = cfg.narrow_capacity
    stream = mixed_scene(cfg)
    blocks = [stream.read(cfg.block_size)[0] for _ in range(N_BLOCKS)]
    words_np = pack_i16_words(blocks)
    ctl = mixed_control(cfg, device)
    state0 = pipeline_init(cfg, device=device)

    reset_launch_counts()
    t0 = time.perf_counter()
    words = torch.from_numpy(words_np).to(device)
    outs, _ = capture_multi(words, state0, ctl, cfg)
    packed = host(outs["_packed"])
    sync()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    expected = {name: N_BLOCKS * MIXED_LAUNCHES[name] for name in counts}
    check(counts == expected, f"mixed launch counts {counts} != {expected}")
    meta = {k: v for k, v in outs.items() if k != "_packed"}
    wire = unpack_wire(meta, packed)

    n_audio = -(-2 * cfg.block_size // cfg.channelizer().channel_count * 48 // 25)
    lsb = 0.0
    for top, key in [("banks", mode) for mode in cfg.narrow_modes] + [("wide", g)]:
        dev_audio = host(outs[top][key]["audio"])
        audio = wire[top][key]["audio"]
        check(audio.shape[0] == N_BLOCKS and audio.shape[-1] == n_audio, f"{key} audio shape")
        check(np.isfinite(audio).all(), f"{key} audio not finite")
        # the wire clips at +-1 (AGC'd audio reaches 1.105, soft_clip's ceiling)
        lsb = max(lsb, float(np.max(np.abs(audio - np.clip(dev_audio, -1.0, 1.0)))))
    check(np.isfinite(wire["spectrum"]).all(), "non-finite spectrum")
    check(lsb <= 1.0 / 32767 + 1e-6, f"unpacked wire audio off by {lsb:.3g} > 1 LSB")

    station_bins = mixed_station_bins(cfg)
    all_station_bins = [b for bins in station_bins.values() for b in bins]
    margins = {}
    for k, mode in enumerate(cfg.narrow_modes):
        audio = wire["banks"][mode]["audio"]
        for b in station_bins[mode]:
            row = audio[2:, b - k * c].ravel()  # blocks 3-8: IIR, AGC and PLL carries settled
            margins[f"{mode}:{b}"] = tone_margin_db(row, cfg.audio_rate)
    margins["wbfm:0"] = tone_margin_db(wire["wide"][g]["audio"][2:, 0].ravel(), cfg.audio_rate)
    for key, v in margins.items():
        check(v >= 20.0, f"station {key}: 1 kHz line only {v:.1f} dB up")
    near = {b + d for b in all_station_bins for d in (-2, -1, 0, 1, 2)} | set(WIDE_CLEAR_BINS)
    empty_rssi = -1e9
    for k, mode in enumerate(cfg.narrow_modes):
        empty = [i for i in range(c) if k * c + i not in near]
        audio, rssi = wire["banks"][mode]["audio"], wire["banks"][mode]["rssi"]
        check(not audio[:, empty].any(), f"an empty {mode} slot's squelch opened")
        empty_rssi = max(empty_rssi, float(rssi[:, empty].max()))
    check(empty_rssi < SQUELCH_DB, "an empty slot's RSSI is above the squelch")
    check(not wire["wide"][g]["audio"][:, 1].any(), "the empty wide slot's squelch opened")

    # the first two blocks against the plain path on the card
    reset_launch_counts()
    st = pipeline_init(cfg, device=device)
    worst, d_rssi, d_spec = float("inf"), 0.0, 0.0
    for blk in range(2):
        out_p, st = plain_capture_step(words[blk], st, ctl, cfg)
        for k, mode in enumerate(cfg.narrow_modes):
            a_p = host(out_p["banks"][mode]["audio"])
            a_k = host(outs["banks"][mode]["audio"][blk])
            for b in station_bins[mode]:
                worst = min(worst, snr_db(a_p[b - k * c], a_k[b - k * c]))
            d_rssi = max(d_rssi, float(np.max(np.abs(host(out_p["banks"][mode]["rssi"])
                                                     - host(outs["banks"][mode]["rssi"][blk])))))
        worst = min(worst, snr_db(host(out_p["wide"][g]["audio"])[0], host(outs["wide"][g]["audio"][blk])[0]))
        d_rssi = max(d_rssi, float(np.max(np.abs(host(out_p["wide"][g]["rssi"])
                                                 - host(outs["wide"][g]["rssi"][blk])))))
        spec_p = host(out_p["spectrum"])
        strong = spec_p >= spec_p.max() - 60.0
        d_spec = max(d_spec, float(np.max(np.abs(spec_p - wire["spectrum"][blk])[strong])))
    check(sum(launch_counts().values()) == 0, "the plain path launched a kernel")
    check(worst >= 50.0, f"first blocks' audio SNR {worst:.1f} dB < 50 against the plain path")
    check(d_rssi <= 1e-3, f"first blocks' slot RSSI differs by {d_rssi:.3g} dB")
    check(d_spec <= 0.05, f"first blocks' spectrum differs by {d_spec:.3g} dB")

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
        phase="mixed", blocks=N_BLOCKS, block_size=cfg.block_size, modes=list(cfg.narrow_modes),
        slots_per_bank=c, wide_slots=cfg.wide_capacity, launches=counts, first_run_s=first_s,
        warm_ms_per_block=ms_block, msps=cfg.block_size / ms_block / 1e3,
        profile=profile_blocks(one_pass, N_BLOCKS, sync),
        tone_margin_db=margins, empty_rssi_max_dbfs=empty_rssi,
        wide_rssi_dbfs=[float(v) for v in wire["wide"][g]["rssi"][0]],
        first_blocks_audio_snr_db=worst, first_blocks_rssi_max_abs_db=d_rssi,
        first_blocks_spectrum_max_abs_db=d_spec, wire_audio_max_abs=lsb,
    )


def profile_blocks(one_pass, blocks: int, sync) -> dict:
    """One warm pass under torch.profiler, per block: traced wall ms, the
    card's busy ms (kernels and copies, CUPTI), its idle share, the host's
    CPU ms and the ops with the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        one_pass()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / blocks

    def dev_ms(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0) / 1e3 / blocks

    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_ms(e) for e in on_card)
    top = sorted(on_card, key=dev_ms, reverse=True)[:14]
    return dict(
        traced_wall_ms_per_block=wall_ms, device_busy_ms_per_block=busy,
        device_idle_share=1.0 - busy / wall_ms,
        host_self_cpu_ms_per_block=sum(e.self_cpu_time_total for e in events
                                       if e.device_type == DeviceType.CPU) / 1e3 / blocks,
        top_device_ms_per_block=[dict(op=e.key[:80], calls_per_block=e.count / blocks, ms=dev_ms(e))
                                 for e in top if dev_ms(e) > 0],
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
    mixed = mixed_config()
    try:
        kernels = kernel_checks(cfg, device)
        for k in kernels:
            log(dict(phase="kernel", **k))
        mixed_lines, cases = mixed_kernel_checks(mixed, device)
        for k in cases:
            log(dict(phase="kernel-case", **k))
        kernels += mixed_lines
        for g in other_geometry_checks(device):
            log(g)
        sl = run_slice(cfg, device)
        log(sl)
        mx = run_mixed(mixed, device)
        log(mx)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    for k in kernels:
        # each kernel's launches on its path: K4 on the first slice's, the
        # others on the mixed capture's
        k["launches"] = (sl if k["name"] == "K4_voice_fir" else mx)["launches"][k["name"]]
        if k["launches"] == 0:
            print(f"chip_smoke: FAILED: {k['name']} was not launched on its path", file=sys.stderr)
            return 1
    if {k["name"] for k in kernels} != set(launch_counts()):
        print("chip_smoke: FAILED: a kernel was not checked", file=sys.stderr)
        return 1
    log({"kernels": [{key: k[key] for key in keys} for k in kernels]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
