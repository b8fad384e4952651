#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``wavecap_tpu_torch``).

Run from the repository root on a machine with one NVIDIA card::

    python3 chip_smoke.py

It drives the port's paths at full width:

* the 800-channel NBFM capture of the first slice (10 Msps, 12.5 kHz
  channels: M = 800, 1,968,000-sample blocks; i16 words -> K1 unpack +
  polyphase arms -> K2 cross-arm DFT -> K3 slot front end -> K4 voice FIR
  -> wire buffer), audio at the 25 kHz channel rate;
* the mixed-analog capture at the server's default channel settings:
  five banks of 160 slots (``am``, ``lsb``, ``nbfm``, ``sam``, ``usb``, one
  slot per channelizer bin) with 48 kHz audio, K3 -> the mode's detector
  (K10 for SAM) -> K5 resampler -> K9 IIR filters and AGC, plus one group
  of 2 WBFM wide slots (K7 shift and decimate -> discriminator -> K5 -> K9
  deemphasis and MPX low-pass);
* the three P25 programs (25 kHz bins, 50 kHz channels): A, C4FM at the
  BASELINE point (10 Msps, M = 400, 0.25 s blocks, 50 C4FM + 50 NBFM
  slots: K3 -> K7 low-pass -> discriminator -> K7 RRC -> K12 block
  timing); B, LSM trunking at 2.4 Msps (M = 96, 0.15 s blocks, 21 CQPSK
  slots with the 41-tap simulcast equalizer: K3 -> carrier NCO -> K7 RRC
  -> K13's CFO estimate (K13_cfo_power x^4, cuFFT, K13_cfo_lines) -> K14
  alias scores and echo fit -> K7 per-slot complex FIR -> K13 timing and
  differential detection); C,
  Phase 2 dual rate (2 CQPSK + 20 slots at 6000 baud, alpha 1);
* the server's capture engine (program D): ``CaptureManager`` ->
  ``Capture`` with pinned staging and fetch buffers, a copy stream and
  event polling, the i16 / i8 / i4 transports (K1 unpacks all three), the
  noise blanker (K11a) and spectral noise reduction (K11b) in the analog
  banks and the wide slots, and the listener-gated audio fetch;
* the P25 programs again with the per-symbol timing scans
  (``WAVECAP_P25_TIMING=scan``: K12s, K13s);
* the multi-device mesh on 8 shards of the card
  (``WAVECAP_TORCH_DEVICE_COUNT=8``, ``stream=1,time=8``): the engine
  (program E: program D's scene, five banks over every bin, two wide
  slots, i16 / i8 / i4) and P25 (program F: program A's scene), with
  K15's exchanges (the halo, the re-shard, the wide IF and history
  gathers) as device copies;
* the P25 and DMR decoders on the host, fed by the engine's P25 banks
  through the port's ``P25Attachment`` and ``DmrAttachment`` (program G:
  C4FM control channels, a voice call and DMR at 10 Msps; LSM behind a
  simulcast echo and Phase 2 calls at 2.4 Msps);
* the channel attachments and the scanner (program H: POCSAG, FLEX and
  RDS pagers and broadcast on an NBFM bank of 160 and a WBFM wide slot at
  10 Msps, a ``ScannerService`` retuning a channel, and the file-replay
  source);
* trunking (program I: P25 Phase 1 and 2 and DMR Tier III sites at 2.4
  Msps, each locked, its grants followed and its calls recorded; a worker
  process; Phase 1 on the mesh);
* the server, the harness and the CLI (program J: the REST and WebSocket
  surface, streams at the shipped limits, a worker-hosted system's
  streams, the ``python -m`` entry points);
* ``ops/planar.py``'s channelizer (K1 + K2 on planes), spectrum and
  elementwise functions, and ``conv_valid``'s banded-matmul route
  (``WAVECAP_FIR_MATMUL=1``), off the programs' paths.

Phases:

0. identity: the card's name and power limit, torch and CUDA versions;
1. build: every kernel from ``wavecap_tpu_torch/kernels/csrc`` with nvcc;
2. kernel checks: each kernel against its plain PyTorch version on the
   card, at the paths' shapes, with inputs from a numpy seed; the
   kernel's, the plain version's and the yardstick library call's time on
   the card (CUPTI, through torch.profiler) beside the kernel's bound, and
   the wrapper's wall time between CUDA events; K3 at every path's shape
   (the slice, programs A, B and D, a mesh shard of E and F, and a
   60,000-sample row in modes 0 and 1) and K1 at program D's block and E's
   and F's shards for every word kind; then K1 on complex input
   and K2 at M = 80 and M = 38 (unfactorable) against their plain versions;
   K11a, K11b and K1 on the adaptive i8 and i4 words at program D's
   shapes, K11a and K11b also at E's (100 rows), K11a on adversarial rows
   (ties at the median, all equal, all zero, n = 1 and 2, a 400,000-sample
   row on the long-row path) and K11b at 92 frames (its staged gain),
   each beside its part's yardstick (``torch.quantile``); K5 and K10 also
   at D's and E's bank rows (160, 100), K5 beside
   one ``conv_transpose1d``, K10's own sin, cos (2 ulp) and atan (3 ulp)
   against float64; K6 (the spectrum on cuFFT) and K8 (``pack_wire``) timed;
   last, K12s and K13s at ``scan_path_shapes()``: programs A, B and C's
   shapes (dead air, and positions past both ends of the reference's
   clamp), the rows the first design refused (two LSM rows of 4 s, two
   Phase 2 rows of 3 s, a C4FM row of 11 s), and the loops whose plan
   differs (C4FM at 240 and 960 kHz: wider chunks, shorter groups; LSM
   with a 30,000 ppm clock range: every step checked), with their cycles a symbol
   beside the chain floor at the operations' latencies measured on the
   card (``scan_op_latencies``); K7 also at a mesh shard's wide slots (program
   E) and program F's two per-shard P25 filters, K14 also on a
   60,000-sample row in both modes; K4 at ``K4_PATH_SHAPES`` (the slice,
   rows of 60,000 and 150,000 samples, rows shorter than the taps) and
   K12 / K13's timing at ``K12_PATH_SHAPES`` (programs A, B, C, F's shard,
   2 s rows in each mode and 5 s LSM rows, whose windows do not fit in
   shared memory), each with its plan, bound and, for the
   timing, the redesign's chain; K13's CFO estimate at ``CFO_PATH_SHAPES``
   (program B's bank, C's control channel and Phase 2 bank; rows at -600,
   0, +600 Hz): K13_cfo_power within 2 ulp of its plain version (bit
   equality reported), K13_cfo_lines' ``j`` and residual equal to its
   plain version's on complex X, the stage's residual equal to the
   sequence before K13_cfo_power (two products, the FFT's pad, the search
   over |X|), with the stage's device ops, cuFFT's time and the stage's
   bound; then a 0-sample block through the card's
   ``channelize`` and ``bank_step`` (NBFM with IIR filters, with the voice
   FIR, AM) and K4 at S = 0 against the plain path: the same shapes, RSSI
   (NaN and -200) and carries, and no kernel launched; and K13's CFO stage
   at n = 0 (X all zero, ``j = 0``, ``resid = 0``);
3. the first slice: a fake 10 Msps receiver with NBFM stations on known
   bins, 6 consecutive blocks through ``pack_i16_words`` -> upload ->
   ``capture_multi`` (800 active slots) -> ``unpack_wire``: each station's
   1 kHz tone, the squelch of empty slots, one launch of each of K1-K4
   per block, and the first block against the plain path on the card;
   warm ms per block and a traced profile;
4. the mixed-analog capture: two stations per narrow mode and one WBFM
   station, 6 blocks the same way: every station's 1 kHz tone, the
   squelch of empty slots, the launch count of each kernel that the
   configuration implies, the first two blocks against the plain path on
   the card, the wire within 1 LSB; warm ms per block and a traced profile;
5. program A: six looped C4FM stations (one 2 kHz off its bin centre) and
   three NBFM stations, 6 blocks: every station's hard decisions against
   its transmitted dibits from block 3 on (>= 99.5 %), the NBFM tones,
   empty slots at the noise floor, exact launch counts, the first two
   blocks against the plain path, the wire soft within half an i8 LSB;
   warm ms per block and a traced profile;
6. programs B and C the same way: LSM stations (one at +600 Hz CFO, one
   behind a 70 us echo that the equalizer must take, clean ones that keep
   identity taps) and Phase 2's control channel and 6000-baud stations;
   B on the adaptive i8 words; warm ms per block and a traced profile;
7. the engine (program D): ``CaptureManager`` over the fake driver at 10
   Msps, ``create_channel`` for every slot of five banks of 160 (``nbfm``;
   ``nbfm`` with the noise blanker and noise reduction; ``am``, ``usb``
   and ``sam`` with the blanker) and two WBFM slots with both options,
   ``warmup``, ``start``, 9 blocks (3 each at i16, i8, i4), 32 audio
   fetch slots a bank: the capture running throughout, every kernel's
   launches, station lines, squelch, the blanker against pulses and the
   noise reduction on a weak voice-like station, the published audio
   against the kernels' output (half an LSB) and the plain path (>= 50
   dB) from the engine's own blocks, the gated rows, pinned buffers;
   block latency, the engine's stage times, host syncs, peak memory;
8. programs A, B and C with the scan timing: the same floors, K12s once
   a block in A, K13s once in B and twice in C, the block timing never;
9. program E, the engine on the mesh: program D's stations through
   ``create_channel`` on a ``stream=1,time=8`` capture (one frequency a
   bin; the grid runs five banks over all 800 bins), 9 blocks at i16 /
   i8 / i4: exact launches a block a shard and K15's copies, station
   lines, silent empty bins, the engine's words through a time=1 mesh
   against time=8 (>= 60 dB on every open bin) and through the slot-bank
   program (>= 50 dB), 0 host syncs, latency, memory; then K15's
   exchanges at E's shapes against their plain versions (exact), timed;
10. program F, P25 on the mesh: program A's scene at time=8 (M = 400, 50
    bins a shard, 0.24 s blocks), the NBFM base bank and the C4FM bank
    over every bin: the six stations' decisions from block 3 on (>= 99.5
    %), the NBFM lines, launches and copies;
11. program G, the port's decoders (``decoders/``: framer, FEC, TSBK,
    LDU, DMR, Phase 2 MAC, the IMBE and AMBE+2 vocoders, on the host) fed
    by the engine: ``CaptureManager`` -> ``create_capture`` ->
    ``create_channel``, a ``P25Attachment`` or ``DmrAttachment`` on each
    ``p25`` / ``dmr`` channel (its own thread and ``Channel.symbols``
    subscription), the ``p25p2`` channels through the trunking
    recorder's Phase 2 path (``GP2Recorders``: a ``VoiceRecorder`` a
    timeslot), one ``_dispatch_blocks`` a
    block, every attachment waited for after each block (a dropped batch
    or a decoder that raised fails).  G1 at the BASELINE point (10 Msps,
    M = 400, a C4FM bank of 50 slots): 40 control channels (each its own
    NAC; >= 99 % of TSBKs CRC-valid from block 3 on, every valid one as
    sent), a voice call (>= 95 % of LDUs with the codewords sent; the
    voice decoder's PCM finite and not silent), a DMR channel (>= 95 % of
    CSBKs as sent) and 8 empty channels (no valid TSBK; their frame syncs
    reported); G2 at 2.4 Msps: an LSM bank with the 41-tap equaliser (>=
    95 %; the 70 us echo station >= 90 % from block 4 on) and a Phase 2
    bank of 20 slots, 4 with calls (>= 90 % of fragments detected, every
    MAC PDU as sent).  Both: exact launches a block (``G1_LAUNCHES``,
    ``G2_LAUNCHES``), the first blocks' card and plain symbols through
    fresh consumers giving the same messages and PCM, decode host ms a
    block beside the block's length, the engine's stages;
12. program H, the attachments and the scanner (``capture/attachments.py``,
    ``capture/scanner.py``, ``decoders/pocsag.py``, ``flex.py``,
    ``rds.py``) on the engine at 10 Msps, M = 400, 50 blocks of 0.2 s
    paced to their length: an NBFM bank of 160 (8 POCSAG pagers at 512,
    1200 and 2400 baud, 4 FLEX pagers, each repeating a seeded set of
    pages; the scanner's channel; gated tones and idle bins) and a WBFM
    wide slot with RDS.  Every page sent decodes, address or capcode and
    content as sent, each call only what its window held, within the
    fewest and most the blocks carry; RDS's PI, PS and RadioText as sent;
    the scanner stops only on its one active entry, stays there while the
    carrier is up, makes two full passes, every retune through
    ``update_channel`` (no rebuild, no new capture); the first two blocks'
    pager audio and wide baseband >= 50 dB against the same engine on the
    CPU (the plain versions); the first 4 blocks written by
    ``write_iq_wav`` and replayed by ``FileReplayDriver`` through a second
    capture: the same pages; exact launches a block (``H_LAUNCHES``);
13. program I, the port's trunking (``trunking/``) on the engine, each
    system the reference's default deployment (``TrunkingSystemConfig``:
    2.4 Msps, i8 words, 4 voice recorders) through ``TrunkingManager`` ->
    ``TrunkingSystem``, its capture fed one ``_dispatch_blocks`` a pair of
    blocks and its pump run once a block, on a virtual clock (holds,
    hunting and call ends follow the blocks): I1 P25 Phase 1 (C4FM: lock,
    NAC, system, site, IDEN_UP; two talkgroups' grants onto two recorders;
    every TSBK from block 3 on as sent; each call's WAV the CPU decode of
    its recorded IMBE frames, as many as were sent, the same frames once
    the FEC has decoded them), I2 Phase 2 (CQPSK control with the probe
    slot, a call in each TDMA slot of the 6000-baud bank: fragments, MAC
    PDUs, AMBE+2 voice), I3 DMR Tier III (CSBK grants to both slots of a
    carrier), I4 a ``TrunkingProcessManager`` worker on the card
    answering ``status`` synced, I5 I1's samples on the 8-shard mesh (the
    same site, calls, WAVs and control messages from 0.6 s on); each
    system's launches a block (the ones its scene implies > 0), and its
    second and third blocks against the engine on the CPU from the card's
    carried state (>= 50 dB, the same messages; the first block reported);
14. program J, the port's server, harness and CLI (``server/``,
    ``harness.py``, ``cli.py``) on the card, spoken to over HTTP and
    WebSocket through the standard library: J1 the shipped deployment
    (``wavecap.yaml.example`` as a dict) on the card and on the CPU, the
    route smoke's walk, the REST script and every WebSocket upgrade
    answering alike (the routes that read YAML listed apart) and every
    ``docs/api-spec.md`` route registered; J2 the server filled to the
    shipped limits through REST (4 captures, one at 10 Msps with 8 narrow,
    2 wide and 4 P25 channels), every channel's audio and every capture's
    spectrum over WebSocket: each station's tone >= 20 dB above the rest,
    the empty channels squelched, the spectra peaking at the stations, one
    channel >= 50 dB against the CPU engine fed the same blocks from block
    2 on, the time to first audio (cold, warm) and launches a block; J3 a
    worker-hosted P25 system (the worker on the card) whose voice and
    spectrum the server serves; J4 ``python -m wavecap_tpu_torch serve``
    with no config file (``/health``, ``POST /shutdown``), ``demod``
    (>= 50 dB), ``decode-iq`` and the harness's scenes, each against the
    same command with ``WAVECAP_TORCH_DEVICE=cpu``;
15. planar and the banded route (``run_planar``, in a process of its
    own, where CUPTI keeps every event): ``planar_channelize`` at the
    first slice's geometry (M = 800, 1,968,000-sample blocks) and
    program B's (M = 96, 360,000), three blocks with the history carried:
    one K1 and one K2 a call, rel L2 <= 1e-5 against its plain version
    and against ``channelize``, the history bit for bit;
    ``planar_power_spectrum`` on 16 rows of 2048 against the CPU (1e-3 dB
    within 60 dB of the peak) and cuFFT's ``power_spectrum`` (0.5 dB);
    ``planar_freq_shift``, ``planar_quadrature_demod`` and
    ``planar_rssi_dbfs`` on a 160 x 9,447 bank against the CPU (NCO words,
    phases and next phase bit-equal, outputs within 1e-5); ``conv_valid``
    with ``WAVECAP_FIR_MATMUL=1`` (this check only) at programs A's, B's
    and D's ``fir_filter`` shapes within 2e-5 of K7, K7 again once the
    variable is restored; a line each with its time, bound and library
    time;
16. a JSON line of the kernels (K15 with its copies and bytes) and the
    final ``{"ok": true, ...}`` line.

Any failed check exits non-zero before the last line.  Without a CUDA
card, or outside the repository, it exits non-zero and prints no result.
It imports nothing of JAX.

To time K1-K5, K7, K9, K10, K11a, K11b, K12, K13, K14, K12s and K13s against another
checkout of the port on the same card::

    python3 chip_smoke.py --phase2-turns OTHER_CHECKOUT [--out FILE]

runs K13's CFO stage first (at ``CFO_PATH_SHAPES``: every device op of
``_estimate_cfo_residual`` with its launches and ms a call, the search
alone, K13_cfo_power where the checkout has it, cuFFT alone; the stage's
residuals must be bit-equal between the checkouts), then K1, K3, K4, K12 / K13's timing and the scans at this checkout's
``K1_PATH_SHAPES``, ``K3_PATH_SHAPES``, ``K4_PATH_SHAPES``,
``K12_PATH_SHAPES`` and ``scan_path_shapes()`` through that checkout's
wrappers (the first K3 refuses the 60,000-sample rows, the first K4 rows
past 27,000 samples, the first K12 / K13 the 2 s rows, the first scans
the long rows; the scans' outputs must be bit-equal between the
checkouts wherever both ran), and phase 2's K2, K5, K7, K9, K10, K11a, K11b and K14 checks of
OTHER_CHECKOUT's ``chip_smoke.py`` and of this one in turns (other, this,
this, other), each in its own process with its own kernels built from its
own sources, and prints one JSON line a turn: the K2 records of
``kernel_checks`` (M = 800, with the ``torch.fft`` route), K2 at M = 400
through that checkout's ``device_ms``, K9 at 100 rows (a mesh shard's),
K5 (narrow one-shot and streaming) at 160 and 100 rows and K10 (PLL and
Costas) at 100 rows the same way, the K5, K7, K9 and K10 records of
``mixed_kernel_checks``, the K11a and K11b records of
``engine_kernel_checks`` at 160 and 100 rows (the wide rows too), the K7
and K14 records of ``p25_kernel_checks``, and K7 at a mesh shard's wide
slots and program F's per-shard filters and K14 on a 60,000-sample row
through that checkout's wrappers (the first K14 refuses the row).
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
SEED = 20261016
N_BLOCKS = 6
MODE = ("nbfm", (("filter_impl", "fir"), ("fast_discriminator", True)))
# (bin, fine offset Hz) of the fake receiver's NBFM stations: 1 kHz tone,
# 4 kHz deviation, amplitude 0.1 each
STATIONS = ((7, 0.0), (40, 0.0), (123, 800.0), (399, -500.0), (520, 0.0), (777, 300.0))
SQUELCH_DB = -45.0  # between the noise floor (~-86 dBFS) and a station (-20 dBFS)
FMA_CYCLES = 4  # latency of a dependent f32 multiply-add on Hopper, in SM cycles
K2_KERNELS = ("arm_dft_kernel",)  # K2's CUDA kernels (one launch a call), for device_ms
K9_KERNELS = ("iir_scan_kernel",)  # K9's CUDA kernels (one launch a call), for device_ms
K5_KERNELS = ("resample_poly_kernel", "resample_poly_row_kernel")  # K5's two variants
K11A_KERNELS = ("noise_blanker_kernel",)  # every template instance (staged, long row; 10 or 12 items)
K11B_KERNELS = ("nr_frames_kernel", "nr_gain_kernel", "nr_overlap_add_kernel")  # both gain variants
K11A_LONG_ROW = 400_000  # complex samples: past a cluster's shared memory, the long-row path
K11B_MANY_FRAMES = 48_000  # audio samples: 92 frames of 1,024 at hop 512, the staged gain
K10_KERNELS = ("pll_kernel",)
K14_KERNELS = ("acf_kernel", "residual_kernel", "epilogue_kernel")
# every kernel's CUDA functions as CUPTI names them (each template instance
# and variant is an op of its own), for the traced totals a block
KERNEL_FUNCTIONS = {
    "K1_unpack_arms": ("unpack_arms_kernel",), "K2_arm_dft": K2_KERNELS,
    "K3_slot_frontend": ("slot_frontend_kernel",), "K4_voice_fir": ("voice_fir_kernel",),
    "K5_resample_poly": K5_KERNELS, "K7_strided_fir": ("strided_fir_kernel",), "K9_iir_cascade": K9_KERNELS,
    "K10_pll": K10_KERNELS, "K11a_noise_blanker": K11A_KERNELS, "K11b_noise_reduction": K11B_KERNELS,
    "K12_c4fm_timing": ("timing_kernel<float, false>",), "K12s_c4fm_scan": ("::scan_kernel<float, false>",),
    "K13_cqpsk_timing": ("timing_kernel<float2, true>",), "K13s_cqpsk_scan": ("::scan_kernel<float2, true>",),
    "K13_cfo_power": ("cfo_power_kernel",), "K13_cfo_lines": ("cfo_lines_kernel",),
    "K14_echo_fit": K14_KERNELS,
}
# K10's step: the dependent path from one phase to the next, counted in the
# SASS of kernels/csrc/pll.cu's unrolled loop (scripts/k10_variants.py dumps
# it): PLL 33 instructions (sin/cos 11, the mix 2, the detector 13 with one
# MUFU.RCP, the loop 4, the wrap 3), Costas 29 (the detector 8, the loop 5,
# the wrap 3), at a multiply-add's latency each
K10_CHAIN_CYCLES = {0: 33 * FMA_CYCLES, 1: 29 * FMA_CYCLES}

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


_PINNED: dict = {}


def fetch(t):
    """The packed wire into a pinned host buffer, as the engine fetches it:
    a device-to-host copy at the link's rate (a pageable ``.cpu()`` stages
    through a bounce buffer, and its time swung from run to run)."""
    import torch

    if t.device.type == "cpu":
        return t.numpy()
    key = (tuple(t.shape), t.dtype)
    buf = _PINNED.get(key)
    if buf is None:
        buf = _PINNED[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return buf.numpy()


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


def device_ms(fn, kernel="", reps: int = 20, warm: int = 3) -> float:
    """Warm mean time on the card of one call: the kernels and copies it
    ran, as CUPTI traced them through torch.profiler, without the host's
    gaps.  With ``kernel`` (a name, or several) only the kernels whose name
    holds it, each launched once a call, timed as the mean of the launches
    CUPTI kept: after profiles of many thousand launches in one process it
    keeps only some (seen on the H100: 0-12 of 20), which a sum over the
    calls would read as a faster kernel.  If it keeps none in three
    profiles, the wall time between CUDA events (an upper bound) stands in."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = (kernel,) if isinstance(kernel, str) else kernel
    for _ in range(3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if not kernel and on_card:
            return float(sum(e.self_device_time_total for e in on_card)) / reps / 1e3
        kept = [e for e in on_card if e.count and any(k in e.key for k in names)]
        if kept:
            return float(sum(e.self_device_time_total / e.count for e in kept)) / 1e3
    return time_ms(fn, reps)


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
    from wavecap_tpu_torch.models.p25 import c4fm, cqpsk, equalizer as eqz
    from wavecap_tpu_torch.ops import agc, channelizer as chz, fir, iir, pll

    with contextlib.ExitStack() as stack:
        for module, name, plain in (
            (chz, "unpack_arms", chz.unpack_arms_plain), (chz, "arm_dft", chz.arm_dft_plain),
            (cb, "slot_frontend", cb.slot_frontend_plain), (cb, "voice_fir", cb.voice_fir_plain),
            (fir, "polyphase_resample", fir.polyphase_resample_plain),
            (fir, "strided_fir", fir.strided_fir_plain),
            (iir, "sos_filter", iir.sos_filter_plain), (iir, "onepole_filter", iir.onepole_filter_plain),
            (agc, "envelope", agc.envelope_plain), (pll, "_loop", pll._loop_plain),
            (c4fm, "c4fm_timing", c4fm.c4fm_timing_plain),
            (cqpsk, "cqpsk_timing", cqpsk.cqpsk_timing_plain),
            (c4fm, "c4fm_scan", c4fm.c4fm_scan_plain), (cqpsk, "cqpsk_scan", cqpsk.cqpsk_scan_plain),
            (cqpsk, "cfo_power", cqpsk.cfo_power_plain), (cqpsk, "cfo_lines", cqpsk.cfo_lines_plain),
            (eqz, "echo_fit", eqz.echo_fit_plain), (eqz, "echo_score", eqz.echo_score_plain),
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
    b, f = bound(*k1_bytes_ops(m, n, "i16"))
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
        ms=timer(lambda: chz.arm_dft(u_p, ch), K2_KERNELS),
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
    b, f = bound(*k3_bytes_ops(c, s, 1))
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
    nb, nf = k4_bytes_ops(c, s, nt)
    b, f = bound(nb, nf)
    results.append(dict(
        name="K4_voice_fir", route="cuda", source="wavecap_tpu_torch/kernels/csrc/voice_fir.cu",
        replaces="wavecap_tpu/ops/fir.py:187 (+ ops/clip.py:17-38, models/channel_bank.py:109)",
        max_abs_err=float(np.max(np.abs(a_k - a_p))), worst_open_snr_db=worst,
        bound_bytes_ms=bound(nb, 0.0)[0], bound_ops_ms=bound(0.0, nf)[0],
        ms=timer(lambda: cb.voice_fir(fm, tail, rssi, assign4, bank), "voice_fir_kernel"),
        wrapper_ms=wall_timer(lambda: cb.voice_fir(fm, tail, rssi, assign4, bank)),
        plain_ms=timer(lambda: cb.voice_fir_plain(fm, tail, rssi, assign4, bank)),
        bound_ms=b, bound_by=f,
        # yardstick: cuDNN's conv1d of the same FIR (TF32 off), no epilogue
        library_ms=timer(lambda: F.conv1d(xin, kern)),
    ))
    return results


def other_geometry_checks(device) -> list[dict]:
    """K1 on complex input and K2 at the other M of the paths: 400 = 20 x 20
    (programs A and F), 96 = 8 x 12 (B and C), 80 = 8 x 10 (1 Msps / 12.5
    kHz) and 38, which does not factor and runs 1 x 38; and at M = 1600
    (tiles of 2 steps), 2000 (the tables read from device memory), 4800
    and 6250 (tiles of 1 step; the design before it reached M ~6,300)."""
    import torch

    from wavecap_tpu_torch.ops import channelizer as chz

    rng = np.random.default_rng(SEED + 1)
    results = []
    for fs in (5_000_000.0, 1_200_000.0, 1_000_000.0, 475_000.0, 20_000_000.0, 25_000_000.0,
               60_000_000.0, 78_125_000.0):
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


# K3's shapes on the paths: (what, slots, bins, row length, mode); the
# mesh shards' banks gather an identity map over their own bins
K3_PATH_SHAPES = (
    ("the slice, 800 x 4,920, mode 1", 800, 800, 4_920, 1),
    ("program D's bank, 160 x 4,920, mode 2", 160, 800, 4_920, 2),
    ("program E's shard, 100 x 4,592, mode 2", 100, 100, 4_592, 2),
    ("program F's shard, 50 x 12,000, mode 2", 50, 50, 12_000, 2),
    ("program A's bank, 50 x 12,500, mode 2", 50, 400, 12_500, 2),
    ("program B's bank, 21 x 7,500, mode 2", 21, 96, 7_500, 2),
    ("one 60,000-sample row, mode 1", 1, 4, 60_000, 1),
    ("one 60,000-sample row, mode 0", 1, 4, 60_000, 0),
)
# K1's: (what, M, words in the block)
K1_PATH_SHAPES = (
    ("program D's block / the slice, M = 800", 800, 1_968_000),
    ("program E's shard, M = 800", 800, 229_600),
    ("program F's shard, M = 400", 400, 300_000),
)
K1_WORDS = {"i16": (np.int32, 4), "i8": (np.int16, 2), "i4": (np.int8, 1), "complex64": (np.complex64, 8)}
# K4's: (what, slots, audio samples a row)
K4_PATH_SHAPES = (
    ("the slice, 800 x 4,920", 800, 4_920),
    ("one 60,000-sample row", 1, 60_000),
    ("one 150,000-sample row (a second pass over its outputs)", 1, 150_000),
    ("8 rows of 100 samples (shorter than the taps)", 8, 100),
    ("8 rows of 1 sample", 8, 1),
)


def k3_path_case(device, slots: int, bins: int, s: int, mode: int, seed: int = SEED + 10):
    """K3's inputs at one of ``K3_PATH_SHAPES``: ``(chans, assign, phase0,
    prev, bank)``.  NBFM tones for the discriminator (clear of its branch
    cut), noise for the shifted rows; the slots on shuffled bins, two of
    them out of range (the gather clamps)."""
    import torch

    from wavecap_tpu_torch.models.analog import NbfmConfig
    from wavecap_tpu_torch.models.channel_bank import ChannelAssignment, ChannelBankConfig
    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

    rng = np.random.default_rng(seed + slots + s + mode)
    ch = ChannelizerConfig(sample_rate=10_000_000.0, channel_bandwidth=12_500.0)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if mode == 2:
        rows = 0.1 * (rng.standard_normal((bins, s)) + 1j * rng.standard_normal((bins, s)))
        bank = ChannelBankConfig(channelizer=ch, mode="shift", demod_cfg=None, capacity=slots)
    else:
        rows = fm_rows(rng, bins, s, ch.channel_rate)
        bank = ChannelBankConfig(channelizer=ch, mode="nbfm", capacity=slots, demod_cfg=NbfmConfig(
            sample_rate=int(ch.channel_rate), fast_discriminator=mode == 1))
    index = rng.permutation(bins)[:slots].astype(np.int32) if slots < bins else np.arange(slots, dtype=np.int32)
    if slots > 2:
        index[:2] = (-3, bins + 5)
    assign = ChannelAssignment(
        channel_index=dev(index), fine_offset_hz=dev(rng.uniform(-1500.0, 1500.0, slots).astype(np.float32)),
        active=dev(np.ones(slots, bool)), squelch_db=dev(np.full(slots, -1e9, np.float32)))
    phase0 = dev(rng.integers(0, 2**32, slots, dtype=np.uint64).astype(np.uint32))
    prev = dev(np.exp(1j * rng.uniform(-np.pi, np.pi, slots)).astype(np.complex64) * 0.3)
    return dev(rows.astype(np.complex64)), assign, phase0, prev, bank


def k4_path_case(device, slots: int, s: int, seed: int = SEED + 13):
    """K4's inputs at one of ``K4_PATH_SHAPES``: ``(fm, hp_z, rssi, assign,
    bank)``, the slice's NBFM bank at ``slots`` slots; a voice-band tone and
    noise a row, a random carried tail; where there are several slots, a
    quarter shut by the squelch and a tenth inactive (slot 0 open)."""
    import dataclasses

    import torch

    from wavecap_tpu_torch.models.channel_bank import ChannelAssignment

    rng = np.random.default_rng(seed + slots + s)
    bank = dataclasses.replace(slice_config().bank_cfg(MODE), capacity=slots)
    rate = bank.demod_cfg.audio_rate
    t = np.arange(s) / rate
    fm = (rng.uniform(0.2, 1.0, (slots, 1)) * np.sin(2 * np.pi * rng.uniform(300.0, 3000.0, (slots, 1)) * t)
          + 0.05 * rng.standard_normal((slots, s)))
    tail = 0.3 * rng.standard_normal((slots, 126))
    rssi = rng.uniform(-80.0, -20.0, slots).astype(np.float32)
    shut = rng.random(slots) < 0.25
    active = rng.random(slots) >= 0.1
    shut[0], active[0] = False, True
    squelch = np.where(shut, rssi + 6.0, rssi - 6.0).astype(np.float32)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    assign = ChannelAssignment(channel_index=dev(np.arange(slots, dtype=np.int32)),
                               fine_offset_hz=dev(np.zeros(slots, np.float32)), active=dev(active),
                               squelch_db=dev(squelch))
    return dev(fm.astype(np.float32)), dev(tail.astype(np.float32)), dev(rssi), assign, bank


def k1_path_case(device, m: int, n: int, kind: str, seed: int = SEED + 11):
    """K1's inputs at one of ``K1_PATH_SHAPES``: ``(x, hist, cfg, scale)``,
    random words of ``kind`` (or complex samples) and a random history."""
    import torch

    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

    rng = np.random.default_rng(seed + m + n)
    cfg = ChannelizerConfig(sample_rate=m * 12_500.0, channel_bandwidth=12_500.0)
    dtype, _ = K1_WORDS[kind]
    if kind == "complex64":
        x = (0.3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max + 1, n).astype(dtype)
    hist = (0.1 * (rng.standard_normal(m * cfg.taps_per_channel)
                   + 1j * rng.standard_normal(m * cfg.taps_per_channel))).astype(np.complex64)
    scale = torch.tensor([0.0123], dtype=torch.float32, device=device) if kind in ("i8", "i4") else None
    return torch.from_numpy(x).to(device), torch.from_numpy(hist).to(device), cfg, scale


def k3_bytes_ops(slots: int, s: int, mode: int) -> tuple[float, float]:
    """K3's bytes (rows in, the discriminator or the shifted rows out, the
    per-slot words) and operations a sample: NCO 3, cos 1, sin 1, mix 6,
    power 3, then with the discriminator product 6, fast atan2 ~12, scale
    1 (33), without it the row's store (16)."""
    out = 4 if mode != 2 else 8
    return slots * s * (8 + out) + slots * 36, (33.0 if mode != 2 else 16.0) * slots * s


def k1_bytes_ops(m: int, n: int, kind: str) -> tuple[float, float]:
    """K1's bytes (the block, the history and taps in; both stacks and, for
    words, the unpacked block out) and operations (two stacks of 9 complex x
    real taps)."""
    t = 9
    word = K1_WORDS[kind][1]
    return n * word + m * t * 12 + 2 * n * 8 + (n * 8 if kind != "complex64" else 0), 2.0 * n * t * 4


def k1_k3_path_checks(device, timer=device_ms) -> list[dict]:
    """K3 at every shape of ``K3_PATH_SHAPES`` and K1 at ``K1_PATH_SHAPES``
    for every word kind, each against its plain version on the card (K3:
    phases bit-exact, discriminator SNR >= 80 dB or rows rel L2 <= 1e-6,
    RSSI within 1e-3 dB, the last sample; K1: the unpacked block exact, the
    stacks within rel L2 1e-6), timed beside its bound."""
    import torch

    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.ops import channelizer as chz

    cases = []
    for what, slots, bins, s, mode in K3_PATH_SHAPES:
        args = k3_path_case(device, slots, bins, s, mode)
        k_out = [host(v) for v in cb.slot_frontend(*args)]
        p_out = [host(v) for v in cb.slot_frontend_plain(*args)]
        check(np.array_equal(k_out[2], p_out[2]), f"K3 ({what}) NCO phases are not bit-exact")
        d_rssi = float(np.max(np.abs(k_out[1] - p_out[1])))
        check(d_rssi <= 1e-3, f"K3 ({what}) RSSI differs by {d_rssi:.3g} dB > 1e-3")
        rec = dict(name="K3_slot_frontend", case=what, plan=cb.k3_plan(slots, s, mode)._asdict(),
                   rssi_max_abs_db=d_rssi, max_abs_err=max_abs(p_out[0], k_out[0]))
        if mode == 2:
            err = rel_l2(p_out[0], k_out[0])
            check(err <= 1e-6, f"K3 ({what}) shifted rows rel L2 {err:.3g} > 1e-6")
            rec.update(rows_rel_l2=err)
        else:
            err = snr_db(p_out[0], k_out[0])
            check(err >= 80.0, f"K3 ({what}) discriminator SNR {err:.1f} dB < 80")
            check(rel_l2(p_out[3], k_out[3]) <= 1e-5, f"K3 ({what}) last sample differs")
            rec.update(fm_snr_db=err)
        b, f = bound(*k3_bytes_ops(slots, s, mode))
        rec.update(ms=timer(lambda: cb.slot_frontend(*args), "slot_frontend_kernel"), bound_ms=b, bound_by=f)
        cases.append(rec)
        del args
    for what, m, n in K1_PATH_SHAPES:
        for kind in K1_WORDS:
            x, hist, cfg, scale = k1_path_case(device, m, n, kind)
            x_k, u_k = chz.unpack_arms(x, hist, cfg, scale)
            x_p, u_p = chz.unpack_arms_plain(x, hist, cfg, scale)
            check(torch.equal(x_k, x_p), f"K1 ({what}, {kind}) unpacked block differs")
            err = rel_l2(host(u_p), host(u_k))
            check(err <= 1e-6, f"K1 ({what}, {kind}) arms rel L2 {err:.3g} > 1e-6")
            b, f = bound(*k1_bytes_ops(m, n, kind))
            cases.append(dict(
                name="K1_unpack_arms", case=f"{what}, {n:,} {kind}", rel_l2=err,
                plan=chz.k1_plan(m, cfg.taps_per_channel, n // m, chz._WORD_KINDS.get(x.dtype, 0))._asdict(),
                ms=timer(lambda: chz.unpack_arms(x, hist, cfg, scale), "unpack_arms_kernel"),
                bound_ms=b, bound_by=f))
            del x_k, u_k, x_p, u_p
    # K1's instance for any other taps a channel, on i16 words at M = 96
    for taps in (5, 12):
        cfg = chz.ChannelizerConfig(sample_rate=96 * 12_500.0, channel_bandwidth=12_500.0, taps_per_channel=taps)
        rng = np.random.default_rng(SEED + taps)
        x = torch.from_numpy(rng.integers(-2**31, 2**31, 96 * 301).astype(np.int32)).to(device)
        hist = torch.from_numpy((0.1 * (rng.standard_normal(96 * taps) + 1j * rng.standard_normal(96 * taps)))
                                .astype(np.complex64)).to(device)
        x_k, u_k = chz.unpack_arms(x, hist, cfg)
        x_p, u_p = chz.unpack_arms_plain(x, hist, cfg)
        check(torch.equal(x_k, x_p), f"K1 (T = {taps}) unpacked block differs")
        err = rel_l2(host(u_p), host(u_k))
        check(err <= 1e-6, f"K1 (T = {taps}) arms rel L2 {err:.3g} > 1e-6")
        cases.append(dict(name="K1_unpack_arms", case=f"T = {taps} (the instance for any T), M = 96, 28,896 i16",
                          rel_l2=err))
    return cases


def k4_bytes_ops(slots: int, s: int, taps: int = 127) -> tuple[float, float]:
    """K4's bytes (the rows and tails in and out, the taps, the per-slot
    words) and operations (a multiply-add a tap, the epilogue's ~6 a sample)."""
    return (2 * slots * s * 4 + 2 * slots * (taps - 1) * 4 + taps * 4 + slots * 13,
            slots * s * (2.0 * taps + 6))


def k4_k12_path_checks(device, timer=device_ms, clock_hz=None) -> list[dict]:
    """K4 at every shape of ``K4_PATH_SHAPES`` (audio >= 70 dB on open slots,
    shut and inactive ones silent, RSSI and tails exact) and K12 / K13's
    timing at every shape of ``K12_PATH_SHAPES`` (:func:`timing_vs_plain`),
    each against its plain version on the card, timed beside its bound (K4
    both ways)."""
    from wavecap_tpu_torch.models import channel_bank as cb

    clock_hz = clock_hz or sm_clock_hz()
    cases = []
    for what, slots, s in K4_PATH_SHAPES:
        args = k4_path_case(device, slots, s)
        a_k, r_k, t_k = (host(v) for v in cb.voice_fir(*args))
        a_p, r_p, t_p = (host(v) for v in cb.voice_fir_plain(*args))
        assign = args[3]
        open_ = host(assign.active) & (host(args[2]) >= host(assign.squelch_db))
        worst = min(snr_db(a_p[i], a_k[i]) for i in np.flatnonzero(open_))
        check(worst >= 70.0, f"K4 ({what}): audio SNR {worst:.1f} dB < 70 on an open slot")
        check(not a_k[~open_].any(), f"K4 ({what}): a shut slot is not silent")
        check(np.array_equal(r_k, r_p) and np.array_equal(t_k, t_p), f"K4 ({what}): rssi or tail differs")
        nb, nf = k4_bytes_ops(slots, s)
        b, f = bound(nb, nf)
        cases.append(dict(name="K4_voice_fir", case=what, plan=cb.k4_plan(slots, s)._asdict(),
                          worst_open_snr_db=worst, max_abs_err=max_abs(a_p, a_k),
                          ms=timer(lambda: cb.voice_fir(*args), "voice_fir_kernel"), bound_ms=b, bound_by=f,
                          bound_bytes_ms=bound(nb, 0.0)[0], bound_ops_ms=bound(0.0, nf)[0]))
        del args
    for what, kind, rows, n in K12_PATH_SHAPES:
        kfn, pfn, buf, st, n_sym, cfg = k12_path_case(device, kind, rows, n)
        name = K12_NAMES[kind]
        rec = timing_vs_plain(name, what, kfn, pfn, buf, st, n_sym, cfg, clock_hz)
        cases.append(dict(name=name, case=what, **rec,
                          ms=timer(lambda: kfn(buf, st, n_sym, cfg), "timing_kernel")))
        del buf
    return cases


def tree_leaves(x) -> list:
    """The tensors of a state tree (NamedTuples and tuples of tensors)."""
    if x is None:
        return []
    if isinstance(x, tuple):
        return [leaf for v in x for leaf in tree_leaves(v)]
    return [x]


def to_cpu(x):
    """A state tree (NamedTuples and tuples of tensors) copied to the CPU."""
    if isinstance(x, tuple):
        items = [to_cpu(v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x if x is None else x.cpu()


def same_bits(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(host(x).tobytes() == host(y).tobytes() and x.shape == y.shape
                                      for x, y in zip(la, lb))


EMPTY_BANKS = {"nbfm, IIR filters": ("nbfm", "NbfmConfig", dict(enable_highpass=True, enable_lowpass=True)),
               "nbfm, the voice FIR": ("nbfm", "NbfmConfig", dict(enable_highpass=True, enable_lowpass=True,
                                                                 filter_impl="fir")),
               "am": ("am", "AmConfig", {})}


def empty_block_checks(device) -> dict:
    """A 0-sample block on the card, after a block of signal: ``channelize``
    (channels (M, 0), the history bitwise unchanged) and ``bank_step`` of
    an NBFM bank with IIR filters, one with the voice FIR and an AM bank
    (M = 80, 4 slots, slot 2 inactive) against the plain versions (the
    same state copied to the CPU): audio (4, 0), RSSI equal (NaN as equal;
    -200 on the inactive slot), every carry bitwise unchanged; K4 at S = 0
    the same; no kernel launched.  Then K13's CFO stage on program B's 21
    rows at n = 0 (an FFT of 1,024 bins): the padded buffer all zero,
    ``j = 0`` and ``resid = 0`` as the plain versions give them, each K13
    kernel launched once by the stage and once on its own."""
    import torch

    from wavecap_tpu_torch import models
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts
    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.models.p25 import cqpsk
    from wavecap_tpu_torch.ops import channelizer as chz

    ch = chz.ChannelizerConfig(sample_rate=1_000_000.0, channel_bandwidth=12_500.0)
    rng = np.random.default_rng(SEED + 14)
    x = torch.from_numpy((0.1 * (rng.standard_normal(80 * 40) + 1j * rng.standard_normal(80 * 40)))
                         .astype(np.complex64)).to(device)
    empty = torch.zeros(0, dtype=torch.complex64, device=device)
    assign = cb.ChannelAssignment(
        torch.tensor([3, 10, 20, 30], dtype=torch.int32, device=device),
        torch.tensor([0.0, 700.0, 0.0, -300.0], device=device),
        torch.tensor([True, True, False, True], device=device), torch.full((4,), -45.0, device=device))
    out = {}
    hist = chz.channelize(x, chz.channelizer_init(ch, device=device), ch)[1]
    reset_launch_counts()
    chans, hist2 = chz.channelize(empty, hist, ch)
    check(tuple(chans.shape) == (80, 0) and same_bits(hist, hist2), "channelize: an empty block changed the history")
    check(sum(launch_counts().values()) == 0, "channelize: an empty block launched a kernel")
    out["channelize"] = dict(channels=list(chans.shape), launches=0)
    for what, (mode, cls, opts) in EMPTY_BANKS.items():
        cfg = cb.ChannelBankConfig(channelizer=ch, mode=mode, capacity=4,
                                   demod_cfg=getattr(models, cls)(sample_rate=25_000, audio_rate=25_000, **opts))
        state = cb.bank_step(x, cb.bank_init(cfg, device=device), assign, cfg)[1]
        reset_launch_counts()
        o_k, s_k = cb.bank_step(empty, state, assign, cfg)
        launched = sum(launch_counts().values())
        on_cpu = to_cpu(state)
        o_p, s_p = cb.bank_step(empty.cpu(), on_cpu, to_cpu(assign), cfg)  # the plain versions
        r_k, r_p = host(o_k["rssi"]), host(o_p["rssi"])
        check(launched == 0, f"bank_step ({what}): an empty block launched {launched} kernels")
        check(tuple(o_k["audio"].shape) == tuple(o_p["audio"].shape) == (4, 0), f"bank_step ({what}): audio shape")
        check(np.array_equal(r_k, r_p, equal_nan=True) and r_k[2] == -200.0 and np.isnan(r_k[[0, 1, 3]]).all(),
              f"bank_step ({what}): RSSI {r_k} against the plain path's {r_p}")
        check(same_bits(state, s_k) and same_bits(on_cpu, s_p), f"bank_step ({what}): a carry changed")
        out[what] = dict(audio=list(o_k["audio"].shape), rssi=[float(v) for v in r_k], launches=launched)
    args = k4_path_case(device, 4, 0)
    reset_launch_counts()
    a_k, r_k, t_k = cb.voice_fir(*args)
    check(sum(launch_counts().values()) == 0, "K4 at S = 0 launched")
    a_p, r_p, t_p = cb.voice_fir_plain(*args)
    check(tuple(a_k.shape) == tuple(a_p.shape) == (4, 0) and same_bits(r_k, r_p) and same_bits(t_k, args[1])
          and same_bits(t_p, args[1]), "K4 at S = 0 differs from its plain version")
    out["K4 at S = 0"] = dict(audio=list(a_k.shape), launches=0)
    cfg_q, filt, _ = cfo_path_case(device, "B", "p25")
    empty_rows = filt[:, :0]
    size, k4, off, step = cqpsk._cfo_search(cfg_q, 0)
    reset_launch_counts()
    r_k = cqpsk._estimate_cfo_residual(empty_rows, cfg_q)
    buf = cqpsk.cfo_power(empty_rows, size)
    r_l, j_l = cqpsk.cfo_lines(torch.fft.fft(buf, dim=-1), k4, off, step)
    launched = {k: v for k, v in launch_counts().items() if v}
    r_p, j_p = cqpsk.cfo_lines_plain(torch.fft.fft(cqpsk.cfo_power_plain(empty_rows.cpu(), size), dim=-1),
                                     k4, off, step)
    check(tuple(buf.shape) == (filt.shape[0], size) and not bool(buf.any()),
          "K13_cfo_power at n = 0: the padded buffer is not all zero")
    check(same_bits(r_k, r_p) and same_bits(r_l, r_p) and same_bits(j_l, j_p) and not bool(j_p.any())
          and not bool(r_p.any()), f"K13's CFO stage at n = 0: resid {host(r_k)}, j {host(j_l)}")
    check(launched == {"K13_cfo_power": 2, "K13_cfo_lines": 2}, f"K13's CFO stage at n = 0 launched {launched}")
    out["K13's CFO stage at n = 0"] = dict(rows=filt.shape[0], size=size, resid=float(r_k.abs().max()),
                                          launches=launched)
    return out


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


def plain_capture_step(words, state, ctl, cfg, scale=None):
    """The same capture step with every kernel swapped for its plain
    version (the reference for the first blocks)."""
    from wavecap_tpu_torch.capture.pipeline import capture_step

    with plain_kernels():
        return capture_step(words, state, ctl, cfg, scale)


def block_of(words, k: int):
    """Block ``k`` of a batch: ``(words, scale)`` (``scale`` None for i16)."""
    if isinstance(words, tuple):
        return words[0][k], words[1][k]
    return words[k], None


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
        fetch(o["_packed"])

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
        profile=profile_blocks(one_pass, N_BLOCKS, sync),
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
    # 2.4 Msps / 25 kHz geometry); the narrow and streaming cases also at
    # program D's and E's bank rows (160, 100).  The yardstick is one
    # conv_transpose1d (zero-stuff by up and filter) sliced at off::down,
    # held against the plain version first
    def k5_yardstick(x, head, up, down, off, n_out, ph_len):
        h = fir._resample_taps(up, down, device).reshape(1, 1, -1)
        v = (x if head is None else torch.cat([head, x], -1)).unsqueeze(1)
        start = off if head is None else (ph_len - 1) * up

        def call():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv_transpose1d(v, h, stride=up)[:, 0, start::down][:, :n_out]
        return call

    def k5_case(case, x, head, up, down, off, n_out, call, plain, lib):
        y_k, y_p = host(call()), host(plain())
        err = rel_l2(y_p, y_k)
        check(err <= 1e-5, f"K5 {case} rel L2 {err:.3g} > 1e-5")
        rows, n_in = x.shape
        taps = fir.design_resample_poly_filter(up, down)
        ph_len = -(-len(taps) // up)
        used_rows = len(np.unique((off + np.arange(n_out, dtype=np.int64) * down) % up))
        head_bytes = 0 if head is None else 2 * rows * (ph_len - 1) * 4  # the head in, the tail out
        b, f = bound(rows * n_in * 4 + rows * n_out * 4 + head_bytes + used_rows * ph_len * 4,
                     2.0 * rows * n_out * ph_len)
        extra = dict(library_note="no single PyTorch call computes a rational resample with up > 1")
        lib_ms = None
        if lib is not None:
            lib_err = rel_l2(y_p, host(lib()))
            check(lib_err <= 1e-5, f"K5 {case}: the conv_transpose1d yardstick rel L2 {lib_err:.3g} > 1e-5")
            lib_ms = timer(lib)
            extra = dict(library_call="F.conv_transpose1d(v, h, stride=up)[..., off::down][:n_out], TF32 off",
                         library_rel_l2=lib_err)
        plan = fir.k5_plan(up, down, ph_len)
        record("K5_resample_poly", f"{case} {up}/{down} ({rows}, {n_in}) -> ({rows}, {n_out})",
               k5_src, k5_rep, lib_ms, max_abs_err=max_abs(y_p, y_k), rel_l2=err,
               ms=timer(call, K5_KERNELS), wrapper_ms=wall_timer(call), plain_ms=timer(plain),
               bound_ms=b, bound_by=f, tile=plan.tile,
               variant=("table", "warp")[plan.variant], **extra)

    rate_n = int(ch.channel_rate)
    xs = {"narrow": dev(rng.standard_normal((m, s)).astype(np.float32)),
          "wide": dev(rng.standard_normal((2, n_if)).astype(np.float32))}
    for case, x, rate_in in (("narrow one-shot", xs["narrow"], rate_n), ("wide one-shot", xs["wide"], if_rate),
                             ("narrow one-shot", xs["narrow"][:160], rate_n),
                             ("narrow one-shot", xs["narrow"][:100], rate_n)):
        up, down, taps = fir._resample_plan(rate_in, ar)
        ph_len = -(-len(taps) // up)
        n_out = -(-x.shape[-1] * up // down)
        off = (len(taps) - 1) // 2
        lib = k5_yardstick(x, None, up, down, off, n_out, ph_len) if case.startswith("narrow") else None
        k5_case(case, x, None, up, down, off, n_out,
                lambda x=x, rate_in=rate_in: fir.resample_poly(x, rate_in, ar),
                plain_call(lambda x=x, rate_in=rate_in: fir.resample_poly(x, rate_in, ar)), lib)
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
    x_st = dev(rng.standard_normal((160, 10_000)).astype(np.float32))
    tail_st = dev(rng.standard_normal((160, ph_len - 1)).astype(np.float32))
    for case, x, tail in (("streaming, after 3 blocks", x3[0], tail_k),
                          ("streaming", x_st, tail_st), ("streaming", x_st[:100], tail_st[:100])):
        k5_case(case, x, tail, up, down, 0, n_out,
                lambda x=x, tail=tail: fir.resample_poly_stream(x, 50_000, 48_000, tail)[0],
                plain_call(lambda x=x, tail=tail: fir.resample_poly_stream(x, 50_000, 48_000, tail)[0]),
                k5_yardstick(x, tail, up, down, 0, n_out, ph_len))
    cases[-3]["rel_l2_3_blocks"] = max(errs)

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
    # K7 at a mesh shard's wide slots (program E, 8 time shards): the shard's
    # samples behind the history's T - 1, one shared row, no head
    n_sh = n // MESH_SHARDS + t_len - 1
    xs = xw[:n_sh]

    def k7_shard():
        return fir.strided_fir(xs, taps, wide.decim, nco=(dphi, p0))

    out_k = [host(v) for v in k7_shard()]
    out_p = [host(v) for v in fir.strided_fir_plain(xs, taps, wide.decim, None, (dphi, p0))]
    err = rel_l2(out_p[0], out_k[0])
    check(err <= 1e-5 and rel_l2(out_p[1], out_k[1]) <= 1e-6 and np.array_equal(out_p[2], out_k[2]),
          f"K7 at a mesh shard's wide slots: rel L2 {err:.3g} > 1e-5, or its tail or phases differ")
    n_out_sh = out_k[0].shape[-1]
    b, f = bound(n_sh * 8 + t_len * 4 + 2 * n_out_sh * 8 + 2 * (t_len - 1) * 8,
                 2.0 * n_sh * 11 + 2.0 * n_out_sh * t_len * 4)
    planes_sh = planes[:, t_len - 1:t_len - 1 + n_sh].contiguous()
    cases.append(dict(
        name="K7_strided_fir", case=f"a mesh shard's wide slots (program E): NCO + decimate by {wide.decim}, "
        f"{t_len} taps, 2 x {n_sh} complex -> {n_out_sh}", rel_l2=err, max_abs_err=max_abs(out_p[0], out_k[0]),
        bound_ms=b, bound_by=f, ms=timer(k7_shard, "strided_fir_kernel"), wrapper_ms=wall_timer(k7_shard),
        plain_ms=timer(lambda: fir.strided_fir_plain(xs, taps, wide.decim, None, (dphi, p0))),
        library_ms=timer(lambda: F.conv1d(planes_sh.unsqueeze(1), kern, stride=wide.decim))))
    # K7 at the wide slots of 20 and 25 Msps captures (0.2 s blocks): spans
    # too long for the big tiles, so the plan takes a phase set a phase
    from wavecap_tpu_torch.capture.pipeline import WideSlotConfig

    for rate in (20_000_000, 25_000_000):
        wide_r = WideSlotConfig(sample_rate=rate, capacity=2)
        taps_r = _wide_taps_on(wide_r, device)
        t_r, n_r = taps_r.shape[0], rate // 5
        x_r = dev((rng.standard_normal(n_r) + 1j * rng.standard_normal(n_r)).astype(np.complex64) * 0.1)
        head_r = dev((rng.standard_normal((2, t_r - 1)) + 1j * rng.standard_normal((2, t_r - 1)))
                     .astype(np.complex64) * 0.1)
        dphi_r = tuning_word(-dev(np.array(WIDE_OFFSETS, np.float32)), rate)

        def k7_rate(x_r=x_r, taps_r=taps_r, d_r=wide_r.decim, head_r=head_r, dphi_r=dphi_r):
            return fir.strided_fir(x_r, taps_r, d_r, head=head_r, nco=(dphi_r, p0))

        def k7_rate_plain(x_r=x_r, taps_r=taps_r, d_r=wide_r.decim, head_r=head_r, dphi_r=dphi_r):
            return fir.strided_fir_plain(x_r, taps_r, d_r, head_r, (dphi_r, p0))

        out_k = [host(v) for v in k7_rate()]
        out_p = [host(v) for v in k7_rate_plain()]
        err = rel_l2(out_p[0], out_k[0])
        check(err <= 1e-5 and rel_l2(out_p[1], out_k[1]) <= 1e-6 and np.array_equal(out_p[2], out_k[2]),
              f"K7 at {rate / 1e6:g} Msps wide slots: rel L2 {err:.3g} > 1e-5, or its tail or phases differ")
        n_out_r = out_k[0].shape[-1]
        plan_r = fir.k7_plan(t_r, wide_r.decim, 2, n_out_r, True, False)
        b, f = bound(n_r * 8 + 2 * (t_r - 1) * 8 * 2 + t_r * 4 + 2 * n_out_r * 8,
                     2.0 * n_r * 11 + 2.0 * n_out_r * t_r * 4)
        cases.append(dict(
            name="K7_strided_fir", case=f"wide slots at {rate / 1e6:g} Msps: NCO + decimate by {wide_r.decim}, "
            f"{t_r} taps, 2 x {n_r} complex -> {n_out_r}", rel_l2=err, max_abs_err=max_abs(out_p[0], out_k[0]),
            plan=dict(groups=plan_r.groups, phase_sets=plan_r.phase_sets, splits=plan_r.splits,
                      direct=plan_r.direct, smem=plan_r.smem),
            bound_ms=b, bound_by=f, ms=timer(k7_rate, "strided_fir_kernel"), wrapper_ms=wall_timer(k7_rate),
            plain_ms=timer(k7_rate_plain), library_ms=None))
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

    # empty and short blocks through K5's and K7's wrappers: no output, the
    # tail and NCO phase carried as the reference carries them.  Without an
    # NCO nothing launches; with one, K7 runs with no output tiles and
    # writes the mixed tail and the next phase, held against the plain version
    from wavecap_tpu_torch.kernels import launch_counts

    before = launch_counts()
    tail24 = fir.resample_stream_init(50_000, 48_000, device=device).expand(96, -1)
    y_e, t_e = fir.resample_poly_stream(x3[0][:, :0], 50_000, 48_000, tail24)
    check(y_e.shape == (96, 0) and t_e is tail24, "K5 stream: an empty block is not a no-op")
    y_e = fir.polyphase_resample(x3[0], up, down, 0, tail24, 0)
    check(y_e.shape == (96, 0), "K5: no outputs asked, some given")
    y_e, t_e = fir.resample_poly_stream(x5[:, :0], 240_000, 48_000, tail5)
    check(y_e.shape == (2, 0) and torch.equal(t_e, tail5), "K7 stream: an empty block is not a no-op")
    check(fir.conv_valid(x5[:, :10], taps5).shape == (2, 0), "K7: a row shorter than its taps gave output")
    short = (x5[:, :7], taps5, 5, tail5[:, :50].contiguous())
    out_k, out_p = fir.strided_fir(*short), fir.strided_fir_plain(*short)
    check(out_k[0].shape == (2, 0) and torch.equal(out_k[1], out_p[1]),
          "K7: a block shorter than its taps does not carry its tail")
    check(launch_counts() == before, "an empty or short block without an NCO launched a kernel")
    for n_short, h_len in ((5, 10), (0, t_len - 1)):
        short = (xw[:n_short], taps, wide.decim, head[:, :h_len].contiguous(), (dphi, p0))
        out_k, out_p = fir.strided_fir(*short), fir.strided_fir_plain(*short)
        check(out_k[0].shape == (2, 0) and out_k[1].shape == out_p[1].shape == (2, h_len + n_short)
              and rel_l2(host(out_p[1]), host(out_k[1])) <= 1e-6 and torch.equal(out_k[2], out_p[2]),
              f"K7: a short block ({h_len} + {n_short} samples) with an NCO does not carry its "
              "mixed tail and phase")
    check(torch.equal(out_k[1], head) and torch.equal(out_k[2], p0),
          "K7: an empty block changed the head or the NCO phase")
    after = launch_counts()
    check(after["K7_strided_fir"] - before["K7_strided_fir"] == 2
          and sum(after.values()) - sum(before.values()) == 2,
          "K7: a short block with an NCO did not launch K7 once")
    cases.append(dict(name="K5_resample_poly", case="empty and short blocks (K5, K7 wrappers)",
                      empty_blocks_ok=True))

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
    def k9_case(case, x, sos, z0):
        """K9's cascade on ``x`` against the plain scan and float64 scipy."""
        rows, n_sec, n_x = x.shape[0], sos.shape[0], x.shape[-1]

        def call():
            return iir.sos_filter(x, sos, z0)
        y_k, _ = (host(v) for v in call())
        y_p, _ = (host(v) for v in iir.sos_filter_plain(x, sos, z0))
        err = snr_db(y_p, y_k)
        check(err >= 50.0, f"K9 {case}: {err:.1f} dB < 50 against the plain scan")
        xs = host(x)[:4].astype(np.float64)
        ref64 = np.stack([sps.sosfilt(sos, xs[i], zi=host(z0)[i].astype(np.float64))[0] for i in range(len(xs))])
        err64 = snr_db(ref64, y_k[:4])
        check(err64 >= 55.0, f"K9 {case}: {err64:.1f} dB < 55 against float64 scipy")
        ch_len, segment = iir.k9_plan(n_x)
        b, f = bound(2 * rows * n_x * 4 + 2 * rows * n_sec * 8 + n_sec * 20, 10.0 * rows * n_x * n_sec)
        record("K9_iir_cascade", f"{case}: {n_sec} sections, ({rows}, {n_x}), chunks of {ch_len}",
               k9_src, k9_rep, None, max_abs_err=float(np.max(np.abs(y_k - y_p))), snr_vs_plain_db=err,
               snr_vs_float64_db=err64, bound_ms=b, bound_by=f, chunk=ch_len, segment=segment,
               n_mod_chunk=n_x % ch_len,
               # one chunk's chain: L samples x sections x a dependent multiply-add pair
               chain_ms=chain_ms(2 * ch_len * n_sec, FMA_CYCLES, clock_hz),
               ms=timer(call, K9_KERNELS), wrapper_ms=wall_timer(call),
               # one call: the plain scan launches thousands of kernels
               plain_ms=timer(lambda: iir.sos_filter_plain(x, sos, z0), reps=1, warm=1),
               library_note="no torch op runs an IIR recurrence")

    for case, x, sos in k9_cases:
        k9_case(case, x, sos, carried(sos, x.shape[0]))
    # the edges of the chunked scan: a mesh shard's 100 rows, 1 row, the
    # 8-section maximum, a short row, rows of 3 segments
    hp = iir.butter_sos("high", (300.0,), 5, ar)
    shard_rows = min(100, c)  # program E's 800 bins over 8 shards
    k9_case("nbfm high-pass, a shard's rows", xa[:shard_rows], hp, carried(hp, shard_rows))
    k9_case("nbfm high-pass, one row", xa[:1], hp, carried(hp, 1))
    lp16 = iir.butter_sos("low", (2000.0,), 16, ar)
    k9_case("low-pass 2 kHz, 8 sections", xa, lp16, carried(lp16, c))
    lp = iir.butter_sos("low", (3000.0,), 5, ar)
    # k9_plan keeps chunks at ceil(segment / 256) or less, so a row is never
    # shorter than its chunk; 50 samples run 50 chunks of 1
    k9_case("low-pass 3 kHz, 50 samples", xa[:4, :50].contiguous(), lp, carried(lp, 4))
    long_x = dev(np.tile(xa_np[:4], 4)[:, :30_000])
    k9_case("low-pass 3 kHz, 3 segments", long_x, lp, carried(lp, 4))
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
                      ms=timer(lambda: iir.onepole_filter(xw2, b0, a, y0), K9_KERNELS),
                      wrapper_ms=wall_timer(lambda: iir.onepole_filter(xw2, b0, a, y0)),
                      plain_ms=timer(lambda: iir.onepole_filter_plain(xw2, b0, a, y0)),
                      library_ms=None, chain_ms=chain_ms(iir.k9_plan(n_audio)[0], FMA_CYCLES, clock_hz)))
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
                      ms=timer(lambda: agc.envelope(xa, ca, cr, st), K9_KERNELS),
                      wrapper_ms=wall_timer(lambda: agc.envelope(xa, ca, cr, st)),
                      plain_ms=timer(lambda: agc.envelope_plain(xa, ca, cr, st)),
                      library_ms=None, chain_ms=chain_ms(2 * iir.k9_plan(n_audio)[0], FMA_CYCLES, clock_hz)))

    # K10: SAM's carrier PLL and the Costas loop at (160, S), and at a mesh
    # shard's 100 rows
    k10_src, k10_rep = ("wavecap_tpu_torch/kernels/csrc/pll.cu",
                        "wavecap_tpu/ops/pll.py:36 carrier_recovery_pll, :70 costas_loop_qpsk")
    ts = np.arange(s) / ch.channel_rate
    f_off = rng.uniform(-40, 40, (c, 1))
    am = 0.3 * (1 + 0.6 * np.sin(2 * np.pi * 1000 * ts)) * np.exp(1j * (2 * np.pi * f_off * ts + rng.uniform(-3, 3, (c, 1))))
    sym = rng.integers(0, 4, (c, s // 5 + 1)).repeat(5, axis=1)[:, :s]
    qpsk = np.exp(1j * (np.pi / 4 + np.pi / 2 * sym + 2 * np.pi * f_off * ts))
    st0 = pll.PllState(dev(rng.uniform(-3, 3, c).astype(np.float32)), dev(np.zeros(c, np.float32)))
    alpha, beta = pll.pll_coeffs(50.0, ch.channel_rate)
    for (case, sig, det), rows in ((k, r) for r in (c, min(100, c)) for k in (
            ("SAM carrier PLL", am, 0), ("Costas QPSK", qpsk, 1))):
        st_r = pll.PllState(st0.phase[:rows], st0.freq[:rows])
        if det == 0:
            def fn(z, st_r=st_r):
                return pll.carrier_recovery_pll(z, ch.channel_rate, st_r)
        else:
            def fn(z, st_r=st_r):
                return pll.costas_loop_qpsk(z, st_r, alpha, beta)
        z = dev((sig[:rows] + 1e-3 * (rng.standard_normal((rows, s)) + 1j * rng.standard_normal((rows, s))))
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
        b, f = bound(2 * rows * s * 8 + 4 * rows * 4, 18.0 * rows * s)
        record("K10_pll", f"{case} ({rows}, {s})", k10_src, k10_rep, None,
               max_abs_err=float(np.max(np.abs(o_k - o_p))), coherent_snr_db=err,
               final_phase_max_abs_rad=d_ph, bound_ms=b, bound_by=f,
               # the step's dependent path, counted from the kernel's SASS
               chain_ms=chain_ms(s, K10_CHAIN_CYCLES[det], clock_hz),
               ms=timer(lambda: fn(z), K10_KERNELS), wrapper_ms=wall_timer(lambda: fn(z)),
               # the plain loop steps sample by sample: its wall time, one call
               # (a CUPTI profile of its launches took ~65 s a case)
               plain_ms=wall_timer(plain_call(lambda: fn(z)), reps=1),
               plain_note="wall time between CUDA events (the loop over samples)",
               library_note="no torch op runs a phase-locked loop")
    cases.append(k10_function_checks(device))

    return [lines[k] for k in ("K5_resample_poly", "K7_strided_fir", "K9_iir_cascade", "K10_pll")], cases


def ulps(ref64: np.ndarray, got: np.ndarray) -> np.ndarray:
    """|got - ref| in float32 ulps of the float64 reference."""
    spacing = np.spacing(np.abs(ref64).astype(np.float32)).astype(np.float64)
    return np.abs(got.astype(np.float64) - ref64) / spacing


def k10_function_checks(device, points: int = 1 << 20) -> dict:
    """K10's own sin, cos and atan on the card against float64, through
    the kernel itself: rows of one sample each.  With a = b = 0 and z = 1
    the output is (cos, sin) of the row's -phase; with phase 0, a = 1, b =
    0 the final phase is the detector atan2(Im z, |Re z| + 1e-10).  Floors:
    2 ulp (sin, cos) over [-pi - 0.1, pi + 0.1], 3 ulp (atan) over a dense
    grid of the detector's range (the quotient and the polynomial each add
    their rounding)."""
    import torch

    from wavecap_tpu_torch.ops import pll

    x = np.linspace(-np.pi - 0.1, np.pi + 0.1, points).astype(np.float32)
    ones = torch.ones((points, 1), dtype=torch.complex64, device=device)
    zero = torch.zeros(points, device=device)
    out, _ = pll._loop(ones, pll.PllState(torch.from_numpy(x).to(device), zero), 0.0, 0.0, 0)
    out = host(out)[:, 0]
    u_cos = float(ulps(np.cos(-x.astype(np.float64)), out.real).max())
    u_sin = float(ulps(np.sin(-x.astype(np.float64)), out.imag).max())
    check(u_cos <= 2.0 and u_sin <= 2.0, f"K10 sin/cos: {u_sin:.2f} / {u_cos:.2f} ulp > 2")
    rng = np.random.default_rng(SEED + 10)
    mag = 10.0 ** rng.uniform(-6, 1, (2, points))
    re = (rng.standard_normal(points) * mag[0]).astype(np.float32)
    im = (rng.standard_normal(points) * mag[1]).astype(np.float32)
    # and a dense sweep of |y| / x through 1, where the two branches meet
    ratio = np.linspace(0.5, 2.0, points // 4)
    re[: points // 4] = np.float32(0.3)
    im[: points // 4] = (0.3 * ratio * np.where(np.arange(points // 4) % 2, 1, -1)).astype(np.float32)
    z = torch.from_numpy((re + 1j * im).astype(np.complex64)).to(device).reshape(points, 1)
    _, st = pll._loop(z, pll.PllState(zero, zero), 1.0, 0.0, 0)
    xpos = (np.abs(re) + np.float32(1e-10)).astype(np.float32)
    u_atan = float(ulps(np.arctan2(im.astype(np.float64), xpos.astype(np.float64)), host(st.phase)).max())
    check(u_atan <= 3.0, f"K10 atan: {u_atan:.2f} ulp > 3")
    return dict(name="K10_pll", case=f"sin, cos, atan on the card, {points} points each",
                sin_max_ulp=u_sin, cos_max_ulp=u_cos, atan_max_ulp=u_atan)


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
    expected = {name: N_BLOCKS * MIXED_LAUNCHES.get(name, 0) for name in counts}
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
        fetch(o["_packed"])

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
    card's busy ms (kernels and copies, CUPTI), its idle share, the pass's
    device-to-host copies (the wire's fetch into pinned memory) and the
    busy ms without them, the host's
    CPU ms, the ops with the most device time, and every kernel's (K1-K14,
    K12s, K13s; K11b's three launches as one) device time and launches
    summed over all its functions' instances (each template instance or
    variant is an op of its own, and may miss the top list)."""
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
    fetch_ms = sum(dev_ms(e) for e in on_card if "DtoH" in e.key)
    top = sorted(on_card, key=dev_ms, reverse=True)[:14]
    return dict(
        traced_wall_ms_per_block=wall_ms, device_busy_ms_per_block=busy,
        device_idle_share=1.0 - busy / wall_ms, fetch_copy_ms_per_block=fetch_ms,
        busy_without_fetch_ms_per_block=busy - fetch_ms,
        host_self_cpu_ms_per_block=sum(e.self_cpu_time_total for e in events
                                       if e.device_type == DeviceType.CPU) / 1e3 / blocks,
        top_device_ms_per_block=[dict(op=e.key[:80], calls_per_block=e.count / blocks, ms=dev_ms(e))
                                 for e in top if dev_ms(e) > 0],
        kernel_totals_per_block={
            name: dict(ms=sum(dev_ms(e) for e in hits), launches=sum(e.count for e in hits) / blocks)
            for name, kernels in KERNEL_FUNCTIONS.items()
            for hits in [[e for e in on_card if any(k in e.key for k in kernels)]]},
    )


# --- the P25 programs: kernel checks (phase 2) and runs (phases 5 and 6) ---------------

P25_LOOP_SYMBOLS = 2_400  # 0.5 s at 4800 baud; a multiple of 3, as 48 kHz -> 10 Msps is 625/3
P25_AMPLITUDE = 0.05
P25_FIRST = 2  # decisions are counted from block 3 on (timing, CFO and equalizer acquired)
P25_SQUELCH_DB = -45.0
# program A (10 Msps, M = 400): C4FM stations (p25 slot, fine offset Hz), NBFM stations (nbfm slot)
A_C4FM_STATIONS = ((0, 0.0), (9, 0.0), (17, 2000.0), (26, 0.0), (33, -700.0), (49, 300.0))
A_NBFM_STATIONS = (3, 21, 40)
# program B (2.4 Msps, M = 96): LSM stations (p25 slot, fine offset Hz, carrier offset Hz, echo)
B_STATIONS = ((0, 0.0, 0.0, False), (3, 0.0, 0.0, False), (7, 0.0, 600.0, False),
              (12, 0.0, 0.0, True), (16, -1500.0, 0.0, False), (20, 800.0, 0.0, False))
ECHO = (168, 0.8, 2.98)  # 70 us at 2.4 Msps, amplitude, phase (tests/test_p25_roundtrip.py:396-399)
# program C: the CQPSK control channel on p25 slot 0 (slot 1 the probe, empty);
# 6000-baud stations (p25p2 slot, fine offset Hz)
C_P2_STATIONS = ((0, 0.0), (5, 1000.0), (11, 0.0), (19, -600.0))
# kernel launches per block of each program
A_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 2, "K5_resample_poly": 1,
              "K7_strided_fir": 2, "K9_iir_cascade": 2, "K12_c4fm_timing": 1}
B_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 1, "K7_strided_fir": 3,
              "K13_cfo_power": 1, "K13_cfo_lines": 1, "K13_cqpsk_timing": 1, "K14_echo_fit": 2}
C_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 2, "K7_strided_fir": 2,
              "K13_cfo_power": 2, "K13_cfo_lines": 2, "K13_cqpsk_timing": 2}
# a serial pass of K12/K13: ~40 SM cycles per element a thread walks, ~300 per block reduction
PASS_CYCLES, REDUCE_CYCLES = 40, 300


def p25_configs() -> dict:
    """Programs A, B and C at full width."""
    from wavecap_tpu_torch.capture.pipeline import CapturePipelineConfig

    common = dict(channel_bandwidth=25_000.0, fft_size=2048, spectrum_frames=2, audio_rate=48_000,
                  wide_capacity=0)
    return {
        "A": CapturePipelineConfig(sample_rate=10_000_000, block_size=2_500_000, narrow_modes=("nbfm",),
                                   narrow_capacity=50, p25_capacity=50, p25_modulation="c4fm",
                                   p25_equalizer_taps=0, **common),
        "B": CapturePipelineConfig(sample_rate=2_400_000, block_size=360_000, narrow_modes=(),
                                   p25_capacity=21, p25_modulation="cqpsk", p25_equalizer_taps=41,
                                   **common),
        "C": CapturePipelineConfig(sample_rate=2_400_000, block_size=360_000, narrow_modes=(),
                                   p25_capacity=2, p25_modulation="cqpsk", p25_equalizer_taps=0,
                                   p25p2_capacity=20, **common),
    }


def p25_bins(m: int, count: int, step: int) -> list:
    """``count`` channelizer bins ``step`` apart, clear of DC and the band edge."""
    bins = [k for k in range(2, m - 1, step) if abs(k - m // 2) > 2]
    check(len(bins) >= count, f"{count} slots do not fit in {m} bins")
    return bins[:count]


def closed_dibits(rng, n: int) -> np.ndarray:
    """Random dibits whose pi/4 phase steps sum to a multiple of 2 pi, so a
    cyclic CQPSK loop of them needs no pad symbols."""
    from wavecap_tpu_torch.models.p25.c4fm import DIBIT_SYMBOLS

    check(n % 2 == 0, "an odd number of pi/4-odd steps cannot close")
    d = rng.integers(0, 4, n).astype(np.uint8)
    while int(np.sum(DIBIT_SYMBOLS[d].astype(np.int64))) % 8:
        d[int(np.flatnonzero(d == 0)[0])] = 1  # a +1 step becomes +3: the sum moves by 2
    return d


def p25_loop(rng, kind: str, out_rate: int, symbol_rate: float = 4800.0, alpha: float = 0.2):
    """``(dibits, iq)``: a seamless loop of P25 modulation at ``out_rate``,
    synthesised at 48 kHz and brought up with circular FFT resampling."""
    from scipy import signal as sps

    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm_cyclic
    from wavecap_tpu_torch.models.p25.cqpsk import modulate_cqpsk_cyclic

    if kind == "c4fm":
        d = rng.integers(0, 4, P25_LOOP_SYMBOLS).astype(np.uint8)
        x = modulate_c4fm_cyclic(d, 48_000.0)
    else:
        d = closed_dibits(rng, int(round(P25_LOOP_SYMBOLS * symbol_rate / 4800.0)))
        x = modulate_cqpsk_cyclic(d, 48_000.0, symbol_rate, alpha)
    n_out = len(x) * out_rate // 48_000
    check(n_out * 48_000 == len(x) * out_rate, "the loop does not resample to a whole length")
    return d, sps.resample(x, n_out).astype(np.complex64)


def agreement(soft: np.ndarray, dibits: np.ndarray) -> float:
    """Share of one block's hard decisions equal to the loop's dibits at the
    best cyclic alignment (cross-correlation of the soft symbols with the
    loop's symbol values)."""
    import torch

    from wavecap_tpu_torch.models.p25.c4fm import DIBIT_SYMBOLS, soft_to_dibits

    sym = DIBIT_SYMBOLS[dibits].astype(np.float64)
    p, n = len(sym), len(soft)
    check(n <= p, "a block holds more symbols than the loop")
    s = np.zeros(p)
    s[:n] = soft
    lag = int(np.argmax(np.fft.ifft(np.conj(np.fft.fft(s)) * np.fft.fft(sym)).real))
    hard = soft_to_dibits(torch.from_numpy(np.asarray(soft, np.float32))).numpy()
    return float(np.mean(hard == dibits[(lag + np.arange(n)) % p]))


def om_lock(u: np.ndarray, sps_: float) -> float:
    """The O&M lock measure of one row of |x|^2 (float64 numpy)."""
    n = len(u)
    w = np.exp(-2j * np.pi * np.arange(n) / sps_)
    return float(np.abs(np.sum(u * w)) / max(np.sum(np.abs(u)), 1e-9))


def c4fm_rows(rng, rows: int, length: int, fs: float) -> np.ndarray:
    """RRC-filtered discriminator rows of C4FM at ``fs``, each with its own
    clock offset (up to +-300 ppm) and start phase; the last row dead air
    (filtered noise whose O&M line sits below half the lock threshold)."""
    from scipy import signal as sps

    from wavecap_tpu_torch.models.p25.c4fm import DEVIATION_HZ, design_rrc, modulate_c4fm

    rrc = design_rrc(float(fs))
    pad = max(600, len(rrc) + 220)  # the filter's span and the start's offset, at least
    out = np.empty((rows, length), np.float32)
    for r in range(rows - 1):
        n48 = int((length + pad) * 48_000 / fs)
        x = modulate_c4fm(rng.integers(0, 4, n48 // 10 + 1).astype(np.uint8), 48_000.0)
        y = sps.resample(x, int(round(len(x) * fs / 48_000 * (1 + rng.uniform(-3e-4, 3e-4)))))
        disc = np.angle(y[1:] * np.conj(y[:-1])) * fs / (2 * np.pi * DEVIATION_HZ / 3.0)
        f = np.convolve(disc, rrc, mode="valid")
        start = 200 + int(rng.integers(0, 11))
        out[r] = f[start:start + length]
    out[-1] = dead_air(rng, length, rrc, fs / 4800.0, 0.005, real=True)
    return out


def cqpsk_rows(rng, rows: int, length: int, fs: float, symbol_rate: float, alpha: float,
               cfo=None) -> np.ndarray:
    """RRC-matched, power-normalised CQPSK rows (clock offsets up to
    +-300 ppm, random start phase and carrier phase; ``cfo`` Hz per row
    when given); the last row dead air unless ``cfo`` is given."""
    from scipy import signal as sps

    from wavecap_tpu_torch.models.p25.cqpsk import design_rrc_cqpsk, modulate_cqpsk

    rrc = design_rrc_cqpsk(float(fs), symbol_rate, alpha)
    out = np.empty((rows, length), np.complex64)
    n_sig = rows if cfo is not None else rows - 1
    for r in range(n_sig):
        n48 = int((length + 600) * 48_000 / fs)
        x = modulate_cqpsk(rng.integers(0, 4, int(n48 * symbol_rate / 48_000) + 1).astype(np.uint8),
                           48_000.0, symbol_rate, alpha)
        y = sps.resample(x, int(round(len(x) * fs / 48_000 * (1 + rng.uniform(-3e-4, 3e-4)))))
        y = y * np.exp(1j * rng.uniform(-np.pi, np.pi))
        if cfo is not None:
            y = y * np.exp(2j * np.pi * cfo[r] * np.arange(len(y)) / fs)
        f = np.convolve(y, rrc, mode="valid")
        start = 200 + int(rng.integers(0, 11))
        f = f[start:start + length]
        out[r] = f / np.sqrt(np.mean(np.abs(f) ** 2))
    if cfo is None:
        out[-1] = dead_air(rng, length, rrc, fs / symbol_rate, 0.002, real=False)
    return out


def dead_air(rng, length: int, rrc: np.ndarray, sps_: float, lock: float, real: bool) -> np.ndarray:
    """Filtered noise whose O&M lock is below half the threshold: the
    frozen-timing branch, clear of the gate."""
    for _ in range(400):
        n = rng.standard_normal(length + len(rrc))
        if not real:
            n = n + 1j * rng.standard_normal(length + len(rrc))
        f = np.convolve(n, rrc, mode="valid")[:length]
        u = (f - f.mean()) ** 2 if real else np.abs(f) ** 2
        if om_lock(u, sps_) < 0.5 * lock:
            return f / np.sqrt(np.mean(np.abs(f) ** 2))
    check(False, "no dead-air row below the lock threshold")


def timing_state(rng, rows: int, sps_: float, cqpsk: bool) -> np.ndarray:
    """Carried timing scalars (6, rows): a start position inside one symbol,
    a first block (freq 0 / gain 0) on a third of the rows, a tracked clock
    elsewhere."""
    st = np.zeros((6, rows), np.float32)
    st[0] = 64.0 + rng.uniform(0.0, sps_, rows)
    first = rng.random(rows) < 0.33
    st[1] = np.where(first, 0.0 if cqpsk else 10.0, sps_ * (1 + rng.uniform(-2e-4, 2e-4, rows)))
    st[2] = np.where(first, 0.0, rng.uniform(-1e-3, 1e-3, rows))
    if cqpsk:
        st[3] = rng.uniform(-0.02, 0.02, rows)  # bias
        prev = np.exp(1j * rng.uniform(-np.pi, np.pi, rows))
        st[4], st[5] = prev.real, prev.imag
    else:
        st[3] = np.where(first, 0.0, rng.uniform(0.6, 1.2, rows))  # gain
        st[4] = rng.uniform(-0.05, 0.05, rows)  # dc
    return st


# K12's and K13's block timing at every path's shape and on 2 s rows:
# (what, modulation, rows, channel samples a block); the rows are 64 + n
# long (the interpolation tail), at the programs' 50 kHz channel rate
K12_PATH_SHAPES = (
    ("program A, 50 x 12,564 f32", "c4fm", 50, 12_500),
    ("program F's shard, 50 x 12,064 f32", "c4fm", 50, 12_000),
    ("program B, 21 x 7,564 c64", "lsm", 21, 7_500),
    ("program C, 20 x 7,564 c64 at 6000 baud", "p2", 20, 7_500),
    ("2 s rows, C4FM, 4 x 100,064 f32", "c4fm", 4, 100_000),
    ("2 s rows, LSM CQPSK, 4 x 100,064 c64", "lsm", 4, 100_000),
    ("2 s rows, Phase 2, 4 x 100,064 c64 at 6000 baud", "p2", 4, 100_000),
    ("5 s rows, LSM CQPSK, 2 x 250,064 c64 (windows past shared memory: the row from L2)", "lsm", 2, 250_000),
)
K12_NAMES = {"c4fm": "K12_c4fm_timing", "lsm": "K13_cqpsk_timing", "p2": "K13_cqpsk_timing"}


def k12_path_case(device, kind: str, rows: int, n: int, seed: int = SEED + 12):
    """The block timing's inputs at one of ``K12_PATH_SHAPES``: ``(kernel,
    plain, buf, st, n_sym, cfg)``; seeded rows of the modulation (the last
    one dead air) and carried scalars from :func:`timing_state`."""
    import torch

    from wavecap_tpu_torch.capture.pipeline import p25_cfg_for, p25p2_cfg_for
    from wavecap_tpu_torch.models.p25 import c4fm, cqpsk

    cfgs = p25_configs()
    rng = np.random.default_rng(seed + rows + n + len(kind))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    if kind == "c4fm":
        cfg = p25_cfg_for(cfgs["A"])
        buf = c4fm_rows(rng, rows, 64 + n, cfg.sample_rate)
        return (c4fm.c4fm_timing, c4fm.c4fm_timing_plain, dev(buf),
                dev(timing_state(rng, rows, cfg.sps, cqpsk=False)), c4fm.n_symbols_per_block(cfg, n), cfg)
    cfg = p25_cfg_for(cfgs["B"]) if kind == "lsm" else p25p2_cfg_for(cfgs["C"])
    buf = cqpsk_rows(rng, rows, 64 + n, cfg.sample_rate, cfg.symbol_rate, cfg.rrc_alpha)
    return (cqpsk.cqpsk_timing, cqpsk.cqpsk_timing_plain, dev(buf),
            dev(timing_state(rng, rows, cfg.sps, cqpsk=True)), cqpsk.n_symbols_per_block(cfg, n), cfg)


def timing_bytes_ops(rows: int, length: int, n_sym: int, item: int) -> tuple[float, float]:
    """The block timing's bytes (the rows, the soft and dibits, the state)
    and operations (the O&M pass ~13 a sample; three Gardner evaluations
    and the gather ~100 a symbol)."""
    n = length - 64
    return rows * (length * item + n_sym * 5 + 48), rows * (13.0 * n + 100.0 * n_sym)


def k12_chain_ms(plan, length: int, n_sym: int, clock_hz: float) -> float:
    """The redesign's serial chain a CTA (``k12_plan``): its share of the
    row passes (dc, the O&M line) and of the four symbol passes (g0 and g1,
    g2, the gather, the rescale), then five cluster-wide sums."""
    samples = -(-(length - 64) // plan.cluster)
    passes = 2 * -(-samples // plan.threads) + 4 * -(-plan.mseg // plan.threads)
    return (passes * PASS_CYCLES + 5 * REDUCE_CYCLES) / clock_hz * 1e3


def timing_vs_plain(name, case, kfn, pfn, buf, st, n_sym, cfg, clock_hz) -> dict:
    """K12 / K13's timing against its plain version on the card: dibits
    equal, soft >= 60 dB, carried state within 1e-3, the dead-air row (the
    last) frozen; with the bound and the redesign's chain."""
    from wavecap_tpu_torch.models.p25.c4fm import k12_plan, timing_consts

    s_k, d_k, o_k = (host(v) for v in kfn(buf, st, n_sym, cfg))
    s_p, d_p, o_p = (host(v) for v in pfn(buf, st, n_sym, cfg))
    rows, length = buf.shape
    check(np.array_equal(d_k, d_p), f"{name} ({case}): dibits differ from the plain version")
    err = snr_db(s_p, s_k)
    check(err >= 60.0, f"{name} ({case}): soft SNR {err:.1f} dB < 60")
    d_state = float(np.max(np.abs(o_k - o_p)))
    check(d_state <= 1e-3, f"{name} ({case}): carried state differs by {d_state:.3g}")
    n = length - 64
    # the dead-air row (the last) froze its timing: no phase step
    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.0)
    st_np = host(st)
    pos = (np.float32(st_np[0, -1]) + np.float32(n_sym) * np.float32(o_p[1, -1])) - np.float32(n)
    pos = pos + np.float32(c.sps) if pos < 4.0 else pos
    pos = pos - np.float32(c.sps) if pos > c.recenter_hi else pos
    check(abs(float(pos) - float(o_k[0, -1])) <= 1e-3, f"{name} ({case}): the dead-air row moved its timing")
    b, f = bound(*timing_bytes_ops(rows, length, n_sym, buf.element_size()))
    plan = k12_plan(rows, n_sym, timing_consts(cfg.sps, cfg.max_clock_ppm, 0.0), buf.element_size())
    return dict(max_abs_err=max_abs(s_p, s_k), soft_snr_db=err, state_max_abs=d_state, bound_ms=b, bound_by=f,
                plan=plan._asdict(), chain_new_ms=k12_chain_ms(plan, length, n_sym, clock_hz))


# K13's CFO estimate at the paths' shapes: (case, program, bank)
CFO_PATH_SHAPES = (("program B", "B", "p25"), ("program C, control channel", "C", "p25"),
                   ("program C, Phase 2", "C", "p25p2"))


def cfo_path_case(device, prog: str, bank: str, rng=None, seed: int = SEED + 15):
    """``(cfg, filt, cfo)`` of K13's CFO stage at a path's shape: the
    bank's rows of one block, matched-filtered and normalized as
    ``cqpsk_demodulate`` hands them to the stage, at -600, 0 and +600 Hz
    in turn; from ``rng`` where given, else from ``seed``."""
    import torch

    from wavecap_tpu_torch.capture.pipeline import p25_cfg_for, p25p2_cfg_for

    c = p25_configs()[prog]
    cfg = p25_cfg_for(c) if bank == "p25" else p25p2_cfg_for(c)
    rows = c.p25_capacity if bank == "p25" else c.p25p2_capacity
    n = 2 * c.block_size // c.channelizer().channel_count
    cfo = np.tile([-600.0, 0.0, 600.0], rows)[:rows]
    rng = rng if rng is not None else np.random.default_rng(seed)
    filt = cqpsk_rows(rng, rows, n, cfg.sample_rate, cfg.symbol_rate, cfg.rrc_alpha, cfo=cfo)
    return cfg, torch.from_numpy(filt).to(device), cfo


def parent_cfo_stage(filt, cfg):
    """K13's CFO stage as it ran before K13_cfo_power: x^4 by two torch
    products, the FFT padded by ``torch.fft.fft``'s ``n=``, and the plain
    search: ``(resid, j)``."""
    import torch

    from wavecap_tpu_torch.models.p25 import cqpsk

    size, k4, off, step = cqpsk._cfo_search(cfg, filt.shape[-1])
    p4 = filt * filt
    p4 = p4 * p4
    return cqpsk.cfo_lines_plain(torch.fft.fft(p4, n=size, dim=-1), k4, off, step)


def device_ops(fn, reps: int = 20, warm: int = 3) -> dict:
    """Every op ``fn`` runs on the card, as CUPTI traced them through
    torch.profiler over ``reps`` warm calls: each op's launches and ms a
    call, and their totals (CUPTI may keep only some launches late in a
    long process: see ``device_ms``)."""
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
    ops = sorted(({"op": e.key, "launches": e.count / reps, "ms": e.self_device_time_total / reps / 1e3}
                  for e in prof.key_averages() if e.device_type == DeviceType.CUDA), key=lambda o: -o["ms"])
    return dict(ms=sum(o["ms"] for o in ops), launches=sum(o["launches"] for o in ops), ops=ops)


def p25_kernel_checks(cfgs, device, timer=device_ms, wall_timer=time_ms, clock_hz=None):
    """K12, K13 (timing, line search), K14 and K7's per-row complex taps
    against their plain versions at the P25 programs' shapes.  Returns
    ``(lines, cases)`` as :func:`mixed_kernel_checks`."""
    import torch
    import torch.nn.functional as F

    from wavecap_tpu_torch.capture.pipeline import p25_cfg_for, p25p2_cfg_for
    from wavecap_tpu_torch.models.p25 import c4fm, cqpsk
    from wavecap_tpu_torch.models.p25 import equalizer as eqz
    from wavecap_tpu_torch.models.p25.c4fm import timing_consts
    from wavecap_tpu_torch.ops import fir

    clock_hz = clock_hz or sm_clock_hz()
    rng = np.random.default_rng(SEED + 3)
    lines, cases = {}, []

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def record(name, case, source, replaces, lib, **k):
        k.update(name=name, case=case, route="cuda", source=source, replaces=replaces, library_ms=lib)
        cases.append(k)
        lines.setdefault(name, k)

    def chain(n: int, n_sym: int, threads: int = 512) -> float:
        passes = 2 * -(-n // threads) + 4 * -(-n_sym // threads)
        return (passes * PASS_CYCLES + 10 * REDUCE_CYCLES) / clock_hz * 1e3

    def timing_case(name, kfn, pfn, buf, st, n_sym, cfg, case, source, replaces, dtype_bytes):
        rec = timing_vs_plain(name, case, kfn, pfn, buf, st, n_sym, cfg, clock_hz)
        n = buf.shape[1] - 64
        record(name, case, source, replaces, None, **rec, chain_ms=chain(n, n_sym),
               ms=timer(lambda: kfn(buf, st, n_sym, cfg), "timing_kernel"),
               wrapper_ms=wall_timer(lambda: kfn(buf, st, n_sym, cfg)),
               plain_ms=timer(lambda: pfn(buf, st, n_sym, cfg)),
               library_note="no single PyTorch call computes the block timing")

    # K12 at program A's p25 bank: 50 rows of 64 + 12,500, 1,200 symbols
    ca = p25_cfg_for(cfgs["A"])
    n_a = 2 * cfgs["A"].block_size // cfgs["A"].channelizer().channel_count
    n_sym = c4fm.n_symbols_per_block(ca, n_a)
    buf = dev(c4fm_rows(rng, cfgs["A"].p25_capacity, 64 + n_a, ca.sample_rate))
    st = dev(timing_state(rng, cfgs["A"].p25_capacity, ca.sps, cqpsk=False))
    timing_case("K12_c4fm_timing", c4fm.c4fm_timing, c4fm.c4fm_timing_plain, buf, st, n_sym, ca,
                f"program A: ({buf.shape[0]}, {buf.shape[1]}) f32 -> {n_sym} symbols",
                "wavecap_tpu_torch/kernels/csrc/p25_timing.cu",
                "wavecap_tpu/models/p25/c4fm.py:340 _demod_block_timing", 4)

    # K13 timing at program B's bank (4800 baud, alpha 0.2) and C's Phase 2 bank
    k13_src = "wavecap_tpu_torch/kernels/csrc/p25_timing.cu"
    k13_rep = "wavecap_tpu/models/p25/cqpsk.py:247 cqpsk_demodulate (block branch :375-469)"
    n_b = 2 * cfgs["B"].block_size // cfgs["B"].channelizer().channel_count
    for cfg_q, rows, case in ((p25_cfg_for(cfgs["B"]), cfgs["B"].p25_capacity, "program B, 4800 baud"),
                              (p25p2_cfg_for(cfgs["C"]), cfgs["C"].p25p2_capacity, "program C, 6000 baud")):
        n_sym = cqpsk.n_symbols_per_block(cfg_q, n_b)
        buf = dev(cqpsk_rows(rng, rows, 64 + n_b, cfg_q.sample_rate, cfg_q.symbol_rate, cfg_q.rrc_alpha))
        st = dev(timing_state(rng, rows, cfg_q.sps, cqpsk=True))
        timing_case("K13_cqpsk_timing", cqpsk.cqpsk_timing, cqpsk.cqpsk_timing_plain, buf, st, n_sym,
                    cfg_q, f"{case}: ({rows}, {64 + n_b}) c64 -> {n_sym} symbols", k13_src, k13_rep, 8)

    # K13's CFO estimate at program B's bank and C's two: K13_cfo_power and
    # K13_cfo_lines against their plain versions, the stage against the
    # sequence before K13_cfo_power
    cfg_b = p25_cfg_for(cfgs["B"])
    rows_b = cfgs["B"].p25_capacity
    for what, prog, bank in CFO_PATH_SHAPES:
        cfg_q, filt, cfo = cfo_path_case(device, prog, bank, rng if prog == "B" else None)
        rows, n = filt.shape
        size, k4, off, step = cqpsk._cfo_search(cfg_q, n)
        buf_k, buf_p = cqpsk.cfo_power(filt, size), cqpsk.cfo_power_plain(filt, size)
        ref = host(torch.view_as_real(buf_p)).astype(np.float64)
        ulp = float(np.max(ulps(ref, host(torch.view_as_real(buf_k))), initial=0.0))
        same = same_bits(buf_k, buf_p)
        check(ulp <= 2.0, f"K13_cfo_power at {what}: {ulp:.1f} ulp from the plain version")
        b, f = bound(rows * n * 8 + rows * size * 8, rows * n * 12.0)
        record("K13_cfo_power", f"{what}: ({rows}, {n}) c64 -> ({rows}, {size}), CFO -600/0/+600 Hz",
               "wavecap_tpu_torch/kernels/csrc/cfo_lines.cu",
               "wavecap_tpu/models/p25/cqpsk.py:170 _estimate_cfo_residual (x^4 and the FFT's pad :183-185)",
               None, max_abs_err=max_abs(ref, host(torch.view_as_real(buf_k))), max_ulp=ulp, bit_equal=same,
               ms=timer(lambda: cqpsk.cfo_power(filt, size), "cfo_power_kernel"),
               wrapper_ms=wall_timer(lambda: cqpsk.cfo_power(filt, size)),
               plain_ms=timer(lambda: cqpsk.cfo_power_plain(filt, size)), bound_ms=b, bound_by=f,
               library_note="no single PyTorch call computes x^4 padded to the FFT's size")
        spec = torch.fft.fft(buf_p, dim=-1)
        r_k, j_k = (host(v) for v in cqpsk.cfo_lines(spec, k4, off, step))
        r_p, j_p = (host(v) for v in cqpsk.cfo_lines_plain(spec, k4, off, step))
        check(np.array_equal(j_k, j_p) and np.array_equal(r_k, r_p),
              f"K13_cfo_lines at {what} differs from the plain version")
        err_hz = float(np.max(np.abs(r_k - cfo)))
        check(err_hz <= 2 * step, f"K13_cfo_lines at {what} misses the CFO by {err_hz:.1f} Hz")
        r_s = host(cqpsk._estimate_cfo_residual(filt, cfg_q))
        r_o, _ = (host(v) for v in parent_cfo_stage(filt, cfg_q))
        check(np.array_equal(r_s, r_o), f"K13's CFO stage at {what} differs from the sequence before it")
        plan = cqpsk.cfo_lines_plan(rows, size, k4, off)
        b, f = bound(rows * size * 8 + rows * 8, rows * (5.0 * size + 2.0 * (2 * k4 + 1)))
        record("K13_cfo_lines", f"{what}: ({rows}, {size}) c64 X, {2 * k4 + 1} candidates, CFO -600/0/+600 Hz",
               "wavecap_tpu_torch/kernels/csrc/cfo_lines.cu",
               "wavecap_tpu/models/p25/cqpsk.py:170 _estimate_cfo_residual (|X| and the line search :185-201)",
               None, max_abs_err=0.0, cfo_max_abs_err_hz=err_hz, resid_equal_to_stage_before=True,
               plan=dict(cluster=plan.cluster, ctas=plan.ctas, per=plan.per, bins=plan.bins),
               ms=timer(lambda: cqpsk.cfo_lines(spec, k4, off, step), "cfo_lines_kernel"),
               wrapper_ms=wall_timer(lambda: cqpsk.cfo_lines(spec, k4, off, step)),
               plain_ms=timer(lambda: cqpsk.cfo_lines_plain(spec, k4, off, step)), bound_ms=b, bound_by=f,
               cufft_ms=timer(lambda: torch.fft.fft(buf_p, dim=-1)),
               stage=device_ops(lambda: cqpsk._estimate_cfo_residual(filt, cfg_q)),
               stage_before_ms=timer(lambda: parent_cfo_stage(filt, cfg_q)),
               stage_bound_ms=bound(rows * n * 8 + 4 * rows * size * 8, 0.0)[0],
               library_note="no single PyTorch call computes the line-pair search")

    # K14 at program B's bank: echo rows (delay 4 samples, a 0.8, theta 2.98) and clean rows
    grid = cqpsk._cfg_grid(cfg_b, device)
    clean = cqpsk_rows(rng, rows_b, n_b, cfg_b.sample_rate, 4800.0, 0.2, cfo=np.zeros(rows_b))
    echo_rows = np.arange(rows_b) % 2 == 0
    x_np = clean.copy()
    x_np[echo_rows] += (0.8 * np.exp(2.98j)) * np.roll(clean[echo_rows], 4, axis=-1)
    x = dev(x_np)
    acc0 = eqz.echo_fit_plain(x, torch.zeros((rows_b, grid.n_tau + 1), dtype=torch.complex64, device=device),
                              torch.ones(rows_b, dtype=torch.bool, device=device), grid, 41, 0.01, 0.35,
                              0.6, 0.5)[1]
    acc = torch.where(dev(rng.random(rows_b) < 0.5)[:, None], acc0, torch.zeros_like(acc0))
    enable = dev(np.arange(rows_b) != 5)

    def fit():
        return eqz.echo_fit(x, acc, enable, grid, 41, 0.01, 0.35, 0.6, 0.5)

    def fit_plain():
        return eqz.echo_fit_plain(x, acc, enable, grid, 41, 0.01, 0.35, 0.6, 0.5)

    t_k, a_k, s_k, j_k = (host(v) for v in fit())
    t_p, a_p, s_p, j_p = (host(v) for v in fit_plain())
    check(np.array_equal(j_k[host(enable)], j_p[host(enable)]), "K14 candidate index differs")
    check(np.array_equal(s_k, s_p), "K14 significance differs")
    n_echo_sig, n_clean_sig = int(s_k[echo_rows].sum()), int(s_k[~echo_rows].sum())
    check(n_echo_sig > 0 and n_clean_sig < int((~echo_rows).sum()),
          f"K14's check needs a significant echo row and a clean row that is not "
          f"({n_echo_sig} echo, {n_clean_sig} clean rows significant)")
    err_t, err_a = rel_l2(t_p, t_k), rel_l2(a_p, a_k)
    check(err_t <= 1e-5 and err_a <= 1e-6, f"K14 taps rel L2 {err_t:.3g} (<= 1e-5), acf {err_a:.3g} (<= 1e-6)")
    n_c, lags = grid.preds.shape
    fit_bytes = rows_b * n_b * 8 + n_c * lags * 8 + n_c * 12 + rows_b * (2 * lags * 8 + 41 * 8 + 5)
    fit_ops = rows_b * (lags * n_b * 8.0 + n_c * lags * 7.0 + 41 * 512 * 8.0)
    b, f = bound(fit_bytes, fit_ops)
    acf_r = torch.view_as_real(torch.from_numpy(a_p).to(device)).reshape(rows_b, -1)
    preds_r = torch.view_as_real(grid.preds).reshape(n_c, -1)
    record("K14_echo_fit", f"program B fit: ({rows_b}, {n_b}) c64 x {n_c} candidates, 41 taps",
           "wavecap_tpu_torch/kernels/csrc/echo_fit.cu",
           "wavecap_tpu/models/p25/equalizer.py:165 fit_and_invert (+ :109 block_acf, :119 resolve_cfo_alias)",
           # yardstick: the residual grid as torch.cdist over (re, im) views, then argmin (two calls)
           timer(lambda: torch.cdist(acf_r, preds_r).argmin(-1)),
           max_abs_err=max_abs(t_p, t_k), taps_rel_l2=err_t, acf_rel_l2=err_a,
           echo_rows_significant=n_echo_sig, clean_rows_significant=n_clean_sig, bound_ms=b, bound_by=f,
           ms=timer(fit, K14_KERNELS), wrapper_ms=wall_timer(fit), plain_ms=timer(fit_plain))
    x3 = torch.cat([x, x * dev(np.exp(2j * np.pi * 1200.0 * np.arange(n_b) / cfg_b.sample_rate)
                               .astype(np.complex64)), torch.flip(x, [0])])
    sc_k, sc_p = host(eqz.echo_score(x3, grid)), host(eqz.echo_score_plain(x3, grid))
    err = rel_l2(sc_p, sc_k)
    check(err <= 1e-5, f"K14 score mode rel L2 {err:.3g} > 1e-5")
    b, f = bound(3 * rows_b * n_b * 8 + n_c * lags * 8 + 3 * rows_b * 4,
                 3 * rows_b * (lags * n_b * 8.0 + n_c * lags * 7.0))
    cases.append(dict(name="K14_echo_fit", case=f"alias score: ({3 * rows_b}, {n_b}) c64", rel_l2=err,
                      bound_ms=b, bound_by=f, ms=timer(lambda: eqz.echo_score(x3, grid), K14_KERNELS),
                      wrapper_ms=wall_timer(lambda: eqz.echo_score(x3, grid)),
                      plain_ms=timer(lambda: eqz.echo_score_plain(x3, grid)), library_ms=None))

    # K14 on one 60,000-sample row (the first design staged a row in shared
    # memory and refused rows past 25,000 samples), fit and score modes
    n_long = 60_000
    xl_np = cqpsk_rows(rng, 1, n_long, cfg_b.sample_rate, 4800.0, 0.2, cfo=np.zeros(1))
    xl_np = xl_np + (0.8 * np.exp(2.98j)) * np.roll(xl_np, 4, axis=-1)
    xl = dev(xl_np.astype(np.complex64))
    acc_l = torch.zeros((1, grid.n_tau + 1), dtype=torch.complex64, device=device)
    on_l = torch.ones(1, dtype=torch.bool, device=device)

    def fit_long():
        return eqz.echo_fit(xl, acc_l, on_l, grid, 41, 0.01, 0.35, 0.6, 0.5)

    def fit_long_plain():
        return eqz.echo_fit_plain(xl, acc_l, on_l, grid, 41, 0.01, 0.35, 0.6, 0.5)

    t_k, a_k, s_k, j_k = (host(v) for v in fit_long())
    t_p, a_p, s_p, j_p = (host(v) for v in fit_long_plain())
    err_t, err_a = rel_l2(t_p, t_k), rel_l2(a_p, a_k)
    check(np.array_equal(j_k, j_p) and np.array_equal(s_k, s_p) and bool(s_k[0]),
          f"K14 on a {n_long}-sample row: candidate {j_k} / {j_p}, significance {s_k} / {s_p}")
    check(err_t <= 1e-5 and err_a <= 1e-6,
          f"K14 on a {n_long}-sample row: taps rel L2 {err_t:.3g} (<= 1e-5), acf {err_a:.3g} (<= 1e-6)")
    b, f = bound(n_long * 8 + n_c * lags * 8 + n_c * 12 + 2 * lags * 8 + 41 * 8 + 5,
                 lags * n_long * 8.0 + n_c * lags * 7.0 + 41 * 512 * 8.0)
    cases.append(dict(name="K14_echo_fit", case=f"fit, one {n_long}-sample row", taps_rel_l2=err_t,
                      acf_rel_l2=err_a, max_abs_err=max_abs(t_p, t_k), bound_ms=b, bound_by=f,
                      ms=timer(fit_long, K14_KERNELS), wrapper_ms=wall_timer(fit_long),
                      plain_ms=timer(fit_long_plain), library_ms=None))
    xl3 = torch.cat([xl, xl * dev(np.exp(2j * np.pi * 1200.0 * np.arange(n_long) / cfg_b.sample_rate)
                                  .astype(np.complex64)), torch.flip(xl, [1])])
    sc_k, sc_p = host(eqz.echo_score(xl3, grid)), host(eqz.echo_score_plain(xl3, grid))
    err = rel_l2(sc_p, sc_k)
    check(err <= 1e-5, f"K14 score mode on {n_long}-sample rows: rel L2 {err:.3g} > 1e-5")
    b, f = bound(3 * n_long * 8 + n_c * lags * 8 + 3 * 4, 3 * (lags * n_long * 8.0 + n_c * lags * 7.0))
    cases.append(dict(name="K14_echo_fit", case=f"alias score, 3 rows of {n_long}", rel_l2=err, bound_ms=b,
                      bound_by=f, ms=timer(lambda: eqz.echo_score(xl3, grid), K14_KERNELS),
                      wrapper_ms=wall_timer(lambda: eqz.echo_score(xl3, grid)),
                      plain_ms=timer(lambda: eqz.echo_score_plain(xl3, grid)), library_ms=None))

    # K7: the equaliser's per-row complex taps in one launch, against conv1d in full f32
    taps = dev((rng.standard_normal((rows_b, 41)) + 1j * rng.standard_normal((rows_b, 41))).astype(np.complex64) * 0.2)
    xin = torch.cat([dev((rng.standard_normal((rows_b, 40)) + 1j * rng.standard_normal((rows_b, 40)))
                         .astype(np.complex64)), x], -1)
    y_k = host(fir.strided_fir(xin, taps, 1)[0])
    y_p = host(fir.strided_fir_plain(xin, taps, 1)[0])
    err = rel_l2(y_p, y_k)
    check(err <= 1e-6, f"K7 per-row complex taps rel L2 {err:.3g} > 1e-6")
    kern = taps.flip(-1).unsqueeze(1)
    b, f = bound(rows_b * (n_b + 40) * 8 + rows_b * 41 * 8 + rows_b * n_b * 8, rows_b * n_b * 41 * 8.0)
    cases.append(dict(name="K7_strided_fir", case=f"equaliser: per-row 41 complex taps, ({rows_b}, {n_b + 40}) c64",
                      rel_l2=err, max_abs_err=max_abs(y_p, y_k), bound_ms=b, bound_by=f,
                      ms=timer(lambda: fir.strided_fir(xin, taps, 1), "strided_fir_kernel"),
                      wrapper_ms=wall_timer(lambda: fir.strided_fir(xin, taps, 1)),
                      plain_ms=timer(lambda: fir.strided_fir_plain(xin, taps, 1)),
                      # yardstick: one complex grouped conv1d
                      library_ms=timer(lambda: F.conv1d(xin.unsqueeze(0), kern, groups=rows_b))))

    # K7 at program F's per-shard P25 filters (8 time shards of program A's
    # 0.24 s blocks: 50 rows of 1,500 channel samples behind their carried
    # T - 1): the C4FM low-pass on complex rows, the RRC on real rows
    lpf, rrc = c4fm._filters_on(float(ca.sample_rate), ca.rrc_alpha, device)
    rows_f = cfgs["A"].p25_capacity
    n_f = 2 * F_BLOCK // MESH_SHARDS // cfgs["A"].channelizer().channel_count
    for taps_f, cplx_f, what in ((lpf, True, "C4FM low-pass, complex rows"), (rrc, False, "C4FM RRC, real rows")):
        t_f = taps_f.shape[0]
        xf_np = rng.standard_normal((rows_f, n_f + t_f - 1))
        if cplx_f:
            xf_np = xf_np + 1j * rng.standard_normal((rows_f, n_f + t_f - 1))
        xf = dev((0.3 * xf_np).astype(np.complex64 if cplx_f else np.float32))
        y_k = host(fir.strided_fir(xf, taps_f, 1)[0])
        y_p = host(fir.strided_fir_plain(xf, taps_f, 1)[0])
        err = rel_l2(y_p, y_k)
        check(err <= 1e-5, f"K7 at program F's {what}: rel L2 {err:.3g} > 1e-5")
        item = 8 if cplx_f else 4
        b, f = bound(rows_f * (n_f + t_f - 1) * item + t_f * 4 + rows_f * n_f * item,
                     rows_f * n_f * t_f * (4.0 if cplx_f else 2.0))
        planes_f = torch.view_as_real(xf).movedim(-1, 1).reshape(-1, 1, n_f + t_f - 1) if cplx_f else xf.unsqueeze(1)
        kern_f = taps_f.flip(0).reshape(1, 1, -1)
        cases.append(dict(name="K7_strided_fir", case=f"program F's per-shard {what}: {t_f} taps, "
                          f"({rows_f}, {n_f + t_f - 1})", rel_l2=err, max_abs_err=max_abs(y_p, y_k),
                          bound_ms=b, bound_by=f,
                          ms=timer(lambda: fir.strided_fir(xf, taps_f, 1), "strided_fir_kernel"),
                          wrapper_ms=wall_timer(lambda: fir.strided_fir(xf, taps_f, 1)),
                          plain_ms=timer(lambda: fir.strided_fir_plain(xf, taps_f, 1)),
                          # yardstick: cuDNN's conv1d of the rows' planes (TF32 off)
                          library_ms=timer(lambda: F.conv1d(planes_f, kern_f))))
    names = ("K12_c4fm_timing", "K13_cqpsk_timing", "K13_cfo_power", "K13_cfo_lines", "K14_echo_fit")
    return [lines[k] for k in names], cases


def p25_scene(cfg, stations):
    """A fake receiver at the capture rate: ``stations`` is a list of
    ``FakeStation`` keyword dicts."""
    from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation

    device = FakeDriver(1, [FakeStation(**s) for s in stations]).open("fake0")
    device.configure(DeviceConfig(sample_rate=cfg.sample_rate))
    return device.start_stream()


def run_capture(cfg, device, words_np, ctl, expected: dict, sync):
    """The blocks through upload -> ``capture_multi`` -> ``unpack_wire`` with
    the launch count of each kernel checked; returns the words on the card,
    the outputs, the last state, the wire, the counts and the first-run
    seconds."""
    import torch

    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init, unpack_wire
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    n = len(words_np[0]) if isinstance(words_np, tuple) else len(words_np)
    state0 = pipeline_init(cfg, device=device)
    reset_launch_counts()
    t0 = time.perf_counter()
    if isinstance(words_np, tuple):  # the adaptive i8 / i4 words and their scales
        words = tuple(torch.from_numpy(a).to(device) for a in words_np)
    else:
        words = torch.from_numpy(words_np).to(device)
    outs, state = capture_multi(words, state0, ctl, cfg)
    packed = host(outs["_packed"])
    sync()
    first_s = time.perf_counter() - t0
    counts = launch_counts()
    want = {name: n * expected.get(name, 0) for name in counts}
    check(counts == want, f"launch counts {counts} != {want}")
    meta = {k: v for k, v in outs.items() if k != "_packed"}
    return words, outs, state, unpack_wire(meta, packed), counts, first_s


def soft_wire_error(outs, wire, bank: str) -> float:
    """The unpacked wire's soft symbols against the card's, clipped to the
    i8 range: within half an LSB (1/32)."""
    dev_soft = np.clip(host(outs[bank]["soft"]), -127 / 16.0, 127 / 16.0)
    err = float(np.max(np.abs(wire[bank]["soft"] - dev_soft)))
    check(err <= 1.0 / 32 + 1e-6, f"{bank} wire soft off by {err:.3g} > 1/32")
    return err


def first_blocks_vs_plain(words, cfg, ctl, outs, device, soft_slots: dict, audio_slots=()) -> dict:
    """The first two blocks through the plain path on the card: soft symbols
    of the station slots and the NBFM stations' audio >= 50 dB."""
    from wavecap_tpu_torch.capture.pipeline import pipeline_init
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    st = pipeline_init(cfg, device=device)
    worst_soft, worst_audio = float("inf"), float("inf")
    for blk in range(2):
        w, sc = block_of(words, blk)
        out_p, st = plain_capture_step(w, st, ctl, cfg, sc)
        for bank, slots in soft_slots.items():
            s_p, s_k = host(out_p[bank]["soft"]), host(outs[bank]["soft"][blk])
            for i in slots:
                worst_soft = min(worst_soft, snr_db(s_p[i], s_k[i]))
        for i in audio_slots:
            worst_audio = min(worst_audio, snr_db(host(out_p["banks"]["nbfm"]["audio"])[i],
                                                  host(outs["banks"]["nbfm"]["audio"][blk])[i]))
    launched = {k: v for k, v in launch_counts().items() if v}
    check(not launched, f"the plain path launched kernels: {launched}")
    check(worst_soft >= 50.0, f"first blocks' soft SNR {worst_soft:.1f} dB < 50 against the plain path")
    check(worst_audio >= 50.0, f"first blocks' audio SNR {worst_audio:.1f} dB < 50 against the plain path")
    return dict(first_blocks_soft_snr_db=worst_soft,
                first_blocks_audio_snr_db=worst_audio if audio_slots else None)


def warm_ms(cfg, device, words, ctl, sync) -> tuple:
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init

    def one_pass():
        o, _ = capture_multi(words, pipeline_init(cfg, device=device), ctl, cfg)
        fetch(o["_packed"])

    one_pass()
    sync()
    t0 = time.perf_counter()
    one_pass()
    sync()
    n = len(words[0]) if isinstance(words, tuple) else len(words)
    return (time.perf_counter() - t0) * 1e3 / n, one_pass


def run_program_a(cfg, device, sync=None, launches=None) -> dict:
    """Program A: C4FM at the BASELINE point (50 p25 + 50 nbfm slots);
    ``launches`` per block, A's block-timing ones by default."""
    import torch

    from wavecap_tpu_torch.capture.engine import pack_i16_words
    from wavecap_tpu_torch.capture.pipeline import control_init

    sync = sync or torch.cuda.synchronize
    rng = np.random.default_rng(SEED + 4)
    ch = cfg.channelizer()
    m = ch.channel_count
    p, c = cfg.p25_capacity, cfg.narrow_capacity
    bins = p25_bins(m, p + c, 3)
    p25_bins_, nbfm_bins = bins[:p], bins[p:]
    loops, stations, fine = {}, [], np.zeros(p, np.float32)
    for slot, f in A_C4FM_STATIONS:
        d, iq = p25_loop(rng, "c4fm", cfg.sample_rate)
        loops[slot] = d
        fine[slot] = f
        stations.append(dict(offset_hz=ch.channel_offset_hz(p25_bins_[slot]) + f, kind="iq_loop",
                             iq_loop=iq, amplitude=P25_AMPLITUDE))
    for slot in A_NBFM_STATIONS:
        stations.append(dict(offset_hz=ch.channel_offset_hz(nbfm_bins[slot]), kind="nbfm",
                             tone_hz=1000.0, deviation_hz=4000.0, amplitude=P25_AMPLITUDE))
    stream = p25_scene(cfg, stations)
    words_np = pack_i16_words([stream.read(cfg.block_size)[0] for _ in range(N_BLOCKS)])
    ctl = control_init(cfg, device=device)
    ctl = ctl._replace(
        banks={"nbfm": ctl.banks["nbfm"]._replace(
            channel_index=torch.tensor(nbfm_bins, dtype=torch.int32, device=device),
            active=torch.ones(c, dtype=torch.bool, device=device),
            squelch_db=torch.full((c,), P25_SQUELCH_DB, dtype=torch.float32, device=device))},
        p25=ctl.p25._replace(channel_index=torch.tensor(p25_bins_, dtype=torch.int32, device=device),
                             fine_offset_hz=torch.from_numpy(fine).to(device),
                             active=torch.ones(p, dtype=torch.bool, device=device)))
    words, outs, _, wire, counts, first_s = run_capture(cfg, device, words_np, ctl, launches or A_LAUNCHES,
                                                        sync)

    soft = host(outs["p25"]["soft"])
    check(np.isfinite(soft).all() and np.isfinite(wire["spectrum"]).all(), "non-finite output")
    n_sym = soft.shape[-1]
    check(n_sym == round(2 * cfg.block_size / m / (ch.channel_rate / 4800.0)), "soft symbols per block")
    agree = {slot: min(agreement(soft[k, slot], d) for k in range(P25_FIRST, N_BLOCKS))
             for slot, d in loops.items()}
    for slot, a in agree.items():
        check(a >= 0.995, f"C4FM station on p25 slot {slot}: {a:.4f} of decisions right < 0.995")
    rssi = wire["p25"]["rssi"]
    empty = [i for i in range(p) if i not in loops]
    station_rssi = float(rssi[:, list(loops)].min())
    check(float(rssi[:, empty].max()) < station_rssi - 30.0, "an empty p25 slot is not at the noise floor")
    audio = wire["banks"]["nbfm"]["audio"]
    margins = {s: tone_margin_db(audio[P25_FIRST:, s].ravel(), cfg.audio_rate) for s in A_NBFM_STATIONS}
    for s, v in margins.items():
        check(v >= 20.0, f"NBFM station on slot {s}: 1 kHz line only {v:.1f} dB up")
    empty_nbfm = [i for i in range(c) if i not in A_NBFM_STATIONS]
    check(not audio[:, empty_nbfm].any(), "an empty nbfm slot's squelch opened")
    wire_err = soft_wire_error(outs, wire, "p25")
    plain = first_blocks_vs_plain(words, cfg, ctl, outs, device, {"p25": list(loops)}, A_NBFM_STATIONS)
    ms_block, one_pass = warm_ms(cfg, device, words, ctl, sync)
    return dict(phase="program A", blocks=N_BLOCKS, block_size=cfg.block_size, channels=m,
                p25_slots=p, nbfm_slots=c, symbols_per_block=n_sym, launches=counts,
                first_run_s=first_s, warm_ms_per_block=ms_block, msps=cfg.block_size / ms_block / 1e3,
                profile=profile_blocks(one_pass, N_BLOCKS, sync),
                decisions_right={str(k): v for k, v in agree.items()},
                station_rssi_min_dbfs=station_rssi, empty_p25_rssi_max_dbfs=float(rssi[:, empty].max()),
                nbfm_tone_margin_db={str(k): v for k, v in margins.items()},
                wire_soft_max_abs=wire_err, **plain)


def run_program_bc(cfg, device, name: str, sync=None, launches=None, echo_first=P25_FIRST) -> dict:
    """Program B (LSM with the simulcast equalizer) or C (Phase 2 dual rate);
    the echo station's decisions are counted from block ``echo_first + 1``."""
    import torch

    from wavecap_tpu_torch.capture.engine import pack_i8_words, pack_i16_words
    from wavecap_tpu_torch.capture.pipeline import control_init, p25_cfg_for

    sync = sync or torch.cuda.synchronize
    rng = np.random.default_rng(SEED + (5 if name == "B" else 6))
    ch = cfg.channelizer()
    m = ch.channel_count
    p, p2 = cfg.p25_capacity, cfg.p25p2_capacity
    bins = p25_bins(m, p + p2, 4)
    banks = {"p25": (bins[:p], np.zeros(p, np.float32), {}), "p25p2": (bins[p:], np.zeros(p2, np.float32), {})}
    stations, echo_slot = [], None
    table = ([("p25", s, f, cfo, e, 4800.0, 0.2) for s, f, cfo, e in B_STATIONS] if name == "B" else
             [("p25", 0, 0.0, 0.0, False, 4800.0, 0.2)]
             + [("p25p2", s, f, 0.0, False, 6000.0, 1.0) for s, f in C_P2_STATIONS])
    for bank, slot, f, cfo, echo, rs, alpha in table:
        if slot >= len(banks[bank][0]):
            continue
        d, iq = p25_loop(rng, "cqpsk", cfg.sample_rate, rs, alpha)
        if echo:
            delay, a, theta = ECHO
            iq = (iq + a * np.exp(1j * theta) * np.roll(iq, delay)).astype(np.complex64)
            echo_slot = slot
        banks[bank][1][slot] = f
        banks[bank][2][slot] = d
        stations.append(dict(offset_hz=ch.channel_offset_hz(banks[bank][0][slot]) + f + cfo,
                             kind="iq_loop", iq_loop=iq, amplitude=P25_AMPLITUDE))
    stream = p25_scene(cfg, stations)
    # B on the adaptive i8 words, as the reference's trunking captures upload
    pack = pack_i8_words if name == "B" else pack_i16_words
    words_np = pack([stream.read(cfg.block_size)[0] for _ in range(N_BLOCKS)])
    ctl = control_init(cfg, device=device)
    for bank, (bb, fine, _) in banks.items():
        if getattr(ctl, bank) is None:
            continue
        ctl = ctl._replace(**{bank: getattr(ctl, bank)._replace(
            channel_index=torch.tensor(bb, dtype=torch.int32, device=device),
            fine_offset_hz=torch.from_numpy(fine).to(device),
            active=torch.ones(len(bb), dtype=torch.bool, device=device))})
    launches = launches or (B_LAUNCHES if name == "B" else C_LAUNCHES)
    words, outs, state, wire, counts, first_s = run_capture(cfg, device, words_np, ctl, launches, sync)

    res = dict(phase=f"program {name}", blocks=N_BLOCKS, block_size=cfg.block_size, channels=m,
               p25_slots=p, p25p2_slots=p2, transport="i8" if name == "B" else "i16", launches=counts,
               first_run_s=first_s)
    soft_slots = {}
    for bank, (_, _, loops) in banks.items():
        if not loops:
            continue
        soft = host(outs[bank]["soft"])
        check(np.isfinite(soft).all(), f"{bank} soft not finite")
        agree = {}
        for slot, d in loops.items():
            echo = slot == echo_slot and bank == "p25"
            agree[slot] = min(agreement(soft[k, slot], d) for k in range(echo_first if echo else P25_FIRST, N_BLOCKS))
            if echo:
                res["echo_block3_decisions_right"] = agreement(soft[P25_FIRST, slot], d)
            floor = 0.95 if echo else 0.99
            check(agree[slot] >= floor, f"{bank} station on slot {slot}: {agree[slot]:.4f} of decisions right < {floor}")
        rssi = wire[bank]["rssi"]
        empty = [i for i in range(soft.shape[1]) if i not in loops]
        if empty:
            check(float(rssi[:, empty].max()) < float(rssi[:, list(loops)].min()) - 30.0,
                  f"an empty {bank} slot is not at the noise floor")
        res[f"{bank}_decisions_right"] = {str(k): v for k, v in agree.items()}
        res[f"{bank}_symbols_per_block"] = soft.shape[-1]
        res[f"{bank}_wire_soft_max_abs"] = soft_wire_error(outs, wire, bank)
        soft_slots[bank] = list(loops)
    if name == "B":
        # the equaliser: engaged on the echo station, identity taps on the clean ones
        hits, taps = host(state.p25.c4fm.eq_hits), host(state.p25.c4fm.eq_taps)
        ident = np.zeros(taps.shape[1], np.complex64)
        ident[taps.shape[1] // 2] = 1.0
        clean = [s for s in banks["p25"][2] if s != echo_slot]
        engage = p25_cfg_for(cfg).eq_engage_blocks
        check([s for s in banks["p25"][2] if hits[s] >= engage] == [echo_slot],
              f"K14 engaged on stations {[s for s in banks['p25'][2] if hits[s] >= engage]}, "
              f"not on the echo station {echo_slot} alone")
        check(not np.allclose(taps[echo_slot], ident), "the echo station holds identity taps")
        check(all(np.array_equal(taps[s], ident) for s in clean), "a clean station's taps are not identity")
        res.update(echo_slot=echo_slot, echo_eq_hits=int(hits[echo_slot]),
                   engaged_slots=[int(i) for i in np.flatnonzero(hits >= engage)])
    res.update(first_blocks_vs_plain(words, cfg, ctl, outs, device, soft_slots))
    ms_block, one_pass = warm_ms(cfg, device, words, ctl, sync)
    res.update(warm_ms_per_block=ms_block, msps=cfg.block_size / ms_block / 1e3,
               profile=profile_blocks(one_pass, N_BLOCKS, sync))
    return res


# --- phase 7: the engine (program D) -----------------------------------------------

D_CENTER = 160_000_000.0
# the five narrow banks as (mode, dsp); bank k holds slot i on bin D_BASE[k] + i
D_BANKS = (
    ("nbfm", {}),
    ("nbfm", {"enable_noise_blanker": True, "enable_noise_reduction": True}),
    ("am", {"enable_noise_blanker": True}),
    ("usb", {"enable_noise_blanker": True}),
    ("sam", {"enable_noise_blanker": True}),
)
D_WIDE_DSP = {"enable_noise_blanker": True, "enable_noise_reduction": True}
D_LADDER = ("i16", "i8", "i4")
D_SEGMENT = 3  # blocks per transport: 9 in all
D_AMPLITUDE = 0.05
D_WEAK_SNR_DB = 10.0  # the weak station over the fake receiver's noise in a 25 kHz channel
D_GATE = (0.16, 0.08)  # the voice-like stations' 1 kHz tone: gate period, on time (s)
D_PULSE = (0.5, 100e-6, 0.12)  # Hann pulse amplitude, length, time in the gate period (s)
D_FETCH_SLOTS = 32
# the wide slots' squelch: their 244 kHz IF holds ~10x a narrow channel's
# noise, and at i4 the quantization noise alone reaches -44 dBFS there
D_WIDE_SQUELCH_DB = -35.0
D_LINE_DB = (20.0, 20.0, 10.0)  # a station's 1 kHz line per transport segment
# launches per block: K3 and K5 once per bank and K5 for the wide group; K7
# the wide shift; K9 as the mixed capture (the second NBFM bank for lsb);
# K10 the sam bank; K11a the four blanking banks and the wide group; K11b
# the noise-reduction bank and the wide group
D_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 5, "K5_resample_poly": 6,
              "K7_strided_fir": 1, "K9_iir_cascade": 14, "K10_pll": 1, "K11a_noise_blanker": 5,
              "K11b_nr_frames": 2, "K11b_nr_gain": 2, "K11b_nr_overlap_add": 2}


def engine_layout(c: int) -> dict:
    """Program D's bins for ``c`` slots a bank: the two NBFM banks share
    bins [0, c), am [c, 2c), usb [3c, 4c), sam [4c, 5c); [2c, 3c) holds
    the band edge (M/2) and the WBFM station.  Station slots within a bank:
    steady 1 kHz tones, the voice-like station hit by pulses, the weak
    voice-like station, and empty listened slots."""
    return dict(base=(0, 0, c, 3 * c, 4 * c), tone=(c * 17 // 160, c * 101 // 160),
                pulse=c * 40 // 160, weak=c * 60 // 160, empty=(c * 130 // 160, c * 150 // 160),
                wide=(round(2.2 * c), round(2.75 * c)))


def gated_fm_loop(fs: float, amplitude: float, pulses: bool) -> np.ndarray:
    """Five gate periods of NBFM (4 kHz deviation) carrying a 1 kHz tone
    gated on and off like speech: spectral noise reduction keeps it, where
    a steady tone is what it takes out.  With ``pulses``, a Hann pulse
    (~20 kHz wide) in the middle of every off gap: the impulse noise."""
    period, on = D_GATE
    n = int(round(fs * 5 * period))
    t = np.arange(n) / fs
    audio = ((t % period) < on) * np.sin(2 * np.pi * 1000.0 * t)
    x = amplitude * np.exp(2j * np.pi * 4000.0 * np.cumsum(audio) / fs)
    if pulses:
        amp, length, at = D_PULSE
        w = amp * np.hanning(int(round(length * fs)))
        for k in range(5):
            i0 = int(round((k * period + at) * fs))
            x[i0:i0 + len(w)] += w * np.exp(1j * (1.0 + 2.1 * k))  # a phase jump: a click
    return x.astype(np.complex64)


def engine_scene(fs: int, m: int, lay: dict):
    from wavecap_tpu_torch.devices import FakeDriver, FakeStation
    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

    ch = ChannelizerConfig(sample_rate=float(fs), channel_bandwidth=12_500.0)
    stations = []
    for k, (mode, _) in enumerate(D_BANKS):
        if k == 1:
            continue  # the second NBFM bank tunes the first one's stations
        kind, carrier = MIXED_KINDS[mode]
        stations += [FakeStation(offset_hz=ch.channel_offset_hz(lay["base"][k] + s) + carrier, kind=kind,
                                 tone_hz=1000.0, deviation_hz=4000.0, amplitude=D_AMPLITUDE)
                     for s in lay["tone"]]
    # the fake receiver's noise: 0.001 a component over fs, 2e-6 * 25e3 / fs in a channel
    weak = float(np.sqrt(10.0 ** (D_WEAK_SNR_DB / 10.0) * 2e-6 * 25e3 / fs))
    for slot, amp, pulses in ((lay["pulse"], D_AMPLITUDE, True), (lay["weak"], weak, False)):
        stations.append(FakeStation(offset_hz=ch.channel_offset_hz(slot), kind="iq_loop",
                                    iq_loop=gated_fm_loop(fs, amp, pulses), amplitude=1.0))
    stations.append(FakeStation(offset_hz=ch.channel_offset_hz(lay["wide"][0]), kind="wbfm",
                                tone_hz=1000.0, deviation_hz=75_000.0, amplitude=D_AMPLITUDE))
    return FakeDriver(1, stations)


def engine_channels(cap, lay: dict, c: int) -> dict:
    """Every slot of every bank opened through ``create_channel``; returns
    the listened channels' handles by (bank, slot) ("w" for wide)."""
    from wavecap_tpu_torch.capture import ChannelSpec

    ch = cap._channelizer
    listened = set(lay["tone"]) | {lay["pulse"], lay["weak"], *lay["empty"]}
    handles = {}
    for k, (mode, dsp) in enumerate(D_BANKS):
        for i in range(c):
            # the weak NBFM station is below the squelch: its slots stay open
            # (an open empty SAM slot would be its PLL tracking noise, a
            # chaotic loop that no two summation orders follow alike)
            sq = None if i == lay["weak"] and mode == "nbfm" else SQUELCH_DB
            h = cap.create_channel(ChannelSpec(
                id=f"b{k}s{i}", mode=mode, frequency_hz=D_CENTER + ch.channel_offset_hz(lay["base"][k] + i),
                squelch_db=sq, dsp=dict(dsp)))
            if i in listened:
                handles[(k, i)] = h
    for j, b in enumerate(lay["wide"]):
        handles[("w", j)] = cap.create_channel(ChannelSpec(
            id=f"w{j}", mode="wbfm", frequency_hz=D_CENTER + ch.channel_offset_hz(b),
            squelch_db=D_WIDE_SQUELCH_DB, dsp=dict(D_WIDE_DSP)))
    return handles


def _words_for(transport: str, block: np.ndarray):
    from wavecap_tpu_torch.capture.engine import pack_i4_words, pack_i8_words, pack_i16_words

    if transport == "i16":
        return pack_i16_words([block]), None
    return (pack_i8_words if transport == "i8" else pack_i4_words)([block])


def _batch_on(device, words, scales):
    import torch

    w = torch.from_numpy(words).to(device)
    return w if scales is None else (w, torch.from_numpy(scales).to(device))


def gated_power_db(blocks: list, t0s: list, where: str, span: tuple, rate: float = 48_000.0) -> float:
    """dB of the audio's power in the tone's pauses over its power while the
    tone is on (away from the edges and the pulses), over ``blocks`` of
    audio whose first samples lie at ``t0s`` in the stream (s), within
    ``span`` of each block: the noise reduction passes a block's last
    ``n - out_len`` samples through unprocessed, and divides its first and
    last half frame by a vanishing window power (the reference's
    overlap-add), so those samples are left out.  ``where="pulse"`` takes
    +-3 ms around each pulse, ``"pause"`` the rest of the pauses (the noise
    floor)."""
    period, on = D_GATE
    at = D_PULSE[2] + D_PULSE[1] / 2 + 1e-3  # the pulse's centre, and ~1 ms through the filters
    num = den = 0.0
    for audio, t0 in zip(blocks, t0s):
        a = audio[span[0]:span[1]]
        phase = (t0 + (span[0] + np.arange(len(a))) / rate) % period
        pulse = np.abs(phase - at) <= 3e-3
        sel = pulse if where == "pulse" else (phase > on + 10e-3) & (phase < period - 10e-3) & ~(np.abs(phase - at) <= 8e-3)
        tone = (phase > 5e-3) & (phase < on - 5e-3)
        num += float(np.sum(a[sel] ** 2)) / max(int(sel.sum()), 1) * len(a)
        den += float(np.sum(a[tone] ** 2)) / max(int(tone.sum()), 1) * len(a)
    return float(10 * np.log10(num / den))


def host_syncs(fn) -> tuple[int, list]:
    """Host syncs of one call, as ``torch.cuda.set_sync_debug_mode`` warns
    them: the count and the distinct messages."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # each sync warns "called a synchronizing CUDA operation"; enabling the
    # mode also warns once that it is a prototype, which is no sync
    msgs = [str(w.message) for w in seen if "called a synchronizing" in str(w.message)]
    return len(msgs), sorted(set(m.splitlines()[0][:120] for m in msgs))


def engine_kernel_checks(device, c: int = 160, n_block: int = 1_968_000, m: int = 800,
                         timer=device_ms, e_rows: int = 100):
    """K11a, K11b and K1's i8 and i4 words against their plain versions on
    the card at program D's shapes (and K11a's and K11b's at a mesh shard's
    ``e_rows``, and their adversarial cases).  Returns ``(lines, cases)``."""
    import torch

    from wavecap_tpu_torch.ops import channelizer as chz
    from wavecap_tpu_torch.ops import noise

    rng = np.random.default_rng(SEED + 7)
    lines, cases = {}, []
    s = 2 * n_block // m
    n_audio = -(-s * 48 // 25)
    n_wide = n_block // max(1, 10_000_000 // 240_000)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def record(name, case, source, replaces, **k):
        k.update(name=name, case=case, route="cuda", source=source, replaces=replaces,
                 library_ms=k.get("library_ms"))
        cases.append(k)
        lines.setdefault(name, k)

    # K11a: complex rows (NBFM, the wide IF) and real rows (the AM envelope)
    # at program D's bank rows and a mesh shard's (E); then the adversarial
    # rows: ties at the median, all equal, all zero, n = 1 and 2, and a row
    # past a cluster's shared memory (the long-row path)
    src_a, rep_a = "wavecap_tpu_torch/kernels/csrc/noise_blanker.cu", "wavecap_tpu/ops/noise.py:17 noise_blanker"
    k11a_cases = [("nbfm IQ rows", c, s, True, None), ("wide IF rows", 2, n_wide, True, None),
                  ("am/ssb/sam detector rows", c, s, False, None)]
    if e_rows and e_rows != c:
        k11a_cases += [("nbfm IQ rows", e_rows, s, True, None), ("am/ssb/sam detector rows", e_rows, s, False, None)]
    k11a_cases += [("ties at the median", 8, s, True, "ties"), ("ties at the median", 2, n_wide, False, "ties"),
                   ("all equal", 4, s, True, "equal"), ("all zero", 4, s, False, "zero"), ("n = 1", 4, 1, True, None),
                   ("n = 2", 4, 2, False, None), ("long row", 1, K11A_LONG_ROW, True, None)]
    for case, rows, n, cplx, kind in k11a_cases:
        x = 0.05 * rng.standard_normal((rows, n)) + 0.2
        if cplx:
            x = x + 1j * 0.05 * rng.standard_normal((rows, n))
        hits = rng.random((rows, n)) < 1.0 / 400
        x = np.where(hits, x * 40.0, x)
        if kind == "ties":  # magnitudes on a 1/64 grid: many equal to the median
            x = np.round(x.real * 64) / 64 + (1j * np.round(x.imag * 64) / 64 if cplx else 0)
        elif kind == "equal":
            x = np.full((rows, n), 0.3 + 0.1j if cplx else -0.3)
        elif kind == "zero":
            x = np.zeros((rows, n))
        x = x.astype(np.complex64 if cplx else np.float32)
        plan = noise.k11a_plan(n, cplx)
        check(plan.staged == (case != "long row"), f"K11a ({case}) plan {plan}: staged only below a cluster's memory")
        xd = dev(x)
        y_k = host(noise.noise_blanker(xd))
        y_p = host(noise.noise_blanker_plain(xd))
        mag = noise._magnitude(xd)
        srt = torch.sort(mag, dim=-1).values
        med = (srt[:, (n - 1) // 2] + srt[:, n // 2]) * 0.5
        thr = host(med)[:, None] * np.float32(10.0 ** 0.5)
        near = np.abs(host(mag) - thr) <= 2 * np.spacing(np.abs(thr))
        near &= host(med)[:, None] >= 1e-10  # a degenerate row passes whatever its threshold
        wide = near.copy()
        for d in range(1, 4):
            wide[:, d:] |= near[:, :-d]
            wide[:, :-d] |= near[:, d:]
        differ = y_k != y_p
        check(not (differ & ~wide).any(), f"K11a ({case}) differs from the plain version away from the threshold")
        check(near.mean() <= 1e-3, f"K11a ({case}): {near.mean():.3g} of samples near the threshold")
        if kind in ("equal", "zero"):
            check(np.array_equal(y_k, x), f"K11a ({case}) changed a row it must pass")
        itemsize = 8 if cplx else 4
        b, f = bound(2 * rows * n * itemsize, 12.0 * rows * n)
        extra = {}
        if kind is None and n > 2 and case != "long row":
            # the median alone through one PyTorch call, held to the plain
            # version's first: quantile's midpoint may round the sum apart (1 ulp)
            q = torch.quantile(mag, 0.5, dim=-1, interpolation="midpoint")
            check(bool(torch.allclose(q, med, rtol=2.0**-23, atol=0.0)),
                  f"K11a ({case}): torch.quantile's median is not the plain version's")
            extra = dict(part_library_ms=timer(lambda: torch.quantile(noise._magnitude(xd), 0.5, dim=-1,
                                                                      interpolation="midpoint")),
                         part_library_note="torch.quantile(|x|, 0.5, dim=-1): the median alone, "
                                           "not the same function (no threshold, mask or dilation)")
        record("K11a_noise_blanker", f"{case} ({rows}, {n})", src_a, rep_a, plan=plan._asdict(),
               near_threshold=int(near.sum()), differing=int(differ.sum()), blanked=int((y_k == 0).sum()),
               max_abs_err=float(np.max(np.abs(y_k - y_p))),
               ms=timer(lambda: noise.noise_blanker(xd), K11A_KERNELS),
               plain_ms=timer(lambda: noise.noise_blanker_plain(xd)), bound_ms=b, bound_by=f,
               library_note="no single PyTorch call blanks on a median threshold", **extra)

    # K11b: (c, n_audio) NBFM audio, a mesh shard's (e_rows, n_audio), (2,
    # n_audio) wide audio (17 frames: the register gain), and (2, 48,000),
    # 92 frames: the staged gain
    src, rep = ("wavecap_tpu_torch/kernels/csrc/noise_reduction.cu",
                "wavecap_tpu/ops/noise.py:44 spectral_noise_reduction")
    k11b_cases = [("nbfm audio", c, n_audio)] + ([("nbfm audio", e_rows, n_audio)] if e_rows and e_rows != c else [])
    k11b_cases += [("wide audio", 2, n_audio), ("wide audio, 92 frames", 2, K11B_MANY_FRAMES)]
    for case, rows, n_a in k11b_cases:
        tt = np.arange(n_a) / 48_000.0
        x = (0.3 * np.sin(2 * np.pi * rng.uniform(300, 3000, (rows, 1)) * tt)
             * ((tt % 0.08) < 0.05) + 0.05 * rng.standard_normal((rows, n_a))).astype(np.float32)
        xd = dev(x)
        y_k = host(noise.spectral_noise_reduction(xd))
        y_p = host(noise.spectral_noise_reduction_plain(xd))
        err = min(snr_db(y_p[i], y_k[i]) for i in range(rows))
        check(err >= 90.0, f"K11b ({case}) {err:.1f} dB < 90 against the plain version")
        hop, frames, out_len = noise._nr_plan(n_a, 1024, 0.5)
        plan = noise.k11b_plan(frames)
        check((plan.bucket > 0) == (frames <= 32), f"K11b ({case}): {frames} frames took the gain plan {plan}")
        bins = 513
        spec_b = rows * frames * bins * 8
        frames_b = rows * frames * 1024 * 4
        plain = timer(lambda: noise.spectral_noise_reduction_plain(xd))
        framed = torch.empty((rows, frames, 1024), dtype=torch.float32, device=device)
        cufft = timer(lambda: torch.fft.irfft(torch.fft.rfft(framed, dim=-1), 1024, dim=-1))
        # the per-bin floor alone through one PyTorch call, held to the plain
        # version's first (quantile interpolates as lo + (hi - lo) h with q in
        # float64: a few ulp from lo (1 - h) + hi h at q = f32(0.1))
        idx = (torch.arange(frames, device=device)[:, None] * hop + torch.arange(1024, device=device)[None, :])
        win, _ = noise._nr_tables(n_a, 1024, 0.5, device)
        spec_mag = noise._magnitude(torch.fft.rfft(xd[..., idx] * win, dim=-1))
        pos = noise._percentile_pos(frames)
        lo_r, hi_r = int(np.floor(pos)), int(np.ceil(pos))
        hw = np.float32(np.float32(pos) - np.float32(lo_r))
        srt = torch.sort(spec_mag, dim=-2).values
        floor_p = srt[..., lo_r, :] * float(np.float32(1.0) - hw) + srt[..., hi_r, :] * float(hw)
        q = torch.quantile(spec_mag, 0.1, dim=-2)
        check(bool(torch.allclose(q, floor_p, rtol=1e-6, atol=1e-12)),
              f"K11b ({case}): torch.quantile's floor is not the plain version's")
        part = timer(lambda: torch.quantile(spec_mag, 0.1, dim=-2))
        parts = (("K11b_nr_frames", "nr_frames_kernel", bound(rows * n_a * 4 + frames_b, 1.0 * frames_b / 4), {}),
                 ("K11b_nr_gain", "nr_gain_kernel",
                  bound(2 * spec_b, rows * frames * bins * (10.0 + 4 * np.log2(max(frames, 2)))),
                  dict(gain_plan=plan._asdict(), part_library_ms=part,
                       part_library_note="torch.quantile(|X|, 0.1, dim=-2) of the frames' spectra: the "
                                         "floor alone, not the same function (no gain, no rewrite)")),
                 ("K11b_nr_overlap_add", "nr_overlap_add_kernel",
                  bound(frames_b + rows * n_a * 8, 4.0 * rows * out_len), {}))
        for name, kname, (b, f), extra in parts:
            record(name, f"{case} ({rows}, {n_a}): {frames} frames", src, rep, snr_vs_plain_db=err,
                   max_abs_err=float(np.max(np.abs(y_k - y_p))),
                   ms=timer(lambda: noise.spectral_noise_reduction(xd), kname), plain_ms=plain,
                   plain_note="the whole plain function (framing, rFFT, sort, gain, irFFT, overlap-add)",
                   cufft_ms=cufft, bound_ms=b, bound_by=f,
                   library_note="no single PyTorch call does spectral subtraction; cufft_ms is the rFFT + irFFT between the launches",
                   **extra)

    # K1 on the adaptive words: the unpacked block bit-equal, the arms within 1e-6
    ch = chz.ChannelizerConfig(sample_rate=float(m * 12_500), channel_bandwidth=12_500.0)
    t = ch.taps_per_channel
    hist = dev((rng.standard_normal(m * t) + 1j * rng.standard_normal(m * t)).astype(np.complex64) * 0.1)
    for kind, dtype, hi in (("i8", np.int16, 2**15), ("i4", np.int8, 2**7)):
        words = dev(rng.integers(-hi, hi, n_block).astype(dtype))
        scale = dev(np.array([0.0123], np.float32))[0]
        x_k, u_k = chz.unpack_arms(words, hist, ch, scale)
        x_p, u_p = chz.unpack_arms_plain(words, hist, ch, scale)
        check(torch.equal(x_k, x_p), f"K1 ({kind} words) unpacked block differs from the plain version")
        err = rel_l2(host(u_p), host(u_k))
        check(err <= 1e-6, f"K1 ({kind} words) arms rel L2 {err:.3g} > 1e-6")
        r_steps = n_block // m
        b, f = bound(n_block * np.dtype(dtype).itemsize + 4 + m * t * 12 + 2 * r_steps * m * 8 + n_block * 8,
                     2 * r_steps * m * t * 4)
        cases.append(dict(name="K1_unpack_arms", case=f"{kind} words + scale, N = {n_block}", rel_l2=err,
                          max_abs_err=max_abs(host(u_p), host(u_k)),
                          ms=timer(lambda: chz.unpack_arms(words, hist, ch, scale), "unpack_arms_kernel"),
                          plain_ms=timer(lambda: chz.unpack_arms_plain(words, hist, ch, scale)),
                          bound_ms=b, bound_by=f, library_ms=None))
    # K6 (the sampled spectrum, cuFFT) and K8 (pack_wire, plain torch) at
    # program D's shapes: library and plain code, timed for their share
    from wavecap_tpu_torch import ops
    from wavecap_tpu_torch.capture.pipeline import pack_wire

    xb = dev((rng.standard_normal(n_block) + 1j * rng.standard_normal(n_block)).astype(np.complex64) * 0.1)
    rows_d = {("bank", k): {"audio": dev(rng.uniform(-1, 1, (1, D_FETCH_SLOTS, n_audio)).astype(np.float32)),
                            "rssi": dev(rng.uniform(-90, -20, (1, c)).astype(np.float32))}
              for k in range(len(D_BANKS))}
    out_d = {"banks": rows_d, "rssi": dev(np.zeros(1, np.float32)),
             "spectrum": dev(np.zeros((1, 2, 2048), np.float32)),
             "wide": {(): {"audio": dev(rng.uniform(-1, 1, (1, 2, n_audio)).astype(np.float32)),
                           "rssi": dev(np.zeros((1, 2), np.float32))}}}
    # bytes bounds: the spectrum reads its 16 sampled frames and writes 2
    # spectra; pack_wire reads every leaf and writes the packed buffer
    wire_bytes = int(pack_wire(out_d).numel())
    leaf_bytes = sum(t.numel() * t.element_size() for t in (
        [v for b in rows_d.values() for v in b.values()] + [out_d["rssi"], out_d["spectrum"]]
        + list(out_d["wide"][()].values())))
    for name, fn, what, nbytes in (
        ("K6_spectrum", lambda: ops.spectrogram_sampled(xb, 2048, n_out=2), f"({n_block},) complex64, 2 frames",
         16 * 2048 * 8 + 2 * 2048 * 4),
        ("K8_pack_wire", lambda: pack_wire(out_d), f"{len(D_BANKS)} banks x {D_FETCH_SLOTS} gated rows + 2 wide",
         leaf_bytes + wire_bytes),
    ):
        cases.append(dict(name=name, case=what, route="torch", ms=timer(fn), launches_per_call=launches_per_call(fn),
                          wall_ms=time_ms(fn), bytes=nbytes, bound_ms=nbytes / PEAK_BYTES_PER_S * 1e3,
                          bound_by="bytes"))
    return [lines[k] for k in ("K11a_noise_blanker", "K11b_nr_frames", "K11b_nr_gain", "K11b_nr_overlap_add")], cases


def launches_per_call(fn) -> int:
    """Kernels the card ran for one call (CUPTI through torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return int(sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA
                   and "memcpy" not in e.key.lower() and "memset" not in e.key.lower()))


def run_engine(device, fs: int = 10_000_000, c: int = 160, n_blocks: int = 3 * D_SEGMENT,
               sync=None) -> dict:
    """Program D through the engine: ``CaptureManager`` -> ``create_capture``
    -> ``create_channel`` for every slot -> ``warmup`` -> ``start``; the
    transport steps i16 -> i8 -> i4 every ``D_SEGMENT`` blocks (set
    between dispatches, as the controller does); then every check."""
    import torch

    from wavecap_tpu_torch.capture import CaptureConfig, CaptureManager
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    sync = sync or torch.cuda.synchronize
    lay = engine_layout(c)
    m = int(fs / 12_500) - int(fs / 12_500) % 2
    cfg = CaptureConfig(center_hz=D_CENTER, sample_rate=fs, channel_bandwidth=12_500.0, block_seconds=0.2,
                        narrow_capacity=c, wide_capacity=2, p25_capacity=0, audio_rate=48_000,
                        fft_size=2048, transport="i16", adaptive_transport=True,
                        audio_fetch_slots=min(D_FETCH_SLOTS, c // 2), pipeline_depth=1,
                        blocks_per_dispatch=1)
    mgr = CaptureManager(engine_scene(fs, m, lay), device=device)
    cap = mgr.create_capture(config=cfg)
    handles = engine_channels(cap, lay, c)
    subs = {key: h.audio.subscribe(maxsize=4 * n_blocks) for key, h in handles.items()}
    iq_sub = cap.iq_subs.subscribe(maxsize=n_blocks + 4)
    t0 = time.perf_counter()
    w = cap.warmup()
    w.join(timeout=900)
    warm_s = time.perf_counter() - t0
    check(not w.is_alive() and cap.warmup_error is None, f"warmup failed: {cap.warmup_error}")

    real = cap._dispatch_blocks
    sent = [0]

    def dispatch(blocks):
        if sent[0] >= n_blocks:
            cap._stop.wait()  # exactly n_blocks: hold the reader until stop()
            return
        cap.transport_active = D_LADDER[sent[0] // D_SEGMENT]
        sent[0] += 1
        real(blocks)

    cap._dispatch_blocks = dispatch
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    states = set()
    t0 = time.perf_counter()
    cap.start()
    try:
        while cap.blocks_processed < n_blocks and time.perf_counter() - t0 < 600:
            if cap.state != "starting":
                states.add(cap.state)
            time.sleep(0.005)
        run_s = time.perf_counter() - t0
        states.add(cap.state)
        counts = launch_counts()
        peak_mem = torch.cuda.max_memory_allocated()
    finally:
        cap.stop()
    check(states == {"running"}, f"capture states {states}: error {cap.error}")
    check(cap.blocks_processed == n_blocks, f"{cap.blocks_processed} blocks processed, not {n_blocks}")
    want = {k: n_blocks * D_LAUNCHES.get(k, 0) for k in counts}
    check(counts == want, f"launch counts {counts} != {want}")
    pinned = [t.is_pinned() for t in cap._seam.staging_buffers() + cap._seam.fetch_buffers()]
    check(len(pinned) >= 3 and all(pinned), "a staging or fetch buffer is not pinned")

    blocks = []
    while (b := iq_sub.get_nowait()) is not None:
        blocks.append(b)
    check(len(blocks) == n_blocks, f"{len(blocks)} IQ blocks published, not {n_blocks}")
    audio = {}
    for key, sub in subs.items():
        got = []
        while (a := sub.get_nowait()) is not None:
            got.append(a)
        audio[key] = got
    n_audio = -(-2 * cap.block_size // m * 48 // 25)
    for key, got in audio.items():
        check(len(got) == n_blocks and all(a.shape == (n_audio,) if key[0] != "w" else a.ndim == 1 for a in got),
              f"channel {key}: {len(got)} audio blocks")
        check(all(np.isfinite(a).all() for a in got), f"channel {key}: audio not finite")

    # the kernel path and the plain path on the card, from the engine's own
    # blocks, words and control: the wire against the kernels' output, and the
    # kernels against the plain versions
    pipe_cfg, ctl = cap._pipe_cfg, cap._ctl
    sel = ctl.audio_sel
    audio_pos = dict(cap._audio_pos)
    listened = {(h.mode_group, h.slot) for key, h in handles.items() if key[0] != "w"}
    check(set(audio_pos) == listened, "the gated rows are not exactly the listened channels")
    for (group, slot), pos in audio_pos.items():
        check(int(sel[group][pos]) == slot, f"gated row {pos} of {group} is not slot {slot}")
    st_k = pipeline_init(pipe_cfg, device=device)
    st_p = pipeline_init(pipe_cfg, device=device)
    lsb, worst_plain, wire_words, low = 0.0, float("inf"), [], []
    first = [seg * D_SEGMENT + j for seg in range(len(D_LADDER)) for j in (0, 1)]
    for k, block in enumerate(blocks):
        transport = D_LADDER[k // D_SEGMENT]
        words, scales = _words_for(transport, block)
        wire_words.append(words.nbytes + (0 if scales is None else scales.nbytes))
        batch = _batch_on(device, words, scales)
        o_k, st_k = capture_multi(batch, st_k, ctl, pipe_cfg)
        if k in first:
            with plain_kernels():
                o_p, st_p = capture_multi(batch, st_p, ctl, pipe_cfg)
        elif k < max(first):
            with plain_kernels():
                _, st_p = capture_multi(batch, st_p, ctl, pipe_cfg)
        for key, h in handles.items():
            if key[0] == "w":
                row_k = o_k["wide"][h.mode_group[1]]["audio"][0, h.slot]
                row_p = None if k not in first else o_p["wide"][h.mode_group[1]]["audio"][0, h.slot]
            else:
                pos = audio_pos[(h.mode_group, h.slot)]
                row_k = o_k["banks"][h.mode_group]["audio"][0, pos]
                row_p = None if k not in first else o_p["banks"][h.mode_group]["audio"][0, pos]
            pub = audio[key][k]
            lsb = max(lsb, float(np.max(np.abs(pub - np.clip(host(row_k), -1.0, 1.0)))))
            if row_p is not None:
                ref = np.clip(host(row_p), -1.0, 1.0)
                if np.abs(ref).max() > 0:
                    v = snr_db(ref, pub)
                    worst_plain = min(worst_plain, v)
                    if v < 60.0:
                        low.append((v, str(key), k))
                else:
                    check(not pub.any(), f"channel {key} block {k}: audio where the plain path is silent")
        if k == 0:
            # the gated rows are their slots' rows of the ungated program
            full, _ = capture_multi(batch, pipeline_init(pipe_cfg, device=device), ctl._replace(audio_sel=None),
                                    pipe_cfg)
            for (group, slot), pos in audio_pos.items():
                check(torch.equal(full["banks"][group]["audio"][0, slot], o_k["banks"][group]["audio"][0, pos]),
                      f"gated row {pos} of {group} differs from slot {slot}")
    check(lsb <= 0.5 / 32767 + 1e-6, f"published audio off the kernels' output by {lsb:.3g} > half an LSB")
    check(worst_plain >= 50.0, f"engine audio {worst_plain:.1f} dB < 50 against the plain path: "
          f"(dB, channel, block) under 60: {sorted(low)[:24]}")

    # the stations: 1 kHz lines per segment, empty slots squelched, the
    # blanker and the noise reduction
    margins, line_min = {}, [float("inf")] * len(D_LADDER)
    for seg in range(len(D_LADDER)):
        blk = range(max(1, seg * D_SEGMENT), (seg + 1) * D_SEGMENT)
        for key in [(k, s) for k in range(len(D_BANKS)) for s in lay["tone"]] + [("w", 0)]:
            v = tone_margin_db(np.concatenate([audio[key][b] for b in blk]), 48_000.0)
            margins[f"{D_LADDER[seg]}:{key[0]}:{key[1]}"] = v
            line_min[seg] = min(line_min[seg], v)
            check(v >= D_LINE_DB[seg], f"{D_LADDER[seg]}: station {key} 1 kHz line {v:.1f} dB < {D_LINE_DB[seg]}")
    empties = [(k, s) for k in range(len(D_BANKS)) for s in lay["empty"]] + [("w", 1)]
    empties += [(k, lay["weak"]) for k, (mode, _) in enumerate(D_BANKS) if mode != "nbfm"]
    for key in empties:
        check(not any(a.any() for a in audio[key]), f"empty listened channel {key}: squelch opened")
    from wavecap_tpu_torch.ops.noise import _nr_plan

    block_s = cap.block_size / fs
    seg16 = list(range(1, D_SEGMENT))
    t0s = [b * block_s for b in seg16]
    hop, _, out_len = _nr_plan(n_audio, 1024, 0.5)
    span = (hop, out_len - hop)
    pulses = {k: gated_power_db([audio[(k, lay["pulse"])][b] for b in seg16], t0s, "pulse", span)
              for k in (0, 1)}
    check(pulses[1] <= pulses[0] - 10.0,
          f"blanker: pulse energy {pulses[1]:.1f} dB, not 10 dB below the default bank's {pulses[0]:.1f}")
    # the weak station's noise floor (its pauses) under its 1 kHz tone
    nr = {k: gated_power_db([audio[(k, lay["weak"])][b] for b in seg16], t0s, "pause", span) for k in (0, 1)}
    check(nr[1] <= nr[0] - 3.0,
          f"noise reduction: noise floor {nr[1]:.1f} dB under the tone, not 3 dB below the default bank's {nr[0]:.1f}")

    # host syncs per block, block latency, the stages, the traced breakdown
    syncs = {}
    for transport in D_LADDER:
        words, scales = _words_for(transport, blocks[0])
        batch = _batch_on(device, words, scales)
        syncs[transport] = host_syncs(lambda: capture_multi(batch, pipeline_init(pipe_cfg, device=device),
                                                            ctl, pipe_cfg))
    lat = np.asarray(list(cap.block_latency_ms)[1:])
    perf = {k: v / cap.perf["dispatches"] for k, v in cap.perf.items() if k != "dispatches"}
    words16 = torch.from_numpy(np.concatenate([_words_for("i16", b)[0] for b in blocks[:D_SEGMENT]])).to(device)

    def one_pass():
        o, _ = capture_multi(words16, pipeline_init(pipe_cfg, device=device), ctl, pipe_cfg)
        fetch(o["_packed"])

    one_pass()
    sync()
    t0 = time.perf_counter()
    one_pass()
    sync()
    direct_ms = (time.perf_counter() - t0) * 1e3 / D_SEGMENT
    return dict(phase="engine (program D)", blocks=n_blocks, block_size=cap.block_size, channels=m,
                slots_per_bank=c, banks=[[mode, dsp] for mode, dsp in D_BANKS], wide_slots=2,
                transports=[D_LADDER[k // D_SEGMENT] for k in range(n_blocks)], launches=counts,
                warmup_s=warm_s, run_s=run_s, states=sorted(states),
                warm_latency_ms_p50=float(np.percentile(lat, 50)), warm_latency_ms_p95=float(np.percentile(lat, 95)),
                latency_ms=[float(v) for v in cap.block_latency_ms],
                perf_ms_per_block=perf, host_syncs_per_block={k: v[0] for k, v in syncs.items()},
                host_sync_sites=sorted({s for v in syncs.values() for s in v[1]}),
                peak_device_memory_bytes=int(peak_mem), upload_bytes_per_block=wire_words,
                direct_ms_per_block=direct_ms, profile=profile_blocks(one_pass, D_SEGMENT, sync),
                tone_margin_db=margins, line_min_db=dict(zip(D_LADDER, line_min)),
                pulse_energy_db={"default": pulses[0], "blanker": pulses[1]},
                weak_floor_under_tone_db={"default": nr[0], "noise_reduction": nr[1]},
                wire_audio_max_abs=lsb, first_blocks_vs_plain_db=worst_plain,
                fetched_rows_per_bank=int(sel[next(iter(sel))].numel()),
                pinned_buffers=len(pinned))


# --- the per-symbol P25 timing scans (K12s, K13s): kernel checks and programs ----------

# the scans' launches in place of the block timing's
A_SCAN_LAUNCHES = {**A_LAUNCHES, "K12_c4fm_timing": 0, "K12s_c4fm_scan": 1}
B_SCAN_LAUNCHES = {**B_LAUNCHES, "K13_cqpsk_timing": 0, "K13s_cqpsk_scan": 1}
C_SCAN_LAUNCHES = {**C_LAUNCHES, "K13_cqpsk_timing": 0, "K13s_cqpsk_scan": 2}
# K12s's and K13s' scans, then rows longer than the first design took (it
# staged every symbol in shared memory: past 17,066 CQPSK and 51,200 C4FM
# symbols it refused), then loops the plan sizes otherwise: (what,
# modulation, rows, channel samples a block, changes to the config); rows
# are 64 + n long, at the programs' 50 kHz unless the config says
SCAN_EXTRA_SHAPES = (
    ("4 s rows, LSM CQPSK, 2 x 200,064 c64", "lsm", 2, 200_000, {}),
    ("3 s rows, Phase 2, 2 x 150,064 c64 at 6000 baud", "p2", 2, 150_000, {}),
    ("11 s row, C4FM, 1 x 550,064 f32", "c4fm", 1, 550_000, {}),
    ("C4FM at 240 kHz (50 samples a symbol: chunks of 2,048), 4 x 48,064 f32", "c4fm", 4, 48_000,
     {"sample_rate": 240_000}),
    ("C4FM at 960 kHz (200 a symbol: groups of 64, every step checked), 2 x 192,064 f32", "c4fm", 2,
     192_000, {"sample_rate": 960_000}),
    ("LSM with a 30,000 ppm clock range (every step checked), 21 x 7,564 c64", "lsm", 21, 7_500,
     {"max_clock_ppm": 30_000.0}),
)


def scan_path_shapes() -> tuple:
    """The scans' shapes: programs A, B and C's (their P25 slots, two
    blocks of channel samples a launch, from :func:`p25_configs`), then
    :data:`SCAN_EXTRA_SHAPES`."""
    cfgs = p25_configs()
    n_a = 2 * cfgs["A"].block_size // cfgs["A"].channelizer().channel_count
    n_b = 2 * cfgs["B"].block_size // cfgs["B"].channelizer().channel_count
    n_c = 2 * cfgs["C"].block_size // cfgs["C"].channelizer().channel_count
    r_a, r_b, r_c = cfgs["A"].p25_capacity, cfgs["B"].p25_capacity, cfgs["C"].p25p2_capacity
    return (
        (f"program A, {r_a} x {64 + n_a:,} f32", "c4fm", r_a, n_a, {}),
        (f"program B, {r_b} x {64 + n_b:,} c64", "lsm", r_b, n_b, {}),
        (f"program C, {r_c} x {64 + n_c:,} c64 at 6000 baud", "p2", r_c, n_c, {}),
    ) + SCAN_EXTRA_SHAPES


SCAN_NAMES = {"c4fm": "K12s_c4fm_scan", "lsm": "K13s_cqpsk_scan", "p2": "K13s_cqpsk_scan"}
SCAN_LONG = 100_000  # channel samples: the long rows, whose plain loop is not timed

# the dependent chain of one symbol that the reference's f32 order fixes,
# loads excluded (the next samples are known steps early): the mid point,
# the floor and fraction, 1 - fraction, the lerp's product and sum, C4FM's
# dc, the error's product (C4FM: the division by the block's constant
# amp^2, at least a multiply and two fused multiply-adds exact), beta err,
# the integrator's sum and clip, the clock's sum, the position's two sums;
# the three clips of err, integ and freq merged exactly into one (p25_scan.cu:
# walk).  op -> count; "floor": a floor and its fraction, the cheaper of
# FRND + FADD and a compare + select between two known floors
SCAN_CHAIN_OPS = {
    "c4fm": {"fadd": 8, "fmul": 4, "ffma": 2, "fmnmx": 2, "floor": 1},
    "cqpsk": {"fadd": 8, "fmul": 3, "ffma": 0, "fmnmx": 2, "floor": 1},
}
# the same chain as the reference writes it: FRND, the IEEE division, three
# clips of two FMNMX each
SCAN_CHAIN_AS_WRITTEN = {
    "c4fm": {"fadd": 9, "fmul": 3, "fdiv_rn": 1, "fmnmx": 6, "frnd": 1},
    "cqpsk": {"fadd": 9, "fmul": 3, "fmnmx": 6, "frnd": 1},
}

# dependent chains of one operation each, timed by clock64 in one thread:
# op k runs n x 16 times; the latencies that SCAN_CHAIN_OPS weighs
SCAN_PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <math.h>
template <int kOp>
__global__ void probe(const float* in, long long* cycles, float* out, int n) {
    __shared__ int chase[64];
    const float a = in[0], b = in[1], c = in[2], d = in[3];
    float x = in[4];
    int i = static_cast<int>(in[5]);
    for (int k = threadIdx.x; k < 64; k += blockDim.x) chase[k] = (k + 1 + static_cast<int>(in[5])) & 63;
    __syncthreads();
    if (threadIdx.x != 0) return;
    const long long t0 = clock64();
#pragma unroll 1
    for (int k = 0; k < n; ++k) {
#pragma unroll
        for (int u = 0; u < 16; ++u) {
            if constexpr (kOp == 0) x = __fadd_rn(x, a);
            if constexpr (kOp == 1) x = __fmul_rn(x, b);
            if constexpr (kOp == 2) x = __fmaf_rn(x, b, a);
            if constexpr (kOp == 3) x = fminf(__fadd_rn(x, a), c);
            if constexpr (kOp == 4) x = __fadd_rn(x >= c ? d : x, a);
            if constexpr (kOp == 5) x = __fadd_rn(floorf(x), a);
            if constexpr (kOp == 6) x = __fadd_rn(static_cast<float>(__float2int_rd(x)), a);
            if constexpr (kOp == 7) i = chase[i];
            if constexpr (kOp == 8) x = __fdiv_rn(x, b);
            if constexpr (kOp == 9) {
                const float q = __fmul_rn(x, d);
                x = __fmaf_rn(__fmaf_rn(-q, b, x), d, q);
            }
        }
    }
    const long long t1 = clock64();
    cycles[kOp] = t1 - t0;
    out[kOp] = x + static_cast<float>(i);
}
extern "C" __attribute__((visibility("default"))) int scan_probe(const void* in, void* cycles, void* out, int n) {
    const float* f = static_cast<const float*>(in);
    long long* c = static_cast<long long*>(cycles);
    float* o = static_cast<float*>(out);
    probe<0><<<1, 32>>>(f, c, o, n); probe<1><<<1, 32>>>(f, c, o, n);
    probe<2><<<1, 32>>>(f, c, o, n); probe<3><<<1, 32>>>(f, c, o, n);
    probe<4><<<1, 32>>>(f, c, o, n); probe<5><<<1, 32>>>(f, c, o, n);
    probe<6><<<1, 32>>>(f, c, o, n); probe<7><<<1, 32>>>(f, c, o, n);
    probe<8><<<1, 32>>>(f, c, o, n); probe<9><<<1, 32>>>(f, c, o, n);
    return static_cast<int>(cudaDeviceSynchronize());
}
"""


def scan_op_latencies(n: int = 4096) -> dict:
    """SM cycles of one dependent operation, from :data:`SCAN_PROBE_SRC`
    built with the kernels' own nvcc line: FADD, FMUL, FFMA, FMNMX (after
    an FADD), a compare and select (FSETP + FSEL), FRND (floorf), F2I +
    I2F (``__float2int_rd`` back to float), a shared-memory load, the
    IEEE division ``__fdiv_rn`` and the division by a known reciprocal
    (a multiply and two fused multiply-adds)."""
    import ctypes
    from pathlib import Path

    import torch

    from wavecap_tpu_torch.kernels import build as kb

    kb.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src, lib = kb.BUILD_DIR / "scan_probe.cu", kb.BUILD_DIR / "libscan_probe.so"
    src.write_text(SCAN_PROBE_SRC)
    out = subprocess.run(kb.nvcc_command(src, lib, kb._find_nvcc()), capture_output=True, text=True, timeout=300)
    check(out.returncode == 0, f"the latency probe did not build:\n{out.stdout}{out.stderr}")
    fn = ctypes.CDLL(str(Path(lib))).scan_probe
    fn.argtypes = (ctypes.c_void_p,) * 3 + (ctypes.c_int,)
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    vals = torch.tensor([1.0, 1.0, 1e30, 0.0, 0.5, 0.0], dtype=torch.float32, device=dev)
    cyc = torch.zeros(10, dtype=torch.int64, device=dev)
    res = torch.zeros(10, dtype=torch.float32, device=dev)
    for _ in range(2):  # the first call pays the module's load
        check(fn(vals.data_ptr(), cyc.data_ptr(), res.data_ptr(), n) == 0, "the latency probe failed")
    c = host(cyc).astype(np.float64) / (16 * n)
    fadd = c[0]
    return dict(fadd=fadd, fmul=c[1], ffma=c[2], fmnmx=c[3] - fadd, select=c[4] - fadd, frnd=c[5] - fadd,
                f2i_i2f=c[6] - fadd, lds=c[7], fdiv_rn=c[8], div_by_reciprocal=c[9])


def scan_floor_cycles(lat: dict, kind: str, ops=None) -> float:
    """The chain of :data:`SCAN_CHAIN_OPS` (or ``ops``) at the measured latencies."""
    lat = dict(lat, floor=min(lat["select"], lat["frnd"] + lat["fadd"]))
    return float(sum(k * lat[op] for op, k in (ops or SCAN_CHAIN_OPS)[kind].items()))


def scan_path_case(device, kind: str, rows: int, n: int, change=None, seed: int = SEED + 9):
    """A scan's inputs at one of :func:`scan_path_shapes`, the program's
    config with ``change``: ``(kernel, plain, buf, st, n_sym, cfg)``.  At
    the shorter rows: station rows, the last dead air, row 0 starting
    below the first sample (its mid-point reads the clamp at 0) and row 1
    with a fast clock past the last (the clamp at len - 2); the long rows
    are station rows."""
    import dataclasses

    import torch

    from wavecap_tpu_torch.capture.pipeline import p25_cfg_for, p25p2_cfg_for
    from wavecap_tpu_torch.models.p25 import c4fm, cqpsk
    from wavecap_tpu_torch.models.p25.c4fm import timing_consts

    cfgs = p25_configs()
    rng = np.random.default_rng(seed + rows + n + len(kind))
    long = n >= SCAN_LONG
    if kind == "c4fm":
        cfg = dataclasses.replace(p25_cfg_for(cfgs["A"]), **(change or {}))
        c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005)
        buf = c4fm_rows(rng, rows + long, 64 + n, cfg.sample_rate)[:rows]
        st = timing_state(rng, rows, cfg.sps, cqpsk=False)
        st[5] = rng.uniform(-3, 3, rows)  # the last raw symbol, which the scan reads
        kfn, pfn, n_sym = c4fm.c4fm_scan, c4fm.c4fm_scan_plain, c4fm.n_symbols_per_block(cfg, n)
    else:
        cfg = dataclasses.replace(p25_cfg_for(cfgs["B"]) if kind == "lsm" else p25p2_cfg_for(cfgs["C"]),
                                  **(change or {}))
        c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002)
        buf = cqpsk_rows(rng, rows + long, 64 + n, cfg.sample_rate, cfg.symbol_rate, cfg.rrc_alpha)[:rows]
        st = timing_state(rng, rows, cfg.sps, cqpsk=True)
        kfn, pfn, n_sym = cqpsk.cqpsk_scan, cqpsk.cqpsk_scan_plain, cqpsk.n_symbols_per_block(cfg, n)
    if not long:
        st[0, 0], st[1, 0] = 0.3, cfg.sps  # y_mid reads before the first sample
        st[0, 1], st[1, 1], st[2, 1] = 64.0 + cfg.sps + 5.0, c.fmax, c.integ_hi  # runs past the end

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return kfn, pfn, dev(buf), dev(st), n_sym, cfg


def scan_digest(outs) -> str:
    """A hash of a scan's ``(soft, dibits, out)`` bits: equal digests are
    bit-equal outputs (soft, dibits, the carried scalars and last symbol)."""
    import hashlib

    h = hashlib.sha256()
    for v in outs:
        h.update(np.ascontiguousarray(host(v)).tobytes())
    return h.hexdigest()[:16]


def scan_plan(kind: str, cfg, item: int):
    """The plan K12s / K13s launch with for ``cfg``."""
    from wavecap_tpu_torch.models.p25.c4fm import _loop_gains, k12s_plan, timing_consts

    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.005 if kind == "c4fm" else 0.002)
    return k12s_plan(c, _loop_gains(cfg)[0], item)


def scan_kernel_checks(device, timer=device_ms, wall_timer=time_ms, clock_hz=None, latencies=None):
    """K12s and K13s against their plain versions at every shape of
    :func:`scan_path_shapes`: dibits equal; soft within 1e-3 and the carried
    state within 1e-3 (the plain mean(filt) sums in another order, and the
    loop walks an ulp a little).  Each timed, with the cycles a symbol at
    the card's SM clock (the whole launch over its symbols) beside the
    chain floor at the probe's measured latencies; at the programs' shapes
    the plain loop timed too.  Returns ``(lines, cases)``."""
    clock_hz = clock_hz or sm_clock_hz()
    lat = latencies or scan_op_latencies()
    lines, cases = {}, []
    for what, kind, rows, n, change in scan_path_shapes():
        kfn, pfn, buf, st, n_sym, cfg = scan_path_case(device, kind, rows, n, change)
        name = SCAN_NAMES[kind]
        got = kfn(buf, st, n_sym, cfg)
        s_k, d_k, o_k = (host(v) for v in got)
        s_p, d_p, o_p = (host(v) for v in pfn(buf, st, n_sym, cfg))
        check(np.array_equal(d_k, d_p), f"{name} ({what}): dibits differ from the plain version "
              f"({int((d_k != d_p).sum())} of {d_k.size})")
        err_soft, err_state = max_abs(s_p, s_k), float(np.max(np.abs(o_k - o_p)))
        check(err_soft <= 1e-3 and err_state <= 1e-3,
              f"{name} ({what}): soft off by {err_soft:.3g}, state by {err_state:.3g} (<= 1e-3)")
        length, item = buf.shape[1], buf.element_size()
        b, f = bound(rows * (length * item + n_sym * 5 + 48), rows * 60.0 * n_sym)
        chain_kind = "c4fm" if kind == "c4fm" else "cqpsk"
        floor_cyc = scan_floor_cycles(lat, chain_kind)
        written_cyc = scan_floor_cycles(lat, chain_kind, SCAN_CHAIN_AS_WRITTEN)
        k = dict(name=name, case=what, route="cuda", source="wavecap_tpu_torch/kernels/csrc/p25_scan.cu",
                 replaces=("wavecap_tpu/models/p25/c4fm.py:268-337 (the step :281-290, the scan :294)"
                           if kind == "c4fm" else
                           "wavecap_tpu/models/p25/cqpsk.py:346-373 (gains, interp, step) + :453-457 (the scan)"),
                 plan=scan_plan(kind, cfg, item)._asdict(), max_abs_err=err_soft,
                 state_max_abs=err_state, digest=scan_digest(got),
                 chain_floor_cycles_per_symbol=floor_cyc, chain_floor_ms=n_sym * floor_cyc / clock_hz * 1e3,
                 chain_as_written_cycles_per_symbol=written_cyc,
                 chain_note="floor: the reference's dependent f32 chain a symbol after exact rewrites "
                            "(SCAN_CHAIN_OPS) at the probe's measured latencies; as written: with FRND, "
                            "__fdiv_rn and three clips; cycles_per_symbol: the launch's ms at the SM clock "
                            "over its symbols (staging and epilogue included)")
        k["ms"] = timer(lambda: kfn(buf, st, n_sym, cfg), "scan_kernel")
        k["cycles_per_symbol"] = k["ms"] * 1e-3 * clock_hz / n_sym
        k["bound_ms"], k["bound_by"] = b, f
        if n < SCAN_LONG:
            k["wrapper_ms"] = wall_timer(lambda: kfn(buf, st, n_sym, cfg))
            # the plain loop is ~20 launches a symbol: its wall time, 3 calls
            k["plain_ms"] = time_ms(lambda: pfn(buf, st, n_sym, cfg), reps=3)
            k["plain_note"] = "wall time between CUDA events (the Python loop over symbols)"
            k["library_ms"] = None
            k["library_note"] = "no single PyTorch call runs a timing loop"
            lines.setdefault(name, k)
        cases.append(k)
        del buf, got
    return [lines["K12s_c4fm_scan"], lines["K13s_cqpsk_scan"]], cases + [dict(name="scan op latencies",
                                                                              cycles=lat)]


@contextlib.contextmanager
def scan_timing():
    """``WAVECAP_P25_TIMING=scan`` while the programs' configs are built and run."""
    os.environ["WAVECAP_P25_TIMING"] = "scan"
    try:
        yield
    finally:
        del os.environ["WAVECAP_P25_TIMING"]


def run_scan_programs(cfgs, device) -> list:
    """Programs A, B and C with the scan timing: the same scenes and floors."""
    with scan_timing():
        # B's echo station from block 4 on: its equalizer engages in block 3
        # (two decisive fits), and the per-symbol loop, at 0.5 % of the
        # symbol rate, settles to the new taps' delay within the next block
        # (the block timing within the block): the reference's own scan
        # reads 0.9139 there on this scene, as the port's plain version
        out = [run_program_a(cfgs["A"], device, launches=A_SCAN_LAUNCHES),
               run_program_bc(cfgs["B"], device, "B", launches=B_SCAN_LAUNCHES, echo_first=P25_FIRST + 1),
               run_program_bc(cfgs["C"], device, "C", launches=C_SCAN_LAUNCHES)]
    for r in out:
        r["phase"] += " (scan timing)"
    return out


# --- the mesh: K15, program E (the engine) and program F (P25) --------------------------

MESH_SPEC = "stream=1,time=8"
MESH_SHARDS = 8


def on_mesh(shards, fn):
    """``fn()`` with every shard's stream after the caller's work so far
    and the caller's after every shard's (a mesh step's fork and join)."""
    from wavecap_tpu_torch.parallel import Shard

    caller = Shard.current(shards[0].device)
    fork = caller.record()
    for sh in shards:
        sh.wait(fork)
    out = fn()
    for sh in shards:
        caller.wait(sh.record())
    return out


def k15_checks(device, m: int, taps: int, n_block: int, wide_n: int, wide_rows: int, copies: dict,
               timer=device_ms):
    """K15's exchanges on 8 shards of the card at program E's shapes, each
    against its plain version (one device, one stream: clone, cat, stack)
    exactly, and timed: the halo (7 tails of M*T), the re-shard (8 x (M,
    S_local) -> 8 x (M/8, S)), the wide IF gather (8 x (W, n/8/decim) to the
    first shard) and the history (one tail).  ``copies`` holds program E's
    per-block copy counts; bytes and the bound are those of one block."""
    import torch

    from wavecap_tpu_torch import parallel as tpar
    from wavecap_tpu_torch.capture.mesh import build_mesh

    rng = np.random.default_rng(SEED + 9)
    shards = build_mesh(MESH_SPEC, device).shards[0]
    n = len(shards)
    h, s_local, mb = m * taps, 2 * n_block // n // m, m // n

    def on(shape, sh):
        a = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)
        with sh.use():
            return torch.from_numpy(a).to(sh.device)

    tails = [on((h,), sh) for sh in shards]
    blocks = [on((m, s_local), sh) for sh in shards]
    decs = [on((wide_rows, wide_n), sh) for sh in shards]
    torch.cuda.synchronize()
    ex = {
        "halo": (lambda: tpar.ppermute(tails, shards, [(i, i + 1) for i in range(n - 1)], label="check")[1:],
                 lambda: [t.clone() for t in tails[:-1]]),
        "reshard": (lambda: tpar.all_to_all_tiled(blocks, shards, label="check"),
                    lambda: [torch.cat([b[d * mb:(d + 1) * mb] for b in blocks], dim=1) for d in range(n)]),
        "wide_if": (lambda: [tpar.all_gather(decs, shards, to=shards[0], label="check")],
                    lambda: [torch.stack(decs)]),
        "history": (lambda: tpar.ppermute(tails, shards, [(n - 1, 0)], label="check")[:1],
                    lambda: [tails[-1].clone()]),
    }
    parts, total_ms, plain_ms, total_bytes = {}, 0.0, 0.0, 0
    for label, (fn, plain) in ex.items():
        got = on_mesh(shards, fn)
        torch.cuda.synchronize()
        want = plain()
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"K15 {label} differs from its plain version")
        nbytes = copies[label]["bytes"]
        ms = timer(lambda: on_mesh(shards, fn))
        p_ms = timer(plain)
        parts[label] = dict(copies=copies[label]["copies"], bytes=nbytes, ms=ms, plain_ms=p_ms,
                            bound_ms=2 * nbytes / PEAK_BYTES_PER_S * 1e3,
                            wall_ms=time_ms(lambda: on_mesh(shards, fn)))
        total_ms += ms
        plain_ms += p_ms
        total_bytes += nbytes
    return dict(name="K15_exchanges", route="cuda", source="wavecap_tpu_torch/parallel/collectives.py",
                replaces="wavecap_tpu/parallel/sharded.py:218-236 (ppermute halo, all_to_all), :271, :354 "
                         "(all_gather)",
                max_abs_err=0.0, ms=total_ms, plain_ms=plain_ms, bound_ms=2 * total_bytes / PEAK_BYTES_PER_S * 1e3,
                bound_by="bytes", library_ms=None, bytes_per_block=total_bytes,
                copies_per_block=sum(p["copies"] for p in parts.values()), parts=parts,
                note="8 shards on one card: device-to-device copies; copies between distinct cards "
                     "(NVLink peer copies) are not measured, there is one card")


def mesh_channels(cap, lay: dict) -> dict:
    """Program E's channels, one frequency a bin: the steady 1 kHz stations
    and two empty listened bins of ``nbfm``, ``am``, ``usb`` and ``sam``
    (program D's banks 0, 2, 3, 4), the pulsed and the weak voice-like
    stations in the ``nbfm`` bank with the blanker and noise reduction
    (bank 1; the weak one squelch-open), and the two WBFM slots."""
    from wavecap_tpu_torch.capture import ChannelSpec

    ch = cap._channelizer
    handles = {}
    for k, (mode, dsp) in enumerate(D_BANKS):
        slots = ([(lay["pulse"], SQUELCH_DB), (lay["weak"], None)] if k == 1 else
                 [(s, SQUELCH_DB) for s in (*lay["tone"], *lay["empty"])])
        for s, sq in slots:
            b = lay["base"][k] + s
            handles[(k, s)] = cap.create_channel(ChannelSpec(
                id=f"b{k}s{s}", mode=mode, frequency_hz=D_CENTER + ch.channel_offset_hz(b), squelch_db=sq,
                dsp=dict(dsp)))
    for j, b in enumerate(lay["wide"]):
        handles[("w", j)] = cap.create_channel(ChannelSpec(
            id=f"w{j}", mode="wbfm", frequency_hz=D_CENTER + ch.channel_offset_hz(b),
            squelch_db=D_WIDE_SQUELCH_DB, dsp=dict(D_WIDE_DSP)))
    return handles


def mesh_launches(n: int) -> dict:
    """Program E's kernel launches a block on ``n`` shards: K1, K2 and K3
    (the grid's shift and RSSI of every bin) once a shard; every bank a
    shard as program D's banks (K5 5, K9 12, K10 1, K11a 4, K11b 1); K7 the
    wide decimator a shard; the wide group's demod once (K5, K9 2, K11a,
    K11b)."""
    per_shard = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 1, "K5_resample_poly": 5,
                 "K7_strided_fir": 1, "K9_iir_cascade": 12, "K10_pll": 1, "K11a_noise_blanker": 4,
                 "K11b_nr_frames": 1, "K11b_nr_gain": 1, "K11b_nr_overlap_add": 1}
    wide = {"K5_resample_poly": 1, "K9_iir_cascade": 2, "K11a_noise_blanker": 1, "K11b_nr_frames": 1,
            "K11b_nr_gain": 1, "K11b_nr_overlap_add": 1}
    return {k: n * v + wide.get(k, 0) for k, v in per_shard.items()}


def mesh_copies(n: int, scaled: bool, wide_groups: int, out_leaves: int, wide_leaves: int) -> dict:
    """K15's copies a block on ``n`` shards, by label."""
    return {"scatter": n * (2 if scaled else 1), "halo": n - 1, "reshard": n * n,
            "wide_if": n * wide_groups, "history": 1, "outputs": n * out_leaves + wide_leaves}


def audio_vs(ref: np.ndarray, got: np.ndarray, floor: float, what: str) -> float:
    """The worst SNR of ``got``'s rows against ``ref``'s where ``ref`` is
    open; silent where ``ref`` is."""
    worst = float("inf")
    for i in range(ref.shape[0]):
        if np.abs(ref[i]).max() == 0:
            check(not got[i].any(), f"{what}: row {i} open where the reference is silent")
            continue
        worst = min(worst, snr_db(ref[i], got[i]))
    check(worst >= floor, f"{what}: {worst:.1f} dB < {floor}")
    return worst


def slot_bank_program(pipe_cfg, cap, handles: dict, device):
    """Program D's slot-bank program on program E's channels: one slot a
    channel in its group's bank (bin, fine offset, squelch), the wide
    slots as the mesh's; ``(cfg, ctl, slot_of)``."""
    import dataclasses

    import torch

    from wavecap_tpu_torch.capture import pipeline as pl

    cfg = dataclasses.replace(pipe_cfg, audio_fetch_slots=0)
    ctl = pl.control_init(cfg, device=device)
    arrays = {g: {f: getattr(ctl.banks[g], f).clone() for f in ctl.banks[g]._fields} for g in cfg.narrow_modes}
    slot_of, used = {}, {g: 0 for g in cfg.narrow_modes}
    ch = cap._channelizer
    for key, h in handles.items():
        if key[0] == "w":
            continue
        g = h.mode_group
        slot = used[g]
        used[g] += 1
        off = h.spec.frequency_hz - D_CENTER
        arrays[g]["channel_index"][slot] = ch.channel_index(off)
        arrays[g]["fine_offset_hz"][slot] = off - ch.channel_offset_hz(ch.channel_index(off))
        arrays[g]["active"][slot] = True
        arrays[g]["squelch_db"][slot] = -1e9 if h.spec.squelch_db is None else h.spec.squelch_db
        slot_of[key] = slot
    banks = {g: pl.ChannelAssignment(**a) for g, a in arrays.items()}
    wide = {}
    for g in cfg.wide_groups:
        w = pl.wide_assignment_init(cfg.wide_capacity, device=device)
        off, act, sq = w.offset_hz.clone(), w.active.clone(), w.squelch_db.clone()
        for key, h in handles.items():
            if key[0] == "w" and h.mode_group[1] == g:
                off[h.slot] = h.spec.frequency_hz - D_CENTER
                act[h.slot] = True
                sq[h.slot] = h.spec.squelch_db
        wide[g] = pl.WideAssignment(off, act, sq)
    return cfg, ctl._replace(banks=banks, wide=wide or None, audio_sel=None), slot_of


def run_engine_mesh(device, fs: int = 10_000_000, c: int = 160, n_blocks: int = 3 * D_SEGMENT,
                    sync=None) -> dict:
    """Program E: the engine on the mesh.  ``CaptureManager`` ->
    ``create_capture(CaptureConfig(mesh="stream=1,time=8"))`` over program
    D's scene, 8 shards of the card (``WAVECAP_TORCH_DEVICE_COUNT=8``),
    ``create_channel`` for program D's stations in its five narrow groups
    (the grid runs five banks over all M bins) and two WBFM slots;
    ``warmup``, ``start``, ``n_blocks`` stepping i16 -> i8 -> i4.  Then the
    checks: the launches and K15's copies a block, the station lines,
    silent empty bins, the engine's words through a time=1 mesh against
    time=8 (>= 60 dB on every open bin), the stations against the
    slot-bank program on the same words (>= 50 dB), 0 host syncs, memory,
    latency."""
    import torch

    from wavecap_tpu_torch.capture import CaptureConfig, CaptureManager
    from wavecap_tpu_torch.capture import mesh as mesh_mod
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts
    from wavecap_tpu_torch.parallel import copy_counts, reset_copy_counts

    os.environ["WAVECAP_TORCH_DEVICE_COUNT"] = str(MESH_SHARDS)
    sync = sync or torch.cuda.synchronize
    lay = engine_layout(c)
    m = int(fs / 12_500) - int(fs / 12_500) % 2
    cfg = CaptureConfig(center_hz=D_CENTER, sample_rate=fs, channel_bandwidth=12_500.0, block_seconds=0.2,
                        narrow_capacity=c, wide_capacity=2, p25_capacity=0, audio_rate=48_000, fft_size=2048,
                        transport="i16", adaptive_transport=True, pipeline_depth=1, blocks_per_dispatch=1,
                        mesh=MESH_SPEC)
    mgr = CaptureManager(engine_scene(fs, m, lay), device=device)
    cap = mgr.create_capture(config=cfg)
    handles = mesh_channels(cap, lay)
    subs = {key: h.audio.subscribe(maxsize=4 * n_blocks) for key, h in handles.items()}
    iq_sub = cap.iq_subs.subscribe(maxsize=n_blocks + 4)
    t0 = time.perf_counter()
    w = cap.warmup()
    w.join(timeout=900)
    warm_s = time.perf_counter() - t0
    check(not w.is_alive() and cap.warmup_error is None, f"warmup failed: {cap.warmup_error}")
    real = cap._dispatch_blocks
    sent = [0]

    def dispatch(blocks):
        if sent[0] >= n_blocks:
            cap._stop.wait()
            return
        cap.transport_active = D_LADDER[sent[0] // D_SEGMENT]
        sent[0] += 1
        real(blocks)

    cap._dispatch_blocks = dispatch
    reset_launch_counts()
    reset_copy_counts()
    torch.cuda.reset_peak_memory_stats()
    states = set()
    t0 = time.perf_counter()
    cap.start()
    try:
        while cap.blocks_processed < n_blocks and time.perf_counter() - t0 < 600:
            if cap.state != "starting":
                states.add(cap.state)
            time.sleep(0.005)
        run_s = time.perf_counter() - t0
        states.add(cap.state)
        counts, copies = launch_counts(), copy_counts()
        peak_mem = torch.cuda.max_memory_allocated()
    finally:
        cap.stop()
    check(states == {"running"}, f"capture states {states}: error {cap.error}")
    check(cap.blocks_processed == n_blocks, f"{cap.blocks_processed} blocks processed, not {n_blocks}")
    per_block = mesh_launches(MESH_SHARDS)
    want = {k: n_blocks * per_block.get(k, 0) for k in counts}
    check(counts == want, f"launch counts {counts} != {want}")
    n_wide = len(cap._pipe_cfg.wide_groups)
    want_copies = {}
    for k in range(n_blocks):
        for label, v in mesh_copies(MESH_SHARDS, D_LADDER[k // D_SEGMENT] != "i16", n_wide, 2, 2 * n_wide).items():
            want_copies[label] = want_copies.get(label, 0) + v
    got_copies = {k: v["copies"] for k, v in copies.items()}
    check(got_copies == want_copies, f"K15 copies {got_copies} != {want_copies}")

    blocks = []
    while (b := iq_sub.get_nowait()) is not None:
        blocks.append(b)
    check(len(blocks) == n_blocks, f"{len(blocks)} IQ blocks published, not {n_blocks}")
    audio = {}
    for key, sub in subs.items():
        got = []
        while (a := sub.get_nowait()) is not None:
            got.append(a)
        audio[key] = got
        check(len(got) == n_blocks and all(np.isfinite(a).all() for a in got), f"channel {key}: audio")

    # the stations' lines per transport segment, the empty bins silent
    margins, line_min = {}, [float("inf")] * len(D_LADDER)
    for seg in range(len(D_LADDER)):
        blk = range(max(1, seg * D_SEGMENT), (seg + 1) * D_SEGMENT)
        for key in [(k, s) for k in (0, 2, 3, 4) for s in lay["tone"]] + [("w", 0)]:
            v = tone_margin_db(np.concatenate([audio[key][b] for b in blk]), 48_000.0)
            margins[f"{D_LADDER[seg]}:{key[0]}:{key[1]}"] = v
            line_min[seg] = min(line_min[seg], v)
            check(v >= 20.0, f"{D_LADDER[seg]}: station {key} 1 kHz line {v:.1f} dB < 20")
    for key in [(k, s) for k in (0, 2, 3, 4) for s in lay["empty"]] + [("w", 1)]:
        check(not any(a.any() for a in audio[key]), f"empty listened channel {key}: squelch opened")

    # the engine's own words through time=8 and time=1 meshes, and the
    # slot-bank program; the published audio against the time=8 output
    pipe_cfg, ctl8, mesh8 = cap._pipe_cfg, cap._ctl, cap._mesh
    entry = cap._mesh_entry(pipe_cfg)
    mesh1 = mesh_mod.build_mesh("stream=1,time=1", device)
    chans = [h for h in handles.values()]
    ctl1 = mesh_mod.mesh_control(pipe_cfg, chans, D_CENTER, mesh1, entry)
    step8 = mesh_mod.mesh_capture_multi(pipe_cfg, mesh8, entry)
    step1 = mesh_mod.mesh_capture_multi(pipe_cfg, mesh1, entry)
    st8, st1 = mesh_mod.mesh_init(pipe_cfg, entry, mesh8), mesh_mod.mesh_init(pipe_cfg, entry, mesh1)
    slot_cfg, slot_ctl, slot_of = slot_bank_program(pipe_cfg, cap, handles, device)
    st_s = pipeline_init(slot_cfg, device=device)
    worst_t1, worst_wide_t1, worst_slot, worst_wide_slot, lsb = (float("inf"),) * 4 + (0.0,)
    for k, block in enumerate(blocks):
        batch = _batch_on(device, *_words_for(D_LADDER[k // D_SEGMENT], block))
        o8, st8 = step8(batch, st8, ctl8)
        o1, st1 = step1(batch, st1, ctl1)
        os_, st_s = capture_multi(batch, st_s, slot_ctl, slot_cfg)
        a8, a1 = host(o8["banks"][entry]["audio"][0]), host(o1["banks"][entry]["audio"][0])
        worst_t1 = min(worst_t1, audio_vs(a8, a1, 60.0, f"block {k}: time=1 against time=8"))
        # the wide slots are no bins: the reference's shard NCO phases
        # (parallel/sharded.py:257-266, copied) turn each shard's IF by a
        # constant, which the discriminator sees at the seams; reported
        for g in pipe_cfg.wide_groups:
            worst_wide_t1 = min(worst_wide_t1, audio_vs(host(o8["wide"][g]["audio"][0]),
                                                        host(o1["wide"][g]["audio"][0]), 0.0,
                                                        f"block {k}: wide, time=1 against time=8"))
        for key, h in handles.items():
            if key[0] == "w":
                row8 = host(o8["wide"][h.mode_group[1]]["audio"][0, h.slot])
                row_s = host(os_["wide"][h.mode_group[1]]["audio"][0, h.slot])
            else:
                row8 = a8[h.slot]
                row_s = host(os_["banks"][h.mode_group]["audio"][0, slot_of[key]])
            lsb = max(lsb, float(np.max(np.abs(audio[key][k] - np.clip(row8, -1.0, 1.0)))))
            if np.abs(row_s).max() == 0:
                check(not row8.any(), f"channel {key} block {k}: the mesh is open where the slot banks are silent")
                continue
            v = snr_db(row_s, row8)
            if key[0] == "w":
                worst_wide_slot = min(worst_wide_slot, v)
            else:
                worst_slot = min(worst_slot, v)
    check(lsb <= 0.5 / 32767 + 1e-6, f"published audio off the mesh's output by {lsb:.3g} > half an LSB")
    check(worst_slot >= 50.0, f"mesh stations {worst_slot:.1f} dB < 50 against the slot-bank program")

    syncs = {}
    for transport in D_LADDER:
        batch = _batch_on(device, *_words_for(transport, blocks[0]))
        syncs[transport] = host_syncs(lambda: step8(batch, mesh_mod.mesh_init(pipe_cfg, entry, mesh8), ctl8))
    check(all(v[0] == 0 for v in syncs.values()), f"host syncs in the mesh step: {syncs}")
    lat = np.asarray(list(cap.block_latency_ms)[1:])
    perf = {k: v / cap.perf["dispatches"] for k, v in cap.perf.items() if k != "dispatches"}
    words16 = torch.from_numpy(np.concatenate([_words_for("i16", b)[0] for b in blocks[:D_SEGMENT]])).to(device)

    def one_pass():
        o, _ = step8(words16, mesh_mod.mesh_init(pipe_cfg, entry, mesh8), ctl8)
        fetch(o["_packed"])

    one_pass()
    sync()
    t0 = time.perf_counter()
    one_pass()
    sync()
    direct_ms = (time.perf_counter() - t0) * 1e3 / D_SEGMENT
    n_audio = host(o8["banks"][entry]["audio"]).shape[-1]
    k15 = k15_checks(device, m, cap._channelizer.taps_per_channel, cap.block_size,
                     cap.block_size // MESH_SHARDS // pipe_cfg.wide_cfg(pipe_cfg.wide_groups[0]).decim,
                     pipe_cfg.wide_capacity,
                     {k: {"copies": v["copies"] // n_blocks, "bytes": v["bytes"] // n_blocks}
                      for k, v in copies.items()})
    return dict(phase="engine on the mesh (program E)", mesh=MESH_SPEC, shards=MESH_SHARDS, blocks=n_blocks,
                block_size=cap.block_size, channels=m, bins_per_shard=m // MESH_SHARDS, banks=len(D_BANKS),
                listened_channels=len(handles), audio_samples_per_block=n_audio,
                transports=[D_LADDER[k // D_SEGMENT] for k in range(n_blocks)], launches=counts,
                launches_per_block=per_block, copies=copies, warmup_s=warm_s, run_s=run_s, states=sorted(states),
                warm_latency_ms_p50=float(np.percentile(lat, 50)), warm_latency_ms_p95=float(np.percentile(lat, 95)),
                latency_ms=[float(v) for v in cap.block_latency_ms], perf_ms_per_block=perf,
                host_syncs_per_block={k: v[0] for k, v in syncs.items()},
                peak_device_memory_bytes=int(peak_mem), direct_ms_per_block=direct_ms,
                profile=profile_blocks(one_pass, D_SEGMENT, sync), tone_margin_db=margins,
                line_min_db=dict(zip(D_LADDER, line_min)), time1_vs_time8_min_db=worst_t1,
                wide_time1_vs_time8_min_db=worst_wide_t1,
                slot_bank_min_db=worst_slot, wide_slot_bank_min_db=worst_wide_slot, wire_audio_max_abs=lsb,
                k15=k15)


F_BLOCK = 2_400_000  # 0.24 s: program A's 0.25 s does not split into M x 8 shards
F_LAUNCHES_PER_SHARD = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 1, "K5_resample_poly": 1,
                        "K7_strided_fir": 2, "K9_iir_cascade": 2, "K12_c4fm_timing": 1}


def run_program_f(cfgs, device, sync=None) -> dict:
    """Program F: program A's scene and geometry (10 Msps, 25 kHz bins,
    M = 400, 50 a shard) through ``capture/mesh.py``'s
    ``mesh_capture_multi`` at time=8: the ``nbfm`` base bank and the C4FM
    own-output bank (``p25-soft``) over every bin; the six C4FM stations'
    decisions from block 3 on, the NBFM lines, launches and copies."""
    import dataclasses

    import torch

    from wavecap_tpu_torch.capture import mesh as mesh_mod
    from wavecap_tpu_torch.capture.engine import pack_i16_words
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts
    from wavecap_tpu_torch.models.p25 import c4fm
    from wavecap_tpu_torch.parallel import copy_counts, reset_copy_counts
    from wavecap_tpu_torch.parallel.sharded import control_from_numpy

    os.environ["WAVECAP_TORCH_DEVICE_COUNT"] = str(MESH_SHARDS)
    sync = sync or torch.cuda.synchronize
    cfg = dataclasses.replace(cfgs["A"], block_size=F_BLOCK)
    rng = np.random.default_rng(SEED + 4)
    ch = cfg.channelizer()
    m = ch.channel_count
    p, c = cfg.p25_capacity, cfg.narrow_capacity
    bins = p25_bins(m, p + c, 3)
    p25_bins_, nbfm_bins = bins[:p], bins[p:]
    loops, stations = {}, []
    fine = np.zeros((1, m), np.float32)
    for slot, f in A_C4FM_STATIONS:
        d, iq = p25_loop(rng, "c4fm", cfg.sample_rate)
        loops[p25_bins_[slot]] = d
        fine[0, p25_bins_[slot]] = f
        stations.append(dict(offset_hz=ch.channel_offset_hz(p25_bins_[slot]) + f, kind="iq_loop", iq_loop=iq,
                             amplitude=P25_AMPLITUDE))
    for slot in A_NBFM_STATIONS:
        stations.append(dict(offset_hz=ch.channel_offset_hz(nbfm_bins[slot]), kind="nbfm", tone_hz=1000.0,
                             deviation_hz=4000.0, amplitude=P25_AMPLITUDE))
    stream = p25_scene(cfg, stations)
    words_np = pack_i16_words([stream.read(cfg.block_size)[0] for _ in range(N_BLOCKS)])
    mesh = mesh_mod.build_mesh(MESH_SPEC, device)
    gcfg = mesh_mod.mesh_grid_cfg(cfg, "nbfm")
    active = np.zeros((1, m), bool)
    active[0, bins] = True
    squelch = np.full((1, m), -1e9, np.float32)
    squelch[0, nbfm_bins] = P25_SQUELCH_DB
    ctl = control_from_numpy(gcfg, mesh, fine, active, squelch)
    step = mesh_mod.mesh_capture_multi(cfg, mesh, "nbfm")
    # the first run starts with no cached O&M table, so one shard's stream
    # builds it while the others launch K12 on theirs; each shard's K12
    # call is kept (inputs and outputs cloned on its stream) and checked
    # afterwards: run again on the same inputs, the table now complete, it
    # must give the same bits; against the plain version, soft >= 60 dB and
    # dibits equal but where the plain soft value lies within 1e-3 of a
    # decision threshold (the two sum in different f32 orders)
    k12_calls = []
    own_timing = c4fm.c4fm_timing

    def kept_timing(buf, st, n_sym, cfg_k):
        got = own_timing(buf, st, n_sym, cfg_k)
        k12_calls.append((buf.clone(), st.clone(), n_sym, cfg_k, tuple(v.clone() for v in got)))
        return got

    c4fm._om_table.cache_clear()
    c4fm.c4fm_timing = kept_timing
    reset_launch_counts()
    reset_copy_counts()
    t0 = time.perf_counter()
    words = torch.from_numpy(words_np).to(device)
    try:
        outs, _ = step(words, mesh_mod.mesh_init(cfg, "nbfm", mesh), ctl)
        host(outs["_packed"])
        sync()
    finally:
        c4fm.c4fm_timing = own_timing
    first_s = time.perf_counter() - t0
    counts, copies = launch_counts(), copy_counts()
    check(len(k12_calls) == N_BLOCKS * MESH_SHARDS, f"program F: {len(k12_calls)} K12 calls kept")
    cold = dict(calls=len(k12_calls), same_bits_warm=True, min_soft_snr_db=np.inf, symbols=0,
                dibits_differing=0, differing_max_margin=0.0, max_state_abs=0.0)
    for buf, st, n_sym_k, cfg_k, got in k12_calls:
        s_k, d_k, o_k = (host(v) for v in got)
        again = [host(v) for v in own_timing(buf, st, n_sym_k, cfg_k)]
        cold["same_bits_warm"] &= all(np.array_equal(u.view(np.uint8), v.view(np.uint8))
                                      for u, v in zip((s_k, d_k, o_k), again))
        s_p, d_p, o_p = (host(v) for v in c4fm.c4fm_timing_plain(buf, st, n_sym_k, cfg_k))
        cold["min_soft_snr_db"] = min(cold["min_soft_snr_db"], snr_db(s_p, s_k))
        cold["max_state_abs"] = max(cold["max_state_abs"], float(np.max(np.abs(o_k - o_p))))
        cold["symbols"] += d_k.size
        diff = d_k != d_p
        if diff.any():  # how far the plain soft value lies from the threshold (0 or +-2) it crossed
            margin = np.min(np.abs(np.abs(s_p[diff])[:, None] - np.array([0.0, 2.0], np.float32)), axis=1)
            cold["dibits_differing"] += int(diff.sum())
            cold["differing_max_margin"] = max(cold["differing_max_margin"], float(margin.max()))
    del k12_calls
    check(cold["same_bits_warm"], "program F: K12 with a cold O&M table differs from K12 run again warm")
    check(cold["min_soft_snr_db"] >= 60.0,
          f"program F, cold O&M table: K12's soft SNR {cold['min_soft_snr_db']:.1f} dB < 60")
    check(cold["differing_max_margin"] <= 1e-3,
          f"program F, cold O&M table: a dibit differs from the plain version "
          f"{cold['differing_max_margin']:.3g} from a decision threshold")
    want = {k: N_BLOCKS * MESH_SHARDS * F_LAUNCHES_PER_SHARD.get(k, 0) for k in counts}
    check(counts == want, f"program F launch counts {counts} != {want}")
    want_copies = {k: N_BLOCKS * v for k, v in mesh_copies(MESH_SHARDS, False, 0, 3, 0).items() if v}
    check({k: v["copies"] for k, v in copies.items()} == want_copies, f"program F copies {copies}")
    soft = host(outs["p25"]["soft"])
    check(np.isfinite(soft).all(), "program F soft not finite")
    n_sym = soft.shape[-1]
    check(n_sym == round(2 * F_BLOCK / m / (ch.channel_rate / 4800.0)), "soft symbols per block")
    agree = {b: min(agreement(soft[k, b], d) for k in range(P25_FIRST, N_BLOCKS)) for b, d in loops.items()}
    for b, a in agree.items():
        check(a >= 0.995, f"program F: C4FM station on bin {b}: {a:.4f} of decisions right < 0.995")
    audio = host(outs["banks"]["nbfm"]["audio"])
    margins = {s: tone_margin_db(audio[P25_FIRST:, nbfm_bins[s]].ravel(), cfg.audio_rate) for s in A_NBFM_STATIONS}
    for s, v in margins.items():
        check(v >= 20.0, f"program F: NBFM station on bin {nbfm_bins[s]}: 1 kHz line only {v:.1f} dB up")
    empty_nbfm = [nbfm_bins[i] for i in range(c) if i not in A_NBFM_STATIONS]
    check(not audio[:, empty_nbfm].any(), "program F: an empty nbfm bin's squelch opened")

    def one_pass():
        o, _ = step(words, mesh_mod.mesh_init(cfg, "nbfm", mesh), ctl)
        fetch(o["_packed"])

    one_pass()
    sync()
    t0 = time.perf_counter()
    one_pass()
    sync()
    ms_block = (time.perf_counter() - t0) * 1e3 / N_BLOCKS
    return dict(phase="P25 on the mesh (program F)", mesh=MESH_SPEC, blocks=N_BLOCKS, block_size=F_BLOCK,
                channels=m, bins_per_shard=m // MESH_SHARDS, symbols_per_block=n_sym, launches=counts,
                copies=copies, first_run_s=first_s, warm_ms_per_block=ms_block,
                msps=F_BLOCK / ms_block / 1e3, profile=profile_blocks(one_pass, N_BLOCKS, sync),
                decisions_right={str(k): v for k, v in agree.items()}, cold_k12_vs_plain=cold,
                nbfm_tone_margin_db={str(nbfm_bins[k]): v for k, v in margins.items()})


# --- phase 11: the decoders on the engine's P25 banks (program G) -----------------------

G_CENTER = 851_000_000.0
G_AMPLITUDE = 0.02  # 42 stations a block: their sum stays inside the i16 range
G1_BLOCKS = 12
G2_BLOCKS = 16
G_PLAIN_BLOCKS = 3  # the first blocks, also through the plain path
G1_FS = 10_000_000
G1_CAPACITY = 50
G1_CONTROL = 40
G1_EMPTY = 8
G2_FS = 2_400_000
G2_P25_CAPACITY = 21
G2_P2_CAPACITY = 20
G_FINE = (0.0, 2000.0, -720.0, 320.0, 1200.0)  # a control station's fine offset by slot % 5 (Hz)
G2_LSM = ((0.0, 0.0, False), (0.0, 600.0, False), (0.0, 0.0, True), (-1500.0, 0.0, False),
          (800.0, 0.0, False), (0.0, 0.0, False))  # (fine offset Hz, carrier offset Hz, echo)
G2_P2 = (0.0, 1000.0, 0.0, -600.0)  # the Phase 2 stations' fine offsets (Hz)
G2_EMPTY = 2  # empty channels in each G2 bank
G_P2_FRAGMENTS = 8  # a Phase 2 loop: MAC_PTT in the first fragment, MAC_END_PTT in the last
# kernel launches per block: G1's C4FM bank alone (no analog bank), G2's
# LSM bank with the equaliser (program B's) and the Phase 2 bank (C's)
G1_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 1, "K7_strided_fir": 2,
               "K12_c4fm_timing": 1}
G2_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 2, "K7_strided_fir": 4,
               "K13_cfo_power": 2, "K13_cfo_lines": 2, "K13_cqpsk_timing": 2, "K14_echo_fit": 2}


def g_key(d: dict) -> str:
    return json.dumps(d, sort_keys=True, default=str)


def g_tsdu_loop(nac: int, site: int, n_tsdus: int = 3):
    """A control channel's TSDUs (IDEN_UP, GRP_V_CH_GRANT, RFSS_STS_BCAST:
    ``harness.py``'s loop, the station's own NAC, talkgroup and site) and the
    messages a CRC-valid TSBK of it may parse to."""
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk

    blocks = [
        pf.encode_tsbk_block(tsbk.TSBKOpcode.IDEN_UP, tsbk.make_iden_up_data(
            identifier=1, base_freq_mhz=851.0, channel_spacing_khz=12.5, tx_offset_mhz=-45.0), last=False),
        pf.encode_tsbk_block(tsbk.TSBKOpcode.GRP_V_CH_GRANT, tsbk.make_group_grant_data(
            tgid=2000 + site, source_id=700_000 + site, band=1, channel_number=56 + site % 64), last=False),
        pf.encode_tsbk_block(tsbk.TSBKOpcode.RFSS_STS_BCAST, tsbk.make_rfss_status_data(
            system_id=0x123, rfss_id=1, site_id=site, band=1, channel_number=16), last=True),
    ]
    frame = pf.build_tsdu_frame(nac, blocks)
    sent = set()
    for b in pf.decode_tsdu(frame).tsbk_blocks:
        sent.add(g_key({"nac": nac, **tsbk.parse_tsbk(b.opcode, b.mfid, b.data)}))
    return np.concatenate([frame] * n_tsdus), sent


def g_voice_loop(nac: int):
    """A voice call: HDU, then LDU1 / LDU2 pairs whose 9 IMBE codewords each
    come from the IMBE encoder on a harmonic tone (120 Hz and its
    harmonics).  Returns the dibits, the LDUs' codewords (by bytes), the
    LDUs per loop and an LDU's length."""
    from wavecap_tpu_torch.decoders import imbe_vocoder as iv
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_voice as pv
    from wavecap_tpu_torch.decoders.voice import imbe_fec_encode

    n_ldu = 8
    t = np.arange(int(n_ldu * 9 * 0.02 * 8000) + 320) / 8000.0
    tone = sum(np.exp(-(((h * 120.0 - 600.0) / 500.0) ** 2)) * np.cos(2 * np.pi * h * 120.0 * t + h)
               for h in range(1, 25))
    us = iv.ImbeEncoder().encode(0.3 * tone / np.max(np.abs(tone)))
    cws = [imbe_fec_encode(u) for u in us[: n_ldu * 9]]
    lc = pv.encode_lc_hexbits(pv.make_group_lc_bits(tgid=3001, source_id=4242))
    head = np.concatenate([pf.FRAME_SYNC_DIBITS, pf.encode_nid(nac, pf.DUID.HDU)])
    hdu = np.concatenate([pf.insert_status_dibits(head, 0), pf.insert_status_dibits(
        pf.bits_to_dibits(pv.encode_hdu_payload(tgid=3001, algid=0x80, kid=0)), 57)])
    pieces, sent = [np.pad(hdu, (0, 396 - len(hdu)))], set()
    for k in range(n_ldu):
        group = cws[9 * k: 9 * k + 9]
        pieces.append(pf.build_ldu_frame(nac, pf.DUID.LDU1 if k % 2 == 0 else pf.DUID.LDU2, lc,
                                         imbe_codewords=group))
        sent.add(np.concatenate(group).astype(np.uint8).tobytes())
    return np.concatenate(pieces), sent, n_ldu, len(pieces[1])


def g_dmr_loop(color_code: int = 7):
    """DMR CSBK data bursts back to back: six grants, aloha and preamble;
    the CSBK fields of each as sent."""
    from wavecap_tpu_torch.decoders import dmr

    csbks = [dmr.make_csbk_bits(0x30 + (k % 2), channel=100 + k, slot=k % 2, dst_id=2000 + k, src_id=700_000 + k)
             for k in range(4)]
    csbks += [dmr.make_csbk_bits(0x19, net=0x1234, site=7, ms_id=42),
              dmr.make_csbk_bits(0x3D, data_follows=True, blocks_to_follow=4, dst_id=9, src_id=8)]
    bursts = [dmr.build_data_burst(b, dmr.DataType.CSBK, color_code=color_code) for b in csbks]
    sent = {g_key({"colorCode": color_code, **dmr.parse_csbk(b)}) for b in csbks}
    return np.concatenate(bursts), sent


def g_p2_loop(tgids: tuple):
    """A Phase 2 superframe loop: the first fragment opens a call in each
    timeslot (FACCH MAC_PTT), the last ends it (MAC_END_PTT), the others
    carry AMBE+2 voice bursts of a harmonic tone.  Returns the dibits, the
    parsed MAC PDUs as sent and the fragments as sent (by bytes)."""
    from wavecap_tpu_torch.decoders import p25_mac as mac
    from wavecap_tpu_torch.decoders import p25_phase2 as p2
    from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeEncoder

    n_frags = G_P2_FRAGMENTS
    t = np.arange(int(n_frags * 4 * 4 * 0.02 * 8000) + 320) / 8000.0
    x = sum(a * np.sin(2 * np.pi * 150.0 * k * t) for k, a in ((1, 1.0), (2, 0.6), (3, 0.45)))
    frames = AmbeEncoder().encode((0.3 * x / np.max(np.abs(x))).astype(np.float32))
    pdus = [[mac.make_mac_ptt(tgid=g, source=90_000 + g, algid=0x80) for g in tgids],
            [mac.make_mac_end_ptt(tgid=g, source=90_000 + g) for g in tgids]]
    frags, sent, f = [], set(), 0
    for k in range(n_frags):
        frag = np.zeros(p2.FRAGMENT_DIBITS, np.uint8)
        for pos in range(4):
            if pos < 2 and k in (0, n_frags - 1):
                burst = mac.encode_timeslot_burst(mac.BURST_FACCH, pdus[k != 0][pos])
                sent.add(g_key(mac.parse_mac_pdu(mac.decode_burst(burst)[1])))
            else:
                burst = p2.build_voice_burst(frames[f % len(frames): f % len(frames) + 4], with_sync=pos >= 2)
                f += 4
            frag[180 * pos: 180 * (pos + 1)] = burst
        frags.append(p2.build_test_fragment(frag))
    return np.concatenate(frags), sent, {x.astype(np.uint8).tobytes() for x in frags}


def fsk4_cyclic(dibits: np.ndarray, deviation_hz: float) -> np.ndarray:
    """``modulate_c4fm_cyclic`` at another deviation (DMR's 1,944 Hz)."""
    from wavecap_tpu_torch.models.p25.c4fm import DIBIT_SYMBOLS, design_rrc

    n = len(dibits) * 10
    impulses = np.zeros(n)
    impulses[::10] = DIBIT_SYMBOLS[np.asarray(dibits, np.uint8)] * 10
    h = design_rrc(48_000.0).astype(np.float64)
    h_pad = np.roll(np.pad(h, (0, n - len(h))), -(len(h) // 2))
    freq = np.fft.irfft(np.fft.rfft(impulses) * np.fft.rfft(h_pad), n) * (deviation_hz / 3.0)
    cycles = np.sum(freq) / 48_000.0
    phase = 2 * np.pi * np.cumsum(freq - (cycles - round(cycles)) * 48_000.0 / n) / 48_000.0
    return np.exp(1j * phase).astype(np.complex64)


def g_station(iq48: np.ndarray, fs: int, offset: float, amplitude: float, echo=None) -> dict:
    """A looped station at ``fs``: circular FFT resampling from 48 kHz, the
    echo applied circularly, and the mixer folded into the loop where the
    offset makes a whole number of cycles over it (else the receiver mixes)."""
    from scipy import signal as sps

    n_out = len(iq48) * fs // 48_000
    check(n_out * 48_000 == len(iq48) * fs, "a loop does not resample to a whole length")
    x = sps.resample(iq48.astype(np.complex128), n_out)
    if echo is not None:
        delay, a, theta = echo
        x = x + a * np.exp(1j * theta) * np.roll(x, delay)
    cycles = offset * n_out / fs
    if abs(cycles - round(cycles)) < 1e-9:
        x = x * np.exp(2j * np.pi * round(cycles) * np.arange(n_out) / n_out)
        offset = 0.0
    return dict(offset_hz=offset, kind="iq_loop", iq_loop=x.astype(np.complex64), amplitude=amplitude)


class GLog:
    """What one channel's consumer put out, by block: ``(block, kind,
    key)`` events (a key of ``None``: decoded but not valid), the PCM it
    published and the symbols it was fed."""

    def __init__(self):
        self.events: list = []
        self.pcm: list = []
        self.symbols = 0

    def keys(self, kind: str, first: int = 0) -> list:
        return [key for k, kd, key in self.events if kd == kind and k >= first]

    def valid(self) -> list:
        """The valid messages, in order (TSBKs, LDU codewords, CSBKs, MAC PDUs)."""
        return [(kd, key) for _, kd, key in self.events if key is not None and kd != "fragment"]


def attachments_wait(atts: dict, k: int, what: str, timeout: float = 60.0) -> float:
    """Until every attachment has taken ``k`` batches; fails on a timeout,
    a dropped batch or a decoder that raised (``errors``: the attachment's
    thread logs the exception and goes on).  Returns the wait (ms)."""
    t0 = time.perf_counter()
    while any(a.batches < k for a in atts.values()):
        check(time.perf_counter() - t0 < timeout, f"{what}: an attachment did not take batch {k} within "
              f"{timeout} s: {[(c, a.batches) for c, a in atts.items() if a.batches < k][:4]}")
        time.sleep(0.001)
    for cid, a in atts.items():
        check(a.errors == 0, f"{what}: attachment {cid} raised in {a.errors} batches")
        check(a._sub.dropped == 0, f"{what}: attachment {cid} dropped {a._sub.dropped} batches")
        check(a.batches == k, f"{what}: attachment {cid} took {a.batches} batches after block {k}")
    return (time.perf_counter() - t0) * 1e3


def g_attach(mode: str, channel):
    """The port's ``P25Attachment`` (``p25``) or ``DmrAttachment`` (``dmr``)
    on a channel, with a tally of what it has noted so far; the P25 voice
    decoder's LDUs are noted on their way in (their codewords, by bytes)."""
    from wavecap_tpu_torch.capture.attachments import DmrAttachment, P25Attachment

    att = DmrAttachment(channel) if mode == "dmr" else P25Attachment(channel)
    att.noted = dict(messages=0, ldus=0, frames={}, bursts=0)
    att.ldus = []
    if mode != "dmr":
        decode = att.voice.decode_codewords

        def noted(codewords):
            att.ldus.append(np.concatenate(codewords).astype(np.uint8).tobytes())
            return decode(codewords)

        att.voice.decode_codewords = noted
    return att


def g_note(att, log: GLog, k: int) -> None:
    """The attachment's output since the last note, as block ``k``'s events:
    each TSBK it put out (CRC-valid; keyed as sent), and one invalid one
    for each of the 3 TSBKs of a TSDU frame its framer found that did not
    come out; each LDU frame (its codewords, or invalid where
    ``decode_ldu`` refused it); each DMR burst (a CSBK's fields, or
    invalid)."""
    from wavecap_tpu_torch.decoders import dmr

    n = att.noted
    msgs = list(att.messages)[n["messages"]:]
    check(len(att.messages) < att.messages.maxlen, f"{att.channel.id}: the message ring filled")
    n["messages"] += len(msgs)
    if att.kind == "dmr":
        for m in msgs:
            fields = ("colorCode",) + tuple(dmr.parse_csbk(dmr.make_csbk_bits(m["opcode"])) or ()) \
                if "opcode" in m else ()
            log.events.append((k, "csbk", g_key({f: m[f] for f in fields if f in m}) if fields else None))
        bursts = att.decoder.bursts_found - n["bursts"]
        n["bursts"] = att.decoder.bursts_found
        log.events += [(k, "csbk", None)] * (bursts - len(msgs))
        return
    frames = {d: c - n["frames"].get(d, 0) for d, c in att.frame_counts.items()}
    n["frames"] = dict(att.frame_counts)
    log.events += [(k, "tsbk", g_key({f: v for f, v in m.items() if f != "time"})) for m in msgs]
    log.events += [(k, "tsbk", None)] * max(0, 3 * frames.get("TSDU", 0) - len(msgs))
    ldus = att.ldus[n["ldus"]:]
    n["ldus"] += len(ldus)
    log.events += [(k, "ldu", x) for x in ldus]
    log.events += [(k, "ldu", None)] * (frames.get("LDU1", 0) + frames.get("LDU2", 0) - len(ldus))


class GP2Recorders:
    """A ``p25p2`` channel's calls through the trunking recorder's Phase 2
    path (``trunking/recorder.py``, ``VoiceRecorder._process_phase2``): one
    recorder a timeslot, each mid-call on its slot, both fed the channel's
    symbols.  Taps log the superframe fragments the slot-0 recorder's
    detector finds, the MAC PDUs each recorder handles (both slots': the
    loop's PTT and END_PTT) and the PCM each synthesizes, as ``GLog``
    events by block; the recorders themselves run unchanged."""

    def __init__(self):
        from wavecap_tpu_torch.decoders.p25_phase2 import P25P2SuperFrameDetector
        from wavecap_tpu_torch.trunking.recorder import CallInfo, VoiceRecorder

        self.log, self.k, self.recs = GLog(), 0, []
        for slot in (0, 1):
            rec = VoiceRecorder(slot, f"p2-slot{slot}", protocol="p25_phase2")
            rec.assign(CallInfo(tgid=0, source_id=0, frequency_hz=0.0, start_time=0.0, tdma_slot=slot))
            det = rec._p2 = P25P2SuperFrameDetector()
            process, handle = det.process, rec._handle_mac

            def tapped(soft, process=process, slot=slot):
                frags = list(process(soft))
                if slot == 0:
                    self.log.events += [(self.k, "fragment", f.dibits.astype(np.uint8).tobytes()) for f in frags]
                return frags

            def mac(pdu, handle=handle):
                self.log.events.append((self.k, "mac", g_key(pdu)))
                return handle(pdu)

            det.process, rec._handle_mac = tapped, mac
            self.recs.append(rec)

    def feed(self, k: int, soft) -> None:
        soft = np.asarray(soft, np.float32)
        self.k = k
        self.log.symbols += len(soft)
        for rec in self.recs:
            n = len(rec._pcm)
            rec.process_symbols(soft, now=float(k))
            self.log.pcm += [p for p in rec._pcm[n:] if len(p)]


def g_stand_in(cid: str):
    """A channel for an attachment fed by hand (``process``): its fan-outs only."""
    from types import SimpleNamespace

    from wavecap_tpu_torch.utils.broadcast import FanOut

    return SimpleNamespace(id=cid, audio=FanOut(maxsize=4096), symbols=FanOut(maxsize=4), baseband=FanOut(maxsize=4))


def g_decode_by_hand(mode: str, softs: list) -> list:
    """A fresh consumer of ``mode`` fed ``softs`` block by block on this
    thread: the attachment's ``process`` (``GP2Recorders`` for ``p25p2``);
    returns its valid messages and PCM."""
    if mode == "p25p2":
        c = GP2Recorders()
        for k, s in enumerate(softs):
            c.feed(k, s)
        return c.log.valid() + [("pcm", x.tobytes()) for x in c.log.pcm]
    ch = g_stand_in(f"by-hand-{mode}")
    att, log = g_attach(mode, ch), GLog()
    pcm = ch.audio.subscribe(maxsize=4096)
    try:
        for k, s in enumerate(softs):
            for m in att.process({"soft": s}):
                att.messages.append(m)
            g_note(att, log, k)
    finally:
        att.stop()
    pcm_bytes = []
    while (x := pcm.get_nowait()) is not None:
        pcm_bytes.append(("pcm", np.asarray(x).tobytes()))
    return log.valid() + pcm_bytes


def g_sent_bounds(counted: int, spacing: int, per_frame: int = 1) -> tuple:
    """The fewest and the most messages that frames ``spacing`` symbols
    apart, ``per_frame`` messages each, can complete in ``counted`` symbols:
    one frame fewer than fit, two more (the window's two edges and the
    framer's look-ahead)."""
    return per_frame * (counted // spacing - 1), per_frame * (counted // spacing + 2)


def g_rate(keys: list, sent: set, floor: float, bounds: tuple, what: str) -> dict:
    """The share of ``keys`` that are CRC-valid, each one that was sent, and
    the valid count between the fewest and the most sent in the counted
    blocks (a stretch of symbols published twice exceeds the most)."""
    sent_lower, sent_upper = bounds
    ok = [x for x in keys if x is not None]
    check(all(x in sent for x in ok), f"{what}: a CRC-valid message was not sent: "
          f"{[x for x in ok if x not in sent][:2]}")
    check(len(ok) <= sent_upper, f"{what}: {len(ok)} valid, more than the {sent_upper} sent")
    rate = len(ok) / max(len(keys), sent_lower, 1)
    check(rate >= floor, f"{what}: {len(ok)} of {max(len(keys), sent_lower)} valid ({rate:.4f} < {floor})")
    return dict(valid=len(ok), decoded=len(keys), sent_lower=sent_lower, sent_upper=sent_upper, rate=rate)


def g_scene(device, cfg, stations: list, n_blocks: int):
    """``CaptureManager`` -> ``create_capture`` over a fake receiver with the
    stations, and ``n_blocks`` of its IQ at the capture's block size."""
    from wavecap_tpu_torch.capture import CaptureManager
    from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation

    # loops already mixed to their offsets and of one length sum into one
    # loop: the receiver then gathers it once a block, not once a station
    merged, rest = {}, []
    for st in stations:
        if st["offset_hz"] == 0.0:
            x = st["amplitude"] * st["iq_loop"]
            n = len(x)
            merged[n] = x if n not in merged else merged[n] + x
        else:
            rest.append(st)
    rest += [dict(offset_hz=0.0, kind="iq_loop", iq_loop=x.astype(np.complex64), amplitude=1.0)
             for x in merged.values()]
    driver = FakeDriver(1, [FakeStation(**s) for s in rest])
    cap = CaptureManager(driver, device=device).create_capture(config=cfg)
    dev = driver.open("fake0")
    dev.configure(DeviceConfig(center_hz=cfg.center_hz, sample_rate=cfg.sample_rate))
    stream = dev.start_stream()
    return cap, [stream.read(cap.block_size)[0] for _ in range(n_blocks)]


def rss_mb() -> float | None:
    try:
        with open("/proc/self/status") as f:
            return next(int(x.split()[1]) / 1024.0 for x in f if x.startswith("VmRSS:"))
    except (OSError, StopIteration):
        return None


def process_state() -> dict:
    """What the host decode time depends on besides the decoders: the
    garbage collector's tracked objects and thresholds, the threads, the
    resident memory, the host's load and processor."""
    import gc
    import threading

    import torch

    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((x.split(":", 1)[1].strip() for x in f if x.startswith("model name")), None)
    except OSError:
        cpu = None
    return dict(gc_tracked_objects=len(gc.get_objects()), gc_count=list(gc.get_count()),
                gc_threshold=list(gc.get_threshold()), python_threads=threading.active_count(),
                torch_threads=torch.get_num_threads(), rss_mb=rss_mb(), load_avg=list(os.getloadavg()),
                cpus=os.cpu_count(), cpu=cpu)


def g_calibration_ms() -> float:
    """The host's speed at the decoders' work, to set decode times taken on
    different machines side by side: a fresh ``P25Attachment``'s
    ``process`` of 12 clean TSDUs (4,320 symbols), ms, the best of 5."""
    from wavecap_tpu_torch.models.p25.c4fm import DIBIT_SYMBOLS

    soft = np.tile(DIBIT_SYMBOLS[g_tsdu_loop(0x100, site=1)[0]], 4).astype(np.float32)
    best = float("inf")
    for _ in range(5):
        att = g_attach("p25", g_stand_in("calibration"))
        try:
            t0 = time.perf_counter()
            out = att.process({"soft": soft})
            best = min(best, (time.perf_counter() - t0) * 1e3)
        finally:
            att.stop()
    check(len(out) >= 33, f"the calibration decoded {len(out)} of 36 TSBKs")
    return best


def run_g_engine(cap, specs: list, blocks: list, launches: dict, transport: str):
    """The scene's blocks through the engine, one ``_dispatch_blocks`` a
    block (no reader or fetch thread: the batch drains inline).  Each
    ``p25`` / ``dmr`` channel has the port's attachment on its own thread
    and ``channel.symbols`` subscription; after each block every attachment
    is waited for until it has taken the block's batch (a dropped batch or
    a decoder that raised fails), and the ``p25p2`` channels' symbols go
    through ``GP2Recorders`` on this thread.  Returns each channel's ``GLog``,
    the counts, the decode time a block (wall from the dispatch's end to
    the last consumer's end, the process's CPU and the garbage collector's
    pauses), the first blocks' published symbols and the card's f32 soft
    symbols of those blocks before the wire packs them.  Earlier garbage is
    collected before the first block, so that the decoders' time does not
    carry it."""
    import gc

    from wavecap_tpu_torch.capture import ChannelSpec
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    taps, atts, p2, logs, pcm = {}, {}, {}, {}, {}
    for cid, mode, freq in specs:
        h = cap.create_channel(ChannelSpec(id=cid, mode=mode, frequency_hz=freq))
        taps[cid] = (h, h.symbols.subscribe(maxsize=4))
        if mode == "p25p2":
            p2[cid] = GP2Recorders()
            logs[cid] = p2[cid].log
        else:
            atts[cid], logs[cid] = g_attach(mode, h), GLog()
            pcm[cid] = h.audio.subscribe(maxsize=4096)
    step, card = cap._step, []

    def keep_soft(batch, state, ctl):  # the engine's own outputs, before the wire
        out, state = step(batch, state, ctl)
        card.append({g: out[g]["soft"].clone() for g in ("p25", "p25p2") if g in out})
        return out, state

    gc_ms, gc_n, t_gc = [0.0], [0, 0, 0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t_gc[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - t_gc[0]) * 1e3
            gc_n[info["generation"]] += 1

    t_c = time.perf_counter()
    freed = gc.collect()
    state0 = dict(process_state(), collected=freed, collect_ms=(time.perf_counter() - t_c) * 1e3,
                  calibration_ms=g_calibration_ms())
    reset_launch_counts()
    timing, first = [], {cid: [] for cid in taps}
    gc.callbacks.append(on_gc)
    try:
        for k, block in enumerate(blocks):
            cap._step = keep_soft if k < G_PLAIN_BLOCKS else step
            cap.transport_active = transport
            cap._dispatch_blocks([block])
            t0, c0, g0, n0 = time.perf_counter(), time.process_time(), gc_ms[0], sum(gc_n)
            for cid, (h, sub) in taps.items():
                got = sub.get_nowait()
                check(got is not None and sub.get_nowait() is None,
                      f"channel {cid}: not one symbol batch in block {k}")
                if k < G_PLAIN_BLOCKS:
                    first[cid].append(np.asarray(got["soft"], np.float32))
                if cid in p2:
                    p2[cid].feed(k, got["soft"])
                else:
                    logs[cid].symbols += len(got["soft"])
            attachments_wait(atts, k + 1, "program G")
            for cid, att in atts.items():
                g_note(att, logs[cid], k)
                while (x := pcm[cid].get_nowait()) is not None:
                    logs[cid].pcm.append(np.asarray(x, np.float32))
            timing.append(((time.perf_counter() - t0) * 1e3, (time.process_time() - c0) * 1e3,
                           gc_ms[0] - g0, sum(gc_n) - n0))
    finally:
        gc.callbacks.remove(on_gc)
        cap._step = step
        for att in atts.values():
            att.stop()
    counts = launch_counts()
    check(cap.blocks_processed == len(blocks) and cap.state != "failed", f"engine state {cap.state}: {cap.error}")
    for cid, (h, sub) in taps.items():
        check(sub.dropped == 0, f"channel {cid}: the symbol fan-out dropped {sub.dropped} batches")
        check(h.mode_group in ("p25", "p25p2"), f"channel {cid} in group {h.mode_group}")
    want = {name: len(blocks) * launches.get(name, 0) for name in counts}
    check(counts == want, f"launch counts {counts} != {want}")
    card = [{g: host(x)[0] for g, x in c.items()} for c in card]
    host_state = dict(before=state0, after=process_state(), gc_collections=gc_n, gc_ms=gc_ms[0])
    return logs, atts, counts, timing, host_state, first, card


def g_first_blocks_vs_plain(device, cap, blocks, first: dict, card: list, specs: list, stations: set,
                            transport: str) -> dict:
    """The first blocks through the plain path on the card from the engine's
    program, control and words: the stations' f32 soft symbols, the card's
    as the engine computed them, >= 50 dB against the plain path's (as
    ``first_blocks_vs_plain`` holds programs A-D; the empty channels' are
    reported); the wire's symbols, the card's as the engine published them,
    also compared (their 1/16 steps counted); and each channel's card and
    plain wire symbols through fresh consumers (``g_decode_by_hand``): the
    same valid messages and PCM."""
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init, unpack_wire
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    pipe_cfg, ctl = cap._pipe_cfg, cap._ctl
    st = pipeline_init(pipe_cfg, device=device)
    reset_launch_counts()
    plain, plain_f32 = {cid: [] for cid, _, _ in specs}, {cid: [] for cid, _, _ in specs}
    slots = {cid: (h.mode_group, h.slot) for cid, h in cap.channels.items()}
    for k in range(G_PLAIN_BLOCKS):
        with plain_kernels():
            out, st = capture_multi(_batch_on(device, *_words_for(transport, blocks[k])), st, ctl, pipe_cfg)
        packed = out.pop("_packed")
        soft = {g: host(out[g]["soft"])[0] for g in card[k]}
        wire = unpack_wire(out, host(packed).reshape(1, -1))
        for cid, (group, slot) in slots.items():
            plain[cid].append(wire[group]["soft"][0][slot])
            plain_f32[cid].append(soft[group][slot])
    launched = {name: v for name, v in launch_counts().items() if v}
    check(not launched, f"the plain path launched kernels: {launched}")
    same, messages = 0, 0
    f32 = {"stations": [], "empty": []}  # (dB, channel, block)
    wire_snr = {"stations": float("inf"), "empty": float("inf")}
    steps = {"stations": 0, "empty": 0, "symbols": 0, "most": 0.0}
    for cid, mode, _ in specs:
        who = "stations" if cid in stations else "empty"
        group, slot = slots[cid]
        a = g_decode_by_hand(mode, first[cid][:G_PLAIN_BLOCKS])
        b = g_decode_by_hand(mode, plain[cid][:G_PLAIN_BLOCKS])
        for k in range(G_PLAIN_BLOCKS):
            f32[who].append((snr_db(plain_f32[cid][k], card[k][group][slot]), cid, k))
            wire_snr[who] = min(wire_snr[who], snr_db(plain[cid][k], first[cid][k]))
            diff = np.abs(np.asarray(plain[cid][k], np.float64) - np.asarray(first[cid][k], np.float64))
            steps[who] += int(np.count_nonzero(diff))
            steps["symbols"] += diff.size
            steps["most"] = max(steps["most"], float(diff.max(initial=0.0)) * 16)
        check(a == b, f"channel {cid}: the card's first blocks give {len(a)} messages and PCM blocks, "
              f"the plain path's {len(b)}, not the same")
        same += 1
        messages += len(a)
    worst = min(f32["stations"])
    check(worst[0] >= 50.0, f"first blocks' f32 soft SNR {worst[0]:.1f} dB < 50 against the plain path "
          f"(channel {worst[1]}, block {worst[2]})")
    f32_report = dict(stations_min=worst[0], stations_min_at=worst[1:],
                      stations_median=float(np.median([x[0] for x in f32["stations"]])),
                      stations_min_by_block=[min(x[0] for x in f32["stations"] if x[2] == k)
                                             for k in range(G_PLAIN_BLOCKS)],
                      empty_min=min(f32["empty"])[0] if f32["empty"] else None)
    return dict(first_blocks=G_PLAIN_BLOCKS, channels_same=same, messages_same=messages,
                first_blocks_f32_soft_snr_db=f32_report, first_blocks_wire_soft_snr_db_min=wire_snr,
                first_blocks_wire_symbols_differing=steps)


def g_report(cap, timing: list, host_state: dict, counts: dict, n_blocks: int) -> dict:
    """The engine's stages and the decode a block: wall from the dispatch's
    end until the last consumer has taken the block (the attachments'
    threads poll their queues every 50 ms), the process's CPU in that
    span, the garbage collector's pauses."""
    block_ms = cap.block_size / cap.config.sample_rate * 1e3
    perf = {k: v / cap.perf["dispatches"] for k, v in cap.perf.items() if k != "dispatches"}
    wall, cpu, gcp, gcn = (np.asarray(x, np.float64) for x in zip(*timing))
    return dict(block_size=cap.block_size, block_ms=block_ms, launches=counts,
                decode_ms_per_block=dict(mean=float(np.mean(wall)), max=float(np.max(wall)),
                                         warm_mean=float(np.mean(wall[1:])), per_block=wall.tolist()),
                decode_process_cpu_ms_per_block=dict(warm_mean=float(np.mean(cpu[1:])), per_block=cpu.tolist()),
                decode_gc_ms_per_block=dict(warm_mean=float(np.mean(gcp[1:])), max=float(np.max(gcp)),
                                            collections=int(gcn.sum())),
                decode_share_of_block=float(np.mean(wall[1:])) / block_ms, host_state=host_state,
                perf_ms_per_block=perf, blocks=n_blocks)


def run_program_g1(device) -> dict:
    """G1 at the BASELINE point: 10 Msps, 25 kHz bins, a C4FM ``p25`` bank
    of 50 slots through the engine: 40 control channels (TSDU loops, each
    its own NAC, talkgroup and site), one voice call (HDU, LDU1 / LDU2 with
    IMBE codewords of a harmonic tone), one ``dmr`` channel (CSBK bursts on
    the same 4800-baud bank) and 8 channels on empty bins."""
    from wavecap_tpu_torch.capture import CaptureConfig
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm_cyclic
    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

    fs, n_control, n_empty, n_blocks = G1_FS, G1_CONTROL, G1_EMPTY, G1_BLOCKS
    t_set0 = time.perf_counter()
    ch = ChannelizerConfig(sample_rate=float(fs), channel_bandwidth=25_000.0)
    n_ch = n_control + 2 + n_empty
    check(n_ch <= G1_CAPACITY, f"{n_ch} channels do not fit the bank's {G1_CAPACITY} slots")
    bins = p25_bins(ch.channel_count, n_ch, max(2, (ch.channel_count - 8) // n_ch))
    stations, specs, sent = [], [], {}
    for s in range(n_control):
        nac, fine = 0x100 + s, G_FINE[s % len(G_FINE)]
        dib, sent[f"c{s}"] = g_tsdu_loop(nac, site=s + 1)
        off = ch.channel_offset_hz(bins[s]) + fine
        stations.append(g_station(modulate_c4fm_cyclic(dib, 48_000.0), fs, off, G_AMPLITUDE))
        specs.append((f"c{s}", "p25", G_CENTER + off))
    vdib, vsent, n_ldu, ldu_len = g_voice_loop(0x2A0)
    vdib = np.pad(vdib, (0, -len(vdib) % 3))
    off = ch.channel_offset_hz(bins[n_control])
    stations.append(g_station(modulate_c4fm_cyclic(vdib, 48_000.0), fs, off, G_AMPLITUDE))
    specs.append(("voice", "p25", G_CENTER + off))
    ddib, dsent = g_dmr_loop()
    off = ch.channel_offset_hz(bins[n_control + 1])
    stations.append(g_station(fsk4_cyclic(ddib, 1944.0), fs, off, G_AMPLITUDE))
    specs.append(("dmr", "dmr", G_CENTER + off))
    for e in range(n_empty):
        specs.append((f"e{e}", "p25", G_CENTER + ch.channel_offset_hz(bins[n_control + 2 + e])))
    cfg = CaptureConfig(center_hz=G_CENTER, sample_rate=fs, channel_bandwidth=25_000.0, block_seconds=0.25,
                        narrow_capacity=0, wide_capacity=0, p25_capacity=G1_CAPACITY, p25_modulation="c4fm",
                        p25_equalizer_taps=0, fft_size=2048, audio_rate=48_000, transport="i16",
                        adaptive_transport=False)
    cap, blocks = g_scene(device, cfg, stations, n_blocks)
    setup_s = time.perf_counter() - t_set0
    cons, atts, counts, timing, host_state, first, card = run_g_engine(cap, specs, blocks, G1_LAUNCHES, "i16")

    n_sym = cons["c0"].symbols // n_blocks
    counted = (n_blocks - P25_FIRST) * n_sym
    control = {}
    for s in range(n_control):
        control[f"c{s}"] = g_rate(cons[f"c{s}"].keys("tsbk", P25_FIRST), sent[f"c{s}"], 0.99,
                                  g_sent_bounds(counted, 360, 3), f"control station c{s}")
    v = cons["voice"]
    ldus = v.keys("ldu", P25_FIRST)
    # the loop is an HDU and n_ldu LDUs: the fewest by their share of it, the most packed back to back
    voice = g_rate(ldus, vsent, 0.95, (counted * n_ldu // len(vdib) - 1, g_sent_bounds(counted, ldu_len)[1]),
                   "voice station's LDUs")
    pcm = np.concatenate(v.pcm) if v.pcm else np.zeros(0, np.float32)
    check(len(pcm) and np.isfinite(pcm).all(), "the voice decoder gave no PCM or non-finite PCM")
    voice.update(pcm_s=len(pcm) / 8000.0, pcm_rms=float(np.sqrt(np.mean(pcm ** 2))))
    check(voice["pcm_rms"] > 1e-3, f"the voice PCM is silent (rms {voice['pcm_rms']:.2e})")
    dmr_ = g_rate(cons["dmr"].keys("csbk", P25_FIRST), dsent, 0.95, g_sent_bounds(counted, 144),
                  "DMR station's CSBKs")
    empty = {}
    for e in range(n_empty):
        c = cons[f"e{e}"]
        valid = [x for x in c.keys("tsbk") if x is not None]
        check(not valid, f"empty channel e{e} yielded CRC-valid TSBKs {valid[:2]}")
        framer = atts[f"e{e}"].framer
        empty[f"e{e}"] = dict(frame_syncs=framer.sync_count, frames=framer.frame_count)
    stations_ = {cid for cid, _, _ in specs if not cid.startswith("e")}
    plain = g_first_blocks_vs_plain(device, cap, blocks, first, card, specs, stations_, "i16")
    rates = [r["rate"] for r in control.values()]
    return dict(phase="decoders on the engine, G1 (C4FM bank at 10 Msps)", channels=ch.channel_count,
                p25_slots=G1_CAPACITY, symbols_per_block=n_sym, setup_s=setup_s,
                control_tsbk_rate_min=min(rates), control_tsbks_valid=sum(r["valid"] for r in control.values()),
                control=control, voice=voice, dmr=dmr_, empty=empty, **plain,
                **g_report(cap, timing, host_state, counts, n_blocks))


def run_program_g2(device) -> dict:
    """G2 at programs B / C's rate: 2.4 Msps, an LSM ``p25`` bank with the
    41-tap equaliser (a station behind the 70 us simulcast echo, one 600 Hz
    off its carrier) and a ``p25p2`` bank of 20 slots, four of them with
    Phase 2 calls (MAC PTT / END_PTT and AMBE+2 voice bursts)."""
    from wavecap_tpu_torch.capture import CaptureConfig
    from wavecap_tpu_torch.models.p25.cqpsk import modulate_cqpsk_cyclic
    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

    fs, n_blocks = G2_FS, G2_BLOCKS
    t_set0 = time.perf_counter()
    ch = ChannelizerConfig(sample_rate=float(fs), channel_bandwidth=25_000.0)
    n_lsm, n_p2 = len(G2_LSM), len(G2_P2)
    bins = p25_bins(ch.channel_count, n_lsm + n_p2 + 2 * G2_EMPTY, 5)
    echo_delay = int(round(70e-6 * fs))
    stations, specs, sent, sent_frags = [], [], {}, {}
    for s, (fine, cfo, echo) in enumerate(G2_LSM):
        dib, sent[f"l{s}"] = g_tsdu_loop(0x300 + s, site=100 + s)
        off = ch.channel_offset_hz(bins[s]) + fine
        stations.append(g_station(modulate_cqpsk_cyclic(dib, 48_000.0), fs, off + cfo, P25_AMPLITUDE,
                                  (echo_delay, ECHO[1], ECHO[2]) if echo else None))
        specs.append((f"l{s}", "p25", G_CENTER + off))
    for s, fine in enumerate(G2_P2):
        dib, sent[f"p{s}"], sent_frags[f"p{s}"] = g_p2_loop((4000 + 2 * s, 4001 + 2 * s))
        off = ch.channel_offset_hz(bins[n_lsm + s]) + fine
        stations.append(g_station(modulate_cqpsk_cyclic(dib, 48_000.0, 6000.0, 1.0), fs, off, P25_AMPLITUDE))
        specs.append((f"p{s}", "p25p2", G_CENTER + off))
    for e in range(G2_EMPTY):
        specs.append((f"le{e}", "p25", G_CENTER + ch.channel_offset_hz(bins[n_lsm + n_p2 + e])))
        specs.append((f"pe{e}", "p25p2", G_CENTER + ch.channel_offset_hz(bins[n_lsm + n_p2 + G2_EMPTY + e])))
    cfg = CaptureConfig(center_hz=G_CENTER, sample_rate=fs, channel_bandwidth=25_000.0, block_seconds=0.15,
                        narrow_capacity=0, wide_capacity=0, p25_capacity=G2_P25_CAPACITY, p25_modulation="cqpsk",
                        p25_equalizer_taps=41, p25p2_capacity=G2_P2_CAPACITY, fft_size=2048, audio_rate=48_000,
                        transport="i8", adaptive_transport=False)
    cap, blocks = g_scene(device, cfg, stations, n_blocks)
    setup_s = time.perf_counter() - t_set0
    cons, atts, counts, timing, host_state, first, card = run_g_engine(cap, specs, blocks, G2_LAUNCHES, "i8")

    n_sym = cons["l0"].symbols // n_blocks
    lsm = {}
    for s, (_, _, echo) in enumerate(G2_LSM):
        start = P25_FIRST + 1 if echo else P25_FIRST  # the equaliser engages in block 3
        counted = (n_blocks - start) * n_sym
        lsm[f"l{s}"] = g_rate(cons[f"l{s}"].keys("tsbk", start), sent[f"l{s}"], 0.90 if echo else 0.95,
                              g_sent_bounds(counted, 360, 3), f"LSM station l{s}" + (" (echo)" if echo else ""))
    p2 = {}
    for s in range(n_p2):
        c = cons[f"p{s}"]
        frags = c.keys("fragment", P25_FIRST)
        dibits = (n_blocks - P25_FIRST) * (c.symbols // n_blocks)
        lo, hi = g_sent_bounds(dibits, 720)
        as_sent = [x for x in frags if x in sent_frags[f"p{s}"]]  # noise fragments match none
        check(hi >= len(as_sent) >= 0.9 * lo, f"Phase 2 station p{s}: {len(as_sent)} fragments as sent "
              f"({len(frags)} found), not within 90 % of {lo} .. {hi} sent")
        # MAC PDUs ride the loop's first and last fragments (adjacent in the
        # cycle), two each: the fewest and the most in lo / hi fragments
        n_loop = G_P2_FRAGMENTS
        mac_lo = 2 * (2 * (lo // n_loop) + max(0, lo % n_loop - (n_loop - 2)))
        mac_hi = 2 * (2 * (hi // n_loop) + min(2, hi % n_loop))
        macs = c.keys("mac", P25_FIRST)
        check(all(m in sent[f"p{s}"] for m in macs), f"Phase 2 station p{s}: a MAC PDU was not sent")
        check(mac_hi >= len(macs) >= 0.9 * mac_lo,
              f"Phase 2 station p{s}: {len(macs)} MAC PDUs, not within 90 % of {mac_lo} .. {mac_hi} sent")
        pcm = np.concatenate(c.pcm) if c.pcm else np.zeros(0, np.float32)
        check(len(pcm) and np.isfinite(pcm).all(), f"Phase 2 station p{s}: no or non-finite voice PCM")
        p2[f"p{s}"] = dict(fragments_as_sent=len(as_sent), fragments=len(frags), sent=[lo, hi],
                           mac_pdus=len(macs), mac_sent=[mac_lo, mac_hi], pcm_s=len(pcm) / 8000.0)
    empty = {}
    for e in range(G2_EMPTY):
        c = cons[f"le{e}"]
        valid = [x for x in c.keys("tsbk") if x is not None]
        check(not valid, f"empty LSM channel le{e} yielded CRC-valid TSBKs")
        empty[f"le{e}"] = dict(frame_syncs=atts[f"le{e}"].framer.sync_count)
        c = cons[f"pe{e}"]
        check(not c.keys("mac"), f"empty Phase 2 channel pe{e} yielded MAC PDUs")
        empty[f"pe{e}"] = dict(fragments=len(c.keys("fragment")))
    state = cap._dev_state
    hits = host(state.p25.c4fm.eq_hits)
    echo_slot = cap.channels[f"l{[e for _, _, e in G2_LSM].index(True)}"].slot
    stations_ = {cid for cid, _, _ in specs if cid[0] in "lp" and cid[1].isdigit()}
    plain = g_first_blocks_vs_plain(device, cap, blocks, first, card, specs, stations_, "i8")
    return dict(phase="decoders on the engine, G2 (LSM + Phase 2 banks at 2.4 Msps)", channels=ch.channel_count,
                p25_slots=G2_P25_CAPACITY, p25p2_slots=G2_P2_CAPACITY, symbols_per_block=n_sym,
                setup_s=setup_s, lsm=lsm, phase2=p2, empty=empty, echo_eq_hits=int(hits[echo_slot]), **plain,
                **g_report(cap, timing, host_state, counts, n_blocks))


# --- phase 12: the channel attachments and the scanner on the engine (program H) --------

H_FS = 10_000_000
H_CENTER = 152_000_000.0
H_BLOCKS = 50  # 0.2 s each (1,984,400 samples: whole wide-slot and channelizer steps)
H_CAPACITY = 160  # program D's bank
H_AMPLITUDE = 0.02
H_DEVIATION = 4500.0  # Hz a unit of the pagers' audio (tests/test_attachments_live.py:207-220)
H_DSP = {"enable_highpass": False, "enable_lowpass": False}  # as the server's attachment route sets them
H_RATE = 50_000  # narrow stations are made at the channel rate, the WBFM one at 10x: whole samples a block
H_POCSAG = ((512, 20), (512, 23), (1200, 26), (1200, 29), (1200, 32), (2400, 35), (2400, 38), (2400, 41))
H_FLEX = (44, 47, 50, 53)
H_RDS_BIN = 100  # the WBFM station at +2.5 MHz: narrow bins 88-112 stay clear of it
H_RDS = (0x5A17, "WAVECAP ", "RDS ON THE H100")  # PI, PS, RadioText
H_SCAN_BINS = (250, 253, 256, 259, 262, 265)
H_SCAN_ACTIVE = 5  # the entry whose bin carries the gated carrier
# the blocks in which that carrier is up: the scanner reaches the last entry
# after five dwells (~16 blocks) and again ~16 blocks after the first
# carrier drops; the gap outlasts a hold and two blocks.  The dwell outlasts
# a retune's wait for a block at the new frequency (a block and its
# dispatch): the scanner reads the channel's last RSSI, which until then
# is the old frequency's
H_SCAN_ON = ((8, 26), (38, 50))
H_SCAN_DWELL_S, H_SCAN_HOLD_S, H_SCAN_SQUELCH_DB = 0.6, 0.4, -60.0
H_TONE_BINS = tuple(range(150, 190, 2))  # gated 1 kHz FM tones among the bank's fillers
H_IDLE_BINS = tuple(range(113, 150)) + tuple(range(300, 400))
H_PLAIN_BLOCKS = 2
H_REPLAY_BLOCKS = 4
H_MARGIN_S = 0.004  # a page's sync-to-content span keeps this far from a block's edges
# the NBFM path's delay, RF to 48 kHz audio, at 25 kHz bins: the channelizer's
# prototype (M x 9 taps) is centred, and a block whose channel samples 25 does
# not divide takes the centred one-shot resampler (measured on the plain path)
H_AUDIO_DELAY_S = (400 * 9 - 2) / 2 / H_FS
# kernel launches per block: one NBFM bank (its IIR filters off) and one wide
# group (K7 shift, K5 to audio, K9 deemphasis and MPX low-pass)
H_LAUNCHES = {"K1_unpack_arms": 1, "K2_arm_dft": 1, "K3_slot_frontend": 1, "K5_resample_poly": 2,
              "K7_strided_fir": 1, "K9_iir_cascade": 2}


class HPage:
    """One sent page: its station, key (address or capcode, content), the
    sync word's start and the end of its content (s, signal time), and
    the least distance (samples) from a decoder's bit sample to its bit's
    edges."""

    def __init__(self, station: str, key: tuple, sync: float, crit_end: float, margin: float):
        self.station, self.key, self.sync, self.crit_end, self.margin = station, key, sync, crit_end, margin


def h_text(rng, n: int, numeric: bool) -> str:
    if numeric:
        return "".join(rng.choice(list("0123456789"), n))
    body = list(rng.choice(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"), n))
    for i in rng.integers(1, max(2, n - 1), n // 5):
        body[int(i)] = " "
    return "".join(body)


def h_pocsag_sets(rng) -> dict:
    """Each POCSAG station's set of pages (address, text, numeric), sized
    so that the sync word, the address word (frame 0) and the content
    words fit inside one block: 512 baud a 5-digit numeric page, 1200
    two alpha pages of up to 11 characters, 2400 three of up to 20."""
    sets = {}
    for s, (baud, _) in enumerate(H_POCSAG):
        n_pages, n_chars = {512: (1, 5), 1200: (2, 11), 2400: (3, 20)}[baud]
        pages = []
        for _ in range(n_pages):
            numeric = baud == 512
            n = n_chars if numeric else int(rng.integers(n_chars // 2, n_chars + 1))
            pages.append((int(rng.integers(1, 1 << 18)) << 3, h_text(rng, n, numeric), numeric))
        sets[f"pocsag{s}"] = (baud, pages)
    return sets


def h_flex_sets(rng) -> dict:
    return {f"flex{s}": [(int(rng.integers(1, 1 << 21)), h_text(rng, int(rng.integers(8, 22)), False))
                         for _ in range(3)] for s in range(len(H_FLEX))}


def h_crit_bits(text: str, numeric: bool) -> int:
    """The sync word, the address word and the content words."""
    return 32 + 32 * (1 + -(-(4 if numeric else 7) * len(text) // 20))


def h_levels(bits: np.ndarray, t0: float, baud: float, n: int, rate: int = H_RATE):
    """``modulate_pocsag`` / ``modulate_flex`` levels (1 -> -0.8) of bits
    starting at ``t0`` s, on the ``rate`` grid: (first sample, levels)."""
    s0 = int(np.ceil(t0 * rate))
    s1 = min(n, int(np.ceil((t0 + len(bits) / baud) * rate)))
    idx = np.minimum(((np.arange(s0, s1) / rate - t0) * baud).astype(np.int64), len(bits) - 1)
    return s0, np.where(bits[idx] > 0, -0.8, 0.8).astype(np.float32)


def h_fm(audio: np.ndarray, deviation: float, rate: int) -> np.ndarray:
    return np.exp(2j * np.pi * deviation * np.cumsum(audio.astype(np.float64)) / rate)


def h_margins(syncs: np.ndarray, n_bits: int, baud: float, n_audio: int, block_s: float, windows: list):
    """For each candidate sync time (s), the least distance (48 kHz
    samples) from a decoder's bit sample to its bit's edges, over the
    ``n_bits`` bits from the sync word on and every call whose window holds
    them all (inf where none does).  The decoders sample a window's bits at
    ``int(j * spb + spb / 2)`` from its start, without clock recovery, and
    each block's audio is resampled on its own (``n_audio`` samples for
    ``block_s``, so the stream's clock steps at every block edge)."""
    tau = syncs[:, None] + np.arange(n_bits + 1)[None, :] / baud + H_AUDIO_DELAY_S
    blk = np.floor(tau / block_s)
    a = blk * n_audio + (tau - blk * block_s) * 48_000
    spb = 48_000 / baud
    worst = np.full(len(syncs), np.inf)
    for w0, w1 in windows:
        inside = (a[:, 0] >= w0) & (a[:, -1] <= w1)
        if not inside.any():
            continue
        j = np.round(((a[:, :-1] + a[:, 1:]) / 2 - w0 - spb / 2) / spb)
        pos = w0 + np.floor(j * spb + spb / 2)
        m = np.minimum(pos - a[:, :-1], a[:, 1:] - pos).min(axis=1)
        worst = np.where(inside, np.minimum(worst, m), worst)
    return worst


def h_best(syncs, n_bits: int, baud: float, n_audio: int, block_s: float, windows: list) -> tuple:
    """The candidate sync time whose bits every call samples farthest from
    their edges, and that margin; a page no call can decode fails."""
    margins = h_margins(np.asarray(syncs), n_bits, baud, n_audio, block_s, windows)
    margins[np.isinf(margins)] = -np.inf  # no call's window holds the page
    i = int(np.argmax(margins))
    check(np.isfinite(margins[i]) and margins[i] >= 1.0,
          f"no placement samples a {baud:g}-baud page 1 sample from its bits' edges ({margins[i]:.2f})")
    return float(syncs[i]), float(margins[i])


def h_pocsag_station(name: str, baud: int, pages: list, first: float, n: int, block_s: float, n_audio: int,
                     run_s: float, n_calls: int):
    """A pager's audio at ``H_RATE``: its set again and again, each page's
    preamble, sync and batch (``encode_message``) with its sync word
    starting just inside a block and its content done before the block
    ends (a block edge inside would let a call decode a shortened page),
    placed where every call's decoder samples its bits farthest from their
    edges (``h_best``); returns (audio, pages)."""
    from wavecap_tpu_torch.decoders import pocsag

    audio, sent = np.zeros(n, np.float32), []
    windows = h_windows(n_audio, 57_600, n_calls)
    t_free, i = first, 0
    while True:
        addr, text, numeric = pages[i % len(pages)]
        bits = pocsag.encode_message(addr, text, numeric=numeric)
        n_crit = h_crit_bits(text, numeric)
        crit = n_crit / baud
        slack = block_s - 2 * H_MARGIN_S - crit
        check(slack > 1 / baud, f"{name}: a page's sync and content do not fit in a block")
        b = max(0, int(np.floor((t_free + 576 / baud) / block_s)))
        if b * block_s + H_MARGIN_S - 576 / baud < t_free:
            b += 1
        sync0 = b * block_s + H_MARGIN_S
        if sync0 + (len(bits) - 574) / baud > run_s - block_s:
            break
        sync, margin = h_best(sync0 + np.arange(0.0, min(slack, 2 / baud), 1 / 384_000), n_crit, baud, n_audio,
                              block_s, windows)
        end = sync + (len(bits) - 576) / baud
        s0, lv = h_levels(bits, sync - 576 / baud, baud, n)
        audio[s0:s0 + len(lv)] = lv
        sent.append(HPage(name, (addr, text, baud), sync, sync + crit, margin))
        t_free, i = end + 0.02, i + 1
    return audio, sent


def h_flex_station(name: str, frames: list, first_block: int, n: int, block_s: float, n_audio: int, run_s: float,
                   n_calls: int):
    """A FLEX pager's audio: its frames (``encode_frame``) 4 blocks apart.
    The decoder drops a data word that fails its check, so a bit lost at a
    block's edge would shorten a page: the block edge falls in the sync
    word (about 10 bits in), and the frame word and all 8 data words lie
    inside the next block, placed as ``h_best`` finds."""
    from wavecap_tpu_torch.decoders import flex

    audio, sent = np.zeros(n, np.float32), []
    windows = h_windows(n_audio, 96_000, n_calls)
    b, i = first_block, 0
    while True:
        cap, text = frames[i % len(frames)]
        bits = flex.encode_frame(cap, text)
        sync0 = (b + 1) * block_s - 10 / 1600
        if sync0 + (len(bits) - 118) / 1600 > run_s - block_s:
            break
        sync, margin = h_best(sync0 + np.arange(0.0, 2 / 1600, 1 / 384_000), 352, 1600.0, n_audio, block_s,
                              windows)
        s0, lv = h_levels(bits, sync - 120 / 1600, 1600.0, n)
        audio[s0:s0 + len(lv)] = lv
        sent.append(HPage(name, (cap, text), sync, sync + 352 / 1600, margin))
        b, i = b + 4, i + 1
    return audio, sent


def h_rds_station(n_wide: int, rate: int) -> np.ndarray:
    """The WBFM station at ``rate``: a 1 kHz program tone, the 19 kHz
    pilot and RDS (``modulate_rds``, as ``tests/test_attachments_live.py:27-46``
    builds it) with the PI, PS (group 0A) and RadioText (2A) of ``H_RDS``,
    75 kHz deviation."""
    from wavecap_tpu_torch.decoders import rds

    pi, ps, rt = H_RDS
    rt = rt.ljust(-(-len(rt) // 4) * 4)
    groups = [rds.encode_group(pi, 0, (10 << 5) | seg, 0xE201, (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1]))
              for seg in range(4)]
    groups += [rds.encode_group(pi, 2, (10 << 5) | seg, (ord(rt[4 * seg]) << 8) | ord(rt[4 * seg + 1]),
                                (ord(rt[4 * seg + 2]) << 8) | ord(rt[4 * seg + 3])) for seg in range(len(rt) // 4)]
    n_bits = int(n_wide / rate * rds.RDS_BITRATE) + 1
    bits = np.concatenate(groups * (-(-n_bits // (104 * len(groups)))))[:n_bits]
    mpx = np.asarray(rds.modulate_rds(bits, rate, amplitude=0.12), np.float64)[:n_wide]
    mpx = np.pad(mpx, (0, n_wide - len(mpx)))
    mpx += 0.4 * np.sin(2 * np.pi * 1000.0 * np.arange(n_wide) / rate)
    return h_fm(mpx, 75_000.0, rate)


def h_gated_carrier(n: int, block_s: float) -> np.ndarray:
    t = np.arange(n) / H_RATE
    env = np.zeros(n)
    for b0, b1 in H_SCAN_ON:
        ramp = 1e-3
        env = np.maximum(env, np.clip(np.minimum(t - b0 * block_s, b1 * block_s - t) / ramp, 0.0, 1.0))
    return 0.5 - 0.5 * np.cos(np.pi * env)


def h_gated_tone(n: int, phase: float) -> np.ndarray:
    period, on = D_GATE
    t = np.arange(n) / H_RATE + phase
    return h_fm(((t % period) < on) * np.sin(2 * np.pi * 1000.0 * t), 4000.0, H_RATE)


def h_scene(cfg, device, n_blocks: int, block_size: int, n_audio: int, seed: int = SEED + 16):
    """Program H's stations as one IQ record of ``n_blocks`` blocks at
    ``H_FS``: each narrow station made at ``H_RATE`` and the WBFM one at
    10x, their spectra placed at their bins' offsets (whole cycles over
    the record) and summed, one inverse FFT on ``device``.  Returns the
    IQ, the pages sent and the scanner's entries (Hz)."""
    import torch

    from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

    rng = np.random.default_rng(seed)
    ch = ChannelizerConfig(sample_rate=float(H_FS), channel_bandwidth=25_000.0)
    block_s = block_size / H_FS
    run_s = n_blocks * block_s
    n_total = n_blocks * block_size
    n = n_total * H_RATE // H_FS
    check(n * H_FS == n_total * H_RATE, "the narrow stations' rate does not divide the record")
    parts, sent = [], []
    for (name, (baud, pages)), (_, b) in zip(h_pocsag_sets(rng).items(), H_POCSAG):
        first = block_s * float(rng.uniform(0.5, 2.0))  # some pages inside the replayed blocks
        audio, pg = h_pocsag_station(name, baud, pages, first, n, block_s, n_audio, run_s, n_blocks)
        parts.append((H_AMPLITUDE * h_fm(audio, H_DEVIATION, H_RATE), H_RATE, b))
        sent += pg
    pg_flex: list = []
    for (name, frames), b in zip(h_flex_sets(rng).items(), H_FLEX):
        audio, pg = h_flex_station(name, frames, 1 + len(pg_flex) % 4, n, block_s, n_audio, run_s, n_blocks)
        pg_flex.append(name)
        parts.append((H_AMPLITUDE * h_fm(audio, H_DEVIATION, H_RATE), H_RATE, b))
        sent += pg
    parts.append((D_AMPLITUDE * h_rds_station(10 * n, 10 * H_RATE), 10 * H_RATE, H_RDS_BIN))
    parts.append((H_AMPLITUDE * h_gated_carrier(n, block_s), H_RATE, H_SCAN_BINS[H_SCAN_ACTIVE]))
    for k, b in enumerate(H_TONE_BINS):
        parts.append((H_AMPLITUDE * h_gated_tone(n, 0.013 * k), H_RATE, b))
    spec = torch.zeros(n_total, dtype=torch.complex64, device=device)
    for x, rate, b in parts:
        n_r = len(x)
        shift = int(round(ch.channel_offset_hz(b) * run_s))
        k = np.fft.fftfreq(n_r, 1.0 / n_r).astype(np.int64)
        target = torch.from_numpy((k + shift) % n_total).to(device)
        spec[target] += torch.fft.fft(torch.from_numpy(x.astype(np.complex64)).to(device)) * (n_total / n_r)
    iq = host(torch.fft.ifft(spec))
    del spec
    scan = [H_CENTER + ch.channel_offset_hz(b) for b in H_SCAN_BINS]
    return iq, sent, scan


class HScanLog:
    """The engine as the scanner sees it: every retune recorded (wall
    time, Hz) on its way to ``Capture.update_channel``."""

    def __init__(self, cap):
        self.cap, self.retunes = cap, []

    @property
    def channels(self):
        return self.cap.channels

    def update_channel(self, channel_id, **kw):
        self.retunes.append((time.perf_counter(), kw.get("frequency_hz")))
        return self.cap.update_channel(channel_id, **kw)


def h_channels(cap, ch_cfg) -> dict:
    """Every channel of program H through ``create_channel``, in one order
    (so that a second capture gets the same slots): the pagers, the
    scanner's channel, the fillers on the gated tones and on idle bins up
    to ``H_CAPACITY``, and the WBFM station's wide slot."""
    from wavecap_tpu_torch.capture import ChannelSpec

    specs = [(f"pocsag{s}", b) for s, (_, b) in enumerate(H_POCSAG)]
    specs += [(f"flex{s}", b) for s, b in enumerate(H_FLEX)]
    specs.append(("scan", H_SCAN_BINS[0]))
    specs += [(f"tone{k}", b) for k, b in enumerate(H_TONE_BINS)]
    idle = iter(H_IDLE_BINS)
    while len(specs) < H_CAPACITY:
        b = next(idle)
        specs.append((f"idle{b}", b))
    check(len({b for _, b in specs}) == len(specs), "program H: two channels on one bin")
    handles = {cid: cap.create_channel(ChannelSpec(id=cid, mode="nbfm", dsp=dict(H_DSP),
                                                   frequency_hz=H_CENTER + ch_cfg.channel_offset_hz(b)))
               for cid, b in specs}
    handles["rds"] = cap.create_channel(ChannelSpec(id="rds", mode="wbfm",
                                                    frequency_hz=H_CENTER + ch_cfg.channel_offset_hz(H_RDS_BIN)))
    return handles


def h_attach(cap, handles: dict) -> dict:
    from wavecap_tpu_torch.capture.attachments import FlexAttachment, PocsagAttachment, RdsAttachment

    atts = {cid: PocsagAttachment(h) for cid, h in handles.items() if cid.startswith("pocsag")}
    atts.update({cid: FlexAttachment(h) for cid, h in handles.items() if cid.startswith("flex")})
    atts["rds"] = RdsAttachment(handles["rds"], capture=cap)
    return atts


def h_msgs(att, since: int) -> list:
    """An attachment's messages from position ``since`` on, without their
    wall-clock stamp."""
    return [{k: v for k, v in m.items() if k != "time"} for m in list(att.messages)[since:]]


def h_windows(n_audio: int, keep: int, n_calls: int) -> list:
    """Each call's audio window (first, end) in stream samples: the
    decoder's kept tail (``keep`` samples, ``POCSAGDecoder`` 1.2 s,
    ``FlexDecoder`` 2 s) and the new block."""
    out, tail = [], 0
    for k in range(n_calls):
        length = tail + n_audio
        out.append(((k + 1) * n_audio - length, (k + 1) * n_audio))
        tail = min(keep, length)
    return out


def h_pager_calls(kind: str, sent: list, got: list, n_audio: int, block_s: float) -> dict:
    """One pager's decodes, call by call, against what the call's window
    held: a page could decode in call ``k`` only if its sync word and
    content lie inside the window, and must decode in a call whose window
    holds them with ``H_MARGIN_S`` to spare.  Every decode is a page sent
    (address or capcode and content as sent), none is decoded twice in
    one call, each page sent decodes in at least one call."""
    keep = 57_600 if kind == "pocsag" else 96_000

    def t_of(i: int) -> float:  # signal time of stream audio sample i
        return (i // n_audio) * block_s + (i % n_audio) / 48_000 - H_AUDIO_DELAY_S

    m = H_MARGIN_S
    decoded, needed = [0] * len(sent), [False] * len(sent)
    most = 0
    for k, (w0, w1) in enumerate(h_windows(n_audio, keep, len(got))):
        lo, hi = t_of(w0), t_of(w1 - 1)
        allowed = {p.key: i for i, p in enumerate(sent) if p.sync >= lo - m and p.crit_end <= hi + m}
        check(len(allowed) == sum(p.sync >= lo - m and p.crit_end <= hi + m for p in sent),
              f"{sent[0].station}: one page twice in a window")
        for i, p in enumerate(sent):
            needed[i] |= p.sync >= lo + m and p.crit_end <= hi - m
        most += len(allowed)
        keys = [(d["address"], d["content"], d["baud"]) if kind == "pocsag" else (d["capcode"], d["content"])
                for d in got[k]]
        check(all(key in allowed for key in keys), f"{sent[0].station} call {k}: decoded {keys} beyond the "
              f"pages its window held {sorted(allowed)}")
        check(len(set(keys)) == len(keys), f"{sent[0].station} call {k}: a page decoded twice: {keys}")
        for key in keys:
            decoded[allowed[key]] += 1
    missed = [sent[i].key for i, n in enumerate(decoded) if n == 0 and needed[i]]
    check(not missed, f"{sent[0].station}: pages sent but never decoded: {missed}")
    fewest = sum(needed)
    check(fewest <= sum(decoded) <= most, f"{sent[0].station}: {sum(decoded)} decodes, not within {fewest} .. {most}")
    return dict(pages_sent=len(sent), decodes=sum(decoded), fewest=fewest, most=most,
                decodes_per_page=[int(n) for n in decoded], sample_margin_min=min(p.margin for p in sent))


def h_config():
    from wavecap_tpu_torch.capture import CaptureConfig

    return CaptureConfig(center_hz=H_CENTER, sample_rate=H_FS, channel_bandwidth=25_000.0, block_seconds=0.2,
                         narrow_capacity=H_CAPACITY, wide_capacity=1, p25_capacity=0, fft_size=2048,
                         audio_rate=48_000, transport="i16", adaptive_transport=False)


def h_scan_report(per_block: list, retunes: list, scanner, scan_freqs: list) -> dict:
    """The scanner's record against the carrier's schedule: it stops (a
    hit) on the active entry only, stays there while the carrier is up,
    visits only its entries, and makes at least two full passes."""
    active = scan_freqs[H_SCAN_ACTIVE]

    def up(k: int) -> bool:
        return any(b0 <= k < b1 for b0, b1 in H_SCAN_ON)

    visited = [f for _, f in retunes]
    check(visited and set(visited) <= set(scan_freqs), f"the scanner tuned {sorted(set(visited) - set(scan_freqs))}")
    hits = {f: n for f, n in scanner.hits.items() if n}
    check(set(hits) == {active}, f"the scanner stopped on {sorted(hits)}, not only on {active}")
    for k, r in enumerate(per_block):
        check(r["state"] != "holding" or r["freq"] == active,
              f"block {k}: the scanner holds on {r['freq']}, an idle entry")
        if k + 1 < len(per_block) and r["freq"] == active and up(k) and up(k + 1):
            check(per_block[k + 1]["freq"] == active,
                  f"block {k + 1}: the scanner left {active} while its carrier was up")
    order = [scan_freqs.index(f) for f in visited]
    passes, want = 0, 0
    for i in order:
        if i == want:
            want += 1
            if want == len(scan_freqs):
                passes, want = passes + 1, 0
    check(passes >= 2, f"the scanner made {passes} full passes, not 2: {order}")
    on_blocks = [k for k, r in enumerate(per_block) if r["freq"] == active]
    return dict(visited_entries=order, visited_hz=visited, full_passes=passes, hits=hits,
                blocks_on_active=on_blocks, carrier_up_blocks=[list(x) for x in H_SCAN_ON],
                states=[r["state"] for r in per_block], rssi_db=[round(r["rssi"], 1) for r in per_block])


def h_vs_plain(first: dict, blocks: list) -> dict:
    """The first blocks through the same engine on the CPU (the plain
    versions): each pager's published audio and the wide slot's
    baseband, >= 50 dB against the card's (program D's floor)."""
    from wavecap_tpu_torch.capture import CaptureManager
    from wavecap_tpu_torch.devices import FakeDriver

    pcap = CaptureManager(FakeDriver(1), device="cpu").create_capture(config=h_config())
    ph = h_channels(pcap, pcap._channelizer)
    pcap.enable_wide_baseband()
    subs = {cid: (ph[cid].baseband if cid == "rds" else ph[cid].audio).subscribe(maxsize=H_PLAIN_BLOCKS + 2)
            for cid in first}
    for k in range(H_PLAIN_BLOCKS):
        pcap.transport_active = "i16"
        pcap._dispatch_blocks([blocks[k]])
    db = {}
    for cid, sub in subs.items():
        for k in range(H_PLAIN_BLOCKS):
            ref = sub.get_nowait()
            check(ref is not None and ref.shape == first[cid][k].shape,
                  f"{cid} block {k}: the plain path published {None if ref is None else ref.shape}")
            db[f"{cid}:{k}"] = snr_db(ref, first[cid][k])
    worst = min(db, key=db.get)
    check(db[worst] >= 50.0, f"program H's first blocks: {worst} at {db[worst]:.1f} dB < 50 against the plain path")
    return dict(first_blocks=H_PLAIN_BLOCKS, min_db=db[worst], min_at=worst,
                audio_min_db=min(v for c, v in db.items() if not c.startswith("rds")),
                baseband_min_db=min(v for c, v in db.items() if c.startswith("rds")))


def h_replay(device, blocks: list, calls: dict) -> dict:
    """``write_iq_wav`` of the first blocks, replayed by ``FileReplayDriver``
    through a second capture on ``device`` with the same channels and
    attachments: the same pages, call for call, as the fake receiver's run."""
    import tempfile
    from pathlib import Path

    from wavecap_tpu_torch.capture import CaptureManager
    from wavecap_tpu_torch.devices import DeviceConfig, FileReplayDriver
    from wavecap_tpu_torch.utils.wavio import write_iq_wav

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "program_h.wav"
        write_iq_wav(path, np.concatenate(blocks[:H_REPLAY_BLOCKS]), H_FS)
        cap = CaptureManager(FileReplayDriver(path, loop=False), device=device).create_capture(config=h_config())
        handles = h_channels(cap, cap._channelizer)
        atts = h_attach(cap, handles)
        try:
            cap.device.configure(DeviceConfig(center_hz=H_CENTER, sample_rate=H_FS))
            check(cap.device.file_rate == H_FS, f"the replay's rate {cap.device.file_rate}")
            stream = cap.device.start_stream()
            step = 0.0
            for k in range(H_REPLAY_BLOCKS):
                x, overflow = stream.read(cap.block_size)
                check(not overflow, "the replay overflowed")
                step = max(step, float(np.max(np.abs(x - blocks[k]))))
                cap.transport_active = "i16"
                cap._dispatch_blocks([x])
                attachments_wait(atts, k + 1, "program H's replay")
            check(stream.read(1)[0][0] == 0 and stream.exhausted, "the replay did not end with its file")
            check(step <= 2.5 / 32768, f"the replayed samples are {step:.3g} off the blocks written")
            same, pages = 0, 0
            for cid, a in atts.items():
                if cid == "rds":
                    continue
                want = [m for c in calls[cid][:H_REPLAY_BLOCKS] for m in c]
                got = h_msgs(a, 0)
                check(got == want, f"{cid}: the replay decoded {got}, the fake receiver's run {want}")
                same, pages = same + 1, pages + len(got)
            check(pages > 0, "no page decoded in the replayed blocks")
        finally:
            for a in atts.values():
                a.stop()
    return dict(blocks=H_REPLAY_BLOCKS, channels_same=same, pages_same=pages, max_sample_step=step)


def run_program_h(device) -> dict:
    """Program H: the port's channel attachments and scanner on the engine
    at 10 Msps, 25 kHz bins (M = 400), 0.2 s blocks.  ``CaptureManager``
    over a fake receiver -> ``create_capture`` -> ``create_channel``: an
    NBFM bank of 160 (8 POCSAG pagers at 512, 1200 and 2400 baud, 4 FLEX
    pagers, the scanner's channel, gated tones and idle bins) and a WBFM
    wide slot with RDS; ``PocsagAttachment`` / ``FlexAttachment`` on the
    pagers, ``RdsAttachment`` on the wide slot (its baseband fan-out on),
    a ``ScannerService`` over six entries, one with a gated carrier.  One
    ``_dispatch_blocks`` a block, paced to the blocks' length (the
    scanner's dwell and hold are wall-clock times), every attachment
    waited for after each block."""
    import torch

    from wavecap_tpu_torch.capture import CaptureManager
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init
    from wavecap_tpu_torch.capture.scanner import ScanEntry, ScannerConfig, ScannerService
    from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    t_all = time.perf_counter()
    stations: list = []
    mgr = CaptureManager(FakeDriver(1, stations), device=device)
    cap = mgr.create_capture(config=h_config())
    ch_cfg = cap._channelizer
    block_s = cap.block_size / H_FS
    steps = 2 * cap.block_size // ch_cfg.channel_count
    n_audio = -(-steps * 48_000 // int(ch_cfg.channel_rate))
    iq, sent, scan_freqs = h_scene(cap.config, device, H_BLOCKS, cap.block_size, n_audio)
    stations.append(FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=iq, amplitude=1.0))
    sdr = mgr.driver.open("fake0")
    sdr.configure(DeviceConfig(center_hz=H_CENTER, sample_rate=H_FS))
    stream = sdr.start_stream()
    blocks = [stream.read(cap.block_size)[0] for _ in range(H_BLOCKS)]
    del iq, stations[:]
    scene_s = time.perf_counter() - t_all

    handles = h_channels(cap, ch_cfg)
    atts = h_attach(cap, handles)
    pagers = [cid for cid in atts if cid != "rds"]
    taps = {cid: handles[cid].audio.subscribe(maxsize=H_BLOCKS + 2) for cid in pagers}
    taps["rds"] = handles["rds"].baseband.subscribe(maxsize=H_BLOCKS + 2)
    scan_h = handles["scan"]
    build, built = cap._build_control, []

    def build_noted():  # the scanner channel's frequency in each control the blocks run with
        built.append(scan_h.spec.frequency_hz)
        return build()

    cap._build_control = build_noted
    t0 = time.perf_counter()
    w = cap.warmup()
    w.join(timeout=900)
    check(not w.is_alive() and cap.warmup_error is None, f"program H: warmup failed: {cap.warmup_error}")
    warm_s = time.perf_counter() - t0
    gen0, slot0 = cap._pipe_gen, scan_h.slot
    scan_log = HScanLog(cap)
    scanner = ScannerService(scan_log, "scan", ScannerConfig(
        entries=[ScanEntry(f) for f in scan_freqs], dwell_s=H_SCAN_DWELL_S, hold_s=H_SCAN_HOLD_S,
        squelch_db=H_SCAN_SQUELCH_DB))
    calls = {cid: [] for cid in atts}
    first = {cid: [] for cid in taps}
    per_block, timing = [], []
    reset_launch_counts()
    t_run = time.perf_counter()
    scanner.start()
    try:
        for k, block in enumerate(blocks):
            t_b = time.perf_counter()
            cap.transport_active = "i16"
            cap._dispatch_blocks([block])
            t_d = time.perf_counter()
            per_block.append(dict(freq=built[-1], rssi=scan_h.rssi_db, state=scanner.state))
            wait_ms = attachments_wait(atts, k + 1, "program H")
            for cid, a in atts.items():
                seen = sum(len(c) for c in calls[cid])
                check(len(a.messages) < a.messages.maxlen, f"{cid}: the message ring filled")
                calls[cid].append(h_msgs(a, seen))
            for cid, sub in taps.items():
                x = sub.get_nowait()
                check(x is not None and sub.get_nowait() is None, f"{cid}: not one published batch in block {k}")
                if cid != "rds":
                    check(x.shape == (n_audio,), f"{cid}: {x.shape} audio samples, not {n_audio}")
                if k < H_PLAIN_BLOCKS:
                    first[cid].append(np.asarray(x, np.float32))
            timing.append(((t_d - t_b) * 1e3, wait_ms))
            time.sleep(max(0.0, t_run + (k + 1) * block_s - time.perf_counter()))
    finally:
        scanner.stop()
        cap._build_control = build
    run_s = time.perf_counter() - t_run
    counts = launch_counts()
    check(cap.blocks_processed == H_BLOCKS and cap.state != "failed", f"program H: engine {cap.state}: {cap.error}")
    if cap.torch_device.type == "cuda":
        want = {name: H_BLOCKS * H_LAUNCHES.get(name, 0) for name in counts}
        check(counts == want, f"program H: launch counts {counts} != {want}")
    check(cap._pipe_gen == gen0 and scan_h.slot == slot0 and list(mgr.captures.values()) == [cap],
          "program H: a retune rebuilt the program, moved the slot or made a capture")
    check(cap.channels["scan"] is scan_h, "program H: the scanner's channel was replaced")

    pages = {}
    for cid in pagers:
        kind = "pocsag" if cid.startswith("pocsag") else "flex"
        pages[cid] = h_pager_calls(kind, [p for p in sent if p.station == cid], calls[cid], n_audio, block_s)
    rds = atts["rds"].decoder.data
    check((rds.pi, rds.ps, rds.radiotext) == H_RDS,
          f"RDS: pi {rds.pi}, ps {rds.ps!r}, radiotext {rds.radiotext!r}, not {H_RDS}")
    scan = h_scan_report(per_block, scan_log.retunes, scanner, scan_freqs)
    for a in atts.values():
        a.stop()
    plain = h_vs_plain(first, blocks)
    replay = h_replay(device, blocks, calls)
    profile = None
    if cap.torch_device.type == "cuda":
        pipe_cfg, ctl = cap._pipe_cfg, cap._ctl
        words = torch.from_numpy(_words_for("i16", blocks[0])[0]).to(device)

        def one_pass():
            o, _ = capture_multi(words, pipeline_init(pipe_cfg, device=device), ctl, pipe_cfg)
            fetch(o["_packed"])

        one_pass()
        torch.cuda.synchronize()
        profile = profile_blocks(one_pass, 1, torch.cuda.synchronize)
    disp, wait = (np.asarray(x) for x in zip(*timing))
    return dict(phase="attachments and scanner on the engine (program H)", blocks=H_BLOCKS,
                block_size=cap.block_size, block_s=block_s, channels=ch_cfg.channel_count, nbfm_slots=H_CAPACITY,
                audio_per_block=n_audio, launches=counts,
                launches_per_block={k: v / H_BLOCKS for k, v in counts.items() if v},
                pages=pages, pages_sent=len(sent), decodes=sum(p["decodes"] for p in pages.values()),
                rds=dict(pi=rds.pi, ps=rds.ps, radiotext=rds.radiotext, blocks_ok=rds.blocks_ok,
                         blocks_bad=rds.blocks_bad, groups=dict(rds.group_counts)),
                scanner=scan, vs_plain=plain, replay=replay, profile=profile,
                dispatch_ms_per_block=dict(mean=float(disp.mean()), max=float(disp.max())),
                attachment_wait_ms_per_block=dict(mean=float(wait.mean()), max=float(wait.max())),
                scene_s=scene_s, warmup_s=warm_s, run_s=run_s, h_wall_s=time.perf_counter() - t_all)




# --- phase 13: trunking on the engine (program I) -----------------------------------------

I_FS = 2_400_000  # the reference's default deployment: 2.4 Msps, i8 transport, 4 voice recorders
I_CENTER = 851_500_000.0
I_CC = 851_200_000.0  # -300 kHz: a 25 kHz bin's centre, as every channel here (the mesh maps channels to bins)
I_BASE_MHZ = 851.0  # the identifiers' base; channels 12.5 kHz apart
I_NAC = 0x293
I_SYSTEM, I_SITE = 0x123, 7
I_AMPLITUDE = 0.05
I_TSDU_S = 360 / 4800.0  # a TSDU of three TSBKs
I_BLOCK = 360_000  # the slot banks' block: 0.15 s at 2.4 Msps (the mesh's is shorter)
I_FIRST = P25_FIRST  # control messages are counted from block 3 on
I_PLAIN_BLOCKS = 2  # each system's first blocks, also through the engine on the CPU
I_T0 = 1_800_000_000.0  # the virtual clock's start (s)
I1_BLOCKS, I2_BLOCKS, I3_BLOCKS = 28, 24, 30  # I1: 4.2 s, whole mesh blocks too (0.12 s)
# I1's calls: (tgid, source, channel, grant window in TSDUs [from, to), voice start s, LDUs)
# (a call keys up on a block edge of both the slot banks' 0.15 s and the mesh's 0.12 s blocks: a
# block a carrier enters part-way is scaled and timed partly on noise)
I1_CALLS = ((2001, 4201, 56, (2, 26), 0.6, 8), (2002, 4202, 64, (8, 34), 1.2, 8))
# I2: both slots of TDMA carrier 24 (IDEN_UP_TDMA identifier 2: 851.3 MHz), one call a slot
I2_CARRIER = 24
I2_CALLS = ((901, 0), (902, 1))
I2_GRANTS = (2, 22)  # TSDUs
I2_KEY_S = 0.3  # the TDMA carrier keys up (MAC_ACTIVE signalling) ...
I2_VOICE_S = 0.9  # ... and the calls' first fragment (MAC_PTT) starts
I2_ACQUIRE_FRAGMENTS = 3  # fragments a retuned 6000-baud slot may misread while it acquires (0.36 s)
# I3: DMR Tier III, LCN 49 / 50 -> carrier 24 (851.3 MHz), slots 0 / 1
I3_CALLS = ((800, 900, 49), (801, 901, 50))
I3_GRANTS = (0.15, 1.5)  # s
I3_VOICE_S = 0.9
I3_SUPERFRAMES = 3
I3_MAX_BER = 0.005  # raw AMBE bits a DMR call may flip through the 4800-baud bank (CPU rehearsal: 0.23 %)
I4_TIMEOUT_S = 240.0
I1_SAME_S = 0.6  # I1 and I5 count control messages from here on: a block edge of both their block lengths
I_HANG_S = 0.3  # a voice transmitter's carrier stays up this long after the call's last voice frame
# the kernels each system's blocks must launch (every count a block is logged)
I_IMPLIED = {"c4fm": ("K1_unpack_arms", "K2_arm_dft", "K3_slot_frontend", "K7_strided_fir", "K12_c4fm_timing"),
             "phase2": ("K1_unpack_arms", "K2_arm_dft", "K3_slot_frontend", "K7_strided_fir", "K13_cfo_power",
                        "K13_cfo_lines", "K13_cqpsk_timing")}
I_CLOCKED = ("system", "control", "recorder", "events")


class IClock:
    """``time`` as the trunking modules see it during program I: ``time()``
    is ``now``, moved on a block's length as each block is published; the
    rest is the real module.  Holds, hunting, sync loss and call ends then
    follow the blocks, not the host's speed."""

    def __init__(self, now: float = I_T0):
        self.now = now

    def time(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(time, name)


@contextlib.contextmanager
def i_clock():
    import importlib

    mods = [importlib.import_module(f"wavecap_tpu_torch.trunking.{n}") for n in I_CLOCKED]
    clock, saved = IClock(), [m.time for m in mods]
    for m in mods:
        m.time = clock
    try:
        yield clock
    finally:
        for m, t in zip(mods, saved):
            m.time = t


class _IGate:
    """The system's stop event while program I drives it: ``is_set`` is
    False for ``steps`` calls, so ``TrunkingSystem._run`` runs that many
    pump iterations on this thread."""

    def __init__(self, steps: int):
        self.steps = steps

    def clear(self):
        pass

    def is_set(self) -> bool:
        self.steps -= 1
        return self.steps < 0


def i_start(sys_) -> None:
    """``TrunkingSystem.start()`` with the blocks fed by hand: the capture's
    reader, fetch and health threads are not started, and the pump thread
    leaves at once (``i_step`` runs its loop)."""
    mgr = sys_.capture_manager
    create = mgr.create_capture

    def no_threads(**kw):
        cap = create(**kw)
        cap.start = lambda: None
        cap._stream_realtime = False  # the blocks are not paced: no adaptive transport
        return cap

    mgr.create_capture = no_threads
    sys_._stop = _IGate(0)
    try:
        sys_.start()
    finally:
        del mgr.create_capture
    sys_._thread.join(timeout=60)
    check(not sys_._thread.is_alive() and sys_.state == "running", f"{sys_.config.id}: start: {sys_.error}")
    sys_._thread = None


def i_step(sys_) -> None:
    sys_._stop = _IGate(1)
    sys_._run()
    check(sys_.state == "running", f"{sys_.config.id}: the pump failed: {sys_.error}")


def i_stop(sys_) -> None:
    import threading

    sys_._stop = threading.Event()
    sys_.stop()


def i_shape(dibits, rate: float, segments: list, total_s: float, modulate) -> np.ndarray:
    """A station at 48 kHz: ``segments`` of (start s, dibits) keyed on, the
    rest of ``total_s`` without a carrier."""
    n48 = int(np.ceil(total_s * 48_000)) + 480
    out = np.zeros(n48, np.complex128)
    for t0, dib in segments:
        x = modulate(np.asarray(dib, np.uint8))
        a = int(round(t0 * 48_000))
        n = max(0, min(len(x), n48 - a))
        out[a:a + n] += x[:n]
    return out


def i_station(iq48: np.ndarray, offset: float, n_out: int) -> np.ndarray:
    from scipy import signal as sps

    x = sps.resample_poly(iq48, I_FS // 48_000, 1)[:n_out]
    x = np.pad(x, (0, n_out - len(x)))
    return (I_AMPLITUDE * x * np.exp(2j * np.pi * offset * np.arange(n_out) / I_FS)).astype(np.complex64)


def i_tsdus(blocks_of, n_tsdu: int):
    """``n_tsdu`` TSDUs, ``blocks_of(k)`` the three TSBK blocks of the k-th,
    and the messages a CRC-valid TSBK of them may parse to."""
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk

    frames, sent = [], set()
    for k in range(n_tsdu):
        frame = pf.build_tsdu_frame(I_NAC, blocks_of(k))
        for b in pf.decode_tsdu(frame).tsbk_blocks:
            sent.add(g_key({"nac": I_NAC, **tsbk.parse_tsbk(b.opcode, b.mfid, b.data)}))
        frames.append(frame)
    return np.concatenate(frames), sent


def i_voice(tgid: int, source: int, n_ldu: int, f0: float):
    """A Phase 1 call: HDUs, ``n_ldu`` LDU1 / LDU2 whose link control names
    the talkgroup and source, 9 IMBE codewords each from the IMBE encoder
    on a harmonic tone at ``f0``, and TDUs for the hang time.  Returns its
    dibits and the codewords in order."""
    from wavecap_tpu_torch.decoders import imbe_vocoder as iv
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_voice as pv
    from wavecap_tpu_torch.decoders.voice import imbe_fec_encode

    t = np.arange(int(n_ldu * 9 * 0.02 * 8000) + 320) / 8000.0
    tone = sum(np.exp(-(((h * f0 - 600.0) / 500.0) ** 2)) * np.cos(2 * np.pi * h * f0 * t + h) for h in range(1, 25))
    cws = [imbe_fec_encode(u) for u in iv.ImbeEncoder().encode(0.3 * tone / np.max(np.abs(tone)))[: n_ldu * 9]]
    lc = pv.encode_lc_hexbits(pv.make_group_lc_bits(tgid=tgid, source_id=source))
    head = np.concatenate([pf.FRAME_SYNC_DIBITS, pf.encode_nid(I_NAC, pf.DUID.HDU)])
    hdu = np.concatenate([pf.insert_status_dibits(head, 0), pf.insert_status_dibits(
        pf.bits_to_dibits(pv.encode_hdu_payload(tgid=tgid, algid=0x80, kid=0)), 57)])
    # the header three times: the slot acquires the carrier on them, not on the first LDU
    pieces = [np.pad(hdu, (0, 396 - len(hdu)))] * 3
    for k in range(n_ldu):
        pieces.append(pf.build_ldu_frame(I_NAC, pf.DUID.LDU1 if k % 2 == 0 else pf.DUID.LDU2, lc,
                                         imbe_codewords=cws[9 * k: 9 * k + 9]))
    tdu = pf.insert_status_dibits(np.concatenate([pf.FRAME_SYNC_DIBITS, pf.encode_nid(I_NAC, pf.DUID.TDU)]), 0)
    # the terminator, repeated through the transmitter's hang time: the carrier drops in a later block
    # (the banks scale and time a block's symbols over the whole block, so a block the carrier leaves
    # part-way decides its last symbols on a scale taken partly from noise)
    pieces += [np.pad(tdu, (0, 72 - len(tdu)))] * int(I_HANG_S * 4800 / 72)
    return np.concatenate(pieces).astype(np.uint8), cws


def i1_scene(n_blocks: int, block_size: int):
    """I1: a C4FM control channel (IDEN_UP, RFSS status with system and
    site, and in each TSDU's middle block the grants of the calls whose
    window holds it, else a system-service broadcast) and the two calls'
    voice carriers at their granted frequencies, each keyed on at its start
    for its HDU, LDUs and TDU, off before and after."""
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm

    total_s = n_blocks * block_size / I_FS
    op = tsbk.TSBKOpcode
    iden = pf.encode_tsbk_block(op.IDEN_UP, tsbk.make_iden_up_data(
        identifier=1, base_freq_mhz=I_BASE_MHZ, channel_spacing_khz=12.5, tx_offset_mhz=-45.0))
    rfss = pf.encode_tsbk_block(op.RFSS_STS_BCAST, tsbk.make_rfss_status_data(
        system_id=I_SYSTEM, rfss_id=1, site_id=I_SITE, band=1, channel_number=16), last=True)
    filler = pf.encode_tsbk_block(op.SYS_SRV_BCAST, tsbk.make_sys_srv_data(0x0F))
    grants = {c[0]: pf.encode_tsbk_block(op.GRP_V_CH_GRANT, tsbk.make_group_grant_data(
        tgid=c[0], source_id=c[1], band=1, channel_number=c[2])) for c in I1_CALLS}

    def blocks_of(k):
        live = [c[0] for c in I1_CALLS if c[3][0] <= k < c[3][1]]
        return [iden, grants[live[k % len(live)]] if live else filler, rfss]

    cc, sent = i_tsdus(blocks_of, int(total_s / I_TSDU_S) + 2)
    n_out = n_blocks * block_size
    c4fm = lambda d: modulate_c4fm(d, 48_000.0)  # noqa: E731
    x = i_station(i_shape(cc, 4800.0, [(0.0, cc)], total_s, c4fm), I_CC - I_CENTER, n_out)
    calls = {}
    for tgid, source, chan, _, start, n_ldu in I1_CALLS:
        dib, cws = i_voice(tgid, source, n_ldu, 110.0 + 20.0 * len(calls))
        freq = I_BASE_MHZ * 1e6 + chan * 12_500.0
        x += i_station(i_shape(dib, 4800.0, [(start, dib)], total_s, c4fm), freq - I_CENTER, n_out)
        calls[tgid] = dict(source=source, frequency_hz=freq, codewords=cws, frames=9 * n_ldu, slot=0)
    return x, sent, calls


def i2_scene(n_blocks: int, block_size: int):
    """I2: a CQPSK control channel (IDEN_UP_TDMA, RFSS status, the two
    slots' grants in the grant window, else a system-service broadcast)
    and the TDMA carrier at 6000 baud, keyed up at ``I2_KEY_S`` with
    MAC_ACTIVE signalling in every burst, then one call in each slot from
    ``I2_VOICE_S``: ``g_p2_loop``'s superframe fragments, MAC_PTT in the
    first, AMBE+2 voice, MAC_END_PTT in the last; then MAC_HANGTIME
    through the hang time."""
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_phase2 as p2
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk
    from wavecap_tpu_torch.models.p25.cqpsk import modulate_cqpsk

    total_s = n_blocks * block_size / I_FS
    op = tsbk.TSBKOpcode
    iden = pf.encode_tsbk_block(op.IDEN_UP_TDMA, tsbk.make_iden_up_tdma_data(
        identifier=2, base_freq_mhz=I_BASE_MHZ, channel_type=3))
    rfss = pf.encode_tsbk_block(op.RFSS_STS_BCAST, tsbk.make_rfss_status_data(
        system_id=I_SYSTEM, rfss_id=1, site_id=I_SITE, band=2, channel_number=0), last=True)
    filler = pf.encode_tsbk_block(op.SYS_SRV_BCAST, tsbk.make_sys_srv_data(0x0F))
    grants = [pf.encode_tsbk_block(op.GRP_V_CH_GRANT, tsbk.make_group_grant_data(
        tgid=g, source_id=90_000 + g, band=2, channel_number=2 * I2_CARRIER + s)) for g, s in I2_CALLS]

    def blocks_of(k):
        return [iden, grants[k % 2] if I2_GRANTS[0] <= k < I2_GRANTS[1] else filler, rfss]

    cc, sent = i_tsdus(blocks_of, int(total_s / I_TSDU_S) + 2)
    n_out = n_blocks * block_size
    x = i_station(i_shape(cc, 4800.0, [(0.0, cc)], total_s, lambda d: modulate_cqpsk(d, 48_000.0, 4800.0)),
                  I_CC - I_CENTER, n_out)
    voice, mac_sent, _ = g_p2_loop(tuple(g for g, _ in I2_CALLS))
    # the carrier keys up at the grants, MAC_ACTIVE signalling in every burst until the calls' PTT
    from wavecap_tpu_torch.decoders import p25_mac as mac

    # and after the calls' last (MAC_END_PTT) MAC_HANGTIME through the hang time
    def signalling(kind):
        pdu = mac.make_mac_content(kind)
        frag = np.zeros(p2.FRAGMENT_DIBITS, np.uint8)
        for pos in range(4):
            frag[180 * pos: 180 * (pos + 1)] = mac.encode_timeslot_burst(mac.BURST_SACCH, pdu, with_sync=pos >= 2)
        return p2.build_test_fragment(frag), g_key(mac.parse_mac_pdu(pdu))

    (lead, lead_key), (hang, hang_key) = signalling(mac.MAC_ACTIVE), signalling(mac.MAC_HANGTIME)
    mac_sent = mac_sent | {lead_key, hang_key}
    n_lead = int(round((I2_VOICE_S - I2_KEY_S) * 6000 / p2.FRAGMENT_DIBITS))
    keyed = np.concatenate([lead] * n_lead + [voice] + [hang] * int(np.ceil(I_HANG_S * 6000 / p2.FRAGMENT_DIBITS)))
    freq = I_BASE_MHZ * 1e6 + I2_CARRIER * 12_500.0
    x += i_station(i_shape(keyed, 6000.0, [(I2_VOICE_S - n_lead * p2.FRAGMENT_DIBITS / 6000.0, keyed)], total_s,
                           lambda d: modulate_cqpsk(d, 48_000.0, 6000.0, alpha=1.0)), freq - I_CENTER, n_out)
    frags = voice.reshape(-1, p2.FRAGMENT_DIBITS)
    calls = {g: dict(source=90_000 + g, frequency_hz=freq, slot=slot, frames=len(i2_voice_bursts(frags, slot)))
             for g, slot in I2_CALLS}
    return x, sent | mac_sent, calls, frags, (lead, hang)


def i3_scene(n_blocks: int, block_size: int):
    """I3: a DMR control channel (CSBK bursts: PV_GRANTs of the two calls
    in the grant window, aloha after), and carrier 24 keyed up at the
    grants with idle bursts, from ``I3_VOICE_S`` both slots' voice,
    ``I3_SUPERFRAMES`` superframes of AMBE frames a slot
    (``build_dual_slot_voice_stream``), then idle bursts again; the calls
    end by the hold after their last voice."""
    from wavecap_tpu_torch.decoders import dmr
    from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeEncoder
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm

    total_s = n_blocks * block_size / I_FS
    burst_s = 144 / 4800.0
    grants = [dmr.make_csbk_bits(0x30, dst_id=g, src_id=s, channel=lcn) for g, s, lcn in I3_CALLS]
    aloha = dmr.make_csbk_bits(0x19, net=0x1234, site=I_SITE, ms_id=42)
    n_bursts = int(total_s / burst_s) + 2
    bits = [grants[k % 2] if I3_GRANTS[0] <= k * burst_s < I3_GRANTS[1] else aloha for k in range(n_bursts)]
    cc = np.concatenate([dmr.build_data_burst(b, dmr.DataType.CSBK) for b in bits])
    sent = {g_key({"colorCode": 1, **dmr.parse_csbk(b)}) for b in (*grants, aloha)}
    fsk = lambda d: modulate_c4fm(d, 48_000.0)  # noqa: E731  (as tests/test_trunking.py:make_dmr_stream_iq)
    n_out = n_blocks * block_size
    x = i_station(i_shape(cc, 4800.0, [(0.0, cc)], total_s, fsk), I_CC - I_CENTER, n_out)
    frames = {}
    for g, f0 in ((I3_CALLS[0][0], 150.0), (I3_CALLS[1][0], 250.0)):
        t = np.arange(int(I3_SUPERFRAMES * 18 * 0.02 * 8000) + 320) / 8000.0
        tone = sum(a * np.sin(2 * np.pi * f0 * k * t) for k, a in ((1, 1.0), (2, 0.6), (3, 0.45)))
        frames[g] = AmbeEncoder().encode((0.3 * tone / np.max(np.abs(tone))).astype(np.float32))[: 18 * I3_SUPERFRAMES]
    g0, g1 = (c[0] for c in I3_CALLS)
    voice = np.concatenate([dmr.build_dual_slot_voice_stream(frames[g0][18 * s: 18 * s + 18],
                                                             frames[g1][18 * s: 18 * s + 18],
                                                             rng=np.random.default_rng(SEED + s))
                            for s in range(I3_SUPERFRAMES)])
    # the repeater keys up at the grants and sends idle bursts around the voice to the run's end (its
    # hang time): a slot on noise alone can find a voice superframe in it
    idle = dmr.build_data_burst(np.zeros(96, np.uint8), dmr.DataType.IDLE)
    n_lead = int(round((I3_VOICE_S - I3_GRANTS[0]) / burst_s))
    n_hang = int(np.ceil((total_s - I3_VOICE_S) / burst_s)) - len(voice) // 144
    keyed = np.concatenate([idle] * n_lead + [voice] + [idle] * max(n_hang, 0))
    freq = I_BASE_MHZ * 1e6 + ((I3_CALLS[0][2] - 1) // 2) * 12_500.0
    x += i_station(i_shape(keyed, 4800.0, [(I3_VOICE_S - n_lead * burst_s, keyed)], total_s, fsk), freq - I_CENTER,
                   n_out)
    calls = {g: dict(source=s, frequency_hz=freq, slot=(lcn - 1) % 2, frames=18 * I3_SUPERFRAMES, ambe=frames[g])
             for g, s, lcn in I3_CALLS}
    return x, sent, calls


def i3_fields(m: dict) -> tuple:
    """A CSBK's fields as ``parse_csbk`` gives them (``g_note``'s key)."""
    from wavecap_tpu_torch.decoders import dmr

    return ("colorCode",) + tuple(dmr.parse_csbk(dmr.make_csbk_bits(m["opcode"])) or ())


def i_blocks(x: np.ndarray, n_blocks: int, block_size: int) -> list:
    """The scene through the port's fake receiver (its noise added), as
    ``n_blocks`` blocks."""
    from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation

    dev = FakeDriver(1, [FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=x, amplitude=1.0)]).open("fake0")
    dev.configure(DeviceConfig(center_hz=I_CENTER, sample_rate=I_FS))
    stream = dev.start_stream()
    return [stream.read(block_size)[0] for _ in range(n_blocks)]


def i_config(name: str, rec_dir: str, **kw) -> dict:
    return dict(id=name, control_channels=[I_CC], center_hz=I_CENTER, recording_dir=rec_dir, **kw)


def i_system(cfg: dict, device, state_dir: str):
    from wavecap_tpu_torch.capture import CaptureManager
    from wavecap_tpu_torch.devices import FakeDriver
    from wavecap_tpu_torch.trunking import TrunkingManager, TrunkingSystemConfig

    tm = TrunkingManager(CaptureManager(FakeDriver(1), device=device), state_dir=state_dir)
    check(tm.device == torch_device(device), f"the trunking manager runs on {tm.device}, not {device}")
    return tm.create_system(TrunkingSystemConfig.from_dict(cfg))


def torch_device(device):
    import torch

    return torch.device(device)


def i_taps(sys_) -> dict:
    """Each Phase 2 recorder's superframe fragments and MAC PDUs as its
    ``_process_phase2`` meets them (a tap on its detector's ``process`` and
    on ``_handle_mac``); the recorder itself is the system's, unchanged."""
    from wavecap_tpu_torch.decoders.p25_phase2 import P25P2SuperFrameDetector

    taps = {}
    for rec in sys_.pool.recorders:
        if rec.protocol != "p25_phase2":
            continue
        log = taps[rec.channel_id] = dict(fragments=[], mac=[])
        det = rec._p2 = P25P2SuperFrameDetector()
        process, handle = det.process, rec._handle_mac

        def tapped(soft, process=process, log=log):
            frags = list(process(soft))
            log["fragments"] += [f.dibits.astype(np.uint8).tobytes() for f in frags]
            return frags

        def mac(pdu, handle=handle, log=log):
            log["mac"].append(g_key(pdu))
            return handle(pdu)

        det.process, rec._handle_mac = tapped, mac
    return taps


def i_drive(sys_, blocks: list, clock) -> dict:
    """The blocks through the system's capture, two a dispatch (its
    ``blocks_per_dispatch``); after each published block the clock moves on
    a block's length and the pump runs once; every subscription drained.
    Returns the launches, the monitor's counts and message-log length
    after block ``I_FIRST`` - 1 and after each block (with the clock), the
    host's dispatch and pump ms."""
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    cap = sys_.capture
    block_s = cap.block_size / cap.config.sample_rate
    out = dict(pump_ms=[], dispatch_ms=[], marks=[])
    reset_launch_counts()
    k = 0
    for j in range(0, len(blocks), 2):
        cap.transport_active = cap.config.transport
        t0 = time.perf_counter()
        cap._dispatch_blocks(blocks[j:j + 2])
        out["dispatch_ms"].append((time.perf_counter() - t0) * 1e3)
        for _ in blocks[j:j + 2]:
            clock.now += block_s
            t0 = time.perf_counter()
            i_step(sys_)
            out["pump_ms"].append((time.perf_counter() - t0) * 1e3)
            k += 1
            st = sys_.monitor.stats
            out["marks"].append((round(clock.now - I_T0, 6), st.tsbk_total, st.tsbk_crc_ok))
            if k == I_FIRST:
                out["first"] = dict(total=st.tsbk_total, ok=st.tsbk_crc_ok, messages=len(sys_.message_log))
    out["launches"] = launch_counts()
    out["perf"] = {k_: v / max(cap.perf.get("dispatches", 1), 1) for k_, v in cap.perf.items() if k_ != "dispatches"}
    out["block_size"] = cap.block_size
    check(cap.blocks_processed == len(blocks) and cap.state != "failed", f"{sys_.config.id}: engine {cap.state}")
    subs = [sys_._cc_sub, *sys_._voice_subs.values()]
    check(all(s_.get_nowait() is None and s_.dropped == 0 for s_ in subs),
          f"{sys_.config.id}: a symbol subscription was not drained or dropped a batch")
    return out


def i_counted_since(run: dict, t_s: float) -> dict:
    """The control messages counted (all, CRC-valid) from the block ending at ``t_s`` to the run's end."""
    at = next(m for m in run["marks"] if abs(m[0] - t_s) < 1e-3)
    end = run["marks"][-1]
    return dict(since_s=t_s, total=end[1] - at[1], ok=end[2] - at[2])


def i_state_to(tree, device):
    """A capture's carried state (tensors in NamedTuples, dicts, tuples) on ``device``."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: i_state_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(i_state_to(v, device) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(i_state_to(v, device) for v in tree)
    return tree


def i_vs_cpu(cfg: dict, blocks: list, device, tmp: str) -> dict:
    """The system's capture against the same capture on the CPU (the plain
    versions): two fresh systems of the config, started inline, take the
    stream's first ``1 + I_PLAIN_BLOCKS`` blocks one a dispatch, the CPU
    one from the card's carried state before each block after the first.
    The first two blocks after the stream's first: every channel's f32 soft
    symbols >= 50 dB against the card's (every channel is tuned to the
    control channel, where each starts), and the messages a fresh control
    monitor decodes from each capture's published symbols of those blocks
    equal.  The stream's first block is reported, not held: a capture
    starts from zero history, so the first channel samples of a station on
    the air are near zero and their FM phase is rounding noise, which any
    f32 arithmetic sets its own way (K2's 3xTF32 against torch's matmul:
    2e-7 apart) and the block timing then reads a block of different
    symbols (``PERF.md`` §6, PR 17)."""
    from wavecap_tpu_torch.trunking.control import ControlChannelMonitor, DmrControlMonitor

    systems, soft, msgs = {}, {}, {}
    with i_clock():
        for name, dev in (("card", device), ("cpu", "cpu")):
            systems[name] = i_system(dict(cfg, recording_dir=os.path.join(tmp, f"{name}-rec")), dev,
                                     os.path.join(tmp, f"{name}-state"))
            i_start(systems[name])
        try:
            monitor = DmrControlMonitor if cfg.get("protocol") == "dmr_tier3" else ControlChannelMonitor
            taps = {}
            for name, sys_ in systems.items():
                cap = sys_.capture
                step = cap._step
                soft[name], msgs[name] = [], []
                subs = {cid: h.symbols.subscribe(maxsize=4) for cid, h in cap.channels.items()}
                mons = {cid: monitor() for cid in subs}

                def keep(batch, state, ctl, step=step, out=soft[name]):
                    o, state = step(batch, state, ctl)
                    out.append({g: host(o[g]["soft"])[0] for g in ("p25", "p25p2") if g in o})
                    return o, state

                cap._step = keep
                taps[name] = (subs, mons)
            for k in range(1 + I_PLAIN_BLOCKS):
                if k:
                    systems["cpu"].capture._dev_state = i_state_to(systems["card"].capture._dev_state,
                                                                    systems["cpu"].capture.torch_device)
                for name, sys_ in systems.items():
                    sys_.capture.transport_active = sys_.capture.config.transport
                    sys_.capture._dispatch_blocks([blocks[k]])
                    subs, mons = taps[name]
                    for cid, sub in subs.items():
                        got = sub.get_nowait()
                        check(got is not None, f"{cfg['id']}: no symbols from {cid} in block {k}")
                        if k:
                            msgs[name] += [(cid, {f: v for f, v in m.items() if f != "data"})
                                           for m in mons[cid].process_symbols(np.asarray(got["soft"], np.float32),
                                                                              now=float(k))]
            channels = {cid: (h.mode_group, h.slot) for cid, h in systems["card"].capture.channels.items()}
        finally:
            for sys_ in systems.values():
                i_stop(sys_)
    per_block = {cid: [snr_db(soft["cpu"][k][g][slot], soft["card"][k][g][slot]) for k in range(1 + I_PLAIN_BLOCKS)]
                 for cid, (g, slot) in channels.items()}
    held = [cid for cid, (g, _) in channels.items() if g == "p25"]
    worst = min(min(per_block[c][1:]) for c in held)
    check(worst >= 50.0, f"{cfg['id']}: blocks 2-{1 + I_PLAIN_BLOCKS}' f32 soft {worst:.1f} dB < 50 against the CPU "
          f"engine from the same state: {per_block}")
    check(canon_json(msgs["card"]) == canon_json(msgs["cpu"]),
          f"{cfg['id']}: the messages decoded from blocks 2-{1 + I_PLAIN_BLOCKS} differ between card and CPU: "
          f"{len(msgs['card'])} / {len(msgs['cpu'])}")
    check(len(msgs["card"]) > 0, f"{cfg['id']}: no message decoded from blocks 2-{1 + I_PLAIN_BLOCKS}")
    return dict(blocks_held=[2, 1 + I_PLAIN_BLOCKS], soft_snr_db_min=worst,
                soft_snr_db_by_block={c: v for c, v in per_block.items()}, messages_same=len(msgs["card"]),
                first_block_soft_snr_db=min(per_block[c][0] for c in held))


def canon_json(x) -> str:
    return json.dumps(x, sort_keys=True, default=str)


def i_tsbks(sys_, run: dict, sent: set, what: str, fields=None) -> dict:
    """Every control message counted from block ``I_FIRST`` + 1 on decoded
    (no CRC failure in the monitor's count since then), each as sent
    (``fields(m)``: the fields compared, default all but the time), and as
    many as the counted blocks carry."""
    st = sys_.monitor.stats
    first = run["first"]
    total, ok = st.tsbk_total - first["total"], st.tsbk_crc_ok - first["ok"]
    msgs = list(sys_.message_log)[first["messages"]:]
    check(len(sys_.message_log) < sys_.message_log.maxlen, f"{what}: the message log filled")
    keys = [g_key({k: v for k, v in m.items() if (k in fields(m) if fields else k != "time")}) for m in msgs]
    bad = [k for k in keys if k not in sent]
    check(not bad, f"{what}: a control message was not sent: {bad[:2]}")
    check(total == ok == len(keys), f"{what}: {ok} of {total} messages from block {I_FIRST + 1} on decoded "
          f"({len(keys)} logged)")
    return dict(messages=len(keys), failed=total - ok)


def i_files(rec_dir: str, tgid: int) -> dict:
    from pathlib import Path

    found = {p.suffix: p for p in Path(rec_dir).rglob(f"*_tg{tgid}_*")}
    check({".wav", ".json"} <= set(found), f"talkgroup {tgid}: the call's recording is missing: {sorted(found)}")
    return found


def i_wav_pcm(path) -> np.ndarray:
    import wave

    with wave.open(str(path), "rb") as w:
        check(w.getframerate() == 8000 and w.getnchannels() == 1, f"{path}: not 8 kHz mono")
        return np.frombuffer(w.readframes(w.getnframes()), np.int16)


def i_calls(sys_, calls: dict, rec_dir: str, decode, what: str) -> dict:
    """Each call the station made was granted, started at the frequency the
    identifiers give, held to its end and written: as many voice frames as
    the station sent in it, the frames as sent (``decode(tgid, files)`` ->
    (frames as sent?, the PCM the CPU decodes from the recorded frames)),
    the WAV's PCM that PCM, the sidecar's counts."""
    hist = {c.tgid: c for c in sys_.call_history}
    check(not sys_.active_calls and set(hist) == set(calls) and len(sys_.call_history) == len(calls),
          f"{what}: calls {[c.tgid for c in sys_.call_history]}, active {list(sys_.active_calls)}, not {sorted(calls)}")
    starts = {e["tgid"]: e for e in sys_.events if e["type"] == "call_start"}
    check(len({starts[g]["recorder"] for g in calls}) == len(calls), f"{what}: the calls did not get their own recorders")
    out = {}
    for tgid, want in calls.items():
        c = hist[tgid]
        check(abs(c.frequency_hz - want["frequency_hz"]) < 1.0 and abs(starts[tgid]["frequencyHz"] - want["frequency_hz"]) < 1.0,
              f"{what}: talkgroup {tgid} at {c.frequency_hz}, not {want['frequency_hz']}")
        check(c.tdma_slot == want["slot"] and c.source_id == want["source"],
              f"{what}: talkgroup {tgid}: slot {c.tdma_slot}, source {c.source_id}, not {want['slot']}, {want['source']}")
        check(c.imbe_frames == want["frames"], f"{what}: talkgroup {tgid}: {c.imbe_frames} voice frames, "
              f"the station sent {want['frames']}")
        files = i_files(rec_dir, tgid)
        meta = json.loads(files[".json"].read_text())
        check(meta["imbeFrames"] == want["frames"] and meta["tgid"] == tgid, f"{what}: talkgroup {tgid}: sidecar {meta}")
        as_sent, pcm = decode(tgid, files)
        check(as_sent, f"{what}: talkgroup {tgid}: the recorded frames are not the frames sent")
        wav = i_wav_pcm(files[".wav"])
        from wavecap_tpu_torch.utils.wavio import pack_pcm16

        check(np.array_equal(wav, pack_pcm16(pcm)), f"{what}: talkgroup {tgid}: the WAV ({len(wav)} samples) is not "
              f"the CPU decode of its frames ({len(pcm)} samples)")
        check(np.sqrt(np.mean((wav / 32768.0) ** 2)) > 1e-3, f"{what}: talkgroup {tgid}: the WAV is silent")
        out[tgid] = dict(frequency_hz=c.frequency_hz, slot=c.tdma_slot, source=c.source_id, frames=c.imbe_frames,
                         seconds=round(c.end_time - c.start_time, 3), audio_s=c.audio_seconds,
                         recorder=starts[tgid]["recorder"])
    return out


def i_launches(run: dict, n_blocks: int, implied: tuple, what: str) -> dict:
    per = {k: v / n_blocks for k, v in run["launches"].items() if v}
    zero = [k for k in implied if not run["launches"].get(k)]
    check(not zero, f"{what}: {zero} launched no time, though the scene implies them: {per}")
    return per


def i_report(sys_, run: dict, n_blocks: int) -> dict:
    st = sys_.status()
    pump = np.asarray(run["pump_ms"])
    return dict(status={k: st[k] for k in ("synced", "nac", "systemId", "siteId", "tsbkCount", "tsbkCrcRate",
                                           "tsbkCountSteady", "tsbkCrcRateSteady")},
                pump_ms_per_block=dict(mean=float(pump.mean()), warm_mean=float(pump[2:].mean()), max=float(pump.max())),
                dispatch_ms_per_dispatch=dict(mean=float(np.mean(run["dispatch_ms"])),
                                              warm_mean=float(np.mean(run["dispatch_ms"][1:])),
                                              per_dispatch=run["dispatch_ms"]),
                block_ms=run["block_size"] / I_FS * 1e3, blocks=n_blocks, engine_ms_per_dispatch=run["perf"])


def i_imbe_decode(calls: dict, flipped: dict):
    """``i_calls``'s ``decode`` for Phase 1: the recorded codewords (the
    call's ``.imbe``, 144 coded bits each as received) are the ones sent
    once the IMBE FEC has decoded both (the raw bits the air path flipped
    are counted in ``flipped``), and the PCM a fresh ``VoiceDecoder``
    gives for the recorded codewords, 9 a frame."""
    def decode(tgid, files):
        from wavecap_tpu_torch.decoders.voice import VoiceDecoder, imbe_fec_decode

        sent = [np.asarray(c, np.uint8)[:144] for c in calls[tgid]["codewords"]]
        raw = np.frombuffer(files[".imbe"].read_bytes() if ".imbe" in files else b"", np.uint8)
        got = [np.unpackbits(raw[18 * i: 18 * i + 18])[:144] for i in range(len(raw) // 18)]
        flipped[tgid] = int(sum(np.sum(a != b) for a, b in zip(got, sent)))
        as_sent = len(got) == len(sent) and all(
            (fa := imbe_fec_decode(a)) is not None and (fb := imbe_fec_decode(b)) is not None and fa.u == fb.u
            for a, b in zip(got, sent))
        dec = VoiceDecoder()
        pcm = [dec.decode_codewords(got[9 * k: 9 * k + 9]) for k in range(len(got) // 9)]
        return as_sent, np.concatenate([p for p in pcm if p is not None and len(p)] or [np.zeros(0, np.float32)])
    return decode


def run_program_i1(device, samples=None, mesh: str | None = None) -> dict:
    """I1: P25 Phase 1 on the engine, the reference's default deployment
    (``TrunkingSystemConfig``: 2.4 Msps, i8 words, 4 voice recorders; C4FM):
    the system locks the control channel, learns its NAC, system, site and
    IDEN_UP, follows two talkgroups' grants onto two recorders, and each
    call's TDU ends it: WAV, IMBE frames and sidecar written."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="program_i1_")
    t_all = time.perf_counter()
    try:
        cfg = i_config("i1" if mesh is None else "i5", os.path.join(tmp, "rec"), mesh=mesh)
        with i_clock() as clock:
            s = i_system(cfg, device, os.path.join(tmp, "state"))
            i_start(s)
            try:
                check(s.config.sample_rate == I_FS and s.config.transport == "i8" and s.config.max_voice_channels == 4
                      and s.capture.config.p25_modulation == "c4fm", "I1 is not the default deployment")
                bs = s.capture.block_size
                check(mesh is not None or bs == I_BLOCK, f"I1: {bs}-sample blocks, not {I_BLOCK}")
                x, sent, calls = i1_scene(I1_BLOCKS, I_BLOCK)
                if samples is None:
                    samples = np.concatenate(i_blocks(x, I1_BLOCKS, I_BLOCK))
                del x
                # the same samples in the capture's blocks (the mesh's are shorter: M x 8 shards)
                check(len(samples) % bs == 0, f"I1's {len(samples)} samples are not whole {bs}-sample blocks")
                blocks = [samples[i: i + bs] for i in range(0, len(samples), bs)]
                n_blocks = len(blocks)
                t_run = time.perf_counter()
                run = i_drive(s, blocks, clock)
                run_s = time.perf_counter() - t_run
                st = s.status()
                check(st["synced"] and st["nac"] == I_NAC and st["systemId"] == I_SYSTEM and st["siteId"] == I_SITE,
                      f"I1: not locked on the site: {st}")
                iden = s.identifiers.get(1)
                check(iden is not None and abs(iden.base_freq_mhz - I_BASE_MHZ) < 1e-6
                      and abs(iden.channel_spacing_khz - 12.5) < 1e-9, f"I1: IDEN_UP not learned: {s.identifiers}")
                tsbks = i_tsbks(s, run, sent, "I1")
                counted = (n_blocks - I_FIRST) * int(bs / I_FS * 4800)
                lo, hi = g_sent_bounds(counted, 360, 3)
                check(lo <= tsbks["messages"] <= hi, f"I1: {tsbks['messages']} TSBKs, not {lo} .. {hi}")
            finally:
                i_stop(s)
        flipped = {}
        result = i_calls(s, calls, cfg["recording_dir"], i_imbe_decode(calls, flipped), "I1" if mesh is None else "I5")
        for g in result:
            result[g]["imbe_bits_flipped"] = flipped[g]
        report = dict(tsbks=tsbks, tsbk_bounds=[lo, hi], tsbks_since=i_counted_since(run, I1_SAME_S), calls=result,
                      **i_report(s, run, n_blocks), run_s=run_s)
        if mesh is None:
            report["launches_per_block"] = i_launches(run, n_blocks, I_IMPLIED["c4fm"], "I1")
            report["vs_cpu"] = i_vs_cpu(cfg, blocks, device, tmp)
        else:
            report["launches_per_block"] = i_launches(run, n_blocks, I_IMPLIED["c4fm"], "I5")
        report.update(phase=f"trunking on the engine, {'I5 (I1 on the mesh ' + mesh + ')' if mesh else 'I1 (P25 Phase 1, C4FM)'}",
                      wall_s=time.perf_counter() - t_all, _samples=samples,
                      _wav={g: i_wav_pcm(i_files(cfg["recording_dir"], g)[".wav"]).tobytes() for g in calls})
        return report
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def run_program_i2(device) -> dict:
    """I2: P25 Phase 2: the CQPSK control channel (4800 baud, with the
    dedicated probe slot beside it) and the TDMA carrier on the 6000-baud
    bank, a call in each slot; each recorder's Phase 2 path takes its slot's
    superframe fragments, its MAC PDUs (PTT: the source; END_PTT: the end)
    and AMBE+2 voice to PCM."""
    import tempfile

    from wavecap_tpu_torch.decoders import p25_phase2 as p2
    from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeDecoder

    tmp = tempfile.mkdtemp(prefix="program_i2_")
    t_all = time.perf_counter()
    try:
        cfg = i_config("i2", os.path.join(tmp, "rec"), protocol="p25_phase2")
        with i_clock() as clock:
            s = i_system(cfg, device, os.path.join(tmp, "state"))
            i_start(s)
            try:
                cap = s.capture
                check(cap.channels["probe"].mode_group == "p25" and cap.config.p25_modulation == "cqpsk"
                      and cap.config.p25p2_capacity == 4, "I2: not the Phase 2 capture")
                x, sent, calls, frags, lead = i2_scene(I2_BLOCKS, cap.block_size)
                blocks = i_blocks(x, I2_BLOCKS, cap.block_size)
                del x
                taps = i_taps(s)
                t_run = time.perf_counter()
                run = i_drive(s, blocks, clock)
                run_s = time.perf_counter() - t_run
                st = s.status()
                check(st["synced"] and st["nac"] == I_NAC and st["systemId"] == I_SYSTEM, f"I2: not locked: {st}")
                ident = s.identifiers.get(2)
                check(ident is not None and ident.is_tdma and ident.slots_per_carrier == 2, f"I2: no TDMA identifier")
                tsbks = i_tsbks(s, run, sent, "I2")
                starts = {e["tgid"]: e["recorder"] for e in s.events if e["type"] == "call_start"}
            finally:
                i_stop(s)
        call_frags = [f.astype(np.uint8).tobytes() for f in frags]
        other = {f.astype(np.uint8).tobytes() for f in lead}
        per_slot = {}
        for g, slot in I2_CALLS:
            # from the retune on: signalling fragments (the first after the retune may be cut or
            # misread), the call's (each as sent, none missed), signalling
            log = taps[f"voice{starts[g]}"]
            got = log["fragments"]
            at = got.index(call_frags[0]) if call_frags[0] in got else -1
            check(at >= 0 and got[at:at + len(call_frags)] == call_frags,
                  f"I2: talkgroup {g}'s recorder found {len(got)} fragments, not the call's {len(call_frags)} "
                  f"amid signalling ({sum(f in call_frags for f in got)} of the call's as sent)")
            macs = [m for m in log["mac"] if m != "null"]
            ptt_end = [m for m in macs if json.loads(m)["mac"] in ("PTT", "END_PTT")]
            check(len(ptt_end) == 2 and all(m in sent for m in macs), f"I2: talkgroup {g}: MAC PDUs {ptt_end}")
            rest = got[:at] + got[at + len(call_frags):]
            # signalling fragments misread while the slot acquires after its retune: their bursts that
            # do not decode as MAC are the recorder's voice too (trunking/recorder.py's rule), counted
            misread = [np.frombuffer(f, np.uint8) for f in rest if f not in other]
            kinds = "".join("c" if f in call_frags else "s" if f in other else "x" for f in got)
            check(kinds.lstrip("x").count("x") == 0 and len(misread) <= I2_ACQUIRE_FRAGMENTS,
                  f"I2: talkgroup {g}: fragments {kinds} (c: the call's, s: signalling, x: misread): misread "
                  f"past the {I2_ACQUIRE_FRAGMENTS} the retune may take")
            voice = i2_voice_bursts(misread, slot) + i2_voice_bursts(frags, slot)
            calls[g]["frames"], calls[g]["bursts"] = len(voice), voice
            per_slot[g] = dict(fragments=len(call_frags), signalling_fragments=len(rest),
                               signalling_as_sent=len(rest) - len(misread), misread_bursts=len(voice) - len(
                                   i2_voice_bursts(frags, slot)), mac_pdus=len(macs))

        def decode(tgid, files):
            want = calls[tgid]["bursts"]
            got = files[".ambe"].read_bytes() if ".ambe" in files else b""
            dec = AmbeDecoder()
            pcm = [dec.decode_frames(p2.extract_voice_frames(np.frombuffer(got, np.uint8)[180 * i: 180 * i + 180]))
                   for i in range(len(got) // 180)]
            return got == b"".join(want), np.concatenate([p for p in pcm if p is not None and len(p)]
                                                         or [np.zeros(0, np.float32)])

        result = i_calls(s, calls, cfg["recording_dir"], decode, "I2")
        for g in result:
            result[g].update(per_slot[g])
        report = dict(phase="trunking on the engine, I2 (P25 Phase 2: CQPSK control, 6000-baud TDMA voice)",
                      tsbks=tsbks, calls=result, launches_per_block=i_launches(run, I2_BLOCKS, I_IMPLIED["phase2"], "I2"),
                      vs_cpu=i_vs_cpu(cfg, blocks, device, tmp), **i_report(s, run, I2_BLOCKS), run_s=run_s,
                      wall_s=time.perf_counter() - t_all)
        return report
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def i2_voice_bursts(frags: np.ndarray, slot: int) -> list:
    """The voice bursts (not MAC) a slot carries in the fragments, as bytes."""
    from wavecap_tpu_torch.decoders import p25_mac
    from wavecap_tpu_torch.decoders.p25_phase2 import FRAGMENT_DIBITS

    out = []
    for f in frags:
        for pos in range(4):
            # positions 0 and 2 are slot 0's, 1 and 3 slot 1's
            if pos % 2 != slot:
                continue
            b = f[180 * pos: 180 * (pos + 1)]
            m = p25_mac.decode_burst(b)
            if m is not None and m[0] in (p25_mac.BURST_SACCH, p25_mac.BURST_FACCH):
                continue
            out.append(b.astype(np.uint8).tobytes())
    assert FRAGMENT_DIBITS == 720
    return out


def run_program_i3(device) -> dict:
    """I3: DMR Tier III: CSBK PV_GRANTs on the control channel map
    logical channels 49 and 50 to both slots of one carrier; the recorders
    follow the CACH slot tags, each call's AMBE frames to PCM, ended by
    the hold after the voice."""
    import tempfile

    from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeDecoder

    tmp = tempfile.mkdtemp(prefix="program_i3_")
    t_all = time.perf_counter()
    try:
        cfg = i_config("i3", os.path.join(tmp, "rec"), protocol="dmr_tier3", dmr_base_hz=I_BASE_MHZ * 1e6)
        with i_clock() as clock:
            s = i_system(cfg, device, os.path.join(tmp, "state"))
            i_start(s)
            try:
                x, sent, calls = i3_scene(I3_BLOCKS, s.capture.block_size)
                blocks = i_blocks(x, I3_BLOCKS, s.capture.block_size)
                del x
                t_run = time.perf_counter()
                run = i_drive(s, blocks, clock)
                run_s = time.perf_counter() - t_run
                check(s.status()["synced"], "I3: the DMR control channel is not locked")
                csbks = i_tsbks(s, run, sent, "I3", fields=i3_fields)
                check(any(m.get("type") == "PV_GRANT" for m in s.message_log), "I3: no PV_GRANT logged")
                check(not any(e["type"] == "grant_same_carrier_busy" for e in s.events), "I3: a grant was refused")
            finally:
                i_stop(s)

        raw_bits = {}

        def pcm_of(bits):
            dec = AmbeDecoder()
            pcm = [dec.decode_frames(bits[18 * k: 18 * k + 18]) for k in range(len(bits) // 18)]
            return np.concatenate([p for p in pcm if p is not None and len(p)] or [np.zeros(0, np.float32)])

        def decode(tgid, files):
            # the recorded AMBE frames (72 coded bits each, as received) are the frames sent but for
            # the bits the air path flipped (counted; at most I3_MAX_BER of them)
            got = files[".ambe"].read_bytes() if ".ambe" in files else b""
            want = calls[tgid]["ambe"]
            bits = np.unpackbits(np.frombuffer(got, np.uint8)).reshape(-1, want.shape[1]) if got else want[:0]
            raw_bits[tgid] = int(np.sum(bits != want)) if bits.shape == want.shape else None
            return bits.shape == want.shape and raw_bits[tgid] <= I3_MAX_BER * want.size, pcm_of(bits)

        result = i_calls(s, calls, cfg["recording_dir"], decode, "I3")
        for g in result:
            result[g]["ambe_bits_flipped"] = raw_bits[g]
        return dict(phase="trunking on the engine, I3 (DMR Tier III: CSBK grants, both slots of one carrier)",
                    csbks=csbks, calls=result, launches_per_block=i_launches(run, I3_BLOCKS, I_IMPLIED["c4fm"], "I3"),
                    vs_cpu=i_vs_cpu(cfg, blocks, device, tmp), **i_report(s, run, I3_BLOCKS), run_s=run_s,
                    wall_s=time.perf_counter() - t_all)
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def run_program_i4(device) -> dict:
    """I4: ``TrunkingProcessManager`` spawns one worker on ``device`` (the
    card) for I1's control channel, looped by the worker's fake receiver;
    its ``status`` RPC answers with the system synced and TSBKs counted,
    ``ping`` answers, and ``stop_all`` leaves no worker and no process."""
    import tempfile

    from wavecap_tpu_torch.trunking.process_manager import TrunkingProcessManager

    tmp = tempfile.mkdtemp(prefix="program_i4_")
    t_all = time.perf_counter()
    mgr = None
    proc = None
    try:
        x, _, _ = i1_scene(8, I_BLOCK)
        mgr = TrunkingProcessManager(state_dir=os.path.join(tmp, "state"), driver="fake", device=device,
                                     stations=[dict(offset_hz=0.0, kind="iq_loop", iq_loop=x, amplitude=1.0)])
        mgr.add_system(i_config("i4", os.path.join(tmp, "rec")))
        mgr.start()
        proc = mgr.workers["default"].process
        check(mgr.workers["default"].worker_cfg["device"] == str(torch_device(device)),
              f"I4: the worker config names {mgr.workers['default'].worker_cfg.get('device')}")
        t0, st, polls = time.perf_counter(), None, 0
        while True:
            check(time.perf_counter() - t0 < I4_TIMEOUT_S, f"I4: the worker was not synced with TSBKs counted within "
                  f"{I4_TIMEOUT_S} s: {st}")
            check(proc.is_alive(), f"I4: the worker died: {mgr.status()}")
            try:
                got = mgr.rpc("default", "status", timeout=10.0)
                polls += 1
                st = got[0] if got else None
                if st and st["synced"] and st["tsbkCount"] > 0:
                    break
            except (TimeoutError, RuntimeError):
                pass
            time.sleep(0.5)
        first_s = time.perf_counter() - t0
        pong = mgr.rpc("default", "ping", timeout=10.0)
        check(pong["pong"] > 0, "I4: no ping")
        mgr.stop_all()
        check(not mgr.workers, "I4: stop_all left a worker")
        proc.join(timeout=30)
        check(not proc.is_alive(), "I4: the worker process is still alive after stop_all")
        return dict(phase="trunking worker process on the card (I4)", synced_after_s=first_s, polls=polls,
                    status={k: st[k] for k in ("state", "synced", "nac", "tsbkCount", "tsbkCrcRate")},
                    exitcode=proc.exitcode, wall_s=time.perf_counter() - t_all)
    finally:
        if mgr is not None and mgr.workers:
            mgr.stop_all()
        if proc is not None and proc.is_alive():
            proc.terminate()
            proc.join(timeout=10)
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def run_program_i(device) -> dict:
    """Program I: the port's trunking on the engine, I1-I5."""
    t0 = time.perf_counter()
    i1 = run_program_i1(device)
    samples, wav = i1.pop("_samples"), i1.pop("_wav")
    log(i1)
    log(run_program_i2(device))
    log(run_program_i3(device))
    log(run_program_i4(device))
    os.environ["WAVECAP_TORCH_DEVICE_COUNT"] = str(MESH_SHARDS)
    i5 = run_program_i1(device, samples=samples, mesh=MESH_SPEC)
    i5.pop("_samples")
    mesh_wav = i5.pop("_wav")
    # the same samples in 0.12 s blocks: the site, and the control messages from the first block edge
    # the two block lengths share on (the first blocks acquire differently)
    keys = ("synced", "nac", "systemId", "siteId")
    check({k: i5["status"][k] for k in keys} == {k: i1["status"][k] for k in keys}
          and i5["tsbks_since"] == i1["tsbks_since"] and i1["tsbks_since"]["total"] == i1["tsbks_since"]["ok"],
          f"I5: the mesh's control channel {i5['status']}, {i5['tsbks_since']} differs from I1's "
          f"{i1['status']}, {i1['tsbks_since']}")
    # a call's timing follows the blocks' edges, and the raw bits flipped are counted, not compared
    same = ("frequency_hz", "slot", "source", "frames", "audio_s")
    check({g: {k: c[k] for k in same} for g, c in i5["calls"].items()}
          == {g: {k: c[k] for k in same} for g, c in i1["calls"].items()},
          f"I5: the mesh's calls {i5['calls']} differ from I1's {i1['calls']}")
    check(mesh_wav == wav, "I5: the mesh's WAVs differ from I1's")
    i5["same_as_i1"] = dict(control_channel={k: i1["status"][k] for k in keys}, tsbks_since=i1["tsbks_since"],
                            calls=same, wav=True)
    log(i5)
    return dict(phase="program I", wall_s=time.perf_counter() - t0)


# --- program J: the server, the harness and the CLI on the card (phase 14) -------------------------

# the shipped deployment (wavecap.yaml.example) as a dict: no PyYAML on the card's machine
J_SHIPPED = {
    "server": {"host": "127.0.0.1", "port": 0},
    "stream": {"audio_rate": 48000, "fft_size": 2048, "spectrum_fps": 10.0},
    "limits": {"max_captures": 4, "max_channels_per_capture": 8, "max_wide_channels": 2, "max_p25_channels": 4},
    "device": {"driver": "fake"},
    "recovery": {"watchdog_timeout_s": 30.0, "startup_timeout_s": 45.0, "max_restarts_per_hour": 6},
    "captures": [{"id": "fm", "center_hz": 90.3e6, "sample_rate": 2.4e6, "auto_start": True,
                  "channels": [{"id": "kexp", "mode": "wbfm", "frequency_hz": 90.3e6, "name": "KEXP"}]}],
    "pocsag_aliases": {"1234567": "City Fire Dispatch"},
    "trunking_systems": [{"id": "example-p25", "name": "Example P25 System",
                          "control_channels": [851.2e6, 852.35e6], "sample_rate": 2.4e6, "hunt_mode": "hunt",
                          "max_voice_channels": 4, "auto_start": False,
                          "talkgroups": [{"tgid": 101, "name": "PD Dispatch", "priority": 1, "record": True},
                                         {"tgid": 201, "name": "FD Dispatch", "priority": 2, "record": True}]}],
}
J_RATE_LIMIT = 1_000_000  # the route walk makes more calls a minute than the shipped limiter allows
J_NEEDS_YAML = ("/recipes", "/identify")  # routes that read YAML (recipes; band names through utils/namers.py)
# J2: (capture id, device, centre Hz, rate, channels: (mode, offset Hz or None for an empty channel, tone Hz))
J2_CAPTURES = (
    ("wide10", "fake0", 152.0e6, 10_000_000,
     (("nbfm", 100e3, 1000.0), ("nbfm", -1.2e6, 1500.0), ("nbfm", 2.05e6, 700.0), ("am", 3.1e6, 900.0),
      ("am", -2.5e6, 1100.0), ("nbfm", 1.3e6, None), ("nbfm", -3.3e6, None), ("am", 4.1e6, None),
      ("wbfm", 1.6e6, 440.0), ("wbfm", -4.0e6, None),
      ("p25", -3.6e6, "cc"), ("p25", -3.8e6, None), ("p25", 3.5e6, None), ("p25", 0.6e6, None))),
    ("vhf", "fake1", 155.0e6, 2_400_000,
     (("nbfm", 100e3, 1000.0), ("am", -300e3, 800.0), ("wbfm", 600e3, 440.0), ("nbfm", -500e3, None))),
    ("uhf", "fake2", 460.0e6, 2_400_000,
     (("nbfm", -150e3, 1300.0), ("am", 250e3, 600.0), ("wbfm", -700e3, 440.0), ("nbfm", 450e3, None))),
    ("air", "fake3", 120.0e6, 2_400_000,
     (("am", 50e3, 1000.0), ("nbfm", -350e3, 900.0), ("wbfm", 800e3, 440.0), ("am", -600e3, None))),
)
J2_AMPLITUDE = 0.05
J2_SQUELCH_DB = -50.0
J2_BLOCKS = 8  # audio blocks collected a channel
J2_PARITY = "vhf"  # the capture whose first channel is held against the CPU engine
J3_TIMEOUT_S = 240.0
J4_TIMEOUT_S = 300.0


class JDriver:
    """The fake driver with a scene a device: ``scenes`` maps a device id to
    its ``FakeStation`` list."""

    name = "fake"

    def __init__(self, scenes: dict):
        from wavecap_tpu_torch.devices import FakeDriver

        self.scenes = scenes
        self._fake = FakeDriver(n_devices=len(scenes))

    def enumerate(self):
        return self._fake.enumerate()

    def open(self, device_id: str):
        dev = self._fake.open(device_id)
        dev.stations = self.scenes[device_id]
        return dev


class JServer:
    """The port's ``AppServer`` on ``device`` in an event loop of its own
    thread (the tests' ``ServerHarness``); ``driver`` replaces the
    configured one before the boot, as ``harness.py`` does."""

    def __init__(self, cfg: dict, device, driver=None):
        import asyncio
        import threading

        from wavecap_tpu_torch.server.app import AppServer
        from wavecap_tpu_torch.utils.config import config_from_dict

        self.server = AppServer(config_from_dict(cfg), device=device)
        if driver is not None:
            self.server.state.driver = driver
            self.server.state.captures.driver = driver
        self.loop = asyncio.new_event_loop()
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        import asyncio

        asyncio.set_event_loop(self.loop)

        async def boot():
            await self.server.start()
            self._started.set()

        self.loop.create_task(boot())
        self.loop.run_forever()

    def start(self) -> "JServer":
        self._thread.start()
        check(self._started.wait(120), "J: the server did not boot within 120 s")
        return self

    def stop(self) -> None:
        import asyncio

        async def shutdown():
            await self.server.stop()
            self.loop.stop()

        asyncio.run_coroutine_threadsafe(shutdown(), self.loop)
        self._thread.join(timeout=30)

    @property
    def port(self) -> int:
        return self.server.port

    @property
    def state(self):
        return self.server.state


def j_http(port: int, method: str, path: str, body=None, timeout: float = 60.0) -> tuple:
    """One request: (status, content type, body: JSON parsed, else bytes).
    A streaming body (not JSON) is not read."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        data = None if body is None else json.dumps(body).encode()
        conn.request(method, path, body=data, headers={"Content-Type": "application/json"} if data else {})
        r = conn.getresponse()
        kind = (r.getheader("content-type") or "").split(";")[0]
        if kind == "application/json":
            return r.status, kind, json.loads(r.read())
        return r.status, kind, None
    finally:
        conn.close()


def j_api(port: int, method: str, path: str, body=None):
    status, _, out = j_http(port, method, "/api/v1" + path, body)
    check(status < 300, f"J: {method} {path} answered {status}: {out}")
    return out


def j_shape(answer: tuple):
    """Status and JSON key sets (a list: the union of its elements' keys;
    capture ids, which a process numbers across its servers, as ``cap*``);
    other bodies by content type."""
    import re

    status, kind, body = answer
    keys = lambda d: {re.sub(r"^cap\d+$", "cap*", k) for k in d}  # noqa: E731
    if isinstance(body, dict):
        return status, sorted(keys(body))
    if isinstance(body, list):
        return status, "list", sorted({k for x in body if isinstance(x, dict) for k in keys(x)})
    return status, kind


class JWs:
    """A minimal WebSocket client (RFC 6455) on a socket: the upgrade,
    frames read (pings answered) and sent masked, the close."""

    def __init__(self, port: int, path: str, timeout: float = 30.0):
        import base64
        import hashlib
        import socket

        self.sock = socket.create_connection(("127.0.0.1", port), timeout=timeout)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall(f"GET {path} HTTP/1.1\r\nHost: 127.0.0.1:{port}\r\nUpgrade: websocket\r\n"
                          f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                          f"Sec-WebSocket-Version: 13\r\n\r\n".encode())
        self.buf = b""
        while b"\r\n\r\n" not in self.buf:
            chunk = self.sock.recv(4096)
            check(bool(chunk), f"J: {path}: the server closed during the upgrade")
            self.buf += chunk
        head, self.buf = self.buf.split(b"\r\n\r\n", 1)
        accept = base64.b64encode(hashlib.sha1((key + "258EAFA5-E914-47DA-95CA-C5AB0DC85B11").encode())
                                  .digest()).decode()
        head = head.decode("latin1")
        check(head.split(" ", 2)[1] == "101" and accept in head, f"J: {path}: upgrade refused: {head[:80]}")

    def _read(self, n: int) -> bytes:
        while len(self.buf) < n:
            chunk = self.sock.recv(1 << 16)
            if not chunk:
                raise ConnectionError("websocket closed")
            self.buf += chunk
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def send(self, opcode: int, payload: bytes = b"") -> None:
        import struct

        n = len(payload)
        head = bytes([0x80 | opcode]) + (bytes([0x80 | n]) if n < 126 else bytes([0x80 | 126]) + struct.pack(">H", n))
        mask = os.urandom(4)
        self.sock.sendall(head + mask + bytes(b ^ mask[i % 4] for i, b in enumerate(payload)))

    def recv(self, timeout: float = 60.0):
        """The next data message: bytes, or str for text."""
        import struct

        self.sock.settimeout(timeout)
        parts, kind = [], None
        while True:
            h = self._read(2)
            fin, op, n = h[0] & 0x80, h[0] & 0x0F, h[1] & 0x7F
            if n == 126:
                n = struct.unpack(">H", self._read(2))[0]
            elif n == 127:
                n = struct.unpack(">Q", self._read(8))[0]
            payload = self._read(n)
            if op == 0x9:
                self.send(0xA, payload)
                continue
            if op == 0x8:
                raise ConnectionError("websocket closed by the server")
            if op in (0x1, 0x2):
                kind, parts = op, [payload]
            elif op == 0x0:
                parts.append(payload)
            if fin and kind is not None:
                data = b"".join(parts)
                return data.decode() if kind == 0x1 else data

    def close(self) -> None:
        try:
            self.send(0x8, b"\x03\xe8")
        except OSError:
            pass
        self.sock.close()


def j_until(pred, what: str, timeout: float = 120.0, dt: float = 0.01) -> float:
    """Wait on a count (``pred``, a subscriber or block count); the seconds."""
    t0 = time.perf_counter()
    while not pred():
        check(time.perf_counter() - t0 < timeout, f"J: never {what} within {timeout} s")
        time.sleep(dt)
    return time.perf_counter() - t0


def j_spec_routes(path: str = os.path.join(os.path.dirname(os.path.abspath(__file__)), "docs", "api-spec.md")) -> list:
    """(method, path) of ``docs/api-spec.md``'s tables, parsed as
    ``tests/test_api_conformance.py`` parses them (``WS`` for the WebSocket
    table; a one-segment continuation replaces the base's last segment)."""
    import re

    out, in_ws = [], False
    for line in open(path).read().splitlines():
        if line.startswith("## "):
            in_ws = "WebSocket" in line
        if line.startswith("## Reference endpoint"):
            break
        if not line.startswith("|"):
            continue
        cells = [c.strip() for c in line.strip("|").split("|")]
        if len(cells) < 2 or cells[0] in ("Method", "Path", "---") or set(cells[0]) <= {"-"}:
            continue
        if in_ws:
            out.extend(("WS", p) for p in re.findall(r"`(/[^`\s?]+)", cells[0]))
            continue
        methods = [m for m in re.split(r"[/,\s]+", cells[0]) if m.isupper()]
        base = None
        for p in re.findall(r"`([^`]+)`", cells[1]) if methods else []:
            p = p.split("?")[0]
            if not p.startswith("/"):
                continue
            if base is None or p.count("/") > 1:
                base = p
            else:
                p = base.rsplit("/", 1)[0] + p
            out.extend((m, p) for m in methods)
    return out


def j_spec_fill(path: str) -> str:
    import re

    path = path.replace("\\", "")
    path = re.sub(r"\{freqHz\}", "851200000", path)
    path = re.sub(r"\{tgid\}", "101", path)
    path = re.sub(r"\{recorderId\}|\{rid\}|\{streamId\}", "0", path)
    path = re.sub(r"\{name\}", "call", path)
    return re.sub(r"\{[^}]+\}", "x1", path)


def j_smoke_ids(port: int) -> dict:
    """``tests/test_route_smoke.py``'s live ids: a capture, a channel, a
    trunking system (not started) and a scanner (not started)."""
    cap = j_api(port, "POST", "/captures", {"centerHz": 155e6, "sampleRate": 800_000})
    ch = j_api(port, "POST", f"/captures/{cap['id']}/channels", {"mode": "nbfm", "frequencyHz": 155.05e6})
    j_api(port, "POST", "/trunking/systems", {"id": "smoke1", "control_channels": [851.2e6],
                                             "sample_rate": 2_400_000})
    scn = j_api(port, "POST", "/scanners", {"captureId": cap["id"], "channelId": ch["id"],
                                           "entries": [{"frequencyHz": 155.05e6}], "autoStart": False})
    return {"cid": cap["id"], "chid": ch["id"], "sid": "smoke1", "rid": "airband", "did": "fake0",
            "scanner": scn["id"]}


def j_walk_urls(router, ids: dict) -> list:
    import re

    urls = []
    for method, rx, _ in router.routes:
        if method != "GET":
            continue
        pat = rx.pattern.strip("^$")

        def fill(m, pat=pat):
            name = m.group(1)
            if name == "sid":
                return ids["sid"] if "/trunking/" in pat else ids["scanner"]
            return ids.get(name, "dummy")

        url = re.sub(r"\(\?P<(\w+)>[^)]*\)", fill, pat).replace("\\", "")
        if "(" not in url:
            urls.append(url)
    return urls


def j_ws_urls(router, ids: dict) -> list:
    import re

    urls = []
    for rx, _ in router.ws_routes:
        url = re.sub(r"\(\?P<(\w+)>[^)]*\)", lambda m: {"cid": ids["cid"], "chid": ids["chid"],
                                                           "sid": ids["sid"]}.get(m.group(1), "dummy"),
                     rx.pattern.strip("^$"))
        if "(" not in url:
            urls.append(url)
    return urls


# tests/test_server.py's CRUD, error, metrics and trunking calls: (name, method, path, body)
J1_SCRIPT = (
    ("create capture", "POST", "/captures", {"centerHz": 155e6, "sampleRate": 800_000}),
    ("create channel", "POST", "/captures/{cid}/channels", {"mode": "nbfm", "frequencyHz": 155.1e6, "name": "t"}),
    ("get capture", "GET", "/captures/{cid}", None),
    ("patch channel", "PATCH", "/channels/{chid}", {"name": "renamed", "squelchDb": -40}),
    ("spectrum of a stopped capture", "GET", "/captures/{cid}/spectrum", None),
    ("delete channel", "DELETE", "/channels/{chid}", None),
    ("stop capture", "POST", "/captures/{cid}/stop", None),
    ("delete capture", "DELETE", "/captures/{cid}", None),
    ("unknown capture", "GET", "/captures/nope", None),
    ("delete unknown channel", "DELETE", "/channels/nope", None),
    ("channel out of range", "POST", "/captures/fm/channels", {"mode": "nbfm", "frequencyHz": 999e9}),
    ("channel without frequency", "POST", "/captures/fm/channels", {"mode": "nbfm"}),
    ("create system", "POST", "/trunking/systems",
     {"id": "tsys", "control_channels": [851.2e6], "sample_rate": 960_000,
      "talkgroups": [{"tgid": 100, "name": "Dispatch"}]}),
    ("talkgroups", "GET", "/trunking/systems/tsys/talkgroups", None),
    ("calls", "GET", "/trunking/systems/tsys/calls", None),
    ("delete system", "DELETE", "/trunking/systems/tsys", None),
)


def j_surface(srv: JServer) -> dict:
    """The REST script, then the route smoke's walk over every GET route
    with live ids, then its ids removed: each answer's shape."""
    out, ids = {}, {}
    for name, method, path, body in J1_SCRIPT:
        ans = j_http(srv.port, method, "/api/v1" + path.format(**ids), body)
        if name == "create capture":
            ids["cid"] = ans[2]["id"]
        if name == "create channel":
            ids["chid"] = ans[2]["id"]
        out[name] = j_shape(ans)
    ids = j_smoke_ids(srv.port)
    for url in j_walk_urls(srv.server.router, ids):
        out[url.replace(ids["cid"], "{cid}").replace(ids["chid"], "{chid}").replace(ids["scanner"], "{scan}")] = \
            j_shape(j_http(srv.port, "GET", url))
    ws = {}
    for url in j_ws_urls(srv.server.router, ids):
        w = JWs(srv.port, url)
        w.close()
        ws[url] = True
    j_api(srv.port, "DELETE", f"/scanners/{ids['scanner']}")
    j_api(srv.port, "DELETE", f"/captures/{ids['cid']}")
    j_api(srv.port, "DELETE", "/trunking/systems/smoke1")
    return dict(answers=out, ws=len(ws))


def run_program_j1(device) -> dict:
    """J1, the surface: the shipped deployment on the card and on the CPU
    (the port's servers, the fake driver): the route smoke and the
    conformance calls answer alike."""
    t0 = time.perf_counter()
    cfg = json.loads(json.dumps(J_SHIPPED))
    cfg["server"]["rate_limit_per_min"] = J_RATE_LIMIT
    card = JServer(cfg, device).start()
    cpu = None
    try:
        fm = card.state.get_capture("fm")
        boot_s = j_until(lambda: fm.blocks_processed > 0, "the shipped fm capture processed a block")
        check(fm.status()["device"] == str(torch_device(device)), f"J1: fm runs on {fm.status()['device']}")
        cpu = JServer(cfg, "cpu").start()
        card_s, cpu_s = j_surface(card), j_surface(cpu)
        held = {k: v for k, v in card_s["answers"].items() if not any(y in k for y in J_NEEDS_YAML)}
        apart = {k: (v, cpu_s["answers"].get(k)) for k, v in card_s["answers"].items() if k not in held}
        differ = {k: (v, cpu_s["answers"].get(k)) for k, v in held.items() if cpu_s["answers"].get(k) != v}
        check(not differ, f"J1: the card's server answers differently from the CPU's: {differ}")
        server_errors = {k: v for k, v in held.items() if isinstance(v[0], int) and v[0] >= 500 and v[0] != 501}
        check(not server_errors, f"J1: 5xx answers: {server_errors}")
        router = card.server.router
        missing = []
        for method, path in j_spec_routes():
            concrete = "/api/v1" + j_spec_fill(path)
            if method == "WS":
                ok = router.find_ws(concrete)[0] is not None
            else:
                try:
                    ok = router.find(method, concrete)[0] is not None
                except Exception:
                    ok = True  # 405: the path exists with another method
            if not ok:
                missing.append((method, path))
        check(not missing, f"J1: spec routes not registered: {missing}")
        check(card_s["ws"] == len(router.ws_routes) >= 10, f"J1: {card_s['ws']} WebSocket routes answered the upgrade")
        return dict(phase="program J1: the server's surface on the card", boot_to_first_block_s=boot_s,
                    held=len(held), needs_pyyaml=apart, ws_routes=card_s["ws"], spec_routes=len(j_spec_routes()),
                    routes=[len(router.routes), len(router.ws_routes)], fm=fm.status()["transportActive"],
                    wall_s=time.perf_counter() - t0)
    finally:
        if cpu is not None:
            cpu.stop()
        card.stop()


def j2_scene(rate: int, chans: tuple) -> list:
    """A capture's stations: an FM or AM tone a station, a WBFM one, and a
    looped C4FM control channel (``g_tsdu_loop``) for ``"cc"``."""
    from wavecap_tpu_torch.devices import FakeStation
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm_cyclic

    out = []
    for mode, off, tone in chans:
        if tone is None:
            continue
        if tone == "cc":
            dibits, _ = g_tsdu_loop(0x293, 7)
            out.append(FakeStation(**g_station(modulate_c4fm_cyclic(dibits, 48_000.0), rate, off, J2_AMPLITUDE)))
        elif mode == "am":
            out.append(FakeStation(offset_hz=off, kind="am", tone_hz=tone, amplitude=J2_AMPLITUDE))
        else:
            out.append(FakeStation(offset_hz=off, kind=mode, tone_hz=tone, amplitude=J2_AMPLITUDE,
                                   deviation_hz=75e3 if mode == "wbfm" else 4000.0))
    return out


def j_tone_db(pcm: np.ndarray, tone: float, rate: int = 48_000) -> float:
    """The tone's power against the rest of 100 Hz - 15 kHz, in dB."""
    x = pcm - pcm.mean()
    p = np.abs(np.fft.rfft(x * np.hanning(len(x)))) ** 2
    f = np.fft.rfftfreq(len(x), 1 / rate)
    band = (f >= 100) & (f <= 15_000)
    on = band & (np.abs(f - tone) <= 20)
    return 10 * np.log10(p[on].sum() / max(p[band & ~on].sum(), 1e-30))


def run_program_j2(device) -> dict:
    """J2: the server filled to the shipped limits through REST, every
    channel's audio and every capture's spectrum over WebSocket; one
    channel against the CPU engine fed the same blocks."""
    import dataclasses

    from wavecap_tpu_torch.capture import Capture, ChannelSpec
    from wavecap_tpu_torch.devices import FakeDriver
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts

    t_all = time.perf_counter()
    cfg = json.loads(json.dumps(J_SHIPPED))
    cfg.update(captures=[], trunking_systems=[])
    cfg["server"]["rate_limit_per_min"] = J_RATE_LIMIT
    scenes = {dev: j2_scene(rate, chans) for _, dev, _, rate, chans in J2_CAPTURES}
    srv = JServer(cfg, device, driver=JDriver(scenes)).start()
    socks = []
    try:
        port = srv.port
        plan, caps, label = {}, {}, {}
        for name, dev, center, rate, chans in J2_CAPTURES:
            cid = j_api(port, "POST", "/captures", {"deviceId": dev, "centerHz": center, "sampleRate": rate})["id"]
            caps[cid], label[name] = srv.state.get_capture(cid), cid
            for mode, off, tone in chans:
                ch = j_api(port, "POST", f"/captures/{cid}/channels",
                           {"mode": mode, "frequencyHz": center + off, "squelchDb": J2_SQUELCH_DB})
                plan[ch["id"]] = (cid, mode, off, tone)
        limits = cfg["limits"]
        check(len(caps) == limits["max_captures"], f"J2: {len(caps)} captures")
        statuses = j_api(port, "GET", "/captures")
        check({c["id"] for c in statuses} == set(caps) and all(c["device"] == str(torch_device(device))
                                                            for c in statuses), f"J2: captures {statuses}")
        # the parity capture: its dispatches (blocks, transport) and its first channel's audio, in process
        par = caps[label[J2_PARITY]]
        par_ch = next(i for i, p in plan.items() if p[0] == label[J2_PARITY])
        par_sub = par.channels[par_ch].audio.subscribe(maxsize=1024)
        dispatched = []
        real = par._dispatch_blocks

        def record(blocks):
            dispatched.append(([np.array(b) for b in blocks], par.transport_active))
            return real(blocks)

        par._dispatch_blocks = record
        audio = {i: [] for i, p in plan.items() if p[1] != "p25"}
        for chid in audio:
            socks.append((chid, JWs(port, f"/api/v1/stream/channels/{chid}")))
        spec_ws = {cid: JWs(port, f"/api/v1/stream/captures/{cid}/spectrum") for cid in caps}
        j_until(lambda: all(srv.state.find_channel(c)[1].audio.count >= 1 for c in audio)
                and all(c.spectrum_subs.count == 1 for c in caps.values()), "every stream subscribed")
        reset_launch_counts()
        first_audio = {}
        for cid in caps:
            t0 = time.perf_counter()
            j_api(port, "POST", f"/captures/{cid}/start")
            chid = next(i for i, p in plan.items() if p[0] == cid)
            w = dict(socks)[chid]
            audio[chid].append(w.recv(timeout=300))
            first_audio[cid] = time.perf_counter() - t0
        for chid, w in socks:
            while len(audio[chid]) < J2_BLOCKS:
                audio[chid].append(w.recv(timeout=300))
        spectra = {cid: json.loads(w.recv(timeout=60)) for cid, w in spec_ws.items()}
        for cid in caps:
            j_api(port, "POST", f"/captures/{cid}/stop")
        blocks = sum(c.blocks_processed for c in caps.values())
        launches = {k: round(v / blocks, 3) for k, v in launch_counts().items() if v}
        # warm: the parity capture again, its kernels and program built
        par._dispatch_blocks = real
        fresh = par.channels[par_ch].audio.subscribe(maxsize=4)  # as a client that connects now
        t0 = time.perf_counter()
        j_api(port, "POST", f"/captures/{label[J2_PARITY]}/start")
        check(fresh.get(timeout=300) is not None, "J2: no audio after the warm start")
        warm_s = time.perf_counter() - t0
        fresh.close()
        j_api(port, "POST", f"/captures/{label[J2_PARITY]}/stop")
        # each station's tone, the empty channels squelched
        lines, silent = {}, {}
        for chid, chunks in audio.items():
            cid, mode, off, tone = plan[chid]
            pcm = np.concatenate([np.frombuffer(c, np.int16) for c in chunks[2:]]).astype(np.float32) / 32768.0
            if tone is None:
                silent[chid] = float(np.abs(pcm).max()) if len(pcm) else 0.0
                if mode != "wbfm":
                    check(silent[chid] == 0.0, f"J2: empty {mode} channel {chid} of {cid} not squelched: "
                          f"peak {silent[chid]}")
            else:
                lines[chid] = round(j_tone_db(pcm, tone), 1)
                check(lines[chid] >= 20.0, f"J2: {mode} station {chid} of {cid} at {off} Hz: its {tone} Hz "
                      f"tone {lines[chid]} dB above the rest")
        peaks = {}
        for name, dev, center, rate, chans in J2_CAPTURES:
            cid = label[name]
            db = np.array(spectra[cid]["db"])
            n = len(db)
            for mode, off, tone in chans:
                if tone is None:
                    continue
                k = n // 2 + round(off / rate * n)
                # a frame catches a WBFM station anywhere in its +-75 kHz swing
                half = 3 if mode != "wbfm" else int(np.ceil(80e3 / (rate / n)))
                key = f"{name}{off:+.0f}"
                peaks[key] = round(float(db[max(k - half, 0):k + half + 1].max() - np.median(db)), 1)
                check(peaks[key] >= 15.0, f"J2: {name}'s spectrum has no peak at {off} Hz: {peaks[key]} dB over "
                      "the median")
        # the parity capture's first channel against the CPU engine fed the same dispatches inline
        card_pcm = []
        while (c := par_sub.get_nowait()) is not None:
            card_pcm.append(c)
        cpu_cap = Capture(FakeDriver(1).open("fake0"), dataclasses.replace(par.config), torch_device="cpu")
        for chid, (cid, mode, off, tone) in plan.items():
            if cid == label[J2_PARITY]:
                spec = srv.state.find_channel(chid)[1].spec
                cpu_cap.create_channel(ChannelSpec(id=spec.id, mode=spec.mode, frequency_hz=spec.frequency_hz,
                                                   squelch_db=spec.squelch_db, name=spec.name, dsp=dict(spec.dsp)))
        cpu_sub = cpu_cap.channels[par_ch].audio.subscribe(maxsize=1024)
        n_par = min(len(dispatched), 6)
        for batch, transport in dispatched[:n_par]:
            cpu_cap.transport_active = transport
            cpu_cap._dispatch_blocks(batch)
        cpu_pcm = []
        while (c := cpu_sub.get_nowait()) is not None:
            cpu_pcm.append(c)
        n_blk = sum(len(b) for b, _ in dispatched[:n_par])
        check(len(cpu_pcm) == n_blk and len(card_pcm) >= n_blk, f"J2: {len(card_pcm)} card and {len(cpu_pcm)} CPU "
              f"audio chunks for {n_blk} blocks")
        vs_cpu = [round(snr_db(cpu_pcm[k], card_pcm[k]), 1) for k in range(n_blk)]
        check(min(vs_cpu[1:]) >= 50.0, f"J2: {par_ch}'s audio against the CPU engine {vs_cpu} dB (>= 50 from "
              "block 2 on)")
        return dict(phase="program J2: streams at the shipped limits on the card", captures=len(caps),
                    channels={n: sum(1 for p in plan.values() if p[0] == c) for n, c in label.items()},
                    lines_db=lines, empty_peak=silent, spectrum_peaks_db=peaks,
                    vs_cpu_db=dict(channel=par_ch, blocks=vs_cpu, transports=[t for _, t in dispatched[:n_par]]),
                    first_audio_s=dict(cold={n: first_audio[c] for n, c in label.items()}, warm=warm_s),
                    blocks=blocks,
                    launches_per_block=launches, wall_s=time.perf_counter() - t_all)
    finally:
        for _, w in socks:
            w.close()
        for w in locals().get("spec_ws", {}).values():
            w.close()
        srv.stop()


def run_program_j3(device) -> dict:
    """J3, the inherited trunking case on the card: a P25 system in a
    worker process on the card (I1's scene looped by the worker's fake
    receiver; the worker runs on its own clock: program I's virtual clock
    cannot reach into it); the server's ``/trunking/stream/{sid}/voice``
    carries the worker's voice, the spectrum snapshot its spectrum."""
    import tempfile

    from wavecap_tpu_torch.trunking.process_manager import TrunkingProcessManager

    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="program_j3_")
    cfg = json.loads(json.dumps(J_SHIPPED))
    cfg.update(captures=[], trunking_systems=[], trunking_workers={"mode": "per_device"})
    srv = JServer(cfg, device).start()
    mgr = voice = events = None
    try:
        state = srv.state
        check(state.trunking_workers is not None and str(state.trunking_workers.device) == str(torch_device(device)),
              "J3: the per-device server did not build its worker manager on the card")
        x, _, calls = i1_scene(24, I_BLOCK)
        mgr = TrunkingProcessManager(state_dir=os.path.join(tmp, "state"), driver="fake", device=device,
                                     stations=[dict(offset_hz=0.0, kind="iq_loop", iq_loop=x, amplitude=1.0)])
        state.trunking_workers = mgr
        state.attach_worker_streams(mgr)
        mgr.add_system(i_config("j3", os.path.join(tmp, "rec")))
        mgr.start()
        check(mgr.workers["default"].worker_cfg["device"] == str(torch_device(device)), "J3: the worker's device")
        hub = state.worker_streams
        voice = JWs(srv.port, "/api/v1/trunking/stream/j3/voice")
        events = JWs(srv.port, "/api/v1/trunking/stream/j3")
        j_until(lambda: hub._get(hub.voice_all, "j3").count == 1, "the voice subscriber")
        t0 = time.perf_counter()
        pcm = [voice.recv(timeout=J3_TIMEOUT_S)]
        first_voice_s = time.perf_counter() - t0
        while sum(len(p) for p in pcm) < 2 * 8000:  # 1 s of 8 kHz int16 voice
            pcm.append(voice.recv(timeout=60))
        seen = []
        while not any(e.get("type") in ("call_start", "grant") for e in seen):
            seen.append(json.loads(events.recv(timeout=60)))
        j_until(lambda: "j3" in hub.latest_spectrum, "a forwarded spectrum", timeout=60)
        status, _, snap = j_http(srv.port, "GET", "/api/v1/trunking/systems/j3/spectrum")
        check(status == 200 and snap["centerHz"] == I_CENTER and len(snap["db"]) == cfg["stream"]["fft_size"],
              f"J3: the spectrum snapshot {status} {snap and {k: v for k, v in snap.items() if k != 'db'}}")
        audio = np.frombuffer(b"".join(pcm), np.int16).astype(np.float32) / 32768.0
        check(float(np.sqrt(np.mean(audio ** 2))) > 0.01, "J3: the worker's voice is silent")
        st = mgr.rpc("default", "status", timeout=10.0)[0]
        mgr.stop_all()
        return dict(phase="program J3: a worker-hosted P25 system's voice and spectrum through the card's server",
                    first_voice_s=first_voice_s, voice_s=len(audio) / 8000, voice_rms=float(np.sqrt(np.mean(audio ** 2))),
                    events=[e.get("type") for e in seen][-5:], spectrum_bins=len(snap["db"]),
                    worker={k: st[k] for k in ("state", "synced", "nac", "tsbkCount")},
                    calls_sent=sorted(calls), wall_s=time.perf_counter() - t_all)
    finally:
        for w in (voice, events):
            if w is not None:
                w.close()
        if mgr is not None and mgr.workers:
            mgr.stop_all()
        srv.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def j4_inputs(tmp: str) -> dict:
    """The CLI's inputs: 1 s of each demod mode's signal at its rate (a
    1 kHz program) and a C4FM control channel at 48 kHz (30 TSDUs), from
    the seed."""
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm
    from wavecap_tpu_torch.utils.wavio import write_iq_wav

    rng = np.random.default_rng(SEED + 18)
    paths = {}
    for mode in ("wbfm", "nbfm", "am", "sam"):
        rate = 240_000 if mode == "wbfm" else 48_000
        t = np.arange(rate) / rate
        prog = np.sin(2 * np.pi * 1000.0 * t)
        if mode in ("wbfm", "nbfm"):
            iq = np.exp(2j * np.pi * (75e3 if mode == "wbfm" else 2.5e3) * np.cumsum(0.8 * prog) / rate)
        else:
            iq = (1.0 + 0.6 * prog) * np.exp(2j * np.pi * 150.0 * t)
        iq = 0.5 * iq + 0.01 * (rng.standard_normal(rate) + 1j * rng.standard_normal(rate))
        paths[mode] = os.path.join(tmp, f"{mode}.wav")
        write_iq_wav(paths[mode], iq.astype(np.complex64), rate)
    dibits, _ = g_tsdu_loop(0x293, 7, n_tsdus=30)
    iq = modulate_c4fm(dibits, 48_000.0)
    iq = iq + 0.02 * (rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
    paths["cc"] = os.path.join(tmp, "cc.wav")
    write_iq_wav(paths["cc"], iq.astype(np.complex64), 48_000)
    return paths


def j4_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_program_j4(device) -> dict:
    """J4, the process entry points on the card (``python -m``), each beside
    the same command with ``WAVECAP_TORCH_DEVICE=cpu``, all started
    together: ``serve`` with no config file (``/health``, then ``POST
    /shutdown``), ``demod`` (wbfm, nbfm, am, sam; >= 50 dB), ``decode-iq``
    (the same statistics and messages) and the harness's tone and
    p25-trunk scenes (the reports' fixed fields).  Then each ``demod`` and
    ``decode-iq`` in this process on the card with the kernels' launches
    counted."""
    import shutil
    import tempfile

    from wavecap_tpu_torch import cli
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts
    from wavecap_tpu_torch.utils.wavio import read_audio_wav

    t_all = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="program_j4_")
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = {}
    try:
        paths = j4_inputs(tmp)
        serve_dir = os.path.join(tmp, "serve")
        os.makedirs(serve_dir)
        port = j4_free_port()
        base_env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
        base_env.pop("WAVECAP_TORCH_DEVICE", None)
        base_env.pop("WAVECAP_TORCH_DEVICE_COUNT", None)
        # one intra-op thread a process: 15 processes at once on a few cores
        # with torch's default threads each stall the CPU runs
        base_env["OMP_NUM_THREADS"] = "1"
        runs = {"serve": (["-m", "wavecap_tpu_torch", "serve", "--port", str(port)], serve_dir, "card")}
        for where in ("card", "cpu"):
            for mode in ("wbfm", "nbfm", "am", "sam"):
                runs[f"demod {mode} {where}"] = (["-m", "wavecap_tpu_torch", "demod", "--input", paths[mode], "--mode",
                                                  mode, "--output", os.path.join(tmp, f"{mode}_{where}.wav")], tmp, where)
            runs[f"decode-iq {where}"] = (["-m", "wavecap_tpu_torch", "decode-iq", "--input", paths["cc"],
                                           "--messages", os.path.join(tmp, f"msgs_{where}.json")], tmp, where)
            for preset in ("tone", "p25-trunk"):
                runs[f"harness {preset} {where}"] = (["-m", "wavecap_tpu_torch.harness", "--preset", preset,
                                                      "--duration", "1.5", "--out-dir",
                                                      os.path.join(tmp, f"h_{where}")], tmp, where)
        t0 = time.perf_counter()
        on_card = torch_device(device).type == "cuda"
        for name, (argv, cwd, where) in runs.items():
            # the card's runs name no device: unset means the card
            env = dict(base_env, **({} if where == "card" and on_card else {"WAVECAP_TORCH_DEVICE": "cpu"}))
            procs[name] = subprocess.Popen([sys.executable, *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)
        # serve: /health, then a clean POST /shutdown
        health_s = None
        while health_s is None:
            check(time.perf_counter() - t0 < J4_TIMEOUT_S and procs["serve"].poll() is None,
                  f"J4: serve did not answer /health: {procs['serve'].poll()}")
            try:
                status, _, body = j_http(port, "GET", "/api/v1/health", timeout=5)
                if status == 200 and body["status"] == "ok":
                    health_s = time.perf_counter() - t0
            except OSError:
                time.sleep(0.2)
        status, _, body = j_http(port, "POST", "/api/v1/shutdown")
        check(status == 200 and body.get("shuttingDown"), f"J4: POST /shutdown answered {status} {body}")
        outs = {}
        for name, p in procs.items():
            try:
                out, _ = p.communicate(timeout=max(1.0, J4_TIMEOUT_S - (time.perf_counter() - t0)))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            outs[name] = out
            check(p.returncode == 0, f"J4: {name} exited {p.returncode}: {out[-2000:]}")
        procs_s = time.perf_counter() - t0
        check("wavecap_tpu listening" in outs["serve"], f"J4: serve's output {outs['serve'][-500:]}")
        demod = {}
        for mode in ("wbfm", "nbfm", "am", "sam"):
            (ca, cr), (pa, pr) = (read_audio_wav(os.path.join(tmp, f"{mode}_{w}.wav")) for w in ("card", "cpu"))
            check(cr == pr == 48_000 and ca.shape == pa.shape and len(ca) > 0, f"J4: demod {mode}'s WAVs differ")
            demod[mode] = round(snr_db(pa, ca), 1)
            check(demod[mode] >= 50.0, f"J4: demod {mode} card against CPU {demod[mode]} dB")

        def stats(where):
            s = json.loads(outs[f"decode-iq {where}"].split("wrote")[0])
            s.pop("realtime_x")
            return s, json.load(open(os.path.join(tmp, f"msgs_{where}.json")))

        check(stats("card") == stats("cpu"), f"J4: decode-iq card {stats('card')[0]} against CPU {stats('cpu')[0]}")
        check(stats("card")[0]["tsbk_crc_ok"] >= 75, f"J4: decode-iq {stats('card')[0]}")
        harness = {}
        for preset, fixed in (("tone", ("preset", "samples", "audio_rate", "dominant_hz")),
                              ("p25-trunk", ("preset", "synced", "nac", "systemId", "siteId", "calls",
                                             "tsbkCrcRateSteady"))):
            card_r, cpu_r = (json.load(open(os.path.join(tmp, f"h_{w}", f"harness_{preset}.json")))
                             for w in ("card", "cpu"))
            check({k: card_r[k] for k in fixed} == {k: cpu_r[k] for k in fixed},
                  f"J4: harness {preset} card {card_r} against CPU {cpu_r}")
            if preset == "tone":
                check(abs(card_r["rms"] - cpu_r["rms"]) <= 0.01 * cpu_r["rms"], f"J4: harness tone rms {card_r} {cpu_r}")
            harness[preset] = card_r
        # the CLI paths' launches, in this process on the card
        launches = {}
        for mode in ("wbfm", "nbfm", "am", "sam"):
            reset_launch_counts()
            with mock.patch.dict(os.environ, {"WAVECAP_TORCH_DEVICE": str(torch_device(device))}), \
                    mock.patch.object(sys, "argv", ["wavecap_tpu", "demod", "--input", paths[mode], "--mode", mode,
                                                    "--output", os.path.join(tmp, f"{mode}_again.wav")]), \
                    contextlib.redirect_stdout(None):
                check(cli.main() == 0, f"J4: demod {mode} in process")
            launches[f"demod {mode}"] = {k: v for k, v in launch_counts().items() if v}
        reset_launch_counts()
        with mock.patch.dict(os.environ, {"WAVECAP_TORCH_DEVICE": str(torch_device(device))}), \
                mock.patch.object(sys, "argv", ["wavecap_tpu", "decode-iq", "--input", paths["cc"]]), \
                contextlib.redirect_stdout(None):
            check(cli.main() == 0, "J4: decode-iq in process")
        launches["decode-iq"] = {k: v for k, v in launch_counts().items() if v}
        # NBFM at 48 kHz in and out with the filters off (its defaults) is torch ops alone
        for name in ("demod wbfm", "demod am", "demod sam", "decode-iq"):
            check(launches[name] or not on_card, f"J4: {name} launched no kernel on the card")
        return dict(phase="program J4: the process entry points on the card", serve_health_s=health_s,
                    processes=len(procs), processes_s=procs_s, demod_vs_cpu_db=demod,
                    decode_iq={k: stats("card")[0][k] for k in ("frames", "tsdu", "tsbk", "tsbk_crc_ok")},
                    harness={p: {k: v for k, v in r.items() if k != "wav_path"} for p, r in harness.items()},
                    launches=launches, wall_s=time.perf_counter() - t_all)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)


def run_program_j(device) -> dict:
    """Program J: the port's server, harness and CLI on the card, J1-J4."""
    t0 = time.perf_counter()
    for run in (run_program_j1, run_program_j2, run_program_j3, run_program_j4):
        log(dict(run(device), card=card_line()))
    return dict(phase="program J", wall_s=time.perf_counter() - t0)


# --- phase 15: planar.py and conv_valid's banded route -------------------------------------

# (name, sample rate, channel bandwidth, block): the first slice's geometry
# (M = 800, S = 4,920) and program B's (M = 96, S = 7,500)
PLANAR_GEOMETRIES = (("the first slice", 10_000_000.0, 12_500.0, 1_968_000),
                     ("program B", 2_400_000.0, 25_000.0, 360_000))
PLANAR_BLOCKS = 3
PLANAR_ROWS = (160, 9_447)  # a bank of program D's 160 slots
SPECTRUM_ROWS = 16
# conv_valid's call sites on the programs' paths: (what, taps, rows, outputs a row, complex rows)
MATMUL_SITES = (("program A's C4FM low-pass", "lpf", 50, 12_500, True),
                ("program A's C4FM RRC", "rrc", 50, 12_500, False),
                ("program B's CQPSK RRC", "cqpsk_rrc", 21, 7_500, True),
                ("program D's voice-band FIR", "voice", 160, 4_920, False))


def planar_line(function: str, replaces: str, route: str, err: float, ms: float, bound_ms: float,
                library_ms, **extra) -> dict:
    return dict(phase="planar", function=function, replaces=replaces, route=route, err=err, ms=ms,
                bound_ms=bound_ms, library_ms=library_ms, **extra)


def planar_channelize_checks(device, timer=device_ms, wall_timer=time_ms, geometries=PLANAR_GEOMETRIES) -> list:
    """``planar_channelize`` over consecutive blocks at each geometry: K1
    and K2 once a call, rel L2 <= 1e-5 against its plain version and
    against ``channelize`` on the same samples, the history carried bit
    for bit; timed beside ``channelize`` and the plain version."""
    import torch
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts
    from wavecap_tpu_torch.ops import channelizer as chz, planar

    rng = np.random.default_rng(SEED + 19)
    lines = []
    for what, fs, bw, n in geometries:
        cfg = chz.ChannelizerConfig(sample_rate=fs, channel_bandwidth=bw)
        m, h = cfg.channel_count, cfg.channel_count * cfg.taps_per_channel
        k = np.arange(PLANAR_BLOCKS * n)
        x = 0.05 * (rng.standard_normal(k.size) + 1j * rng.standard_normal(k.size))
        for b in rng.choice(m, 6, replace=False):  # tones on six bins
            x += 0.2 * np.exp(2j * np.pi * (b / m + rng.uniform(-0.2, 0.2) / m) * k)
        x = torch.from_numpy(x.astype(np.complex64)).to(device)
        st = planar.planar_channelizer_init(cfg, device=device)
        st_p = planar.planar_channelizer_init(cfg, device=device)
        st_c = chz.channelizer_init(cfg, device=device)
        errs_p, errs_c = [], []
        for blk in range(PLANAR_BLOCKS):
            xb = x[blk * n:(blk + 1) * n]
            re, im = xb.real.contiguous(), xb.imag.contiguous()
            reset_launch_counts()
            yr, yi, st = planar.planar_channelize(re, im, st, cfg)
            if device.type == "cuda":
                torch.cuda.synchronize()
                counts = {k_: v for k_, v in launch_counts().items() if v}
                check(counts == {"K1_unpack_arms": 1, "K2_arm_dft": 1},
                      f"planar_channelize at {what}: launches {counts}, not one K1 and one K2")
            pr, pi, st_p = planar.planar_channelize_plain(re, im, st_p, cfg)
            yc, st_c = chz.channelize(xb, st_c, cfg)
            got = host(torch.complex(yr, yi))
            check(got.shape == (m, 2 * n // m), f"planar_channelize at {what}: shape {got.shape}")
            errs_p.append(rel_l2(host(torch.complex(pr, pi)), got))
            errs_c.append(rel_l2(host(yc), got))
            check(torch.equal(st[0], re[-h:]) and torch.equal(st[1], im[-h:]),
                  f"planar_channelize at {what}: the history is not the block's last {h} samples")
            check(torch.equal(st_p[0], st[0]) and torch.equal(st_p[1], st[1]),
                  f"planar_channelize at {what}: the plain version carried another history")
        check(max(errs_p) <= 1e-5, f"planar_channelize at {what}: rel L2 {max(errs_p):.3g} > 1e-5 "
              "against its plain version")
        check(max(errs_c) <= 1e-5, f"planar_channelize at {what}: rel L2 {max(errs_c):.3g} > 1e-5 "
              "against channelize")
        b_ms, b_by = bound(2 * n * 4 + 2 * m * (2 * n // m) * 4, 0.0)
        lines.append(planar_line(
            "planar_channelize", "wavecap_tpu/ops/planar.py:205", "cuda (K1 + K2)", max(errs_p),
            timer(lambda: planar.planar_channelize(re, im, st, cfg)), b_ms, None,
            case=f"{what}: M = {m}, N = {n:,}, S = {2 * n // m:,}, {PLANAR_BLOCKS} blocks",
            rel_l2_vs_channelize=max(errs_c), bound_by=b_by,
            wall_ms=wall_timer(lambda: planar.planar_channelize(re, im, st, cfg)),
            channelize_ms=timer(lambda: chz.channelize(xb, st_c, cfg)),
            plain_ms=timer(lambda: planar.planar_channelize_plain(re, im, st_p, cfg)),
            library_note="no torch call channelizes"))
        del x, xb, re, im, yr, yi, pr, pi, yc
    return lines


def planar_spectrum_check(device, timer=device_ms) -> dict:
    """``planar_power_spectrum`` on 16 rows at 2048 bins against the same
    call on the CPU (1e-3 dB within 60 dB of the peak, the same argmax) and
    the port's ``power_spectrum`` on cuFFT (0.5 dB in the strong bins)."""
    import torch
    from wavecap_tpu_torch.ops import planar
    from wavecap_tpu_torch.ops.spectrum import power_spectrum

    rng = np.random.default_rng(SEED + 20)
    nfft, rows = 2048, SPECTRUM_ROWS
    k = np.arange(nfft)
    x = np.stack([np.exp(2j * np.pi * rng.uniform(-0.45, 0.45) * k) for _ in range(rows)])
    x = (x + 1e-3 * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    xc = torch.from_numpy(x)
    xd = xc.to(device)
    re, im = xd.real.contiguous(), xd.imag.contiguous()
    got = host(planar.planar_power_spectrum(re, im, nfft))
    cpu = host(planar.planar_power_spectrum(xc.real.contiguous(), xc.imag.contiguous(), nfft))
    lib = host(power_spectrum(xd, nfft))
    d_cpu = d_lib = 0.0
    for g, c, lb in zip(got, cpu, lib):
        check(int(np.argmax(g)) == int(np.argmax(c)) == int(np.argmax(lb)),
              "planar_power_spectrum: the peak bin differs from the CPU's or cuFFT's")
        near = c > c.max() - 60.0
        d_cpu = max(d_cpu, float(np.max(np.abs(g[near] - c[near]))))
        strong = lb > -60.0
        d_lib = max(d_lib, float(np.max(np.abs(g[strong] - lb[strong]))))
    check(d_cpu <= 1e-3, f"planar_power_spectrum: {d_cpu:.3g} dB from the CPU's within 60 dB of the peak")
    check(d_lib <= 0.5, f"planar_power_spectrum: {d_lib:.3g} dB from power_spectrum in the strong bins")
    # the function's own work: planes in, dB out; an FFT's 5 N log2 N a row
    b_ms, b_by = bound(rows * nfft * (8 + 4), rows * 5.0 * nfft * np.log2(nfft))
    return planar_line("planar_power_spectrum", "wavecap_tpu/ops/planar.py:272", "plain (four f32 matmuls)",
                       d_cpu, timer(lambda: planar.planar_power_spectrum(re, im, nfft)), b_ms,
                       timer(lambda: power_spectrum(xd, nfft)),
                       case=f"{rows} rows x {nfft}", bound_by=b_by, db_vs_power_spectrum=d_lib,
                       # the matmul form's own floor: four (rows, N) @ (N, N) f32 products
                       form_bound_ms=bound(0.0, 4 * 2.0 * rows * nfft * nfft)[0],
                       library_note="power_spectrum: torch.fft.fft (cuFFT), from the same complex rows")


def planar_elementwise_checks(device, timer=device_ms) -> list:
    """``planar_freq_shift``, ``planar_quadrature_demod`` and
    ``planar_rssi_dbfs`` on a 160 x 9,447 bank, card against CPU: NCO words
    and phases bit-equal, outputs within 1e-5."""
    import torch
    from wavecap_tpu_torch.ops import planar
    from wavecap_tpu_torch.ops.nco import nco_phases, tuning_word

    rng = np.random.default_rng(SEED + 21)
    rows, n = PLANAR_ROWS
    fs = 25_000.0
    x = (0.3 * np.exp(1j * rng.uniform(-np.pi, np.pi, (rows, n)))
         * (1 + 0.1 * rng.standard_normal((rows, n)))).astype(np.complex64)
    re_c, im_c = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    re, im = re_c.to(device), im_c.to(device)
    off_c = torch.from_numpy(rng.uniform(-3000.0, 3000.0, rows).astype(np.float32))
    ph0_c = torch.from_numpy(rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32))
    off, ph0 = off_c.to(device), ph0_c.to(device)
    lines = []

    dphi, dphi_c = tuning_word(off, fs), tuning_word(off_c, fs)
    check(torch.equal(dphi.cpu(), dphi_c), "planar_freq_shift: the card's tuning words differ from the CPU's")
    check(torch.equal(nco_phases(n, dphi, ph0).cpu(), nco_phases(n, dphi_c, ph0_c)),
          "planar_freq_shift: the card's NCO phases differ from the CPU's")
    gr, gi, gp = planar.planar_freq_shift(re, im, off, fs, ph0)
    cr, ci, cp = planar.planar_freq_shift(re_c, im_c, off_c, fs, ph0_c)
    check(torch.equal(gp.cpu(), cp), "planar_freq_shift: the next phase differs from the CPU's")
    err = max(max_abs(host(cr), host(gr)), max_abs(host(ci), host(gi)))
    check(err <= 1e-5, f"planar_freq_shift: {err:.3g} from the CPU's")
    b_ms, b_by = bound(rows * n * 16, 0.0)
    lines.append(planar_line("planar_freq_shift", "wavecap_tpu/ops/planar.py:169", "plain (torch)", err,
                             timer(lambda: planar.planar_freq_shift(re, im, off, fs, ph0)), b_ms, None,
                             case=f"{rows} x {n}", bound_by=b_by))

    prev_re_c, prev_im_c = re_c[:, 0].contiguous(), im_c[:, 0].contiguous()
    prev_re, prev_im = prev_re_c.to(device), prev_im_c.to(device)
    ga, glr, gli = planar.planar_quadrature_demod(re, im, fs, prev_re, prev_im, 5_000.0)
    ca, clr, cli = planar.planar_quadrature_demod(re_c, im_c, fs, prev_re_c, prev_im_c, 5_000.0)
    err = max_abs(host(ca), host(ga))
    check(err <= 1e-5, f"planar_quadrature_demod: {err:.3g} from the CPU's")
    check(torch.equal(glr.cpu(), clr) and torch.equal(gli.cpu(), cli),
          "planar_quadrature_demod: the last samples differ")
    b_ms, b_by = bound(rows * n * 12, 0.0)
    lines.append(planar_line("planar_quadrature_demod", "wavecap_tpu/ops/planar.py:179", "plain (torch)", err,
                             timer(lambda: planar.planar_quadrature_demod(re, im, fs, prev_re, prev_im, 5_000.0)),
                             b_ms, None, case=f"{rows} x {n}", bound_by=b_by))

    g = host(planar.planar_rssi_dbfs(re, im))
    err = max_abs(host(planar.planar_rssi_dbfs(re_c, im_c)), g)
    check(err <= 1e-5, f"planar_rssi_dbfs: {err:.3g} dB from the CPU's")
    b_ms, b_by = bound(rows * n * 8, 0.0)
    lines.append(planar_line("planar_rssi_dbfs", "wavecap_tpu/ops/planar.py:190", "plain (torch)", err,
                             timer(lambda: planar.planar_rssi_dbfs(re, im)), b_ms, None,
                             case=f"{rows} x {n}", bound_by=b_by))
    return lines


def matmul_site_case(device, taps_name: str, rows: int, n_out: int, cplx: bool, rng):
    """The taps and a block of rows of one ``conv_valid`` call site."""
    import torch
    from wavecap_tpu_torch.models import analog
    from wavecap_tpu_torch.models.p25 import c4fm, cqpsk

    if taps_name in ("lpf", "rrc"):
        taps = c4fm._filters_on(50_000.0, 0.2, device)[taps_name == "rrc"]
    elif taps_name == "cqpsk_rrc":
        taps = cqpsk._rrc_on(50_000.0, 4800.0, 0.2, device)
    else:
        cfg = analog.NbfmConfig(sample_rate=25_000, audio_rate=25_000, enable_highpass=True,
                                enable_lowpass=True, filter_impl="fir")
        taps = torch.from_numpy(analog.voice_band_taps(cfg)).to(device)
    n = n_out + taps.shape[0] - 1
    x = rng.standard_normal((rows, n))
    if cplx:
        x = x + 1j * rng.standard_normal((rows, n))
    return torch.from_numpy((0.3 * x).astype(np.complex64 if cplx else np.float32)).to(device), taps


def matmul_route_checks(device, timer=device_ms, sites=MATMUL_SITES) -> list:
    """``conv_valid`` with ``WAVECAP_FIR_MATMUL=1`` (this check only) at
    each ``fir_filter`` site's shape: within 2e-5 (max |a - b| / max |a|)
    of K7's direct path, no K7 launched; once the variable is restored the
    same call launches K7 again.  Timed beside K7 and cuDNN's conv1d."""
    import torch
    from wavecap_tpu_torch.kernels import launch_counts, reset_launch_counts
    from wavecap_tpu_torch.ops import fir

    rng = np.random.default_rng(SEED + 22)
    lines = []
    for what, taps_name, rows, n_out, cplx in sites:
        x, taps = matmul_site_case(device, taps_name, rows, n_out, cplx, rng)
        t = taps.shape[0]
        direct = host(fir._conv_valid_direct(x, taps))
        with mock.patch.dict(os.environ, {"WAVECAP_FIR_MATMUL": "1"}):
            reset_launch_counts()
            got = fir.conv_valid(x, taps)
            if device.type == "cuda":
                torch.cuda.synchronize()
                check(not any(launch_counts().values()),
                      f"the banded route at {what} launched {launch_counts()}")
            got = host(got)
            route_ms = timer(lambda: fir.conv_valid(x, taps))
        check(got.shape == direct.shape == (rows, n_out), f"the banded route at {what}: shape {got.shape}")
        err = float(np.max(np.abs(direct - got))) / float(np.max(np.abs(direct)))
        check(err < 2e-5, f"the banded route at {what}: {err:.3g} from K7's direct path")
        reset_launch_counts()
        fir.conv_valid(x, taps)
        if device.type == "cuda":
            torch.cuda.synchronize()
            check(launch_counts()["K7_strided_fir"] == 1,
                  f"conv_valid at {what} without the variable did not launch K7")
        planes = 2 if cplx else 1
        b_ms, b_by = bound(rows * planes * 4 * ((n_out + t - 1) + n_out), 2.0 * t * rows * planes * n_out)
        tiles = -(-n_out // fir._CONV_TILE)
        form_ops = 2.0 * rows * planes * tiles * (fir._CONV_TILE + t - 1) * fir._CONV_TILE
        lines.append(planar_line(
            "_conv_valid_matmul", "wavecap_tpu/ops/fir.py:107", "plain (banded f32 einsum)", err, route_ms,
            b_ms, timer(lambda: fir.strided_fir_plain(x, taps, 1)),
            case=f"{what}: {t} taps, {rows} x {n_out} {'complex' if cplx else 'real'}", bound_by=b_by,
            form_bound_ms=bound(0.0, form_ops)[0],  # the band's products, zeros included
            k7_ms=timer(lambda: fir._conv_valid_direct(x, taps), ("strided_fir_kernel",)),
            library_note="F.conv1d (cuDNN), the plain version of K7"))
    return lines


def run_planar(device) -> list:
    """Phase 15: ``ops/planar.py``'s channelizer, spectrum and elementwise
    functions, and ``conv_valid``'s banded-matmul route."""
    return (planar_channelize_checks(device) + [planar_spectrum_check(device)]
            + planar_elementwise_checks(device) + matmul_route_checks(device))


PLANAR_CHILD = """
import json, torch
import chip_smoke as cs
from wavecap_tpu_torch.kernels import build_all

build_all()
for line in cs.run_planar(torch.device("cuda")):
    print(json.dumps(line), flush=True)
"""


def run_planar_in_child() -> list:
    """Phase 15 in a process of its own: after the many thousand launches
    of the phases before it, CUPTI keeps few or none of a profile's events
    in this process (see ``device_ms``).  The kernels are built already."""
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", PLANAR_CHILD], cwd=here, capture_output=True, text=True,
                          timeout=600)
    if proc.returncode != 0:
        raise CheckFailed(f"phase 15 (planar) failed:\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()


# one turn of --phase2-turns, run in the checkout given as its argument
PHASE2_TURN = """
import json, sys
sys.path.insert(0, sys.argv[1])
import numpy as np, torch
import chip_smoke as cs
from wavecap_tpu_torch.kernels import build_all
from wavecap_tpu_torch.ops import channelizer as chz, iir

build_all()
dev = torch.device("cuda")
# the checkout's shapes and cases from the checkout that runs the turns (argv[2])
import importlib.util
spec = importlib.util.spec_from_file_location("turn_shapes", sys.argv[2] + "/chip_smoke.py")
shapes = importlib.util.module_from_spec(spec)
spec.loader.exec_module(shapes)
# first, in a fresh process (see device_ms): K13's CFO stage at the paths'
# shapes through this checkout's _estimate_cfo_residual, every device op
# with its launches and ms a call, its search alone (over |X| before
# K13_cfo_power, over complex X after), its x^4 kernel where it has one,
# cuFFT alone, and the bits of the stage's residuals
from wavecap_tpu_torch.models.p25 import cqpsk
k13 = []
for what, prog, bank in shapes.CFO_PATH_SHAPES:
    cfg_q, filt, _ = shapes.cfo_path_case(dev, prog, bank)
    size, k4, off, step = cqpsk._cfo_search(cfg_q, filt.shape[-1])
    redesigned = hasattr(cqpsk, "cfo_power")
    buf = cqpsk.cfo_power(filt, size) if redesigned else None
    x = torch.fft.fft(buf, dim=-1) if redesigned else torch.fft.fft(filt * filt * (filt * filt), n=size, dim=-1)
    srch = x if redesigned else torch.abs(x)
    resid = cqpsk._estimate_cfo_residual(filt, cfg_q)
    rec = dict(name="K13 CFO stage", case=f"{what}: ({filt.shape[0]}, {filt.shape[1]}), size {size}, "
               f"{2 * k4 + 1} candidates", bits={"resid": shapes.scan_digest([resid])},
               resid=[float(v) for v in resid.cpu()],
               stage=shapes.device_ops(lambda: cqpsk._estimate_cfo_residual(filt, cfg_q)),
               stage_ms=cs.device_ms(lambda: cqpsk._estimate_cfo_residual(filt, cfg_q)),
               lines_ms=cs.device_ms(lambda: cqpsk.cfo_lines(srch, k4, off, step), ("cfo_lines_kernel",)),
               cufft_ms=cs.device_ms(lambda: torch.fft.fft(x, dim=-1)))
    if redesigned:
        rec["power_ms"] = cs.device_ms(lambda: cqpsk.cfo_power(filt, size), ("cfo_power_kernel",))
    k13.append(rec)
    del filt, buf, x, srch
k2 = [k for k in cs.kernel_checks(cs.slice_config(), dev) if k["name"] == "K2_arm_dft"]
ch = chz.ChannelizerConfig(sample_rate=10e6, channel_bandwidth=25e3, dft_impl="matmul")
rng = np.random.default_rng(cs.SEED)
u = torch.from_numpy((rng.standard_normal((2, 3000, 400)) + 1j * rng.standard_normal((2, 3000, 400)))
                     .astype(np.complex64)).to(dev)
k2.append(dict(name="K2_arm_dft", case="M = 400, 3,000 steps", ms=cs.device_ms(lambda: chz.arm_dft(u, ch),
               ("arm_dft_kernel",)), library_ms=cs.device_ms(lambda: chz._fft_arms(u, ch))))
# K1 and K3 at the paths' shapes through this checkout's wrappers, the
# inputs from the shape table and case functions of the checkout that runs the
# turns, the same in every checkout
from wavecap_tpu_torch.models import channel_bank as cb
k3 = []
for what, slots, bins, s_len, mode in shapes.K3_PATH_SHAPES:
    args = shapes.k3_path_case(dev, slots, bins, s_len, mode)
    try:
        ms = cs.device_ms(lambda: cb.slot_frontend(*args), ("slot_frontend_kernel",))
    except NotImplementedError as e:  # the first K3 refuses rows past 27,000 samples in modes 0 and 1
        ms = f"refused: {e}"
    k3.append(dict(name="K3_slot_frontend", case=what, ms=ms))
    del args
k1 = []
for what, m_k1, n_k1 in shapes.K1_PATH_SHAPES:
    for kind in shapes.K1_WORDS:
        x1, h1, c1, sc1 = shapes.k1_path_case(dev, m_k1, n_k1, kind)
        k1.append(dict(name="K1_unpack_arms", case=f"{what}, {n_k1:,} {kind}",
                       ms=cs.device_ms(lambda: chz.unpack_arms(x1, h1, c1, sc1), ("unpack_arms_kernel",))))
        del x1
# K4 and K12 / K13's timing the same way (the first designs refuse the long rows)
k4 = []
for what, slots, s_len in shapes.K4_PATH_SHAPES:
    a4 = shapes.k4_path_case(dev, slots, s_len)
    try:
        ms = cs.device_ms(lambda: cb.voice_fir(*a4), ("voice_fir_kernel",))
    except NotImplementedError as e:  # the first K4 refuses rows past 27,000 samples
        ms = f"refused: {e}"
    k4.append(dict(name="K4_voice_fir", case=what, ms=ms))
    del a4
k12 = []
for what, kind, rows, n_k12 in shapes.K12_PATH_SHAPES:
    kfn, pfn, buf, st, n_sym, cfg = shapes.k12_path_case(dev, kind, rows, n_k12)
    try:
        ms = cs.device_ms(lambda: kfn(buf, st, n_sym, cfg), ("timing_kernel",))
    except NotImplementedError as e:  # the first K12 / K13 refuses rows it cannot stage
        ms = f"refused: {e}"
    k12.append(dict(name=shapes.K12_NAMES[kind], case=what, ms=ms))
    del buf
# K12s and K13s at scan_path_shapes() the same way (the first design refuses
# the long rows), with the bits of each output for the parity of the turns
k12s = []
for what, kind, rows, n, change in shapes.scan_path_shapes():
    kfn, pfn, buf, st, n_sym, cfg = shapes.scan_path_case(dev, kind, rows, n, change)
    try:
        got = kfn(buf, st, n_sym, cfg)
        rec = dict(bits={k: shapes.scan_digest([v]) for k, v in (("soft", got[0]), ("dibits", got[1]),
                                                                   ("pos_freq_integ", got[2][:3]),
                                                                   ("out", got[2]))},
                   ms=cs.device_ms(lambda: kfn(buf, st, n_sym, cfg), ("scan_kernel",)))
        del got
    except NotImplementedError as e:  # the first design refuses rows it cannot stage
        rec = dict(ms=f"refused: {e}")
    k12s.append(dict(name=shapes.SCAN_NAMES[kind], case=what, **rec))
    del buf
x = torch.from_numpy((0.3 * rng.standard_normal((100, 9447))).astype(np.float32)).to(dev)
hp = iir.butter_sos("high", (300.0,), 5, 48_000)
z = torch.zeros((100, hp.shape[0], 2), device=dev)
k9 = [dict(name="K9_iir_cascade", case="high-pass, 3 sections, (100, 9447)",
           ms=cs.device_ms(lambda: iir.sos_filter(x, hp, z), ("iir_cascade_kernel", "iir_scan_kernel")))]
# K5 and K10 at program D's and E's bank rows through this checkout's wrappers
from wavecap_tpu_torch.ops import fir, pll
k5_kernels = ("resample_poly_kernel", "resample_poly_row_kernel")
xn = torch.from_numpy(rng.standard_normal((160, 4920)).astype(np.float32)).to(dev)
xs = torch.from_numpy(rng.standard_normal((160, 10000)).astype(np.float32)).to(dev)
ts = torch.from_numpy(rng.standard_normal((160, 20)).astype(np.float32)).to(dev)
k5 = []
for rows in (160, 100):
    k5.append(dict(name="K5_resample_poly", case=f"narrow one-shot 48/25 ({rows}, 4920)",
                   ms=cs.device_ms(lambda: fir.resample_poly(xn[:rows], 25_000, 48_000), k5_kernels)))
    k5.append(dict(name="K5_resample_poly", case=f"streaming 24/25 ({rows}, 10000)",
                   ms=cs.device_ms(lambda: fir.resample_poly_stream(xs[:rows], 50_000, 48_000, ts[:rows]),
                                   k5_kernels)))
z = torch.from_numpy((0.3 * np.exp(1j * rng.uniform(-np.pi, np.pi, (100, 4920)))).astype(np.complex64)).to(dev)
st = pll.PllState(torch.from_numpy(rng.uniform(-3, 3, 100).astype(np.float32)).to(dev), torch.zeros(100, device=dev))
al, be = pll.pll_coeffs(50.0, 25_000.0)
k10 = [dict(name="K10_pll", case="SAM carrier PLL (100, 4920)",
            ms=cs.device_ms(lambda: pll.carrier_recovery_pll(z, 25_000.0, st), ("pll_kernel",))),
       dict(name="K10_pll", case="Costas QPSK (100, 4920)",
            ms=cs.device_ms(lambda: pll.costas_loop_qpsk(z, st, al, be), ("pll_kernel",)))]
# the P25 checks before the mixed checks' plain scans (see device_ms)
_, p_cases = cs.p25_kernel_checks(cs.p25_configs(), dev)
lines, cases = cs.mixed_kernel_checks(cs.mixed_config(), dev)
k9 += [k for k in lines + cases if k["name"] == "K9_iir_cascade"]
k5 += [k for k in cases if k["name"] == "K5_resample_poly"]
k10 += [k for k in cases if k["name"] == "K10_pll"]
k7 = [k for k in lines + cases if k["name"] == "K7_strided_fir"]
# K11a and K11b at program D's 160 bank rows and a mesh shard's 100, and
# the wide rows, through this checkout's own checks and device_ms
k11 = []
for rows in (160, 100):
    _, cases = cs.engine_kernel_checks(dev, c=rows)
    k11 += [dict(k, call_rows=rows) for k in cases if k["name"].startswith("K11")]
# K7 and K14: this checkout's own phase-2 cases (K7's wide slots and up == 1
# in mixed_kernel_checks, the equaliser and K14's fit and alias scores in
# p25_kernel_checks, run above), then K7 at a mesh shard's shapes and K14 on a
# 60,000-sample row through its wrappers, the same in every checkout
from wavecap_tpu_torch.capture.pipeline import p25_cfg_for
from wavecap_tpu_torch.models.p25 import c4fm, cqpsk, equalizer as eqz
from wavecap_tpu_torch.ops.nco import tuning_word
k7 += [k for k in p_cases if k["name"] == "K7_strided_fir"]
k14 = [k for k in p_cases if k["name"] == "K14_echo_fit"]
k7_fn = ("strided_fir_kernel",)
tw = torch.from_numpy(fir.design_decimation_fir(41, 10_000_000.0)).to(dev)
xs = torch.from_numpy((0.1 * (rng.standard_normal(247_030) + 1j * rng.standard_normal(247_030)))
                      .astype(np.complex64)).to(dev)
dphi = tuning_word(-torch.tensor([700_000.0, -1_200_000.0], device=dev), 10_000_000.0)
p0 = torch.from_numpy(np.array([12345, 4_000_000_000], np.uint32)).to(dev)
k7.append(dict(name="K7_strided_fir", case="turn: a mesh shard's wide slots, 2 x 247,030 -> 6,000",
               ms=cs.device_ms(lambda: fir.strided_fir(xs, tw, 41, nco=(dphi, p0)), k7_fn)))
from wavecap_tpu_torch.capture.pipeline import WideSlotConfig
for rate in (20_000_000, 25_000_000):
    d_r = WideSlotConfig(sample_rate=rate).decim
    t_r = torch.from_numpy(fir.design_decimation_fir(d_r, float(rate))).to(dev)
    x_r = torch.from_numpy((0.1 * (rng.standard_normal(rate // 5) + 1j * rng.standard_normal(rate // 5)))
                           .astype(np.complex64)).to(dev)
    h_r = torch.zeros((2, t_r.shape[0] - 1), dtype=torch.complex64, device=dev)
    dphi_r = tuning_word(-torch.tensor([700_000.0, -1_200_000.0], device=dev), float(rate))
    try:
        ms = cs.device_ms(lambda: fir.strided_fir(x_r, t_r, d_r, head=h_r, nco=(dphi_r, p0)), k7_fn)
    except NotImplementedError as e:
        ms = f"refused: {e}"
    k7.append(dict(name="K7_strided_fir", case=f"turn: wide slots at {rate / 1e6:g} Msps, 2 x {rate // 5} "
                   f"-> {(rate // 5 - 1) // d_r + 1}, {t_r.shape[0]} taps", ms=ms))
lpf, rrc = c4fm._filters_on(50_000.0, 0.2, dev)
for taps, cplx in ((lpf, True), (rrc, False)):
    xf = rng.standard_normal((50, 1_500 + taps.shape[0] - 1))
    xf = xf + 1j * rng.standard_normal(xf.shape) if cplx else xf
    xf = torch.from_numpy(xf.astype(np.complex64 if cplx else np.float32)).to(dev)
    k7.append(dict(name="K7_strided_fir", case=f"turn: program F's per-shard {taps.shape[0]} taps, "
                   f"{tuple(xf.shape)} {'complex' if cplx else 'real'}",
                   ms=cs.device_ms(lambda: fir.strided_fir(xf, taps, 1), k7_fn)))
grid = cqpsk._cfg_grid(p25_cfg_for(cs.p25_configs()["B"]), dev)
xl = torch.from_numpy((rng.standard_normal((1, 60_000)) + 1j * rng.standard_normal((1, 60_000)))
                      .astype(np.complex64)).to(dev)
acc = torch.zeros((1, grid.n_tau + 1), dtype=torch.complex64, device=dev)
on = torch.ones(1, dtype=torch.bool, device=dev)
try:
    ms = cs.device_ms(lambda: eqz.echo_fit(xl, acc, on, grid, 41, 0.01, 0.35, 0.6, 0.5),
                      ("acf_kernel", "residual_kernel", "epilogue_kernel"))
except NotImplementedError as e:
    ms = f"refused: {e}"
k14.append(dict(name="K14_echo_fit", case="turn: fit, one 60,000-sample row", ms=ms))
print(json.dumps(dict(checkout=sys.argv[1], K13cfo=k13, K1=k1, K2=k2, K3=k3, K4=k4, K12=k12, K12s=k12s, K9=k9,
                      K5=k5, K10=k10, K11=k11, K7=k7, K14=k14), default=float))
"""


def phase2_turns(other: str, out: str | None) -> int:
    """``--phase2-turns``: see the module's docstring."""
    from pathlib import Path

    here = str(Path(__file__).resolve().parent)
    other = str(Path(other).resolve())
    card = card_line()
    log(card)
    lines = []
    for root in (other, here, here, other):
        proc = subprocess.run([sys.executable, "-c", PHASE2_TURN, root, here], cwd=root,
                              env=dict(os.environ, PYTHONPATH=root), capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            print(f"chip_smoke: the turn in {root} failed\n{proc.stdout[-2000:]}{proc.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        line = dict(json.loads(proc.stdout.strip().splitlines()[-1]), card=card)
        log(line)
        lines.append(line)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text("".join(json.dumps(line) + "\n" for line in lines))
    # the scans' outputs and K13's CFO residuals of this checkout's turns
    # against the other's, where both ran: bit for bit
    parity = {}
    for old_, new_ in ((lines[0], lines[1]), (lines[3], lines[2])):
        for key in ("K12s", "K13cfo"):
            for a, b in zip(old_.get(key, []), new_.get(key, [])):
                if "bits" in a and "bits" in b:
                    parity.setdefault(b["case"], []).append({k: a["bits"][k] == b["bits"][k] for k in b["bits"]})
    log(dict(phase="scan and CFO parity with the other checkout", cases=parity))
    if any(not all(d.values()) for v in parity.values() for d in v):
        print("chip_smoke: the scans' or the CFO stage's bits differ from the other checkout's", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="Chip smoke test of the PyTorch + CUDA port.")
    ap.add_argument("--phase2-turns", metavar="OTHER_CHECKOUT",
                    help="time K13's CFO stage, K1-K5, K7, K9-K14, K12s, K13s of this checkout and OTHER_CHECKOUT "
                         "in turns")
    ap.add_argument("--out", help="with --phase2-turns: also write its JSON lines here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.phase2_turns:
        return phase2_turns(args.phase2_turns, args.out)
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
    p25 = p25_configs()
    t_phases, stamps = time.perf_counter(), []

    def stamp(name: str) -> None:
        stamps.append((name, round(time.perf_counter() - t_phases, 1)))

    try:
        kernels = kernel_checks(cfg, device)
        for k in kernels:
            log(dict(phase="kernel", **k))
        for k in k1_k3_path_checks(device):
            log(dict(phase="kernel-case", **k))
        for k in k4_k12_path_checks(device):
            log(dict(phase="kernel-case", **k))
        log(dict(phase="empty blocks", **empty_block_checks(device)))
        stamp("kernel checks")
        # the P25 kernels before the mixed checks' plain scans, whose many
        # thousand launches make CUPTI drop later ones (see device_ms)
        p25_lines, cases = p25_kernel_checks(p25, device)
        for k in cases:
            log(dict(phase="kernel-case", **k))
        kernels += p25_lines
        d_lines, cases = engine_kernel_checks(device)
        for k in cases:
            log(dict(phase="kernel-case", **k))
        kernels += d_lines
        mixed_lines, cases = mixed_kernel_checks(mixed, device)
        for k in cases:
            log(dict(phase="kernel-case", **k))
        kernels += mixed_lines
        # last: the scans' plain loops are ~20 launches a symbol
        scan_lines, cases = scan_kernel_checks(device)
        for k in cases:
            log(dict(phase="kernel-case", **k))
        kernels += scan_lines
        stamp("P25, engine, mixed and scan kernel checks")
        for g in other_geometry_checks(device):
            log(g)
        stamp("geometry checks")
        sl = run_slice(cfg, device)
        log(sl)
        mx = run_mixed(mixed, device)
        log(mx)
        pa = run_program_a(p25["A"], device)
        log(pa)
        pb = run_program_bc(p25["B"], device, "B")
        log(pb)
        pc = run_program_bc(p25["C"], device, "C")
        log(pc)
        stamp("slice, mixed, A, B, C")
        pa_s, pb_s, pc_s = run_scan_programs(p25, device)
        for r in (pa_s, pb_s, pc_s):
            log(r)
        stamp("scan programs")
        pd = run_engine(device)
        log({k: v for k, v in pd.items() if k != "latency_ms"})
        log(dict(phase="engine latency", latency_ms=pd["latency_ms"]))
        stamp("D")
        pe = run_engine_mesh(device)
        log({k: v for k, v in pe.items() if k not in ("latency_ms", "k15")})
        log(dict(phase="engine on the mesh latency", latency_ms=pe["latency_ms"]))
        log(dict(phase="kernel-case", **pe["k15"]))
        stamp("E")
        pf = run_program_f(p25, device)
        log(pf)
        stamp("F")
        # program G: the port's decoders on the engine's P25 banks
        log(run_program_g1(device))
        log(run_program_g2(device))
        stamp("G1, G2")
        # program H: the channel attachments and the scanner on the engine
        log(run_program_h(device))
        stamp("H")
        # program I: the port's trunking on the engine
        log(run_program_i(device))
        stamp("I")
        # program J: the port's server, harness and CLI
        log(run_program_j(device))
        stamp("J")
        # planar.py and conv_valid's banded route, off the programs' paths
        for line in run_planar_in_child():
            log(line)
        stamp("planar")
        log(dict(phase="seconds since the build", stamps=stamps))
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("bytes_per_block", "copies_per_block")
    # each kernel's launches on its own path: K4 on the first slice's, K12
    # on program A's, K13 and K14 on program B's, K11 on the engine's
    # (program D), the others on the mixed capture's
    path = {"K4_voice_fir": sl, "K12_c4fm_timing": pa, "K13_cqpsk_timing": pb,
            "K13_cfo_power": pb, "K13_cfo_lines": pb, "K14_echo_fit": pb, "K11a_noise_blanker": pd,
            "K11b_nr_frames": pd, "K11b_nr_gain": pd, "K11b_nr_overlap_add": pd,
            "K12s_c4fm_scan": pa_s, "K13s_cqpsk_scan": pb_s}
    for k in kernels:
        k["launches"] = path.get(k["name"], mx)["launches"][k["name"]]
        if k["launches"] == 0:
            print(f"chip_smoke: FAILED: {k['name']} was not launched on its path", file=sys.stderr)
            return 1
    # K15 on program E's path: every exchange copy of its run
    k15 = dict(pe["k15"], launches=sum(v["copies"] for v in pe["copies"].values()))
    kernels.append(k15)
    if {k["name"] for k in kernels} != set(launch_counts()) | {"K15_exchanges"}:
        print("chip_smoke: FAILED: a kernel was not checked", file=sys.stderr)
        return 1
    log({"kernels": [{**{key: k[key] for key in keys}, **{key: k[key] for key in extra if key in k}}
                     for k in kernels]})
    log(card)
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
