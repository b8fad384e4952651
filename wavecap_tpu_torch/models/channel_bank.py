"""Channel bank: one wideband stream -> many demodulated audio channels.

Counterpart of ``wavecap_tpu/models/channel_bank.py``.  The channelizer
produces every channel at once, and one demod mode runs over a static
number of slots; where the reference ``vmap``s a per-slot function, the
port writes the slot axis out.  Per-slot routing (channel index, fine
offset, active mask, squelch) is data, so retuning changes no shape.

Two kernels carry the bank's own work on the card, each with its plain
version here:

* K3 ``slot_frontend``: gather of the slot's channel row, the exact
  uint32 NCO shift and RSSI, then for NBFM the FM discriminator; for the
  other modes, and for NBFM with the noise blanker (which the reference
  runs on the shifted IQ before the discriminator), it writes the shifted
  rows, which the mode's demod takes (through the registry) on the whole
  ``(capacity, S)`` batch;
* K4 ``voice_fir``: NBFM's 127-tap voice-band FIR (``filter_impl="fir"``)
  with its overlap-save carry, RMS normalization, soft clip, squelch and
  the active mask.

Every other bank ends with the reference's squelch and active-mask
epilogue in torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import ops
from ..kernels import launch
from ..ops.channelizer import ChannelizerConfig, channelize, channelizer_init
from ..utils.torchenv import DeviceLike, resolve_device
from .analog import NbfmConfig, nbfm_audio, voice_band_taps
from .registry import get_demod

_CLIP_GAIN = float(np.float32(1.0 / np.tanh(1.5)) * np.float32(0.95))  # soft_clip's
_MIN_RMS = 1e-4  # rms_normalize's default
_K3_V = 4  # consecutive samples a K3 thread takes a pass
_K3_WARP_SPAN = 32 * _K3_V  # a K3 segment is a multiple of a warp's samples
_K3_MAX_CLUSTER = 8  # CTAs (one cluster) a row
_K3_MAX_THREADS = 512
_K3_SMS = 132  # SMs of the H100
_K3_TARGET_CTAS = 4 * _K3_SMS  # CTAs a launch aims at: four an SM
_K4_R = 16  # consecutive outputs a K4 thread forms a pass
_K4_WARP_SPAN = 32 * _K4_R  # outputs a warp forms a pass
_K4_MAX_CLUSTER = 8  # CTAs (one cluster) a row
# CTAs a row for the rows left over after the whole rows: clusters of 3, 4
# or 8 at three CTAs an SM do not all fit on the card at once, and those
# that wait start a second round (scripts/k4_k12_variants.py)
_K4_CUT_CLUSTER = 2
_K4_MAX_THREADS = 384
_K4_REGS = 56  # registers a K4 thread holds (the kernel's launch bounds cap them)
_K4_SMEM = 232_448  # shared memory of an H100 SM, bytes


@dataclass(frozen=True)
class ChannelBankConfig:
    channelizer: ChannelizerConfig
    mode: str  # demod mode for every slot in this bank
    demod_cfg: Any  # demod config at the channelizer's channel rate
    capacity: int = 8  # static slot count


class ChannelBankState(NamedTuple):
    chan_state: torch.Tensor  # channelizer history
    demod_states: Any  # stacked demod state, leading axis = capacity
    nco_phase: torch.Tensor  # (capacity,) uint32 fine-shift phase


class ChannelAssignment(NamedTuple):
    """Per-slot routing (update freely; no shape changes)."""

    channel_index: torch.Tensor  # (capacity,) int32 channelizer bin
    fine_offset_hz: torch.Tensor  # (capacity,) f32 residual offset
    active: torch.Tensor  # (capacity,) bool
    squelch_db: torch.Tensor  # (capacity,) f32 dBFS threshold (-1e9 = open)


def _check_bank(cfg: ChannelBankConfig):
    get_demod(cfg.mode)  # raises for a mode neither package knows
    return cfg.demod_cfg


def _voice_fir_path(cfg: ChannelBankConfig) -> bool:
    """NBFM whose audio chain is the voice-band FIR alone: kernel K4 (the
    noise reduction sits between the FIR and the normalization)."""
    dc = cfg.demod_cfg
    return (cfg.mode.lower() == "nbfm" and dc.filter_impl == "fir"
            and (dc.enable_highpass or dc.enable_lowpass)
            and not dc.enable_deemphasis and not dc.notch_frequencies
            and not dc.enable_noise_reduction)


def assignment_init(capacity: int, device: DeviceLike = None) -> ChannelAssignment:
    dev = resolve_device(device)
    return ChannelAssignment(
        channel_index=torch.zeros(capacity, dtype=torch.int32, device=dev),
        fine_offset_hz=torch.zeros(capacity, dtype=torch.float32, device=dev),
        active=torch.zeros(capacity, dtype=torch.bool, device=dev),
        squelch_db=torch.full((capacity,), -1e9, dtype=torch.float32, device=dev),
    )


def _stack_states(state, capacity: int):
    if isinstance(state, torch.Tensor):
        return state.expand((capacity,) + tuple(state.shape)).contiguous()
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return type(state)(*(_stack_states(s, capacity) for s in state))
    return tuple(_stack_states(s, capacity) for s in state)


def bank_init(cfg: ChannelBankConfig, device: DeviceLike = None) -> ChannelBankState:
    _check_bank(cfg)
    dev = resolve_device(device)
    spec = get_demod(cfg.mode)
    return ChannelBankState(
        chan_state=channelizer_init(cfg.channelizer, device=dev),
        demod_states=_stack_states(spec.init(cfg.demod_cfg, device=dev), cfg.capacity),
        nco_phase=torch.zeros(cfg.capacity, dtype=torch.uint32, device=dev),
    )


def _on(t: torch.Tensor, device: torch.device, dtype: torch.dtype, shape: tuple, what: str):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{what} must be {dtype} of shape {shape} on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


# --- K3: gather + NCO + RSSI + discriminator ---------------------------------


def _k3_mode(cfg: ChannelBankConfig) -> int:
    """K3's output: 0 exact discriminator, 1 fast, 2 the shifted rows (every
    mode but NBFM, and NBFM that blanks its IQ before the discriminator)."""
    if cfg.mode.lower() != "nbfm" or cfg.demod_cfg.enable_noise_blanker:
        return 2
    return 1 if cfg.demod_cfg.fast_discriminator else 0


class K3Plan(NamedTuple):
    """How K3 runs: each row cut into ``cluster`` segments of ``seg``
    samples (a multiple of 128; the last segment may be shorter), one CTA
    of ``threads`` threads a segment, a row's CTAs one thread-block
    cluster; a CTA takes ``threads x 4`` consecutive samples a pass, in
    ``passes`` passes; ``ctas`` CTAs in all."""

    seg: int
    cluster: int
    threads: int
    passes: int
    ctas: int


def k3_plan(n_slots: int, s_len: int, mode: int, forced: tuple | None = None) -> K3Plan:
    """K3's launch plan, the one the kernel runs: as few CTAs a row (at
    most 8) as give the launch 528 CTAs, four an SM; each segment one pass
    of up to 512 threads, else passes of 256 threads (of 512 where the
    launch has fewer CTAs than the card has SMs).  ``mode`` does not change
    the plan: the same split wins for the discriminator and the rows.
    ``forced``: ``(cluster, threads)`` in its place (the cluster is then
    shrunk to the segments the row fills)."""
    spans = max(-(-s_len // _K3_WARP_SPAN), 1)
    if forced is not None:
        cluster, threads = forced
    else:
        cluster = min(_K3_MAX_CLUSTER, spans, max(1, -(-_K3_TARGET_CTAS // max(n_slots, 1))))
        threads = None
    seg = -(-spans // cluster) * _K3_WARP_SPAN
    cluster = max(-(-s_len // seg), 1)
    if threads is None:  # one pass; else passes of 256 threads, of 512 for a launch of few CTAs
        threads = seg // _K3_V
        if threads > _K3_MAX_THREADS:
            threads = _K3_MAX_THREADS if n_slots * cluster < _K3_SMS else _K3_MAX_THREADS // 2
    return K3Plan(seg, cluster, threads, -(-seg // (threads * _K3_V)), n_slots * cluster)


def slot_frontend_plain(chans, assign: ChannelAssignment, nco_phase, disc_prev,
                        cfg: ChannelBankConfig):
    """Plain version of K3: ``(out, rssi, nco_phase, disc_prev)`` per slot,
    where ``out`` is the NBFM discriminator or, for the other modes, the
    shifted complex rows (``disc_prev`` then passes through)."""
    idx = assign.channel_index.clamp(0, chans.shape[0] - 1).long()  # the reference clamps
    shifted, phase1 = ops.freq_shift(
        chans[idx], -assign.fine_offset_hz, cfg.channelizer.channel_rate, nco_phase
    )
    rssi = ops.rssi_dbfs(shifted)
    mode = _k3_mode(cfg)
    if mode == 2:
        return shifted, rssi, phase1, disc_prev
    dc = cfg.demod_cfg
    fm, last = ops.quadrature_demod(
        shifted, dc.sample_rate, disc_prev, max_deviation_hz=dc.max_deviation_hz,
        atan_impl="fast" if mode == 1 else "exact",
    )
    return fm, rssi, phase1, last


def slot_frontend(chans, assign: ChannelAssignment, nco_phase, disc_prev,
                  cfg: ChannelBankConfig):
    """K3: see :func:`slot_frontend_plain`.  Only a CPU tensor takes the
    plain version; the tuning words are the plain per-slot torch math.  An
    empty block launches nothing: empty rows, the mean power of no samples
    (NaN dB), the phases and ``disc_prev`` carried, as the plain version
    has them."""
    if chans.device.type == "cpu":
        return slot_frontend_plain(chans, assign, nco_phase, disc_prev, cfg)
    dev = chans.device
    if chans.dim() != 2 or chans.dtype != torch.complex64 or not chans.is_contiguous():
        raise ValueError("K3 takes contiguous complex64 channels of shape (M, S)")
    m, s = chans.shape
    mode = _k3_mode(cfg)
    c = cfg.capacity
    _on(assign.channel_index, dev, torch.int32, (c,), "channel_index")
    _on(assign.fine_offset_hz, dev, torch.float32, (c,), "fine_offset_hz")
    _on(nco_phase, dev, torch.uint32, (c,), "nco_phase")
    if mode != 2:
        _on(disc_prev, dev, torch.complex64, (c,), "disc_prev")
    if s == 0:
        rows = torch.empty((c, 0), dtype=torch.complex64 if mode == 2 else torch.float32, device=dev)
        return (rows, torch.full((c,), float("nan"), dtype=torch.float32, device=dev),
                nco_phase.clone(), disc_prev)
    plan = k3_plan(c, s, mode)
    dphi = ops.tuning_word(-assign.fine_offset_hz, cfg.channelizer.channel_rate).contiguous()
    rssi = torch.empty(c, dtype=torch.float32, device=dev)
    phase1 = torch.empty(c, dtype=torch.uint32, device=dev)
    if mode == 2:
        rows = torch.empty((c, s), dtype=torch.complex64, device=dev)
        launch("K3_slot_frontend", dev, chans, assign.channel_index, dphi, nco_phase, None,
               rows, rssi, phase1, None, c, m, s, 0.0, mode, plan.seg, plan.cluster, plan.threads)
        return rows, rssi, phase1, disc_prev
    dc = cfg.demod_cfg
    fm = torch.empty((c, s), dtype=torch.float32, device=dev)
    last = torch.empty(c, dtype=torch.complex64, device=dev)
    scale = float(np.float32(dc.sample_rate / (2.0 * np.pi * dc.max_deviation_hz)))
    launch(
        "K3_slot_frontend", dev, chans, assign.channel_index, dphi, nco_phase, disc_prev,
        fm, rssi, phase1, last, c, m, s, scale, mode, plan.seg, plan.cluster, plan.threads,
    )
    return fm, rssi, phase1, last


# --- K4: voice FIR + normalize + clip + squelch ------------------------------


@lru_cache(maxsize=32)
def _taps(dc: NbfmConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(voice_band_taps(dc)).to(device)


def voice_fir_plain(fm, hp_z, rssi, assign: ChannelAssignment, cfg: ChannelBankConfig):
    """Plain version of K4: ``(audio, rssi, hp_z)`` per slot."""
    dc = cfg.demod_cfg
    audio, hp_z = ops.fir_filter(fm, _taps(dc, fm.device), hp_z)
    audio = ops.soft_clip(ops.rms_normalize(audio, dc.target_rms))
    audio = ops.squelch_gate(audio, rssi, assign.squelch_db)
    audio = torch.where(assign.active[:, None], audio, torch.zeros_like(audio))
    rssi = torch.where(assign.active, rssi, torch.full_like(rssi, -200.0))
    return audio, rssi, hp_z


class K4Plan(NamedTuple):
    """How K4 runs: ``ctas`` CTAs of ``threads`` threads, as many as the
    card holds at once, in thread-block clusters of ``cluster``.  Each CTA
    first filters ``whole`` rows alone (CTA ``b``: rows ``b, b + ctas,
    ...``; one pass a row), then the rows left are cut into ``cluster``
    segments of ``seg`` outputs (a multiple of 16; the last segment may be
    shorter), one CTA a segment: cluster ``c`` takes the left rows ``c, c +
    ctas / cluster, ...``.  A thread forms 16 consecutive outputs a pass,
    ``passes`` passes a segment (with one, the outputs stay in registers
    until the row's gain is known); a CTA fetches its next row's inputs
    while it filters one."""

    seg: int
    cluster: int
    threads: int
    passes: int
    ctas: int
    whole: int


def _k4_resident(threads: int) -> int:
    """K4's CTAs of ``threads`` threads that the card holds at once."""
    warps = threads // 32  # a CTA's warps take an SM's four register files in turn
    span = threads * _K4_R + 128  # a pass's staged inputs, padded, on 16 bytes
    smem = 4 * (2 * -(-(span + span // 16 + 1) // 4) * 4 + threads * _K4_R) + 2048
    return _K3_SMS * max(1, min(2048 // threads, (16384 // (32 * _K4_REGS)) // -(-warps // 4),
                                _K4_SMEM // smem))


def k4_plan(n_slots: int, s_len: int, n_taps: int = 127, forced: tuple | None = None) -> K4Plan:
    """K4's launch plan, the one the kernel runs.  Where one CTA of at most
    384 threads forms a whole row in one pass and the rows outnumber the
    CTAs the card holds at once (the slice), each CTA takes whole rows
    alone, as many rounds as every CTA has a row, and the rows left over
    are each cut into two segments over a cluster of 2 CTAs, so that the
    launch ends on half rows rather than on a few CTAs filtering a last
    whole row each.  Otherwise
    every row is cut: as few CTAs a row (at most 8, each at least a warp's
    512 outputs) as give the launch 528 CTAs, four an SM, and no fewer than
    keep a segment to one pass of at most 384 threads; a segment one pass
    where it fits, else passes of 384 threads.  ``n_taps`` only checks the
    kernel's filter length.  ``forced``: ``(cluster, threads)`` or
    ``(cluster, threads, ctas)`` of the second kind in its place (the
    cluster then shrunk to the segments the row fills, the CTAs to whole
    clusters of at most a row each)."""
    if n_taps != 127:
        raise ValueError(f"K4 runs the 127-tap voice FIR, not {n_taps} taps")
    spans = max(-(-s_len // _K4_R), 1)  # groups of 16 outputs
    if forced is None and spans <= _K4_MAX_THREADS:
        threads = -(-spans // 32) * 32  # a whole row in one pass
        resident = _k4_resident(threads)
        if n_slots >= resident:
            left = n_slots % resident
            cluster = min(_K4_CUT_CLUSTER, -(-spans // 32), max(1, resident // left)) if left else 1
            ctas = resident // cluster * cluster
            seg = -(-spans // cluster) * _K4_R
            return K4Plan(seg, max(-(-s_len // seg), 1), threads, 1, ctas, n_slots // ctas)
    ctas = None
    if forced is not None:
        cluster, threads = forced[:2]
        ctas = forced[2] if len(forced) > 2 else None
    else:
        one_pass = -(-spans // _K4_MAX_THREADS)  # CTAs a row for one pass of 384 threads
        cluster = min(_K4_MAX_CLUSTER, -(-spans // 32),  # a segment at least a warp's pass
                      max(one_pass, -(-_K3_TARGET_CTAS // max(n_slots, 1))))
        threads = None
    seg = -(-spans // cluster) * _K4_R
    cluster = max(-(-s_len // seg), 1)
    if threads is None:
        threads = min(_K4_MAX_THREADS, -(-seg // _K4_WARP_SPAN) * 32)
    clusters = min(n_slots, max(1, (ctas or _k4_resident(threads)) // cluster))
    return K4Plan(seg, cluster, threads, -(-seg // (threads * _K4_R)), clusters * cluster, 0)


def voice_fir(fm, hp_z, rssi, assign: ChannelAssignment, cfg: ChannelBankConfig):
    """K4: see :func:`voice_fir_plain`.  Only a CPU tensor takes the plain
    version.  An empty block launches nothing: the audio is empty, the
    tail carries over and the RSSI is masked, as the plain version has it."""
    if fm.device.type == "cpu":
        return voice_fir_plain(fm, hp_z, rssi, assign, cfg)
    dev = fm.device
    c = cfg.capacity
    if fm.dim() != 2 or fm.shape[0] != c:
        raise ValueError(f"K4 takes discriminator rows of shape ({c}, S)")
    s = fm.shape[1]
    taps = _taps(cfg.demod_cfg, dev)
    n_taps = taps.shape[0]
    _on(fm, dev, torch.float32, (c, s), "fm")
    _on(hp_z, dev, torch.float32, (c, n_taps - 1), "hp_z")
    _on(rssi, dev, torch.float32, (c,), "rssi")
    _on(assign.squelch_db, dev, torch.float32, (c,), "squelch_db")
    _on(assign.active, dev, torch.bool, (c,), "active")
    if s == 0:
        return fm, torch.where(assign.active, rssi, torch.full_like(rssi, -200.0)), hp_z
    plan = k4_plan(c, s, n_taps)
    audio = torch.empty((c, s), dtype=torch.float32, device=dev)
    rssi_out = torch.empty(c, dtype=torch.float32, device=dev)
    tail_out = torch.empty((c, n_taps - 1), dtype=torch.float32, device=dev)
    launch(
        "K4_voice_fir", dev, fm, hp_z, taps, rssi, assign.squelch_db, assign.active,
        audio, rssi_out, tail_out, c, s, n_taps, float(cfg.demod_cfg.target_rms),
        _MIN_RMS, _CLIP_GAIN, plan.seg, plan.cluster, plan.threads, plan.passes, plan.ctas,
        plan.whole,
    )
    return audio, rssi_out, tail_out


# --- the bank ----------------------------------------------------------------


def bank_demod_step(
    chans: torch.Tensor,
    state: ChannelBankState,
    assign: ChannelAssignment,
    cfg: ChannelBankConfig,
):
    """Demod bank over pre-channelized output ``chans`` of shape (M, S).

    Returns ``(out, state)``; ``state.chan_state`` passes through untouched
    (the caller owns the shared channelizer history).
    """
    dc = _check_bank(cfg)
    ds = state.demod_states
    if _k3_mode(cfg) != 2:  # NBFM: K3 runs the discriminator
        fm, rssi, nco_phase, disc_prev = slot_frontend(
            chans, assign, state.nco_phase, ds.disc_prev, cfg
        )
        ds = ds._replace(disc_prev=disc_prev)
        if _voice_fir_path(cfg):
            fm, rs_tail = ops.resample_poly_stream(fm, dc.sample_rate, dc.audio_rate, ds.rs_tail)
            audio, rssi, hp_z = voice_fir(fm, ds.hp_z, rssi, assign, cfg)
            out = {"audio": audio, "rssi": rssi}
            return out, ChannelBankState(state.chan_state, ds._replace(hp_z=hp_z, rs_tail=rs_tail),
                                         nco_phase)
        audio, ds = nbfm_audio(fm, ds, dc)
    else:
        shifted, rssi, nco_phase, _ = slot_frontend(chans, assign, state.nco_phase, None, cfg)
        audio, ds = get_demod(cfg.mode).demod(shifted, ds, dc)
    audio = ops.squelch_gate(audio, rssi, assign.squelch_db)
    audio = torch.where(assign.active[:, None], audio, torch.zeros_like(audio))
    rssi = torch.where(assign.active, rssi, torch.full_like(rssi, -200.0))
    out = {"audio": audio, "rssi": rssi}
    return out, ChannelBankState(state.chan_state, ds, nco_phase)


def bank_step(
    iq: torch.Tensor,
    state: ChannelBankState,
    assign: ChannelAssignment,
    cfg: ChannelBankConfig,
):
    """Standalone wideband step: channelize + demod bank (single-bank use)."""
    chans, chan_state = channelize(iq, state.chan_state, cfg.channelizer)
    out, state = bank_demod_step(chans, state, assign, cfg)
    return out, state._replace(chan_state=chan_state)
