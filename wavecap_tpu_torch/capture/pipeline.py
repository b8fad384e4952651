"""Per-capture block step: spectrum, channel banks, wide (WBFM) slots and
the P25 banks.

Counterpart of ``wavecap_tpu/capture/pipeline.py``.  One block becomes,
in one step on the card: the sampled spectrum, the whole-block RSSI,
every narrowband channel through one channelizer pass and one demod bank
per bank key (any analog mode), the wide slots (an NCO shift and a
decimating FIR of the whole block, then WBFM), the P25 symbol banks (the
4800-baud C4FM or CQPSK bank and the 6000-baud Phase 2 bank, soft
symbols), and one packed uint8 wire buffer that the host fetches.

With ``audio_fetch_slots`` set, only the listener-selected slots' audio
rows (``CaptureControl.audio_sel``) ride the wire.

The transports are the engine's: i16 pairs in int32 words, the adaptive
i8 pairs in int16 words and i4 nibble pairs in int8 words (each with its
block's f32 scale, a tensor on the card), or interleaved f32.  Kernel K1
unpacks the words while it builds the channelizer's arms, and also
writes the complex block for the spectrum, the RSSI, the wide slots and
the next history.  Kernel K7 shifts and decimates the block for each
wide slot group in one launch.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from functools import lru_cache
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import ops
from ..models import channel_bank
from ..models.channel_bank import (
    ChannelAssignment,
    ChannelBankConfig,
    _stack_states,
    assignment_init,
    bank_demod_step,
    bank_init,
)
from ..models.analog import WbfmConfig, wbfm_demod_baseband, wbfm_init
from ..models.p25.c4fm import C4fmConfig, c4fm_demodulate, c4fm_init
from ..models.p25.cqpsk import CqpskConfig, cqpsk_demodulate, cqpsk_init
from ..models.registry import get_demod
from ..ops.channelizer import ChannelizerConfig, _channelize, channelizer_init, unpack_words
from ..ops import fir as fir_ops
from ..utils.torchenv import DeviceLike, resolve_device

NARROW_MODES = ("nbfm", "am", "sam", "usb", "lsb")
WIDE_RATE = 240_000  # WBFM intermediate rate

# --- device->host wire formats ----------------------------------------------
# Each output leaf rides its natural wire width instead of f32: audio as
# i16, the P25 soft symbols as i8 at 1/16 resolution, the wide slots'
# pre-MPX baseband as i16 at +-8; the rest (spectrum dB, rssi) as f32.
# ``pack_wire`` builds the one fetched uint8 buffer on the device;
# ``unpack_wire`` reverses it on the host from the shapes of the
# unfetched leaves.
_WIRE_SPECS: dict[str, tuple] = {
    "audio": (torch.int16, 32767.0),
    "soft": (torch.int8, 16.0),
    "baseband": (torch.int16, 4095.0),
}
_NP_DTYPES = {
    torch.int8: np.dtype(np.int8),
    torch.int16: np.dtype(np.int16),
    torch.float32: np.dtype(np.float32),
}


def wire_spec(name: str) -> tuple:
    """Wire (dtype, scale) for an output-leaf name; f32 passthrough default."""
    return _WIRE_SPECS.get(name, (torch.float32, 1.0))


def _leaves(tree, name: str = ""):
    """(leaf name, leaf) of nested dicts in the reference's flatten order
    (``jax.tree_util`` sorts dict keys)."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], str(key))
    else:
        yield name, tree


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], leaves) for key in sorted(tree)}
    return next(leaves)


def pack_wire(out: dict) -> torch.Tensor:
    """Concatenate every output leaf into ONE uint8 buffer (one fetch)."""
    parts = []
    for name, leaf in _leaves(out):
        dtype, scale = wire_spec(name)
        if dtype == torch.float32:
            enc = leaf.to(torch.float32)
        else:
            info = torch.iinfo(dtype)
            enc = torch.clamp(
                torch.round(leaf.to(torch.float32) * scale), info.min + 1, info.max
            ).to(dtype)
        parts.append(enc.contiguous().reshape(-1).view(torch.uint8))
    return torch.cat(parts)


def unpack_wire(unpacked: dict, flat_u8: np.ndarray) -> dict:
    """Host-side inverse of :func:`pack_wire` for a stacked batch.

    ``unpacked`` holds the unfetched leaves (only their shapes are read,
    with a leading block axis); ``flat_u8`` is the fetched ``(n, bytes)``
    uint8 buffer."""
    flat_u8 = np.asarray(flat_u8)
    rebuilt = []
    off = 0
    for name, leaf in _leaves(unpacked):
        dtype, scale = wire_spec(name)
        np_dtype = _NP_DTYPES[dtype]
        shape = tuple(leaf.shape)
        per = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        nb = per * np_dtype.itemsize
        # a copy: every leaf owns its memory (the engine reuses the buffer)
        raw = np.array(flat_u8[:, off : off + nb], order="C").view(np_dtype)
        arr = raw.reshape(shape)
        if np_dtype != np.float32:
            arr = arr.astype(np.float32) * np.float32(1.0 / scale)
        rebuilt.append(arr)
        off += nb
    return _rebuild(unpacked, iter(rebuilt))


def bank_key_parts(entry) -> tuple[str, tuple]:
    """A ``narrow_modes`` entry -> ``(mode, dsp_overrides)``."""
    if isinstance(entry, str):
        return entry, ()
    mode, opts = entry
    return mode, tuple(opts)


@dataclass(frozen=True)
class WideSlotConfig:
    """Direct-path (WBFM) slot group config."""

    sample_rate: int
    capacity: int = 2
    audio_rate: int = 48_000
    dsp: tuple = ()  # WbfmConfig overrides ((field, value), ...)

    @property
    def decim(self) -> int:
        return max(1, int(self.sample_rate) // WIDE_RATE)

    @property
    def if_rate(self) -> int:
        return int(self.sample_rate) // self.decim

    def wbfm_cfg(self) -> WbfmConfig:
        return WbfmConfig(sample_rate=self.if_rate, audio_rate=self.audio_rate, **dict(self.dsp))


@dataclass(frozen=True)
class CapturePipelineConfig:
    sample_rate: int
    block_size: int
    fft_size: int = 2048
    # bank keys present: mode strings and/or (mode, dsp_overrides) tuples
    narrow_modes: tuple = ()
    narrow_capacity: int = 8
    channel_bandwidth: float = 25_000.0
    wide_capacity: int = 0
    p25_capacity: int = 0
    p25_modulation: str = "c4fm"
    p25p2_capacity: int = 0
    p25_equalizer_taps: int = 0
    audio_rate: int = 48_000
    export_wide_baseband: bool = False
    wide_groups: tuple = ()
    # > 0: only these listener-selected slots' audio rides the wire
    audio_fetch_slots: int = 0
    spectrum_frames: int = 2

    def channelizer(self) -> ChannelizerConfig:
        return ChannelizerConfig(
            sample_rate=float(self.sample_rate),
            channel_bandwidth=self.channel_bandwidth,
        )

    def bank_cfg(self, entry) -> ChannelBankConfig:
        ch = self.channelizer()
        rate = int(ch.channel_rate)
        mode, opts = bank_key_parts(entry)
        spec = get_demod(mode)
        kwargs: dict[str, Any] = dict(sample_rate=rate, audio_rate=self.audio_rate)
        if mode == "nbfm":
            kwargs.update(enable_highpass=True, enable_lowpass=True)
        if mode in ("usb", "lsb"):
            kwargs.update(mode=mode)
        kwargs.update(dict(opts))  # per-channel DSP overrides win
        return ChannelBankConfig(
            channelizer=ch,
            mode=mode,
            demod_cfg=spec.config_cls(**kwargs),
            capacity=self.narrow_capacity,
        )

    def wide_cfg(self, dsp: tuple = ()) -> WideSlotConfig:
        return WideSlotConfig(
            sample_rate=self.sample_rate,
            capacity=self.wide_capacity,
            audio_rate=self.audio_rate,
            dsp=dsp,
        )


class WideState(NamedTuple):
    nco_phase: torch.Tensor  # (W,) uint32
    fir_tail: torch.Tensor  # (W, taps-1) complex64
    demod_states: Any  # stacked WbfmState


class WideAssignment(NamedTuple):
    offset_hz: torch.Tensor  # (W,) f32 from capture center
    active: torch.Tensor  # (W,) bool
    squelch_db: torch.Tensor  # (W,) f32


class P25BankState(NamedTuple):
    nco_phase: torch.Tensor  # (P,) uint32
    c4fm: Any  # stacked C4fmState or CqpskState


class CaptureState(NamedTuple):
    chan_state: torch.Tensor | None  # shared channelizer history
    banks: dict  # bank key -> ChannelBankState
    wide: dict | None = None  # dsp key -> WideState (one group per DSP set)
    p25: P25BankState | None = None
    p25p2: P25BankState | None = None  # Phase 2 6000-baud H-DQPSK bank


class CaptureControl(NamedTuple):
    banks: dict  # bank key -> ChannelAssignment
    wide: dict | None = None  # dsp key -> WideAssignment
    p25: ChannelAssignment | None = None
    p25p2: ChannelAssignment | None = None
    # bank key -> (audio_fetch_slots,) int32 slot indices whose audio rides
    # the wire (present only when cfg.audio_fetch_slots > 0)
    audio_sel: dict | None = None


def wide_assignment_init(capacity: int, device: DeviceLike = None) -> WideAssignment:
    dev = resolve_device(device)
    return WideAssignment(
        offset_hz=torch.zeros(capacity, dtype=torch.float32, device=dev),
        active=torch.zeros(capacity, dtype=torch.bool, device=dev),
        squelch_db=torch.full((capacity,), -1e9, dtype=torch.float32, device=dev),
    )


def _wide_taps(cfg: WideSlotConfig) -> np.ndarray:
    return fir_ops.design_decimation_fir(cfg.decim, float(cfg.sample_rate))


@lru_cache(maxsize=16)
def _wide_taps_on(cfg: WideSlotConfig, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_wide_taps(cfg)).to(device)


def wide_init(cfg: WideSlotConfig, device: DeviceLike = None) -> WideState:
    dev = resolve_device(device)
    taps = _wide_taps(cfg)
    w = cfg.capacity
    return WideState(
        nco_phase=torch.zeros(w, dtype=torch.uint32, device=dev),
        fir_tail=torch.zeros((w, len(taps) - 1), dtype=torch.complex64, device=dev),
        demod_states=_stack_states(wbfm_init(cfg.wbfm_cfg(), device=dev), w),
    )


def p25_cfg_for(cfg: CapturePipelineConfig):
    """The 4800-baud bank's demod config (``WAVECAP_P25_TIMING`` picks the
    timing, as in the reference; only "block" is ported)."""
    rate = int(cfg.channelizer().channel_rate)
    timing = os.environ.get("WAVECAP_P25_TIMING", "block")
    cls = CqpskConfig if cfg.p25_modulation == "cqpsk" else C4fmConfig
    return cls(sample_rate=rate, timing_impl=timing, equalizer_taps=cfg.p25_equalizer_taps)


def _p25_fns(cfg: CapturePipelineConfig):
    if cfg.p25_modulation == "cqpsk":
        return cqpsk_init, cqpsk_demodulate
    return c4fm_init, c4fm_demodulate


def p25p2_cfg_for(cfg: CapturePipelineConfig) -> CqpskConfig:
    """Phase 2 TDMA voice: 6000-baud H-DQPSK, full-excess-bandwidth RRC."""
    rate = int(cfg.channelizer().channel_rate)
    timing = os.environ.get("WAVECAP_P25_TIMING", "block")
    return CqpskConfig(sample_rate=rate, symbol_rate=6000.0, rrc_alpha=1.0, timing_impl=timing)


def p25_init(cfg: CapturePipelineConfig, device: DeviceLike = None) -> P25BankState:
    init_fn, _ = _p25_fns(cfg)
    dev = resolve_device(device)
    p = cfg.p25_capacity
    return P25BankState(nco_phase=torch.zeros(p, dtype=torch.uint32, device=dev),
                        c4fm=_stack_states(init_fn(p25_cfg_for(cfg), device=dev), p))


def p25p2_init(cfg: CapturePipelineConfig, device: DeviceLike = None) -> P25BankState:
    dev = resolve_device(device)
    p = cfg.p25p2_capacity
    return P25BankState(nco_phase=torch.zeros(p, dtype=torch.uint32, device=dev),
                        c4fm=_stack_states(cqpsk_init(p25p2_cfg_for(cfg), device=dev), p))


def pipeline_init(cfg: CapturePipelineConfig, device: DeviceLike = None) -> CaptureState:
    dev = resolve_device(device)
    banks = {m: bank_init(cfg.bank_cfg(m), device=dev) for m in cfg.narrow_modes}
    wide = ({g: wide_init(cfg.wide_cfg(g), device=dev) for g in cfg.wide_groups}
            if cfg.wide_capacity > 0 else None)
    p25 = p25_init(cfg, device=dev) if cfg.p25_capacity > 0 else None
    p25p2 = p25p2_init(cfg, device=dev) if cfg.p25p2_capacity > 0 else None
    needs_chan = bool(cfg.narrow_modes) or cfg.p25_capacity > 0 or cfg.p25p2_capacity > 0
    chan = channelizer_init(cfg.channelizer(), device=dev) if needs_chan else None
    return CaptureState(chan_state=chan, banks=banks, wide=wide, p25=p25, p25p2=p25p2)


def control_init(cfg: CapturePipelineConfig, device: DeviceLike = None) -> CaptureControl:
    dev = resolve_device(device)
    banks = {m: assignment_init(cfg.narrow_capacity, device=dev) for m in cfg.narrow_modes}
    wide = ({g: wide_assignment_init(cfg.wide_capacity, device=dev) for g in cfg.wide_groups}
            if cfg.wide_capacity > 0 else None)
    p25 = assignment_init(cfg.p25_capacity, device=dev) if cfg.p25_capacity > 0 else None
    p25p2 = assignment_init(cfg.p25p2_capacity, device=dev) if cfg.p25p2_capacity > 0 else None
    audio_sel = ({m: torch.zeros(cfg.audio_fetch_slots, dtype=torch.int32, device=dev)
                  for m in cfg.narrow_modes} if cfg.audio_fetch_slots > 0 else None)
    return CaptureControl(banks=banks, wide=wide, p25=p25, p25p2=p25p2, audio_sel=audio_sel)


def _wide_step(
    iq: torch.Tensor,
    state: WideState,
    assign: WideAssignment,
    cfg: WideSlotConfig,
    export_baseband: bool = False,
):
    """The wide slots of one group: K7 shifts each slot's offset to 0 Hz
    (the exact NCO) and decimates the whole block to the IF rate, then
    RSSI, WBFM, squelch and the active mask."""
    taps = _wide_taps_on(cfg, iq.device)
    dphi = ops.tuning_word(-assign.offset_hz, cfg.sample_rate)
    dec, tails, phases = fir_ops.strided_fir(iq, taps, cfg.decim, head=state.fir_tail,
                                     nco=(dphi, state.nco_phase))
    rssi = ops.rssi_dbfs(dec)
    audio, fm, dstates = wbfm_demod_baseband(dec, state.demod_states, cfg.wbfm_cfg())
    audio = ops.squelch_gate(audio, rssi, assign.squelch_db)
    audio = torch.where(assign.active[:, None], audio, torch.zeros_like(audio))
    rssi = torch.where(assign.active, rssi, torch.full_like(rssi, -200.0))
    out = {"audio": audio, "rssi": rssi}
    if export_baseband:
        out["baseband"] = fm
    return out, WideState(phases, tails, dstates)


def _p25_step(chans, state: P25BankState, assign: ChannelAssignment,
              cfg: CapturePipelineConfig, c4, demod_fn):
    """4FSK/DQPSK symbol bank over the shared channelizer output; ``c4``
    and ``demod_fn`` select the variant (4800-baud C4FM/CQPSK bank or the
    Phase 2 6000-baud H-DQPSK bank).  K3's shifted-row mode gathers each
    slot's channel, shifts it by its fine offset and takes its RSSI."""
    front = ChannelBankConfig(channelizer=cfg.channelizer(), mode="p25-soft", demod_cfg=c4,
                              capacity=assign.channel_index.shape[0])
    shifted, rssi, phases, _ = channel_bank.slot_frontend(chans, assign, state.nco_phase, None, front)
    eq_ok = None
    if getattr(c4, "equalizer_taps", 0) > 0:
        # the echo-fit template assumes a near-bin-centred channel: gate
        # the fit on each slot's fine offset
        eq_ok = assign.fine_offset_hz.abs() <= float(np.float32(c4.eq_max_fine_offset_hz))
    soft, _dibits, c4states = demod_fn(shifted, state.c4fm, c4, eq_ok)
    rssi = torch.where(assign.active, rssi, torch.full_like(rssi, -200.0))
    # hard decisions are not exported: host consumers re-derive them from soft
    return {"soft": soft, "rssi": rssi}, P25BankState(phases, c4states)


def _to_complex(x_in: torch.Tensor, scale: torch.Tensor | None = None) -> torch.Tensor:
    """Transport words -> complex64: int8 words hold adaptive-i4 nibble
    pairs and int16 words adaptive-i8 pairs (low half I), each times the
    block's ``scale``; int32 words hold i16 pairs scaled 1/32768; f32
    holds interleaved floats."""
    if x_in.dtype in (torch.int8, torch.int16, torch.int32):
        return unpack_words(x_in, scale)
    return torch.complex(x_in[..., 0::2], x_in[..., 1::2])


def _audio_gated(cfg: CapturePipelineConfig, ctl: CaptureControl) -> bool:
    return 0 < cfg.audio_fetch_slots < cfg.narrow_capacity and ctl.audio_sel is not None


def capture_step(
    x: torch.Tensor,
    state: CaptureState,
    ctl: CaptureControl,
    cfg: CapturePipelineConfig,
    scale: torch.Tensor | None = None,
):
    """One block through the whole capture.  Returns ``(outputs, state)``.

    ``x`` is the complex64 block, interleaved f32, or transport words
    (``scale`` is the adaptive i8 / i4 block's f32 scale), which K1
    unpacks on the card as it builds the channelizer's arms.
    """
    if x.dtype == torch.float32:
        x = _to_complex(x)
    new_chan_state = state.chan_state
    chans = None
    if state.chan_state is not None:
        x, chans, new_chan_state = _channelize(x, state.chan_state, cfg.channelizer(), scale)
    elif not x.is_complex():
        x = _to_complex(x, scale)

    out: dict[str, Any] = {}
    out["spectrum"] = ops.spectrogram_sampled(x, cfg.fft_size, n_out=max(cfg.spectrum_frames, 1))
    out["rssi"] = ops.rssi_dbfs(x)

    new_banks = {}
    bank_out = {}
    for key in cfg.narrow_modes:
        o, s = bank_demod_step(chans, state.banks[key], ctl.banks[key], cfg.bank_cfg(key))
        if _audio_gated(cfg, ctl):
            # only the listener-selected rows' audio rides the wire; rssi
            # (and the demod state) stay full-capacity
            o = dict(o)
            o["audio"] = torch.index_select(o["audio"], 0, ctl.audio_sel[key])
        bank_out[key] = o
        new_banks[key] = s
    out["banks"] = bank_out

    new_wide = state.wide
    if cfg.wide_capacity > 0 and state.wide is not None and ctl.wide is not None:
        wide_out, new_wide = {}, {}
        for g in cfg.wide_groups:
            wide_out[g], new_wide[g] = _wide_step(
                x, state.wide[g], ctl.wide[g], cfg.wide_cfg(g), cfg.export_wide_baseband
            )
        out["wide"] = wide_out

    new_p25 = state.p25
    if cfg.p25_capacity > 0 and state.p25 is not None and ctl.p25 is not None:
        _, demod_fn = _p25_fns(cfg)
        out["p25"], new_p25 = _p25_step(chans, state.p25, ctl.p25, cfg, p25_cfg_for(cfg), demod_fn)
    new_p25p2 = state.p25p2
    if cfg.p25p2_capacity > 0 and state.p25p2 is not None and ctl.p25p2 is not None:
        out["p25p2"], new_p25p2 = _p25_step(chans, state.p25p2, ctl.p25p2, cfg,
                                            p25p2_cfg_for(cfg), cqpsk_demodulate)
    out["_packed"] = pack_wire(out)
    return out, CaptureState(chan_state=new_chan_state, banks=new_banks, wide=new_wide,
                             p25=new_p25, p25p2=new_p25p2)


def _stack(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


def capture_multi(
    x_rows,
    state: CaptureState,
    ctl: CaptureControl,
    cfg: CapturePipelineConfig,
):
    """Consecutive stacked blocks ``(n, N)`` through :func:`capture_step`,
    threading the state (the counterpart of ``jit_capture_multi``).
    ``x_rows`` is the stacked rows, or ``(rows, scales)`` for the adaptive
    i8 / i4 transports (``scales`` ``(n,)`` f32 on the rows' device).
    Outputs gain a leading block axis; ``_packed`` is ``(n, bytes)``."""
    rows, scales = x_rows if isinstance(x_rows, tuple) else (x_rows, None)
    outs = []
    for k in range(rows.shape[0]):
        out, state = capture_step(rows[k], state, ctl, cfg,
                                  None if scales is None else scales[k])
        outs.append(out)
    return _stack(outs), state
