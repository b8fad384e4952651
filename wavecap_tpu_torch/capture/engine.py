"""Host-side capture runtime: device reads -> block program on the card -> fan-out.

Counterpart of ``wavecap_tpu/capture/engine.py``, with its names and
behaviour: one reader thread per capture accumulates device chunks into
fixed blocks, converts them to the transport words, runs
:func:`..pipeline.capture_multi` and hands the packed wire buffer to a
fetch thread, which unpacks it and fans audio, spectrum, RSSI, IQ and
soft symbols out to bounded drop-oldest subscribers; overflow and retune
reset the carried DSP state but keep the channel assignments; channels
are slots in per-(mode, DSP overrides) banks, so create, remove and
retune touch only the control tensors while a new bank key rebuilds the
program; a health monitor restarts stalled or dead captures.

The reference's device seam (``jnp.asarray`` uploads, async jit dispatch
and an ``is_ready`` sleep-poll fetch) becomes explicit CUDA objects:

* upload: the host conversion writes each batch into a pinned staging
  buffer, from a ring of ``pipeline_depth + 2`` per transport width; the
  copy to the card runs on a copy stream, the compute stream waits on its
  event, and a staging buffer is written again only after its upload
  event has completed;
* dispatch: ``capture_multi`` is enqueued on the compute stream, then
  the packed wire buffer is copied ``non_blocking`` into a pinned fetch
  buffer (a ring too) and a ``done`` event is recorded;
* fetch: the fetch thread polls ``done.query()`` with 2 ms sleeps (so
  the wait never holds the GIL), unpacks the wire from the pinned
  buffer, fans out and returns the buffer to its ring;
* warmup: the nvcc build, the cached designs and one zeros batch per
  width of the transport ladder, under the compile watchdog's budget.

``Capture`` and ``CaptureManager`` run on the CUDA card unless
``device="cpu"`` is asked for; there the same engine runs the plain
versions synchronously (no streams, no pinned memory).  A kernel error
fails the capture: nothing falls back.

With ``CaptureConfig.mesh`` (``"stream=1,time=8"``) the block program is
the mesh's (:mod:`.mesh`): channels map to channelizer bins of one grid,
the block is uploaded to the first shard's device and the mesh step
splits it from there; the shards' streams follow the compute stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from math import gcd

import numpy as np
import torch

from ..devices.base import Device, DeviceConfig
from ..models.analog import WbfmConfig
from ..models.registry import get_demod
from ..ops.channelizer import ChannelizerConfig
from ..utils.broadcast import FanOut
from ..utils.observability import ERROR_TRACKER
from ..utils.torchenv import DeviceLike, resolve_device
from . import mesh as mesh_mod
from . import pipeline as pl
from .classifier import ChannelClassifier

logger = logging.getLogger(__name__)

WIDE_MODES = ("wbfm",)
# "dmr" rides the same 4800-baud 4FSK symbol bank as P25 C4FM
P25_MODES = ("p25", "dmr")


def dsp_key(dsp: dict) -> tuple:
    """Canonical hashable form of per-channel DSP overrides (bank key part)."""
    return tuple(
        (k, tuple(v) if isinstance(v, (list, tuple)) else v)
        for k, v in sorted(dsp.items())
    )


@dataclass
class ChannelSpec:
    """User-facing channel definition."""

    id: str
    mode: str  # wbfm | nbfm | am | sam | usb | lsb | p25 | dmr | p25p2
    frequency_hz: float  # absolute RF frequency
    squelch_db: float | None = None
    name: str = ""
    # demod-config overrides (snake_case field -> value), e.g.
    # {"enable_noise_blanker": True, "notch_frequencies": (1000.0,)}
    dsp: dict = field(default_factory=dict)


@dataclass
class CaptureConfig:
    center_hz: float = 100_000_000.0
    sample_rate: int = 2_400_000
    gain_db: float | None = None
    ppm: float = 0.0
    bandwidth_hz: float | None = None
    antenna: str | None = None
    agc: bool = False
    block_seconds: float = 0.2
    fft_size: int = 2048
    narrow_capacity: int = 8
    wide_capacity: int = 2
    p25_capacity: int = 2
    p25_modulation: str = "c4fm"  # c4fm | cqpsk
    p25p2_capacity: int = 0
    p25_equalizer_taps: int = 0
    audio_rate: int = 48_000
    channel_bandwidth: float = 25_000.0
    # > 0: fetch only this many narrow-bank audio rows per bank, chosen by
    # which channels have live audio listeners (a control tensor: listener
    # changes never rebuild); demod and RSSI still run for every slot
    audio_fetch_slots: int = 0
    # host -> card IQ transport, and the adaptive ladder's ceiling:
    # i16 pairs, or adaptive i8 / i4 with a per-block scale, or f32
    transport: str = "i16"  # i4 | i8 | i16 | f32
    adaptive_transport: bool = True
    # batches in flight beyond the one being dispatched (0 = synchronous)
    pipeline_depth: int = 1
    blocks_per_dispatch: int = 1
    # > 0: restart the capture every N seconds (not counted as a failure)
    restart_interval_s: float = 0.0
    # the multi-device mesh backend: "stream=1,time=8" shards the block over
    # its devices (torchenv.devices); None is the single-device slot banks
    mesh: str | None = None


class ChannelHandle:
    """Host-side channel: slot routing + audio subscriber fan-out."""

    def __init__(self, spec: ChannelSpec, mode_group: str, slot: int):
        self.spec = spec
        self.mode_group = mode_group  # "wide", "p25", or (mode, dsp_key)
        self.slot = slot
        self.audio = FanOut(maxsize=32)
        self.symbols = FanOut(maxsize=32)  # P25 soft-symbol batches
        self.baseband = FanOut(maxsize=16)  # wide pre-MPX discriminator
        self.rssi_db: float = -200.0
        self.rssi_history: list = []  # (time, rssi) ring, ~5 min at 5 Hz
        self.state = "active"

    def record_rssi(self, rssi: float, now: float) -> None:
        self.rssi_db = rssi
        h = self.rssi_history
        if not h or now - h[-1][0] >= 1.0:
            h.append((round(now, 1), round(rssi, 1)))
            if len(h) > 300:
                del h[: len(h) - 300]

    @property
    def id(self) -> str:
        return self.spec.id


# --- host transport conversion (the reference's engine.py:1251-1302) ---------


def pack_i16_words(blocks, out: np.ndarray | None = None) -> np.ndarray:
    """Stacked ``(n, N)`` int32 words from ``n`` complex64 blocks: I and Q
    scaled by 32767, rounded, clipped to i16 and viewed as one word."""
    if out is None:
        out = np.empty((len(blocks), np.asarray(blocks[0]).size), np.int32)
    for k, b in enumerate(blocks):
        q = np.round(np.ascontiguousarray(b).view(np.float32) * 32767.0)
        np.clip(q, -32768, 32767, out=q)
        out[k].view(np.int16)[:] = q
    return out


def _peaks(f_rows) -> np.ndarray:
    # peak from a stride-8 subsample: within ~0.1 dB for real IQ, and the
    # clip bounds any stragglers
    return np.array([max(float(np.max(np.abs(r[::8]))), 1e-12) for r in f_rows], np.float32)


def pack_i8_words(blocks, out: np.ndarray | None = None, scales: np.ndarray | None = None):
    """Adaptive i8: ``(words, scales)``, one int16 word per complex sample
    (low byte I) and each block's f32 scale (its peak / 127)."""
    f_rows = [np.ascontiguousarray(b).view(np.float32) for b in blocks]
    if out is None:
        out = np.empty((len(blocks), f_rows[0].size // 2), np.int16)
        scales = np.empty(len(blocks), np.float32)
    peaks = _peaks(f_rows)
    for k, (r, p) in enumerate(zip(f_rows, peaks)):
        q = r * np.float32(127.0 / p)
        np.rint(q, out=q)
        np.clip(q, -127, 127, out=q)
        out[k].view(np.int8)[:] = q
    scales[:] = peaks * np.float32(1.0 / 127.0)
    return out, scales


def pack_i4_words(blocks, out: np.ndarray | None = None, scales: np.ndarray | None = None):
    """Adaptive i4: ``(words, scales)``, one int8 word per complex sample
    (low nibble I, high nibble Q) and each block's f32 scale (peak / 7)."""
    f_rows = [np.ascontiguousarray(b).view(np.float32) for b in blocks]
    if out is None:
        out = np.empty((len(blocks), f_rows[0].size // 2), np.int8)
        scales = np.empty(len(blocks), np.float32)
    peaks = _peaks(f_rows)
    for k, (r, p) in enumerate(zip(f_rows, peaks)):
        q = r * np.float32(7.0 / p)
        np.rint(q, out=q)
        np.clip(q, -7, 7, out=q)
        qi = q.astype(np.int8)
        out[k] = (qi[1::2] << 4) | (qi[0::2] & 0x0F)
    scales[:] = peaks * np.float32(1.0 / 7.0)
    return out, scales


def pack_f32(blocks, out: np.ndarray | None = None) -> np.ndarray:
    """Interleaved f32 rows ``(n, 2N)``."""
    if out is None:
        out = np.empty((len(blocks), 2 * np.asarray(blocks[0]).size), np.float32)
    for k, b in enumerate(blocks):
        out[k] = np.ascontiguousarray(b).view(np.float32)
    return out


# transport -> (word dtype, words per complex sample, carries a scale)
TRANSPORTS = {
    "i16": (torch.int32, 1, False),
    "i8": (torch.int16, 1, True),
    "i4": (torch.int8, 1, True),
    "f32": (torch.float32, 2, False),
}


def convert_blocks(transport: str, blocks, words: np.ndarray, scales: np.ndarray | None) -> None:
    """The host conversion of ``blocks`` into ``words`` (and ``scales``)."""
    if transport == "i16":
        pack_i16_words(blocks, words)
    elif transport == "i8":
        pack_i8_words(blocks, words, scales)
    elif transport == "i4":
        pack_i4_words(blocks, words, scales)
    else:
        pack_f32(blocks, words)


# --- the device seam ----------------------------------------------------------


class _Stage:
    """One staging buffer: the words (and scales) of a batch on the host."""

    def __init__(self, transport: str, n: int, size: int, pinned: bool):
        dtype, per, scaled = TRANSPORTS[transport]
        self.words = torch.empty((n, per * size), dtype=dtype, pin_memory=pinned)
        self.scales = torch.empty(n, dtype=torch.float32, pin_memory=pinned) if scaled else None
        self.event: torch.cuda.Event | None = None  # its last upload

    def numpy(self):
        return self.words.numpy(), None if self.scales is None else self.scales.numpy()


class _DeviceSeam:
    """Streams, events and pinned host buffers between host and card.

    On the CPU (``device="cpu"``) there is nothing to overlap: the staging
    tensors are the batch, and the packed output is read in place."""

    def __init__(self, device: torch.device, depth: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.ring = max(0, depth) + 2
        self.copy_stream = torch.cuda.Stream(device) if self.cuda else None
        self.compute_stream = torch.cuda.Stream(device) if self.cuda else None
        self._stages: dict[tuple, list] = {}  # (transport, n, size) -> [stages, next]
        self._free: list[torch.Tensor] = []  # pinned fetch buffers not in use
        self._n_fetch = 0
        self._fcv = threading.Condition()

    def compute(self):
        """Context: this thread's work goes on the compute stream."""
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.compute_stream)

    def stage(self, transport: str, n: int, size: int) -> _Stage:
        """The next staging buffer of the ring, once its last upload is done."""
        key = (transport, n, size)
        ring = self._stages.get(key)
        if ring is None:
            ring = self._stages[key] = [
                [_Stage(transport, n, size, self.cuda) for _ in range(self.ring)], 0]
        stages, i = ring
        ring[1] = (i + 1) % len(stages)
        st = stages[i]
        if st.event is not None:
            st.event.synchronize()  # the card has read this buffer
        return st

    def staging_buffers(self) -> list[torch.Tensor]:
        return [t for stages, _ in self._stages.values() for s in stages
                for t in (s.words, s.scales) if t is not None]

    def upload(self, st: _Stage):
        """The batch on the card: ``words`` or ``(words, scales)``."""
        if not self.cuda:
            return st.words if st.scales is None else (st.words, st.scales)
        with torch.cuda.stream(self.copy_stream):
            words = st.words.to(self.device, non_blocking=True)
            scales = None if st.scales is None else st.scales.to(self.device, non_blocking=True)
            st.event = torch.cuda.Event()
            st.event.record(self.copy_stream)
        self.compute_stream.wait_event(st.event)
        # allocated on the copy stream, read on the compute stream
        words.record_stream(self.compute_stream)
        if scales is None:
            return words
        scales.record_stream(self.compute_stream)
        return words, scales

    def fetch(self, packed: torch.Tensor):
        """Enqueue the wire buffer's copy to the host on the current
        (compute) stream: ``(host view, ring buffer, done event)``."""
        if not self.cuda:
            return packed, None, None
        nbytes = packed.numel()
        buf = self._take(nbytes)
        host = buf[:nbytes].view(packed.shape)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record(self.compute_stream)
        return host, buf, done

    def _take(self, nbytes: int) -> torch.Tensor:
        deadline = time.time() + 10.0
        with self._fcv:
            while True:
                for i, b in enumerate(self._free):
                    if b.numel() >= nbytes:
                        return self._free.pop(i)
                if self._free:  # too small for this program: replace it
                    self._free.pop()
                    self._n_fetch -= 1
                if self._n_fetch < self.ring or time.time() > deadline:
                    self._n_fetch += 1
                    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                self._fcv.wait(0.1)

    def give(self, buf: torch.Tensor | None) -> None:
        if buf is None:
            return
        with self._fcv:
            self._free.append(buf)
            self._fcv.notify_all()

    def fetch_buffers(self) -> list[torch.Tensor]:
        with self._fcv:
            return list(self._free)


def _meta(tree):
    """The outputs' shapes only (``unpack_wire`` reads nothing else), so
    the card's output memory is released before the fetch."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


class Capture:
    """One device stream + its block program on the card.

    ``device`` is the SDR (the reference's name); ``torch_device`` is where
    the block program runs: ``None`` means the CUDA card (raises without
    one), ``"cpu"`` the plain versions."""

    _ids = itertools.count(1)

    def __init__(self, device: Device, config: CaptureConfig, capture_id: str | None = None,
                 torch_device: DeviceLike = None):
        self.id = capture_id or f"cap{next(self._ids)}"
        self.device = device
        self.config = config
        self.torch_device = resolve_device(torch_device)
        self._seam = _DeviceSeam(self.torch_device, config.pipeline_depth)
        self.state = "created"  # created|starting|running|stopped|failed
        self.error: str | None = None

        self.channels: dict[str, ChannelHandle] = {}
        self.iq_subs = FanOut(maxsize=8)
        self.spectrum_subs = FanOut(maxsize=8)
        # the last published frame, so snapshots answer while a rebuild stalls
        self.last_spectrum: np.ndarray | None = None

        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._step = None  # (batch, state, ctl) -> (outputs, state)
        self._init_state = None
        self._pipe_cfg: pl.CapturePipelineConfig | None = None
        self._dev_state = None
        self._pipe_gen = 0
        self._ctl = None
        self._ctl_dirty = True
        self._retune_pending = False
        # in-flight dispatched batches, drained by the fetch thread
        self._pending: deque = deque()
        self._pend_cv = threading.Condition()
        self._fetching = 0  # batches popped by the fetch thread, not yet done
        self._fetch_thread: threading.Thread | None = None
        self._wide_baseband = False
        self._audio_fp: frozenset = frozenset()
        self._audio_pos: dict = {}
        # adaptive transport: transport_active is the width of the next batch
        self.transport_active: str = config.transport
        self._adapt_ema = 0.0
        self._adapt_good = 0
        self._last_fetch_busy_ms = 0.0
        # test/simulation hook: sleep nbytes/bps after conversion
        self._upload_throttle_bps: float | None = None
        self._stream_realtime = True
        self.recovery = None

        self.classifier = ChannelClassifier(config.center_hz, config.sample_rate, config.fft_size)

        # metrics
        self.blocks_processed = 0
        self.overflow_count = 0
        self.last_block_time: float = 0.0
        self.block_ms: float = 0.0
        # per-stage wall-time totals (ms) and the dispatch count
        self.perf: dict[str, float] = {}
        # per batch: host clock from the dispatch's start to fan-out done
        self.block_latency_ms: deque = deque(maxlen=4096)
        self.warmup_error: BaseException | None = None

        # health monitoring
        self.startup_timeout_s = 120.0
        self.watchdog_timeout_s = 30.0
        self.device_open_timeout_s = 30.0
        # the first dispatch of a fresh program builds the kernels (nvcc)
        # and the cached designs: the stall watchdog must not fire then
        self.compile_timeout_s = 900.0
        self._compiling = False
        self._compile_started = 0.0
        self._program_warm = False
        self.auto_restart = True
        self.restart_count = 0
        self.max_restarts_per_hour = 6
        self._restart_times: list[float] = []
        self._health_thread: threading.Thread | None = None
        self._started_at = 0.0
        self._desired_running = False
        self._gen = 0

        self._compute_block_size()

    # -- geometry ---------------------------------------------------------

    def _compute_block_size(self) -> None:
        cfg = self.config
        ch = ChannelizerConfig(sample_rate=float(cfg.sample_rate),
                               channel_bandwidth=cfg.channel_bandwidth)
        m = ch.channel_count
        decim = max(1, int(cfg.sample_rate) // pl.WIDE_RATE)
        unit = int(np.lcm(m, decim))
        if cfg.p25_capacity > 0 or cfg.p25p2_capacity > 0:
            # whole symbols per block, or the demod slips a symbol
            for sym_rate in (4800, 6000):
                unit = int(np.lcm(unit, cfg.sample_rate // gcd(int(cfg.sample_rate), sym_rate)))
        min_block = unit
        if cfg.mesh:
            n_time = mesh_mod.parse_mesh_spec(cfg.mesh)["time"]
            # each time shard channelizes whole M-sample steps, and its
            # sub-block must cover the M*T halo history
            unit = int(np.lcm(unit, m * n_time))
            min_block = -(-(m * ch.taps_per_channel * n_time) // unit) * unit
        n = int(round(cfg.sample_rate * cfg.block_seconds))
        self.block_size = max(min_block, unit, (n // unit) * unit)
        self._channelizer = ch
        self._mesh = None  # built at the first mesh program rebuild

    # -- channel management ----------------------------------------------

    def _mode_group(self, mode: str) -> str:
        m = mode.lower()
        if m in WIDE_MODES:
            return "wide"
        if m == "p25p2":
            return "p25p2"
        if m in P25_MODES:
            return "p25"
        return m

    def _group_for(self, spec: ChannelSpec):
        """Bank group key: ("wide", dsp_key), "p25", "p25p2", or
        (mode, dsp_key) for narrow channels."""
        g = self._mode_group(spec.mode)
        if g == "wide":
            self._validate_dsp("wbfm", spec.dsp)
            return ("wide", dsp_key(spec.dsp))
        if g in ("p25", "p25p2"):
            if spec.dsp:
                raise ValueError(f"dsp options not supported for {spec.mode}")
            return g
        get_demod(g)  # unknown narrow modes fail here, before slotting
        self._validate_dsp(g, spec.dsp)
        return (g, dsp_key(spec.dsp))

    @staticmethod
    def _validate_dsp(mode: str, dsp: dict) -> None:
        if not dsp:
            return
        cfg_cls = WbfmConfig if mode == "wbfm" else get_demod(mode).config_cls
        allowed = {f.name for f in dataclasses.fields(cfg_cls)} - {
            "sample_rate", "audio_rate", "mode"}
        bad = set(dsp) - allowed
        if bad:
            raise ValueError(
                f"unknown dsp option(s) for {mode}: {sorted(bad)}; allowed: {sorted(allowed)}"
            )

    def _alloc_slot(self, group, exclude_id: str | None = None) -> int:
        if self._is_wide(group):
            cap = self.config.wide_capacity
        elif group == "p25":
            cap = self.config.p25_capacity
        elif group == "p25p2":
            cap = self.config.p25p2_capacity
        else:
            cap = self.config.narrow_capacity
        used = {c.slot for c in self.channels.values()
                if c.mode_group == group and c.spec.id != exclude_id}
        free = [s for s in range(cap) if s not in used]
        if not free:
            name = group if isinstance(group, str) else group[0]
            raise RuntimeError(f"no free {name} slots (capacity {cap})")
        return free[0]

    def _mesh_bin(self, spec: ChannelSpec, exclude_id: str | None = None) -> int:
        """The mesh's slot: the channelizer bin of the frequency.  Channels
        at the same frequency may share a bin (both read the one stream);
        two frequencies in one bin would need two fine offsets, which the
        per-bin control cannot hold."""
        bin_idx = self._channelizer.channel_index(spec.frequency_hz - self.config.center_hz)
        for c in self.channels.values():
            if (c.spec.id != exclude_id and not self._is_wide(c.mode_group) and c.slot == bin_idx
                    and c.spec.frequency_hz != spec.frequency_hz):
                raise ValueError(
                    f"channelizer bin {bin_idx} already carries channel {c.spec.id!r} at "
                    f"{c.spec.frequency_hz} Hz (mesh backend: one frequency per bin)")
        return bin_idx

    def _check_mesh_group(self, group) -> None:
        if group == "p25p2" and self.config.p25p2_capacity <= 0:
            raise ValueError("mesh p25p2 channels need p25p2_capacity > 0 at creation "
                             "(enables the dual-rate grid)")
        if group in ("p25", "p25p2") and self.config.p25_capacity <= 0:
            # the symbol-commensurate block geometry is decided at creation
            raise ValueError("mesh p25 channels need p25_capacity > 0 at capture creation")

    def _mesh_slot(self, group, spec: ChannelSpec, exclude_id: str | None = None) -> int:
        """Wide mesh channels take slot-bank-style slots (they run off the
        raw stream); the others their bin."""
        if self._is_wide(group):
            return self._alloc_slot(group, exclude_id=exclude_id)
        return self._mesh_bin(spec, exclude_id=exclude_id)

    def _check_span(self, frequency_hz: float) -> None:
        off = float(frequency_hz) - self.config.center_hz
        half = self.config.sample_rate / 2
        if not (-half < off < half):
            raise ValueError(f"frequency {frequency_hz} outside capture span")

    def create_channel(self, spec: ChannelSpec) -> ChannelHandle:
        with self._lock:
            if spec.id in self.channels:
                raise ValueError(f"channel {spec.id!r} exists")
            group = self._group_for(spec)
            self._check_span(spec.frequency_hz)
            if self.config.mesh:
                self._check_mesh_group(group)
                slot = self._mesh_slot(group, spec)
            else:
                slot = self._alloc_slot(group)
            ch = ChannelHandle(spec, group, slot)
            self.channels[spec.id] = ch
            self._rebuild_pipeline_if_needed()
            self._ctl_dirty = True
            return ch

    def remove_channel(self, channel_id: str) -> None:
        with self._lock:
            self.channels.pop(channel_id, None)
            self._ctl_dirty = True

    def update_channel(self, channel_id: str, **kwargs) -> ChannelHandle:
        with self._lock:
            ch = self.channels[channel_id]
            freq = kwargs.get("frequency_hz")
            if freq is not None:
                # channel_index wraps modulo the bank size: an out-of-span
                # retune would alias onto a wrong in-band frequency
                self._check_span(freq)
            new_mode = kwargs.pop("mode", None)
            dsp_patch = kwargs.pop("dsp", None)
            if new_mode is not None or dsp_patch is not None:
                # mode / DSP change: re-slot into the target bank (a new
                # bank key rebuilds the program); None removes an override
                cand_dsp = dict(ch.spec.dsp)
                if dsp_patch is not None:
                    for k, v in dsp_patch.items():
                        if v is None:
                            cand_dsp.pop(k, None)
                        else:
                            cand_dsp[k] = tuple(v) if isinstance(v, list) else v
                cand = ChannelSpec(id=ch.spec.id, mode=new_mode or ch.spec.mode,
                                   frequency_hz=ch.spec.frequency_hz, dsp=cand_dsp)
                group = self._group_for(cand)  # validates mode + dsp
                if self.config.mesh:
                    self._check_mesh_group(group)
                    if self._is_wide(group) != self._is_wide(ch.mode_group):
                        # wide <-> narrow: a wide slot <-> a bin
                        ch.slot = self._mesh_slot(group, ch.spec, exclude_id=ch.spec.id)
                    ch.mode_group = group
                elif group != ch.mode_group:
                    ch.slot = self._alloc_slot(group, exclude_id=ch.spec.id)
                    ch.mode_group = group
                ch.spec.mode = cand.mode
                ch.spec.dsp = cand_dsp
            for k, v in kwargs.items():
                if k == "squelch_db":
                    ch.spec.squelch_db = v  # explicit None = open squelch
                elif v is not None and hasattr(ch.spec, k):
                    setattr(ch.spec, k, v)
            if self.config.mesh and freq is not None and not self._is_wide(ch.mode_group):
                # a retune re-bins the channel (a wide slot retunes by its offset)
                ch.slot = self._mesh_bin(ch.spec, exclude_id=ch.spec.id)
            self._rebuild_pipeline_if_needed()
            self._ctl_dirty = True
            return ch

    def update_config(
        self,
        center_hz: float | None = None,
        gain_db: float | None = None,
        sample_rate: int | None = None,
        ppm: float | None = None,
        bandwidth_hz: float | None = None,
        antenna: str | None = None,
        agc: bool | None = None,
    ) -> None:
        """Retune the capture.  Front-end changes retune the running device
        live (the reader calls ``device.configure`` between reads); a
        sample-rate change rebuilds the block geometry and restarts."""
        rate_change = sample_rate is not None and int(sample_rate) != self.config.sample_rate
        fe_change = False
        if ppm is not None:
            self.config.ppm = float(ppm)
            fe_change = True
        if bandwidth_hz is not None:
            self.config.bandwidth_hz = float(bandwidth_hz) or None
            fe_change = True
        if antenna is not None:
            self.config.antenna = antenna or None
            fe_change = True
        if agc is not None:
            self.config.agc = bool(agc)
            fe_change = True
        was_running = self.state == "running"
        if was_running and rate_change:
            self.stop()
        if center_hz is not None:
            self.config.center_hz = float(center_hz)
        if gain_db is not None:
            self.config.gain_db = float(gain_db)
        if rate_change:
            self.config.sample_rate = int(sample_rate)
            # the new geometry before the rebuild, or channel offsets map
            # through stale bin spacing
            self._compute_block_size()
            self._pipe_cfg = None
        if center_hz is not None or rate_change:
            self.classifier = ChannelClassifier(
                self.config.center_hz, self.config.sample_rate, self.config.fft_size)
            # the cached frame is from the old frequency or rate
            self.last_spectrum = None
        self._ctl_dirty = True
        if was_running and rate_change:
            self.start()
        elif self.state == "running" and (center_hz is not None or gain_db is not None or fe_change):
            self._retune_pending = True

    # -- pipeline build ----------------------------------------------------

    @staticmethod
    def _is_wide(group) -> bool:
        return isinstance(group, tuple) and group[0] == "wide"

    @property
    def _audio_gated(self) -> bool:
        # the mesh grid fetches every bin's audio: gating is the slot banks'
        if self.config.mesh:
            return False
        return 0 < self.config.audio_fetch_slots < self.config.narrow_capacity

    def _narrow_modes(self) -> tuple:
        return tuple(sorted({c.mode_group for c in self.channels.values()
                             if c.mode_group not in ("p25", "p25p2")
                             and not self._is_wide(c.mode_group)}))

    def _wide_groups(self) -> tuple:
        """Distinct wide DSP-override sets present (one group each)."""
        return tuple(sorted({c.mode_group[1] for c in self.channels.values()
                             if self._is_wide(c.mode_group)}))

    def enable_wide_baseband(self) -> None:
        """Turn on the pre-MPX baseband export for wide slots (RDS
        consumers); rebuilds the program."""
        if not self._wide_baseband:
            with self._lock:
                self._wide_baseband = True
                self._rebuild_pipeline_if_needed()
                self._ctl_dirty = True

    def _make_pipe_cfg(self) -> pl.CapturePipelineConfig:
        cfg = self.config
        groups = {c.mode_group for c in self.channels.values()}
        wide_groups = self._wide_groups()
        # only the bank types that have channels run
        return pl.CapturePipelineConfig(
            sample_rate=cfg.sample_rate,
            block_size=self.block_size,
            fft_size=cfg.fft_size,
            narrow_modes=self._narrow_modes(),
            narrow_capacity=cfg.narrow_capacity,
            channel_bandwidth=cfg.channel_bandwidth,
            wide_capacity=cfg.wide_capacity if wide_groups else 0,
            p25_capacity=cfg.p25_capacity if "p25" in groups else 0,
            p25_modulation=cfg.p25_modulation,
            p25_equalizer_taps=cfg.p25_equalizer_taps,
            p25p2_capacity=cfg.p25p2_capacity if "p25p2" in groups else 0,
            audio_rate=cfg.audio_rate,
            export_wide_baseband=self._wide_baseband and bool(wide_groups),
            wide_groups=wide_groups,
            audio_fetch_slots=cfg.audio_fetch_slots,
        )

    def _rebuild_pipeline_if_needed(self) -> None:
        new_cfg = self._make_pipe_cfg()
        if new_cfg != self._pipe_cfg:
            self._flush_pending()
            self._pipe_cfg = new_cfg
            if self._on_mesh(new_cfg):
                if self._mesh is None:
                    self._mesh = mesh_mod.build_mesh(self.config.mesh, self.torch_device)
                entry = self._mesh_entry(new_cfg)
                self._step = mesh_mod.mesh_capture_multi(new_cfg, self._mesh, entry)
                self._init_state = functools.partial(mesh_mod.mesh_init, new_cfg, entry, self._mesh)
            else:
                self._step = functools.partial(pl.capture_multi, cfg=new_cfg)
                self._init_state = functools.partial(pl.pipeline_init, new_cfg, self.torch_device)
            self._reset_state()
            # tag the state with its program: an in-flight batch of the old
            # program must not write its state back over this one
            self._pipe_gen += 1
            self._program_warm = False

    def _on_mesh(self, cfg: pl.CapturePipelineConfig) -> bool:
        return bool(self.config.mesh) and bool(cfg.narrow_modes or cfg.p25_capacity or cfg.wide_groups)

    @staticmethod
    def _mesh_entry(cfg: pl.CapturePipelineConfig):
        """The grid's base bank: the first narrow group, else "p25", else
        None (a wide-only capture)."""
        if cfg.narrow_modes:
            return cfg.narrow_modes[0]
        return "p25" if cfg.p25_capacity else None

    def _reset_state(self) -> None:
        with self._seam.compute():
            self._dev_state = self._init_state()

    def _build_control(self):
        assert self._pipe_cfg is not None
        cfg = self._pipe_cfg
        if self._on_mesh(cfg):
            groups = set(cfg.narrow_modes) | {("wide", g) for g in cfg.wide_groups}
            if cfg.p25_capacity or cfg.p25p2_capacity:
                groups |= {"p25", "p25p2"}  # the base bank or the own-output banks
            chans = [c for c in self.channels.values() if c.mode_group in groups]
            return mesh_mod.mesh_control(cfg, chans, self.config.center_hz, self._mesh,
                                         self._mesh_entry(cfg))
        ch_cfg = self._channelizer
        dev = self.torch_device
        wide_arrays = {g: dict(off=[0.0] * cfg.wide_capacity, act=[False] * cfg.wide_capacity,
                               sq=[-1e9] * cfg.wide_capacity) for g in cfg.wide_groups}

        def slot_arrays(cap):
            return dict(idx=np.zeros(cap, np.int32), fine=np.zeros(cap, np.float32),
                        act=np.zeros(cap, bool), sq=np.full(cap, -1e9, np.float32))

        bank_arrays = {m: slot_arrays(cfg.narrow_capacity) for m in cfg.narrow_modes}
        p25 = slot_arrays(cfg.p25_capacity)
        p25p2 = slot_arrays(cfg.p25p2_capacity)
        for ch in self.channels.values():
            off = ch.spec.frequency_hz - self.config.center_hz
            sq = ch.spec.squelch_db if ch.spec.squelch_db is not None else -1e9
            if self._is_wide(ch.mode_group):
                warr = wide_arrays[ch.mode_group[1]]
                warr["off"][ch.slot] = off
                warr["act"][ch.slot] = True
                warr["sq"][ch.slot] = sq
                continue
            arr = {"p25": p25, "p25p2": p25p2}.get(ch.mode_group) or bank_arrays[ch.mode_group]
            ci = ch_cfg.channel_index(off)
            arr["idx"][ch.slot] = ci
            arr["fine"][ch.slot] = off - ch_cfg.channel_offset_hz(ci)
            arr["act"][ch.slot] = True
            if ch.mode_group not in ("p25", "p25p2"):
                arr["sq"][ch.slot] = sq

        def on_card(a):
            return torch.from_numpy(np.asarray(a)).to(dev)

        def assignment(a):
            return pl.ChannelAssignment(channel_index=on_card(a["idx"]),
                                        fine_offset_hz=on_card(a["fine"]),
                                        active=on_card(a["act"]), squelch_db=on_card(a["sq"]))

        new_wide = ({g: pl.WideAssignment(offset_hz=on_card(np.asarray(a["off"], np.float32)),
                                          active=on_card(np.asarray(a["act"], bool)),
                                          squelch_db=on_card(np.asarray(a["sq"], np.float32)))
                     for g, a in wide_arrays.items()} if cfg.wide_capacity > 0 else None)
        k = cfg.audio_fetch_slots
        audio_sel = None
        self._audio_pos = {}
        if k > 0:
            audio_sel = {}
            for m in cfg.narrow_modes:
                listeners = sorted(c.slot for c in self.channels.values()
                                   if c.mode_group == m and c.audio.active)[:k]
                for pos, slot in enumerate(listeners):
                    self._audio_pos[(m, slot)] = pos
                sel = np.zeros(k, np.int32)
                sel[: len(listeners)] = listeners
                audio_sel[m] = on_card(sel)
        return pl.CaptureControl(
            banks={m: assignment(a) for m, a in bank_arrays.items()},
            wide=new_wide,
            p25=assignment(p25) if cfg.p25_capacity > 0 else None,
            p25p2=assignment(p25p2) if cfg.p25p2_capacity > 0 else None,
            audio_sel=audio_sel,
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        self._desired_running = True
        self._start_locked()

    def _start_internal(self) -> None:
        """Health-monitor restart: starts only if no stop() landed since."""
        self._start_locked()

    def _start_locked(self) -> None:
        with self._lock:
            if not self._desired_running or self.state == "running":
                return
            self.state = "starting"
            self._stop.clear()
            self._retune_pending = False
            self._started_at = time.time()
            # a fresh stream starts at the configured fidelity ceiling
            self.transport_active = self.config.transport
            self._adapt_ema = 0.0
            self._adapt_good = 0
            self._gen += 1
            self._rebuild_pipeline_if_needed()
            # publish the attributes only after .start(): a concurrent stop()
            # must never join a constructed-but-unstarted thread
            t = threading.Thread(target=self._run, name=f"Capture-{self.id}", daemon=True)
            t.start()
            self._thread = t
            ft = threading.Thread(target=self._fetch_loop, name=f"CaptureFetch-{self.id}",
                                  daemon=True)
            ft.start()
            self._fetch_thread = ft
            if self._health_thread is None or not self._health_thread.is_alive():
                self._health_thread = threading.Thread(
                    target=self._health_monitor, name=f"HealthMon-{self.id}", daemon=True)
                self._health_thread.start()

    _TRANSPORT_LADDER = ("i16", "i8", "i4")

    def warmup(self) -> threading.Thread:
        """Build and warm this capture's program before ``start()``: the
        kernels' nvcc build (on the card), the cached designs and one zeros
        batch per width of the transport ladder, under the compile
        watchdog's budget.  No device interaction; the carried state is
        left as it was.  Returns the worker thread (joinable); an error is
        kept in ``warmup_error``."""

        def _go() -> None:
            try:
                if self._seam.cuda:
                    from ..kernels import build_all

                    build_all()
                with self._lock:
                    self._rebuild_pipeline_if_needed()
                    step, state = self._step, self._dev_state
                    with self._seam.compute():
                        ctl = self._build_control()
                n = max(1, self.config.blocks_per_dispatch)
                widths = [self.config.transport]
                if self.config.adaptive_transport and self.config.transport in self._TRANSPORT_LADDER:
                    i = self._TRANSPORT_LADDER.index(self.config.transport)
                    widths = list(self._TRANSPORT_LADDER[i:])
                self._compile_started = time.time()
                self._compiling = True
                try:
                    for transport in widths:
                        dtype, per, scaled = TRANSPORTS[transport]
                        with self._seam.compute():
                            words = torch.zeros((n, per * self.block_size), dtype=dtype,
                                                device=self.torch_device)
                            batch = words
                            if scaled:
                                fill = 1.0 / (7.0 if transport == "i4" else 127.0)
                                batch = (words, torch.full((n,), fill, dtype=torch.float32,
                                                           device=self.torch_device))
                            step(batch, state, ctl)
                        if self._seam.cuda:
                            self._seam.compute_stream.synchronize()
                finally:
                    self._compiling = False
                self._program_warm = True
            except Exception as e:  # best-effort, as the reference's; kept for the caller
                self.warmup_error = e
                logger.exception("capture %s warmup failed", self.id)

        t = threading.Thread(target=_go, name=f"Warmup-{self.id}", daemon=True)
        t.start()
        return t

    def _health_monitor(self) -> None:
        """Watchdog: thread death / stalled blocks -> failed (+auto restart)."""
        while not self._stop.is_set():
            time.sleep(1.0)
            if self.state not in ("running", "starting", "failed"):
                continue
            now = time.time()
            if (self.config.restart_interval_s > 0 and self.state == "running"
                    and self.blocks_processed > 0
                    and now - self._started_at > self.config.restart_interval_s):
                # scheduled restart: hygiene, not a failure
                logger.info("capture %s scheduled restart", self.id)
                try:
                    self._do_stop()
                    self._start_internal()
                except Exception:  # pragma: no cover
                    logger.exception("scheduled restart failed")
                if not self._desired_running:
                    return
                continue
            failed = self.state == "failed"
            thread_dead = self._thread is not None and not self._thread.is_alive()
            stalled = False
            in_flight = bool(self._pending) or self._fetching > 0
            if self._compiling or (self.blocks_processed == 0 and in_flight):
                # warm-up: only a blown build budget counts as a stall
                stalled = now - max(self._compile_started, self.last_block_time) > self.compile_timeout_s
            elif self.state == "running" and self.blocks_processed == 0:
                stalled = now - max(self._started_at, self.last_block_time) > self.startup_timeout_s
            elif self.state == "running" and self.blocks_processed > 0:
                stalled = now - self.last_block_time > self.watchdog_timeout_s
            elif self.state == "starting":
                stalled = now - self._started_at > self.device_open_timeout_s
            if not (failed or thread_dead or stalled):
                continue
            reason = (f"failed: {self.error}" if failed
                      else "thread died" if thread_dead else "no blocks (watchdog)")
            ERROR_TRACKER.record("capture_watchdog", self.id, reason)
            logger.warning("capture %s unhealthy: %s", self.id, reason)
            self._restart_times = [t for t in self._restart_times if now - t < 3600]
            if self.auto_restart and len(self._restart_times) < self.max_restarts_per_hour:
                self._restart_times.append(now)
                self.restart_count += 1
                try:
                    self._do_stop()
                    self._start_internal()
                except Exception:
                    self.state = "failed"
                    self.error = reason
                    return
                if not self._desired_running:
                    return
                continue
            # plain restarts exhausted: escalate to driver-service recovery
            if self.recovery is not None:
                result = self.recovery.restart_service()
                ERROR_TRACKER.record("capture_recovery", self.id, f"service restart: {result}")
                if result.get("ok"):
                    self._restart_times = []
                    try:
                        self._do_stop()
                        self._start_internal()
                        if not self._desired_running:
                            return
                        continue
                    except Exception:  # pragma: no cover
                        pass
            self._do_stop()
            self.state = "failed"
            self.error = reason
            return

    def stop(self) -> None:
        with self._lock:
            # under the same lock as _start_locked: a restart in flight
            # observes the shutdown and stands down
            self._desired_running = False
        self._do_stop()

    def _do_stop(self) -> None:
        """Teardown without clearing the owner's intent."""
        with self._lock:
            self._stop.set()
        with self._pend_cv:
            self._pend_cv.notify_all()
        for attr in ("_thread", "_fetch_thread"):
            t = getattr(self, attr)
            if t is not None and t is not threading.current_thread():
                try:
                    t.join(timeout=10)
                except RuntimeError:  # pragma: no cover - start/stop race
                    pass
            setattr(self, attr, None)
        self.state = "stopped"
        self.last_spectrum = None

    def restart(self) -> None:
        self.stop()
        self.start()

    # -- the loop ----------------------------------------------------------

    def _device_config(self) -> DeviceConfig:
        return DeviceConfig(
            center_hz=self.config.center_hz, sample_rate=self.config.sample_rate,
            gain_db=self.config.gain_db, ppm=self.config.ppm,
            bandwidth_hz=self.config.bandwidth_hz, antenna=self.config.antenna,
            agc=self.config.agc,
        )

    def _run(self) -> None:
        gen = self._gen
        try:
            self.device.configure(self._device_config())
            stream = self.device.start_stream()
        except Exception as e:  # pragma: no cover - device failures
            if gen == self._gen:
                self.state = "failed"
                self.error = f"device start failed: {e}"
            logger.exception("capture %s failed to start", self.id)
            return
        if gen != self._gen:
            stream.close()
            return
        self.state = "running"
        # fake/file streams declare realtime=False and disable adaptation
        self._stream_realtime = bool(getattr(stream, "realtime", True))
        chunk = max(8192, self.config.sample_rate // 20)
        chunks: list[np.ndarray] = []
        pending_n = 0
        n_batch = max(1, self.config.blocks_per_dispatch)
        blocks: list[np.ndarray] = []
        try:
            while not self._stop.is_set() and gen == self._gen:
                if self._retune_pending:
                    self._retune_pending = False
                    self.device.configure(self._device_config())
                    # buffered IQ is stale and the retune is a phase jump:
                    # the overflow contract
                    self._flush_pending()
                    chunks, pending_n, blocks = [], 0, []
                    if self._pipe_cfg is not None:
                        self._reset_state()
                samples, overflow = stream.read(chunk)
                if overflow:
                    self.overflow_count += 1
                    self._flush_pending()
                    chunks, pending_n, blocks = [], 0, []
                    if self._pipe_cfg is not None:
                        self._reset_state()
                    continue
                chunks.append(samples)
                pending_n += samples.size
                while pending_n >= self.block_size:
                    cat = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
                    block = cat[: self.block_size]
                    rest = cat[self.block_size:]
                    chunks = [rest] if rest.size else []
                    pending_n = rest.size
                    blocks.append(block)
                    if len(blocks) == n_batch:
                        self._dispatch_blocks(blocks)
                        blocks = []
                if (pending_n < self.block_size and not blocks
                        and (self._fetch_thread is None or not self._fetch_thread.is_alive())):
                    self._drain_inline()
        except Exception as e:
            self.state = "failed"
            self.error = str(e)
            logger.exception("capture %s crashed", self.id)
        finally:
            self._flush_pending()
            stream.close()

    def _dispatch_blocks(self, blocks: list[np.ndarray]) -> None:
        """Convert, upload and enqueue one batch; hand it to the fetch thread."""
        t0 = time.perf_counter()
        with self._lock:
            if self._audio_gated:
                # the listener set picks the fetched audio rows (a control
                # tensor: no rebuild)
                fp = frozenset((c.mode_group, c.slot) for c in self.channels.values()
                               if c.mode_group not in ("p25", "p25p2")
                               and not self._is_wide(c.mode_group) and c.audio.active)
                if fp != self._audio_fp:
                    self._audio_fp = fp
                    self._ctl_dirty = True
            if self._ctl_dirty or self._ctl is None:
                with self._seam.compute():
                    self._ctl = self._build_control()
                self._ctl_dirty = False
            step = self._step
            ctl = self._ctl
            state = self._dev_state
            pipe_gen = self._pipe_gen
            channels = list(self.channels.values())
            audio_pos = dict(self._audio_pos)
        assert step is not None
        t_conv0 = time.perf_counter()
        transport = self.transport_active
        stage = self._seam.stage(transport, len(blocks), self.block_size)
        words_np, scales_np = stage.numpy()
        convert_blocks(transport, blocks, words_np, scales_np)
        t_conv1 = time.perf_counter()
        if self._upload_throttle_bps:
            nbytes = words_np.nbytes + (0 if scales_np is None else scales_np.nbytes)
            time.sleep(nbytes / self._upload_throttle_bps)
        # heartbeat before dispatch: a cold build must not trip the watchdog
        self.last_block_time = time.time()
        warm_at_dispatch = self._program_warm
        if not self._program_warm:
            self._compile_started = time.time()
            self._compiling = True
        try:
            batch = self._seam.upload(stage)
            t_up = time.perf_counter()
            with self._seam.compute():
                out, state = step(batch, state, ctl)
                host, buf, done = self._seam.fetch(out.pop("_packed"))
            meta = _meta(out)
            del out
            t_disp = time.perf_counter()
        finally:
            self._compiling = False
            self._program_warm = True
            self.last_block_time = time.time()
        p = self.perf
        p["conv_ms"] = p.get("conv_ms", 0.0) + (t_conv1 - t_conv0) * 1e3
        p["upload_ms"] = p.get("upload_ms", 0.0) + (t_up - t_conv1) * 1e3
        p["dispatch_ms"] = p.get("dispatch_ms", 0.0) + (t_disp - t_up) * 1e3
        p["dispatches"] = p.get("dispatches", 0) + 1
        with self._lock:
            if self._pipe_gen == pipe_gen:
                self._dev_state = state
            # else: the program was rebuilt while this batch was in flight
        limit = max(0, self.config.pipeline_depth)
        t_wait0 = time.perf_counter()
        with self._pend_cv:
            self._pending.append((meta, host, buf, done, blocks, channels, audio_pos, t0))
            self._pend_cv.notify_all()
            while (len(self._pending) + self._fetching > limit and not self._stop.is_set()
                   and self._fetch_thread is not None and self._fetch_thread.is_alive()):
                self._pend_cv.wait(0.1)
        p["wait_ms"] = p.get("wait_ms", 0.0) + (time.perf_counter() - t_wait0) * 1e3
        if warm_at_dispatch:
            busy_ms = (time.perf_counter() - t0) * 1e3
            budget_ms = len(blocks) * self.block_size / self.config.sample_rate * 1e3
            self._adapt_transport(max(busy_ms, self._last_fetch_busy_ms), budget_ms)
        if self._fetch_thread is None or not self._fetch_thread.is_alive():
            self._drain_inline()

    def _adapt_transport(self, busy_ms: float, budget_ms: float) -> None:
        """Step the IQ transport down the i16 -> i8 -> i4 ladder when the
        EMA of the load (busy / budget) passes 0.90; step back up after 40
        batches whose predicted post-upgrade load (2x) stays below 0.85;
        never above the configured ceiling."""
        cfg = self.config
        if not cfg.adaptive_transport or cfg.transport not in ("i16", "i8"):
            return
        if not self._stream_realtime or budget_ms <= 0:
            return
        ladder = self._TRANSPORT_LADDER
        load = busy_ms / budget_ms
        self._adapt_ema = 0.7 * self._adapt_ema + 0.3 * load
        cur = ladder.index(self.transport_active)
        base = ladder.index(cfg.transport)
        if self._adapt_ema > 0.90 and cur < len(ladder) - 1:
            self.transport_active = ladder[cur + 1]
            self._adapt_good = 0
            self._adapt_ema = 0.0
            logger.warning("capture %s: load %.2f of realtime, degrading transport to %s",
                           self.id, load, self.transport_active)
        elif cur > base and self._adapt_ema * 2.0 < 0.85:
            self._adapt_good += 1
            if self._adapt_good >= 40:
                self.transport_active = ladder[cur - 1]
                self._adapt_good = 0
                self._adapt_ema = 0.0
                logger.info("capture %s: link recovered, transport back to %s",
                            self.id, self.transport_active)
        else:
            self._adapt_good = 0

    def _fetch_loop(self) -> None:
        """Drain dispatched batches in order: wait, unpack, fan out."""
        while True:
            with self._pend_cv:
                while not self._pending:
                    if self._stop.is_set():
                        return
                    self._pend_cv.wait(0.2)
                item = self._pending.popleft()
                self._fetching += 1
                self._pend_cv.notify_all()
            try:
                self._finish_batch(item)
            except Exception:
                logger.exception("capture %s fetch failed", self.id)
                self.state = "failed"
                self.error = "fetch failed"
            finally:
                with self._pend_cv:
                    self._fetching -= 1
                    self._pend_cv.notify_all()

    def _drain_inline(self) -> None:
        """Synchronous drain for callers without a fetch thread."""
        while True:
            with self._pend_cv:
                if not self._pending:
                    return
                item = self._pending.popleft()
            self._finish_batch(item)

    def _flush_pending(self) -> None:
        """Wait until every dispatched batch has been fetched and fanned out."""
        if self._fetch_thread is None or not self._fetch_thread.is_alive():
            self._drain_inline()
            return
        with self._pend_cv:
            while self._pending or self._fetching:
                self._pend_cv.wait(0.1)

    def _finish_batch(self, item) -> None:
        """Fetch one in-flight batch (one packed buffer) and fan out."""
        meta, host, buf, done, blocks, channels, audio_pos, t0 = item
        n = len(blocks)
        t_f0 = time.perf_counter()
        if done is not None:
            # sleep-poll, so the wait never holds the GIL from the reader
            while not done.query():
                if self._stop.is_set():
                    break
                time.sleep(0.002)
            done.synchronize()
        out = pl.unpack_wire(meta, host.numpy().reshape(n, -1))
        self._seam.give(buf)  # every unpacked leaf owns its memory
        t_f1 = time.perf_counter()
        now = time.time()
        for b in range(n):
            spec = out["spectrum"][b]
            self.last_spectrum = spec
            self.spectrum_subs.publish(spec)
            self.classifier.update(spec)
            if self.iq_subs.active:
                self.iq_subs.publish(blocks[b])
            for ch in channels:
                if ch.state == "stopped":
                    continue  # per-channel stop: the slot runs, nothing is published
                if ch.mode_group in ("p25", "p25p2"):
                    grp = out.get(ch.mode_group)
                    if grp is None:
                        continue
                    ch.record_rssi(float(grp["rssi"][b][ch.slot]), now)
                    ch.symbols.publish({"soft": grp["soft"][b][ch.slot], "rssi": ch.rssi_db})
                    continue
                if self._is_wide(ch.mode_group):
                    grp = (out.get("wide") or {}).get(ch.mode_group[1])
                elif self.config.mesh:
                    # the mesh grid emits one bank: each bin's bank_idx chose its mode
                    grp = next(iter(out["banks"].values()), None)
                else:
                    grp = out["banks"].get(ch.mode_group)
                if grp is None:
                    continue
                ch.record_rssi(float(grp["rssi"][b][ch.slot]), now)
                if self._audio_gated and not self._is_wide(ch.mode_group):
                    pos = audio_pos.get((ch.mode_group, ch.slot))
                    if pos is not None:
                        ch.audio.publish(grp["audio"][b][pos])
                else:
                    ch.audio.publish(grp["audio"][b][ch.slot])
                if "baseband" in grp and ch.baseband.active:
                    ch.baseband.publish(grp["baseband"][b][ch.slot])
        self.blocks_processed += n
        self.last_block_time = time.time()
        t_end = time.perf_counter()
        self.block_ms = (t_end - t0) * 1e3 / n
        self.block_latency_ms.append((t_end - t0) * 1e3)
        p = self.perf
        p["fetch_ms"] = p.get("fetch_ms", 0.0) + (t_f1 - t_f0) * 1e3
        p["fanout_ms"] = p.get("fanout_ms", 0.0) + (t_end - t_f1) * 1e3
        self._last_fetch_busy_ms = (t_end - t_f0) * 1e3

    # -- info --------------------------------------------------------------

    def status(self) -> dict:
        return {
            "id": self.id,
            "state": self.state,
            "error": self.error,
            "centerHz": self.config.center_hz,
            "sampleRate": self.config.sample_rate,
            "gainDb": self.config.gain_db,
            "ppm": self.config.ppm,
            "bandwidthHz": self.config.bandwidth_hz,
            "antenna": self.config.antenna,
            "agc": self.config.agc,
            "blockSize": self.block_size,
            "mesh": self.config.mesh,
            "device": str(self.torch_device),
            "blocksProcessed": self.blocks_processed,
            "overflowCount": self.overflow_count,
            "blockMs": round(self.block_ms, 2),
            "transport": self.config.transport,
            "transportActive": self.transport_active,
            "perf": {k: round(v, 1) for k, v in self.perf.items()},
            "channels": [
                {
                    "id": c.id,
                    "mode": c.spec.mode,
                    "frequencyHz": c.spec.frequency_hz,
                    "rssiDb": round(c.rssi_db, 1),
                    "name": c.spec.name,
                    "squelchDb": c.spec.squelch_db,
                    "state": c.state,
                    "dsp": {k: list(v) if isinstance(v, tuple) else v for k, v in c.spec.dsp.items()},
                }
                for c in self.channels.values()
            ],
        }


class CaptureManager:
    """Create/start/stop captures over a device driver; every capture's
    block program runs on ``device`` (``None``: the CUDA card)."""

    def __init__(self, driver, max_captures: int = 4, recovery=None, device: DeviceLike = None):
        self.driver = driver
        self.max_captures = max_captures
        self.captures: dict[str, Capture] = {}
        self.recovery = recovery
        self.device = resolve_device(device)
        self._lock = threading.RLock()

    def list_devices(self):
        return self.driver.enumerate()

    def create_capture(
        self,
        device_id: str | None = None,
        config: CaptureConfig | None = None,
        capture_id: str | None = None,
    ) -> Capture:
        with self._lock:
            if len(self.captures) >= self.max_captures:
                raise RuntimeError(f"capture limit {self.max_captures} reached")
            if capture_id is not None and capture_id in self.captures:
                raise RuntimeError(f"capture {capture_id!r} exists")
            devices = self.driver.enumerate()
            if not devices:
                raise RuntimeError("no devices")
            dev_id = device_id or devices[0].id
            sdr = self.driver.open(dev_id)
            cap = Capture(sdr, config or CaptureConfig(), capture_id, torch_device=self.device)
            cap.recovery = self.recovery
            self.captures[cap.id] = cap
            return cap

    def get(self, capture_id: str) -> Capture:
        return self.captures[capture_id]

    def remove_capture(self, capture_id: str) -> None:
        with self._lock:
            cap = self.captures.pop(capture_id, None)
        if cap:
            cap.stop()
            cap.device.close()

    def stop_all(self) -> None:
        for cap in list(self.captures.values()):
            cap.stop()

