"""The JAX package's capture state and control, as the port's.

The system has no weights: its parameters are the carried stream state
(channelizer history, per-slot NCO phases, discriminator samples, FIR
tails, IIR sections, AGC envelopes, PLL phases, resampler tails, the P25
banks' timing, carrier and equalizer state) plus
filter taps, which both packages design with scipy.  These functions
take the reference's ``CaptureState`` / ``CaptureControl`` as NamedTuples
or nested dicts of numpy arrays (for example after ``jax.device_get``)
and return the port's on the requested device, so a stream can move from
one package to the other mid-flight.  The port's own initial state is
the template: every leaf is taken from the reference by field name and
must match the template's shape.

The mesh's ``GridState`` / ``GridControl`` hand over the same way into
the port's per-shard layout: each ``(n_streams, M, ...)`` leaf split over
the mesh's time shards, the history and the wide demods onto each row's
first shard (the wide NCO phases, replicated in the reference, onto
every shard).

The host decoders hand over by ``decoder_state_from_reference``: a
reference framer, detector, vocoder or DMR tracker becomes the port's
object of the same class with the same buffers, counters and parameters,
so a decode can move from one package to the other mid-stream.
"""

from __future__ import annotations

import enum
import importlib
from collections import deque

import numpy as np
import torch

from .capture.pipeline import CaptureControl, CaptureState, CapturePipelineConfig
from .capture.pipeline import control_init, pipeline_init
from .parallel.mesh import Mesh
from .parallel.sharded import GridControl, GridState, ShardedGridConfig, control_from_numpy, grid_init
from .utils.torchenv import DeviceLike, resolve_device


def _field(tree, name):
    if isinstance(tree, dict):
        return tree[name]
    return getattr(tree, name)


def _fill(template, src, where: str):
    """``template``'s structure with every leaf taken from ``src``."""
    if isinstance(template, torch.Tensor):
        arr = np.array(src, copy=True)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{where}: shape {arr.shape} != {tuple(template.shape)}")
        return torch.from_numpy(arr).to(device=template.device, dtype=template.dtype)
    if isinstance(template, dict):
        return {k: _fill(v, _field(src, k), f"{where}[{k!r}]") for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(_fill(getattr(template, f), _field(src, f), f"{where}.{f}")
                                for f in template._fields))
    if isinstance(template, tuple):
        if len(src) != len(template):
            raise ValueError(f"{where}: {len(src)} entries != {len(template)}")
        return tuple(_fill(t, s, f"{where}[{i}]") for i, (t, s) in enumerate(zip(template, src)))
    if template is None:
        return None
    raise TypeError(f"{where}: unexpected {type(template)}")


def capture_state_from_numpy(
    cfg: CapturePipelineConfig, tree, device: DeviceLike = None
) -> CaptureState:
    """The reference's capture state (narrow banks, wide groups, P25 banks)
    as the port's."""
    dev = resolve_device(device)
    return _fill(pipeline_init(cfg, device=dev), tree, "state")


def capture_control_from_numpy(
    cfg: CapturePipelineConfig, tree, device: DeviceLike = None
) -> CaptureControl:
    """The reference's capture control (narrow, wide and P25 assignments,
    and the listener-selected ``audio_sel`` rows) as the port's."""
    dev = resolve_device(device)
    return _fill(control_init(cfg, device=dev), tree, "control")


def _map(tree, fn):
    """``fn`` on every numpy leaf of a reference pytree (NamedTuples,
    tuples, dicts)."""
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(v, fn) for v in tree))
    if isinstance(tree, (tuple, list)):
        return tuple(_map(v, fn) for v in tree)
    if tree is None:
        return None
    return fn(np.asarray(tree))


def grid_state_from_numpy(cfg: ShardedGridConfig, mesh: Mesh, tree) -> GridState:
    """The reference's mesh ``GridState`` (leaves ``(n_streams, ...)``) as
    the port's on ``mesh``."""
    n_streams, n_time = mesh.shape["stream"], mesh.shape["time"]
    mb = cfg.channelizer.channel_count // n_time

    def shards(bins_tree):
        return tuple(tuple(_map(bins_tree, lambda a, r=r, t=t: a[r, t * mb:(t + 1) * mb])
                           for t in range(n_time)) for r in range(n_streams))

    wide = _field(tree, "wide")
    src = GridState(
        hist=tuple(np.asarray(_field(tree, "hist"))[r] for r in range(n_streams)),
        demod_states=shards(_field(tree, "demod_states")),
        nco_phase=shards(_field(tree, "nco_phase")),
        demod_states2=tuple(shards(d) for d in _field(tree, "demod_states2")),
        demod_states_extra=tuple(shards(d) for d in _field(tree, "demod_states_extra")),
        wide=None if wide is None else tuple(
            {gk: {"nco": tuple(np.asarray(g["nco"])[r] for _ in range(n_time)),
                  "demod": _map(g["demod"], lambda a, r=r: a[r])} for gk, g in wide.items()}
            for r in range(n_streams)),
    )
    return _fill(grid_init(cfg, mesh), src, "grid state")


def grid_control_from_numpy(cfg: ShardedGridConfig, mesh: Mesh, tree) -> GridControl:
    """The reference's mesh ``GridControl`` (``(n_streams, M)`` leaves and
    the wide groups' ``(n_streams, W)``) as the port's on ``mesh``."""
    wide = _field(tree, "wide")
    return control_from_numpy(cfg, mesh, _field(tree, "fine_offset_hz"), _field(tree, "active"),
                              _field(tree, "squelch_db"), _field(tree, "bank_idx"),
                              None if wide is None else _map(wide, lambda a: a))


# --- the host decoders ----------------------------------------------------------------

_REFERENCE_DECODERS = "wavecap_tpu.decoders."
DECODER_CLASSES = ("P25Framer", "P25P2SuperFrameDetector", "ImbeDecoder", "VoiceDecoder",
                   "AmbeDecoder", "DMRDecoder", "DMRVoiceTracker")


def _port_type(obj) -> type:
    """The port's class of a reference decoder object, by module and name
    (read from the object: nothing of the reference is imported)."""
    mod = type(obj).__module__
    if not mod.startswith(_REFERENCE_DECODERS):
        raise TypeError(f"{type(obj).__qualname__} from {mod} is not a reference decoder class")
    port = importlib.import_module("wavecap_tpu_torch.decoders." + mod[len(_REFERENCE_DECODERS):])
    return getattr(port, type(obj).__qualname__)


def _decoder_value(v):
    """A copy of one attribute: arrays copied, containers rebuilt, reference
    decoder objects and enum members as the port's, generators with their
    state; plain values (and callbacks) as they are."""
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, enum.Enum):
        return getattr(_port_type(v), v.name) if type(v).__module__.startswith(_REFERENCE_DECODERS) else v
    if isinstance(v, np.random.Generator):
        g = np.random.Generator(type(v.bit_generator)())
        g.bit_generator.state = v.bit_generator.state
        return g
    if isinstance(v, deque):
        return deque((_decoder_value(x) for x in v), maxlen=v.maxlen)
    if isinstance(v, dict):
        return {k: _decoder_value(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)) and not hasattr(v, "_fields"):
        return type(v)(_decoder_value(x) for x in v)
    if type(v).__module__.startswith(_REFERENCE_DECODERS):
        return _decoder_object(v)
    return v


def _decoder_object(obj):
    cls = _port_type(obj)
    # the port's VoiceDecoder holds its own vocoder library handle
    handles = ("lib", "_mbelib") if cls.__name__ == "VoiceDecoder" else ()
    new = cls() if handles else cls.__new__(cls)
    for k, v in vars(obj).items():
        if k not in handles:
            setattr(new, k, _decoder_value(v))
    return new


def decoder_state_from_reference(obj):
    """The reference's decoder ``obj`` (one of ``DECODER_CLASSES``: the P25
    framer with its NAC tracker, the Phase 2 superframe detector, the IMBE
    and AMBE vocoders, the voice facade minus its library handle, the DMR
    burst decoder and voice tracker) as the port's object of the same class,
    its state copied as numpy arrays and plain values."""
    if type(obj).__qualname__ not in DECODER_CLASSES:
        raise TypeError(f"no hand-over for {type(obj).__qualname__}; one of {DECODER_CLASSES}")
    return _decoder_object(obj)
