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
"""

from __future__ import annotations

import numpy as np
import torch

from .capture.pipeline import CaptureControl, CaptureState, CapturePipelineConfig
from .capture.pipeline import control_init, pipeline_init
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
