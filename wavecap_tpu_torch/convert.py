"""The JAX package's capture state and control, as the port's.

The system has no weights: its parameters are the carried stream state
(channelizer history, per-slot NCO phases, discriminator samples, FIR
tails) plus filter taps, which both packages design with scipy.  These
functions take the reference's ``CaptureState`` / ``CaptureControl`` as
NamedTuples or nested dicts of numpy arrays (for example after
``jax.device_get``) and return the port's on the requested device, so a
stream can move from one package to the other mid-flight.
"""

from __future__ import annotations

import numpy as np
import torch

from .capture.pipeline import CaptureControl, CaptureState, CapturePipelineConfig
from .models.analog import NbfmState
from .models.channel_bank import ChannelAssignment, ChannelBankState
from .utils.torchenv import DeviceLike, resolve_device


def _field(tree, name: str):
    return tree[name] if isinstance(tree, dict) else getattr(tree, name)


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def capture_state_from_numpy(
    cfg: CapturePipelineConfig, tree, device: DeviceLike = None
) -> CaptureState:
    """The reference's capture state (narrow NBFM banks) as the port's."""
    dev = resolve_device(device)
    if any(_field(tree, k) is not None for k in ("wide", "p25", "p25p2")):
        raise NotImplementedError("wide and P25 bank state are ROADMAP Queue 1 items 7-8")
    chan = _field(tree, "chan_state")
    banks = {}
    src_banks = _field(tree, "banks")
    for key in cfg.narrow_modes:
        b = src_banks[key]
        ds = _field(b, "demod_states")
        banks[key] = ChannelBankState(
            chan_state=_tensor(_field(b, "chan_state"), dev),
            demod_states=NbfmState(
                *(_tensor(_field(ds, f), dev) for f in ("disc_prev", "deemph", "hp_z", "lp_z")),
                notch_z=tuple(_tensor(z, dev) for z in _field(ds, "notch_z")),
                rs_tail=_tensor(_field(ds, "rs_tail"), dev),
            ),
            nco_phase=_tensor(_field(b, "nco_phase"), dev),
        )
    return CaptureState(
        chan_state=None if chan is None else _tensor(chan, dev), banks=banks
    )


def capture_control_from_numpy(
    cfg: CapturePipelineConfig, tree, device: DeviceLike = None
) -> CaptureControl:
    """The reference's capture control (narrow bank assignments) as the port's."""
    dev = resolve_device(device)
    if any(_field(tree, k) is not None for k in ("wide", "p25", "p25p2")):
        raise NotImplementedError("wide and P25 assignments are ROADMAP Queue 1 items 7-8")
    if _field(tree, "audio_sel") is not None:
        raise NotImplementedError(
            "the listener-selected audio fetch comes with the engine, ROADMAP Queue 1 item 9"
        )
    src_banks = _field(tree, "banks")
    banks = {
        key: ChannelAssignment(
            *(_tensor(_field(src_banks[key], f), dev) for f in ChannelAssignment._fields)
        )
        for key in cfg.narrow_modes
    }
    return CaptureControl(banks=banks)
