"""Automatic gain control on batched blocks.

Counterpart of ``wavecap_tpu/ops/agc.py``: the envelope is two cascaded
one-pole lowpasses over ``|x|`` (attack pass, then release pass) combined
with an elementwise max, with the two carries kept across blocks.  On
the card, kernel K9 runs both passes and the max in one launch (its
envelope mode); only a CPU tensor takes the plain one-pole scans.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, resolve_device
from .clip import soft_clip
from .iir import _K9_ENVELOPE, _k9, onepole_filter, onepole_filter_plain


class AgcState(NamedTuple):
    env_attack: torch.Tensor  # carry of the attack-pass envelope
    env_release: torch.Tensor  # carry of the release-pass envelope


def agc_init(dtype=torch.float32, device: DeviceLike = None) -> AgcState:
    dev = resolve_device(device)
    return AgcState(torch.zeros((), dtype=dtype, device=dev),
                    torch.zeros((), dtype=dtype, device=dev))


def _coef(ms: float, sample_rate: float) -> float:
    n = (ms / 1000.0) * sample_rate
    return float(1.0 - np.exp(-1.0 / n)) if n > 0 else 1.0


def envelope_plain(x: torch.Tensor, attack_coef: float, release_coef: float, state: AgcState):
    """Plain version of K9's envelope mode: two one-pole doubling scans."""
    abs_x = x.abs()
    env_a, ca = onepole_filter_plain(abs_x, attack_coef, 1.0 - attack_coef, state.env_attack)
    env_r, cr = onepole_filter_plain(env_a, release_coef, 1.0 - release_coef, state.env_release)
    return torch.maximum(env_a, env_r), AgcState(ca, cr)


def envelope(x: torch.Tensor, attack_coef: float, release_coef: float, state: AgcState):
    """Asymmetric attack/release envelope.  Returns ``(env, state)``.  On a
    CUDA tensor this launches K9 once; only a CPU tensor takes the plain
    version."""
    if x.shape[-1] == 0:
        return x, state
    if x.device.type == "cpu":
        return envelope_plain(x, attack_coef, release_coef, state)
    lead = x.shape[:-1]
    carry = torch.stack([state.env_attack.expand(lead), state.env_release.expand(lead)], dim=-1)
    coeffs = tuple(float(np.float32(c)) for c in
                   (attack_coef, 1.0 - attack_coef, release_coef, 1.0 - release_coef))
    env, carry = _k9(x, coeffs, carry.reshape(-1, 2), _K9_ENVELOPE, 2)
    carry = carry.reshape(lead + (2,))
    return env, AgcState(carry[..., 0], carry[..., 1])


def apply_agc(
    x: torch.Tensor,
    sample_rate: float,
    state: AgcState,
    target_db: float = -20.0,
    attack_ms: float = 5.0,
    release_ms: float = 50.0,
    max_gain_db: float = 60.0,
):
    """Envelope-follower AGC with soft clip.  Returns ``(y, state)``."""
    target = 10.0 ** (target_db / 20.0)
    max_gain = 10.0 ** (max_gain_db / 20.0)
    env, state = envelope(x, _coef(attack_ms, sample_rate), _coef(release_ms, sample_rate), state)
    gain = torch.clamp_max(target / torch.clamp_min(env, 1e-6), max_gain)
    return soft_clip(x * gain, headroom=1.0), state


def simple_agc(x: torch.Tensor, target_rms: float = 0.1, max_gain: float = 10.0):
    """Block RMS AGC."""
    rms = torch.sqrt(torch.mean(x * x, dim=-1, keepdim=True))
    gain = torch.where(rms > 1e-6, target_rms / torch.clamp_min(rms, 1e-6),
                       torch.full_like(rms, max_gain))
    return soft_clip(x * torch.clamp_max(gain, max_gain), headroom=1.0)
