"""NBFM demodulator, FIR path (counterpart of ``wavecap_tpu/models/analog.py``).

``nbfm_demod(iq, state, cfg) -> (audio, state)`` on a batch of channels
(``B + (n,)``), with the reference's config and state types.  This slice
ports the linear-phase voice-band FIR path (``filter_impl="fir"``) at an
audio rate equal to the channel rate; the IIR filters, deemphasis,
notches, noise blanker and noise reduction, and rate changes raise
``NotImplementedError`` naming the ROADMAP kernel that brings them.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sps

from .. import ops
from ..utils.torchenv import DeviceLike, resolve_device


@dataclass(frozen=True)
class NbfmConfig:
    sample_rate: int
    audio_rate: int = 48_000
    max_deviation_hz: float = 5_000.0
    enable_deemphasis: bool = False
    deemphasis_tau: float = 75e-6
    enable_highpass: bool = False
    highpass_hz: float = 300.0
    enable_lowpass: bool = False
    lowpass_hz: float = 3_000.0
    enable_noise_blanker: bool = False
    noise_blanker_threshold_db: float = 10.0
    notch_frequencies: tuple = ()
    enable_noise_reduction: bool = False
    noise_reduction_db: float = 12.0
    target_rms: float = 0.18
    filter_impl: str = "iir"  # "iir" (biquad scans, not ported yet) | "fir"
    fast_discriminator: bool = False  # polynomial atan2 (~1e-4 rad)


class NbfmState(NamedTuple):
    disc_prev: torch.Tensor
    deemph: torch.Tensor
    hp_z: torch.Tensor
    lp_z: torch.Tensor
    notch_z: tuple
    rs_tail: torch.Tensor


def check_supported(cfg: NbfmConfig) -> None:
    """Raise for the parts of NBFM this slice does not port yet."""
    if cfg.filter_impl != "fir":
        raise NotImplementedError("NBFM filter_impl='iir' is ROADMAP kernel K9 (biquad scans)")
    if cfg.enable_deemphasis or cfg.notch_frequencies:
        raise NotImplementedError("NBFM deemphasis and notches are ROADMAP kernel K9")
    if cfg.enable_noise_blanker or cfg.enable_noise_reduction:
        raise NotImplementedError("NBFM noise blanker / reduction are ROADMAP kernel K11")
    if int(cfg.sample_rate) != int(cfg.audio_rate):
        raise NotImplementedError("NBFM audio at another rate is ROADMAP kernel K5")


@lru_cache(maxsize=32)
def _voice_band_fir(audio_rate: int, low_hz: float, high_hz: float, taps: int = 127):
    """Linear-phase bandpass covering the voice filters' passband."""
    nyq = audio_rate / 2.0
    lo = max(low_hz, 1.0) / nyq
    hi = min(high_hz, nyq * 0.95) / nyq
    h = _sps.firwin(taps, [lo, hi], pass_zero=False, window=("kaiser", 6.0))
    return h.astype(np.float32)


def voice_band_taps(cfg: NbfmConfig) -> np.ndarray:
    """The voice-band FIR of ``cfg`` (applied when a band filter is on)."""
    ar = cfg.audio_rate
    return _voice_band_fir(
        ar,
        cfg.highpass_hz if cfg.enable_highpass else 10.0,
        cfg.lowpass_hz if cfg.enable_lowpass else ar * 0.45,
    )


def nbfm_init(cfg: NbfmConfig, device: DeviceLike = None) -> NbfmState:
    check_supported(cfg)
    dev = resolve_device(device)
    taps = voice_band_taps(cfg)
    return NbfmState(
        disc_prev=ops.fm_discriminator_init(device=dev),
        deemph=torch.zeros((), dtype=torch.float32, device=dev),
        hp_z=ops.fir_init(len(taps), torch.float32, device=dev),
        lp_z=torch.zeros((0,), dtype=torch.float32, device=dev),
        notch_z=(),
        rs_tail=ops.resample_stream_init(cfg.sample_rate, cfg.audio_rate, device=dev),
    )


def nbfm_demod(iq: torch.Tensor, state: NbfmState, cfg: NbfmConfig):
    """Narrowband FM voice -> audio; discriminator scaled to max deviation."""
    check_supported(cfg)
    ar = cfg.audio_rate
    fm, disc_prev = ops.quadrature_demod(
        iq,
        cfg.sample_rate,
        state.disc_prev,
        max_deviation_hz=cfg.max_deviation_hz,
        atan_impl="fast" if cfg.fast_discriminator else "exact",
    )
    audio, rs_tail = ops.resample_poly_stream(fm, cfg.sample_rate, ar, state.rs_tail)
    hp_z = state.hp_z
    if cfg.enable_highpass or cfg.enable_lowpass:
        taps = torch.from_numpy(voice_band_taps(cfg)).to(audio.device)
        audio, hp_z = ops.fir_filter(audio, taps, hp_z)
    audio = ops.rms_normalize(audio, cfg.target_rms)
    audio = ops.soft_clip(audio)
    return audio, NbfmState(disc_prev, state.deemph, hp_z, state.lp_z, state.notch_z, rs_tail)
