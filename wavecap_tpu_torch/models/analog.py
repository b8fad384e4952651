"""Analog demodulators: WBFM, NBFM, AM, SSB, SAM.

Counterpart of ``wavecap_tpu/models/analog.py``: pure block functions
``demod(iq, state, cfg) -> (audio, state)`` over a batch of channels
(``B + (n,)``, the states stacked with the same leading axes), with the
reference's config and state types.  As in the reference, every linear
audio filter runs at ``audio_rate``, after the detector and the
resampler.  The noise blanker (kernel K11a) and the spectral noise
reduction (K11b) run at the reference's places: the blanker on the IQ
before the FM discriminators and on the AM, SSB and SAM detector
outputs before their resamplers, the noise reduction on the NBFM and
WBFM audio before normalization.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sps

from .. import ops
from ..ops import iir as iir_ops
from ..ops import noise as noise_ops
from ..ops import pll as pll_ops
from ..utils.torchenv import DeviceLike, resolve_device


# --- shared audio post-chain ---------------------------------------------------


def _notch_states(n_notch: int, device: torch.device) -> tuple:
    return tuple(ops.sos_init(1, device=device) for _ in range(n_notch))


def _apply_notches(audio, rate, freqs, states):
    new_states = []
    for f, z in zip(freqs, states):
        if 0 < f < rate / 2:
            audio, z = iir_ops.notch(audio, rate, f, z)
        new_states.append(z)
    return audio, tuple(new_states)


# --- WBFM ----------------------------------------------------------------------


@dataclass(frozen=True)
class WbfmConfig:
    sample_rate: int
    audio_rate: int = 48_000
    enable_deemphasis: bool = True
    deemphasis_tau: float = 75e-6
    enable_mpx_filter: bool = True
    mpx_cutoff_hz: float = 15_000.0
    enable_highpass: bool = False
    highpass_hz: float = 100.0
    enable_noise_blanker: bool = False
    noise_blanker_threshold_db: float = 10.0
    notch_frequencies: tuple = ()
    enable_noise_reduction: bool = False
    noise_reduction_db: float = 12.0
    target_rms: float = 0.18


class WbfmState(NamedTuple):
    disc_prev: torch.Tensor
    deemph: torch.Tensor
    mpx_z: torch.Tensor
    hp_z: torch.Tensor
    notch_z: tuple
    rs_tail: torch.Tensor


def wbfm_init(cfg: WbfmConfig, device: DeviceLike = None) -> WbfmState:
    dev = resolve_device(device)
    return WbfmState(
        disc_prev=ops.fm_discriminator_init(device=dev),
        deemph=ops.onepole_init(device=dev),
        mpx_z=ops.sos_init(iir_ops.n_sections("low", 5), device=dev),
        hp_z=ops.sos_init(iir_ops.n_sections("high", 5), device=dev),
        notch_z=_notch_states(len(cfg.notch_frequencies), dev),
        rs_tail=ops.resample_stream_init(cfg.sample_rate, cfg.audio_rate, device=dev),
    )


def wbfm_demod(iq: torch.Tensor, state: WbfmState, cfg: WbfmConfig):
    """Wideband broadcast FM -> mono audio at ``cfg.audio_rate``."""
    audio, _fm, st = wbfm_demod_baseband(iq, state, cfg)
    return audio, st


def wbfm_demod_baseband(iq: torch.Tensor, state: WbfmState, cfg: WbfmConfig):
    """Like :func:`wbfm_demod`, also returning the pre-MPX discriminator
    baseband at the input rate (where the 57 kHz RDS subcarrier lives)."""
    ar = cfg.audio_rate
    if cfg.enable_noise_blanker:
        iq = noise_ops.noise_blanker(iq, cfg.noise_blanker_threshold_db)
    fm, disc_prev = ops.quadrature_demod(iq, cfg.sample_rate, state.disc_prev)
    audio, rs_tail = ops.resample_poly_stream(fm, cfg.sample_rate, ar, state.rs_tail)
    deemph = state.deemph
    if cfg.enable_deemphasis:
        audio, deemph = ops.deemphasis(audio, ar, cfg.deemphasis_tau, deemph)
    mpx_z = state.mpx_z
    if cfg.enable_mpx_filter and cfg.mpx_cutoff_hz < ar / 2:
        audio, mpx_z = iir_ops.lowpass(audio, ar, cfg.mpx_cutoff_hz, mpx_z)
    hp_z = state.hp_z
    if cfg.enable_highpass and cfg.highpass_hz > 0:
        audio, hp_z = iir_ops.highpass(audio, ar, cfg.highpass_hz, hp_z)
    audio, notch_z = _apply_notches(audio, ar, cfg.notch_frequencies, state.notch_z)
    if cfg.enable_noise_reduction:
        audio = noise_ops.spectral_noise_reduction(audio, cfg.noise_reduction_db)
    audio = ops.soft_clip(ops.rms_normalize(audio, cfg.target_rms))
    return audio, fm, WbfmState(disc_prev, deemph, mpx_z, hp_z, notch_z, rs_tail)


# --- NBFM ----------------------------------------------------------------------


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
    filter_impl: str = "iir"  # "iir" (biquad cascades, kernel K9) | "fir" (kernel K4)
    fast_discriminator: bool = False  # polynomial atan2 (~1e-4 rad)


class NbfmState(NamedTuple):
    disc_prev: torch.Tensor
    deemph: torch.Tensor
    hp_z: torch.Tensor
    lp_z: torch.Tensor
    notch_z: tuple
    rs_tail: torch.Tensor


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
    dev = resolve_device(device)
    if cfg.filter_impl == "fir":
        hp_z = ops.fir_init(len(voice_band_taps(cfg)), torch.float32, device=dev)
        lp_z = torch.zeros((0,), dtype=torch.float32, device=dev)
    else:
        hp_z = ops.sos_init(iir_ops.n_sections("high", 5), device=dev)
        lp_z = ops.sos_init(iir_ops.n_sections("low", 5), device=dev)
    return NbfmState(
        disc_prev=ops.fm_discriminator_init(device=dev),
        deemph=ops.onepole_init(device=dev),
        hp_z=hp_z,
        lp_z=lp_z,
        notch_z=_notch_states(len(cfg.notch_frequencies), dev),
        rs_tail=ops.resample_stream_init(cfg.sample_rate, cfg.audio_rate, device=dev),
    )


def nbfm_audio(fm: torch.Tensor, state: NbfmState, cfg: NbfmConfig):
    """NBFM after the discriminator: resample, deemphasis, the voice
    filters, notches, the noise reduction, normalize and clip.
    ``state.disc_prev`` passes through."""
    ar = cfg.audio_rate
    audio, rs_tail = ops.resample_poly_stream(fm, cfg.sample_rate, ar, state.rs_tail)
    deemph = state.deemph
    if cfg.enable_deemphasis:
        audio, deemph = ops.deemphasis(audio, ar, cfg.deemphasis_tau, deemph)
    hp_z, lp_z = state.hp_z, state.lp_z
    if cfg.filter_impl == "fir" and (cfg.enable_highpass or cfg.enable_lowpass):
        taps = torch.from_numpy(voice_band_taps(cfg)).to(audio.device)
        audio, hp_z = ops.fir_filter(audio, taps, hp_z)
    else:
        if cfg.enable_highpass and cfg.highpass_hz > 0:
            audio, hp_z = iir_ops.highpass(audio, ar, cfg.highpass_hz, hp_z)
        if cfg.enable_lowpass and 0 < cfg.lowpass_hz < ar / 2:
            audio, lp_z = iir_ops.lowpass(audio, ar, cfg.lowpass_hz, lp_z)
    audio, notch_z = _apply_notches(audio, ar, cfg.notch_frequencies, state.notch_z)
    if cfg.enable_noise_reduction:
        audio = noise_ops.spectral_noise_reduction(audio, cfg.noise_reduction_db)
    audio = ops.soft_clip(ops.rms_normalize(audio, cfg.target_rms))
    return audio, NbfmState(state.disc_prev, deemph, hp_z, lp_z, notch_z, rs_tail)


def nbfm_demod(iq: torch.Tensor, state: NbfmState, cfg: NbfmConfig):
    """Narrowband FM voice -> audio; discriminator scaled to max deviation."""
    if cfg.enable_noise_blanker:
        iq = noise_ops.noise_blanker(iq, cfg.noise_blanker_threshold_db)
    fm, disc_prev = ops.quadrature_demod(
        iq, cfg.sample_rate, state.disc_prev, max_deviation_hz=cfg.max_deviation_hz,
        atan_impl="fast" if cfg.fast_discriminator else "exact",
    )
    return nbfm_audio(fm, state._replace(disc_prev=disc_prev), cfg)


# --- AM ------------------------------------------------------------------------


@dataclass(frozen=True)
class AmConfig:
    sample_rate: int
    audio_rate: int = 48_000
    enable_agc: bool = True
    agc_target_db: float = -20.0
    enable_highpass: bool = True
    highpass_hz: float = 100.0
    enable_lowpass: bool = True
    lowpass_hz: float = 5_000.0
    enable_noise_blanker: bool = False
    noise_blanker_threshold_db: float = 10.0
    notch_frequencies: tuple = ()


class AmState(NamedTuple):
    hp_z: torch.Tensor
    lp_z: torch.Tensor
    agc: ops.AgcState
    notch_z: tuple
    rs_tail: torch.Tensor


def am_init(cfg: AmConfig, device: DeviceLike = None) -> AmState:
    dev = resolve_device(device)
    return AmState(
        hp_z=ops.sos_init(iir_ops.n_sections("high", 5), device=dev),
        lp_z=ops.sos_init(iir_ops.n_sections("low", 5), device=dev),
        agc=ops.agc_init(device=dev),
        notch_z=_notch_states(len(cfg.notch_frequencies), dev),
        rs_tail=ops.resample_stream_init(cfg.sample_rate, cfg.audio_rate, device=dev),
    )


def _voice_post(audio, hp_z, lp_z, agc, notch_z, cfg):
    """AM and SAM after the detector and the resampler: high-pass,
    low-pass, notches, then AGC (or a plain soft clip)."""
    ar = cfg.audio_rate
    if cfg.enable_highpass and cfg.highpass_hz > 0:
        audio, hp_z = iir_ops.highpass(audio, ar, cfg.highpass_hz, hp_z)
    if cfg.enable_lowpass and 0 < cfg.lowpass_hz < ar / 2:
        audio, lp_z = iir_ops.lowpass(audio, ar, cfg.lowpass_hz, lp_z)
    audio, notch_z = _apply_notches(audio, ar, cfg.notch_frequencies, notch_z)
    if cfg.enable_agc:
        audio, agc = ops.apply_agc(audio, ar, agc, target_db=cfg.agc_target_db)
    else:
        audio = ops.soft_clip(audio)
    return audio, hp_z, lp_z, agc, notch_z


def am_demod(iq: torch.Tensor, state: AmState, cfg: AmConfig):
    """AM envelope detection -> audio."""
    audio = ops.am_envelope(iq)
    if cfg.enable_noise_blanker:
        audio = noise_ops.noise_blanker(audio, cfg.noise_blanker_threshold_db)
    audio, rs_tail = ops.resample_poly_stream(audio, cfg.sample_rate, cfg.audio_rate,
                                              state.rs_tail)
    audio, hp_z, lp_z, agc, notch_z = _voice_post(
        audio, state.hp_z, state.lp_z, state.agc, state.notch_z, cfg)
    return audio, AmState(hp_z, lp_z, agc, notch_z, rs_tail)


# --- SSB -----------------------------------------------------------------------


@dataclass(frozen=True)
class SsbConfig:
    sample_rate: int
    audio_rate: int = 48_000
    mode: str = "usb"  # "usb" | "lsb"
    bfo_offset_hz: float = 1_500.0
    enable_agc: bool = True
    agc_target_db: float = -20.0
    enable_bandpass: bool = True
    bandpass_low: float = 300.0
    bandpass_high: float = 3_000.0
    enable_noise_blanker: bool = False
    noise_blanker_threshold_db: float = 10.0
    notch_frequencies: tuple = ()


class SsbState(NamedTuple):
    nco_phase: torch.Tensor
    bp_z: torch.Tensor
    agc: ops.AgcState
    notch_z: tuple
    rs_tail: torch.Tensor


def ssb_init(cfg: SsbConfig, device: DeviceLike = None) -> SsbState:
    dev = resolve_device(device)
    return SsbState(
        nco_phase=torch.zeros((), dtype=torch.uint32, device=dev),
        # order 5, the reference's bandpass default
        bp_z=ops.sos_init(iir_ops.n_sections("band", 5), device=dev),
        agc=ops.agc_init(device=dev),
        notch_z=_notch_states(len(cfg.notch_frequencies), dev),
        rs_tail=ops.resample_stream_init(cfg.sample_rate, cfg.audio_rate, device=dev),
    )


def ssb_demod(iq: torch.Tensor, state: SsbState, cfg: SsbConfig):
    """SSB product detection: the fixed BFO shift (exact host tuning
    word), the real part, then the band-pass and AGC at audio rate."""
    ar = cfg.audio_rate
    shift = cfg.bfo_offset_hz if cfg.mode.lower() == "usb" else -cfg.bfo_offset_hz
    shifted, nco_phase = ops.freq_shift(iq, float(shift), cfg.sample_rate, state.nco_phase)
    audio = ops.ssb_product(shifted)
    if cfg.enable_noise_blanker:
        audio = noise_ops.noise_blanker(audio, cfg.noise_blanker_threshold_db)
    audio, rs_tail = ops.resample_poly_stream(audio, cfg.sample_rate, ar, state.rs_tail)
    bp_z = state.bp_z
    if cfg.enable_bandpass:
        audio, bp_z = iir_ops.bandpass(audio, ar, cfg.bandpass_low, cfg.bandpass_high, bp_z,
                                       order=5)
    audio, notch_z = _apply_notches(audio, ar, cfg.notch_frequencies, state.notch_z)
    agc = state.agc
    if cfg.enable_agc:
        audio, agc = ops.apply_agc(audio, ar, agc, target_db=cfg.agc_target_db)
    else:
        audio = ops.soft_clip(audio)
    return audio, SsbState(nco_phase, bp_z, agc, notch_z, rs_tail)


# --- SAM (synchronous AM) ------------------------------------------------------


@dataclass(frozen=True)
class SamConfig:
    sample_rate: int
    audio_rate: int = 48_000
    sideband: str = "dsb"  # "dsb" | "usb" | "lsb"
    pll_bandwidth_hz: float = 50.0
    pll_damping: float = 0.707
    enable_agc: bool = True
    agc_target_db: float = -20.0
    enable_highpass: bool = True
    highpass_hz: float = 100.0
    enable_lowpass: bool = True
    lowpass_hz: float = 5_000.0
    enable_noise_blanker: bool = False
    noise_blanker_threshold_db: float = 10.0
    notch_frequencies: tuple = ()


class SamState(NamedTuple):
    pll: pll_ops.PllState
    hp_z: torch.Tensor
    lp_z: torch.Tensor
    agc: ops.AgcState
    notch_z: tuple
    rs_tail: torch.Tensor


def sam_init(cfg: SamConfig, device: DeviceLike = None) -> SamState:
    dev = resolve_device(device)
    return SamState(
        pll=pll_ops.pll_init(device=dev),
        hp_z=ops.sos_init(iir_ops.n_sections("high", 5), device=dev),
        lp_z=ops.sos_init(iir_ops.n_sections("low", 5), device=dev),
        agc=ops.agc_init(device=dev),
        notch_z=_notch_states(len(cfg.notch_frequencies), dev),
        rs_tail=ops.resample_stream_init(cfg.sample_rate, cfg.audio_rate, device=dev),
    )


def sam_demod(iq: torch.Tensor, state: SamState, cfg: SamConfig):
    """Synchronous AM with PLL carrier recovery.  The recovered carrier
    offset in Hz is ``state.pll.freq * sample_rate / (2 pi)``."""
    coherent, pll_state = pll_ops.carrier_recovery_pll(
        iq, cfg.sample_rate, state.pll, cfg.pll_bandwidth_hz, cfg.pll_damping
    )
    sb = cfg.sideband.lower()
    if sb == "usb":
        audio = coherent.real + coherent.imag
    elif sb == "lsb":
        audio = coherent.real - coherent.imag
    else:
        audio = coherent.real
    audio = audio.to(torch.float32)
    if cfg.enable_noise_blanker:
        audio = noise_ops.noise_blanker(audio, cfg.noise_blanker_threshold_db)
    audio, rs_tail = ops.resample_poly_stream(audio, cfg.sample_rate, cfg.audio_rate,
                                              state.rs_tail)
    audio, hp_z, lp_z, agc, notch_z = _voice_post(
        audio, state.hp_z, state.lp_z, state.agc, state.notch_z, cfg)
    return audio, SamState(pll_state, hp_z, lp_z, agc, notch_z, rs_tail)
