"""Kernel library of the port: stateful-by-carry ops on torch tensors."""

from .nco import freq_shift, tuning_word, nco_phases
from .fir import (
    fir_filter,
    fir_init,
    conv_valid,
    resample_poly_stream,
    resample_stream_init,
)
from .clip import soft_clip, rms_normalize, rssi_dbfs, squelch_gate
from .demod import fast_atan2, quadrature_demod, fm_discriminator_init
from .spectrum import power_spectrum, spectrogram_sampled

__all__ = [n for n in dir() if not n.startswith("_")]
