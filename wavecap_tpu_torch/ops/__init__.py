"""Kernel library of the port: stateful-by-carry ops on torch tensors."""

from .nco import freq_shift, tuning_word, nco_phases, real_osc
from .fir import (
    fir_filter,
    fir_decimate,
    fir_init,
    conv_valid,
    resample_poly,
    resample_poly_stream,
    resample_stream_init,
    design_lowpass_fir,
    design_decimation_fir,
)
from .iir import (
    onepole_filter,
    onepole_init,
    deemphasis,
    sos_filter,
    sos_init,
    lowpass,
    highpass,
    bandpass,
    notch,
    butter_sos,
    n_sections,
)
from .agc import apply_agc, simple_agc, agc_init, AgcState
from .clip import soft_clip, rms_normalize, rssi_dbfs, squelch_gate
from .demod import (
    am_envelope,
    fast_atan2,
    fm_discriminator_init,
    quadrature_demod,
    ssb_product,
)
from .spectrum import power_spectrum, spectrogram, spectrogram_sampled

__all__ = [n for n in dir() if not n.startswith("_")]
