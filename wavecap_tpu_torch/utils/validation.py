"""Hot-path input validation.

The air interface is untrusted: TSBK-derived tuning data and DSP-produced
audio both go through sanity gates before anything acts on them (reference
``backend/wavecapsdr/validation.py:37-53`` guards audio/array finiteness and
``trunking`` range-checks derived frequencies).

The port's copy of ``wavecap_tpu/utils/validation.py``, with the same public names.
"""

from __future__ import annotations

import numpy as np

# Plausible RF tuning range for anything this framework would be asked to
# receive (long-wave broadcast .. low microwave).  TSBK IDEN math that lands
# outside is corrupt or hostile, never a real site.
RF_MIN_HZ = 25e6
RF_MAX_HZ = 1.3e9


def plausible_rf_hz(freq_hz: float | None) -> bool:
    """True when ``freq_hz`` is a finite, plausibly-tunable RF frequency."""
    if freq_hz is None:
        return False
    try:
        f = float(freq_hz)
    except (TypeError, ValueError):
        return False
    return np.isfinite(f) and RF_MIN_HZ <= f <= RF_MAX_HZ


def plausible_iden(
    base_freq_mhz: float, channel_spacing_khz: float, bandwidth_khz: float
) -> bool:
    """Sanity bounds for an IDEN_UP channel identifier before it is stored
    (a corrupt-but-CRC-lucky TSBK must not poison the channel->frequency
    map used to tune voice recorders)."""
    try:
        base = float(base_freq_mhz)
        spacing = float(channel_spacing_khz)
        bw = float(bandwidth_khz)
    except (TypeError, ValueError):
        return False
    if not (np.isfinite(base) and np.isfinite(spacing) and np.isfinite(bw)):
        return False
    if not (RF_MIN_HZ / 1e6 <= base <= RF_MAX_HZ / 1e6):
        return False
    if not (0.0 < spacing <= 1000.0):  # P25 spacings are 2.5-125 kHz
        return False
    if not (0.0 <= bw <= 1000.0):
        return False
    return True


def sanitize_audio(audio: np.ndarray, clip: float = 4.0) -> np.ndarray:
    """Replace non-finite samples and clamp runaway amplitudes.

    DSP edge cases (AGC divide on an all-zero block, filter blowup on a
    corrupt input) must not propagate NaN/Inf into WAV files, encoders, or
    WebSocket PCM streams.  Returns the input unchanged when clean (no
    copy on the hot path)."""
    a = np.asarray(audio)
    if a.size == 0:
        return a
    if np.isfinite(a).all():
        m = float(np.max(np.abs(a)))
        if m <= clip:
            return a
        return np.clip(a, -clip, clip)
    out = np.nan_to_num(a, nan=0.0, posinf=clip, neginf=-clip)
    return np.clip(out, -clip, clip)
