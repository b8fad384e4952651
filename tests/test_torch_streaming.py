"""Block-segmentation invariance of the port's demods, against the JAX package's, on the CPU.

Mirrors ``tests/test_streaming_invariance.py``'s 11 demod cases: a signal
run through the port in B-sample blocks equals the port in 2B-sample
blocks and the reference in 2B-sample blocks, within the reference's own
bound (5e-3 of the peak: f32 accumulation in other orders and programs).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu import models as jmodels
from wavecap_tpu_torch import models as tmodels
from tests.conftest import make_fm_signal, make_tone

torch.set_num_threads(1)

FS = 240_000
BLOCK = 24_000  # divisible by every resampling factor in the chain


def run_port(mode, cfg, x, block):
    spec = tmodels.get_demod(mode)
    state = spec.init(cfg, device="cpu")
    parts = []
    for i in range(0, len(x), block):
        y, state = spec.demod(torch.from_numpy(x[i : i + block]), state, cfg)
        parts.append(y.numpy())
    return np.concatenate(parts)


def run_reference(mode, cfg, x, block):
    spec = jmodels.get_demod(mode)
    state = spec.init(cfg)
    parts = []
    for i in range(0, len(x), block):
        y, state = spec.demod(jnp.asarray(x[i : i + block]), state, cfg)
        parts.append(np.asarray(y))
    return np.concatenate(parts)


def signal(mode, rng):
    if mode == "wbfm":
        return make_fm_signal(1000.0, FS, 4 * BLOCK, deviation_hz=50_000.0)
    if mode == "nbfm":
        return make_fm_signal(800.0, FS, 4 * BLOCK, deviation_hz=3_000.0)
    x = (make_tone(1000.0, FS, 4 * BLOCK) * 0.5).astype(np.complex64)
    return x + 0.001 * (
        rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x))
    ).astype(np.complex64)


def rel_peak_err(a, b) -> float:
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) / max(1e-6, float(np.abs(a).max()))


CASES = [(mode, {}) for mode in ("wbfm", "nbfm", "am", "sam", "usb")] + [
    # the reference's DSP variants (test_streaming_invariance.py:67-77)
    ("nbfm", {"notch_frequencies": (2000.0, 2600.0)}),
    ("nbfm", {"enable_deemphasis": True, "deemphasis_tau": 50e-6}),
    ("nbfm", {"filter_impl": "fir"}),
    ("wbfm", {"enable_highpass": True, "notch_frequencies": (5000.0,)}),
    ("am", {"enable_agc": True, "notch_frequencies": (3000.0,)}),
    ("usb", {"bandpass_low": 200.0, "bandpass_high": 2800.0}),
]


@pytest.mark.parametrize("mode,dsp", CASES, ids=[f"{m}-{sorted(d)}" for m, d in CASES])
def test_segmentation_invariance(mode, dsp, rng):
    x = signal(mode, rng).astype(np.complex64)
    tcfg = tmodels.make_config(mode, FS, audio_rate=48_000, **dsp)
    jcfg = jmodels.make_config(mode, FS, audio_rate=48_000, **dsp)
    a = run_port(mode, tcfg, x, BLOCK)
    b = run_port(mode, tcfg, x, 2 * BLOCK)
    ref = run_reference(mode, jcfg, x, 2 * BLOCK)
    assert rel_peak_err(a, b) < 5e-3, rel_peak_err(a, b)
    assert rel_peak_err(ref, a) < 5e-3, rel_peak_err(ref, a)
