"""The PyTorch port's ops against the JAX package's, on the CPU.

Same numpy-seeded inputs through both; each tolerance is stated with its
reason.  The port runs its plain versions here (CPU tensors).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from wavecap_tpu import ops as jops
from wavecap_tpu.capture import pipeline as jpipe
from wavecap_tpu_torch import ops as tops
from wavecap_tpu_torch.capture import pipeline as tpipe
from wavecap_tpu_torch.capture.engine import pack_i16_words
from wavecap_tpu_torch.models.analog import _voice_band_fir
from tests.conftest import make_fm_signal, snr_db

torch.set_num_threads(1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def fm_tone(rng, n, fs, tone=1000.0, dev=3000.0, carrier=1200.0, amp=0.7):
    """High-SNR FM: the discriminator stays clear of its +-pi branch cut."""
    x = make_fm_signal(tone, fs, n, deviation_hz=dev, amplitude=amp)
    x = x * np.exp(2j * np.pi * carrier * np.arange(n) / fs)
    noise = 1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return (x + noise).astype(np.complex64)


# --- NCO: bit-exact tuning words and accumulators ----------------------------

OFFSETS = np.concatenate([
    np.linspace(-12_500.0, 12_500.0, 401),
    [-1e-9, -1e-3, -0.5, 0.0, 1e-3, 0.5, 6250.0, -6250.0, 12_499.999, -12_499.999],
    np.random.default_rng(7).uniform(-5e6, 5e6, 200),
])


@pytest.mark.parametrize("fs", [25_000.0, 10_000_000.0, 1_000_000.0])
def test_tuning_word_static_bit_exact(fs):
    for off in OFFSETS[::7]:
        ref = int(jops.tuning_word(float(off), fs))
        got = int(tops.tuning_word(float(off), fs, device="cpu"))
        assert got == ref, (off, got, ref)


@pytest.mark.parametrize("fs", [25_000.0, 10_000_000.0, 1_000_000.0])
def test_tuning_word_traced_bit_exact(fs):
    """The traced f32 hi/lo split: Python-sign remainder, f32 division,
    half-to-even rounding -- every bit of the word must match."""
    off = OFFSETS.astype(np.float32)
    ref = np.asarray(jops.tuning_word(jnp.asarray(off), fs))
    got = tops.tuning_word(t(off), fs).numpy()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, ref)
    # negated offsets, as the bank tunes by -fine_offset
    ref = np.asarray(jops.tuning_word(-jnp.asarray(off), fs))
    np.testing.assert_array_equal(tops.tuning_word(-t(off), fs).numpy(), ref)


def test_nco_phases_across_wrap_bit_exact():
    """Accumulators that cross 2**32 inside the block: the phases (f32)
    and the carried phase must equal the reference's exactly."""
    n = 5000
    for dphi, phase0 in [(0xFFFFFFF0, 0xFFFFFF00), (3_000_000, 0xFFF00000),
                         (0x80000001, 0x7FFFFFFF), (12345, 0)]:
        ref = np.asarray(jops.nco_phases(n, jnp.uint32(dphi), jnp.uint32(phase0)))
        got = tops.nco_phases(
            n, torch.tensor(dphi, dtype=torch.uint32), torch.tensor(phase0, dtype=torch.uint32)
        ).numpy()
        np.testing.assert_array_equal(got, ref)


def test_freq_shift_batched_matches_per_row(rng):
    rows, n, fs = 5, 3000, 25_000.0
    x = (rng.standard_normal((rows, n)) + 1j * rng.standard_normal((rows, n))).astype(np.complex64)
    off = rng.uniform(-3000, 3000, rows).astype(np.float32)
    p0 = rng.integers(0, 2**32, rows, dtype=np.uint64).astype(np.uint32)
    got, nxt = tops.freq_shift(t(x), t(off), fs, t(p0))
    for i in range(rows):
        ref, ref_nxt = jops.freq_shift(jnp.asarray(x[i]), jnp.asarray(off[i]), fs,
                                       jnp.uint32(p0[i]))
        # identical phases; cos/sin and the complex product may differ by
        # an ulp between the two libraries: ~1e-7 relative
        err = np.linalg.norm(got[i].numpy() - np.asarray(ref)) / np.linalg.norm(np.asarray(ref))
        assert err < 1e-6, (i, err)
        assert int(nxt[i]) == int(ref_nxt)


# --- discriminator -------------------------------------------------------------


def test_fast_atan2_matches(rng):
    y = rng.standard_normal(20_000).astype(np.float32)
    x = rng.standard_normal(20_000).astype(np.float32)
    y[:4], x[:4] = [0, 0, 1, -1], [0, -1, 0, 0]
    ref = np.asarray(jops.demod.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    got = tops.fast_atan2(t(y), t(x)).numpy()
    # the same f32 polynomial; the compilers may fuse differently: a few ulp
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-6)


@pytest.mark.parametrize("impl", ["fast", "exact"])
def test_quadrature_demod_split_matches(rng, impl):
    """Blocks split at odd boundaries with the carried last sample equal
    the reference's one-shot output (FM at high SNR: 80 dB floor)."""
    fs = 25_000.0
    x = fm_tone(rng, 7000, fs)
    ref, _ = jops.quadrature_demod(jnp.asarray(x), fs, jops.fm_discriminator_init(),
                                   max_deviation_hz=5000.0, atan_impl=impl)
    prev = tops.fm_discriminator_init(device="cpu")
    parts = []
    for a, b in [(0, 1), (1, 1234), (1234, 1235), (1235, 4001), (4001, 7000)]:
        y, prev = tops.quadrature_demod(t(x[a:b]), fs, prev, max_deviation_hz=5000.0,
                                        atan_impl=impl)
        parts.append(y.numpy())
    got = np.concatenate(parts)
    assert snr_db(np.asarray(ref), got) >= 80.0


# --- clip / rssi / squelch --------------------------------------------------------


def test_clip_functions_match(rng):
    x = (rng.standard_normal((4, 3000)) * 0.3).astype(np.float32)
    x[3] *= 1e-6  # below min_rms: gain 1
    np.testing.assert_allclose(
        tops.soft_clip(t(x)).numpy(), np.asarray(jops.soft_clip(jnp.asarray(x))),
        rtol=0, atol=1e-6,  # tanh of the same f32 argument: an ulp or two
    )
    np.testing.assert_allclose(
        tops.rms_normalize(t(x)).numpy(), np.asarray(jops.rms_normalize(jnp.asarray(x))),
        rtol=1e-5, atol=1e-9,  # row means summed in another order
    )
    iq = (x[:, :1000] + 1j * x[:, 1000:2000]).astype(np.complex64)
    # RSSI: |dB| <= 1e-3 (mean power summed in another order)
    np.testing.assert_allclose(
        tops.rssi_dbfs(t(iq)).numpy(), np.asarray(jops.rssi_dbfs(jnp.asarray(iq))),
        rtol=0, atol=1e-3,
    )
    rssi = np.array([-30.0, -50.0, -40.0, -40.0], np.float32)
    thr = np.array([-40.0, -40.0, -40.0, -39.0], np.float32)
    np.testing.assert_array_equal(
        tops.squelch_gate(t(x), t(rssi), t(thr)).numpy(),
        np.asarray(jops.squelch_gate(jnp.asarray(x), jnp.asarray(rssi), jnp.asarray(thr))),
    )


# --- FIR -------------------------------------------------------------------------------


def test_fir_filter_127_taps_split_at_odd_boundaries(rng):
    """The voice-band FIR streamed over odd block splits, batched over
    rows, equals the reference's one-shot direct convolution (two f32
    direct convolutions summed in different orders: >= 100 dB)."""
    taps = _voice_band_fir(25_000, 300.0, 3000.0)
    from wavecap_tpu.models.analog import _voice_band_fir as ref_fir
    np.testing.assert_array_equal(taps, ref_fir(25_000, 300.0, 3000.0))
    x = rng.standard_normal((3, 4000)).astype(np.float32)
    tail = tops.fir_init(len(taps), torch.float32, device="cpu").expand(3, -1)
    parts = []
    for a, b in [(0, 37), (37, 38), (38, 1001), (1001, 2999), (2999, 4000)]:
        y, tail = tops.fir_filter(t(x[:, a:b]), t(taps), tail)
        parts.append(y.numpy())
    got = np.concatenate(parts, axis=-1)
    for i in range(3):
        ref, _ = jops.fir_filter(jnp.asarray(x[i]), jnp.asarray(taps), jops.fir_init(len(taps), jnp.float32))
        assert snr_db(np.asarray(ref), got[i]) >= 100.0
    np.testing.assert_array_equal(tail.numpy(), x[:, -(len(taps) - 1):])


def test_conv_valid_stride_and_complex_input(rng):
    """The direct valid convolution's other forms: a decimating stride and
    complex samples (two real convolutions), real taps."""
    taps = rng.standard_normal(31).astype(np.float32)
    x = (rng.standard_normal(1000) + 1j * rng.standard_normal(1000)).astype(np.complex64)
    for stride in (1, 3):
        ref = np.asarray(jops.conv_valid(jnp.asarray(x), jnp.asarray(taps), stride))
        got = tops.conv_valid(t(x), t(taps), stride).numpy()
        assert got.shape == ref.shape
        assert snr_db(ref.real, got.real) >= 100.0 and snr_db(ref.imag, got.imag) >= 100.0
    # more than 128 taps at stride 1: the FFT convolution, as the reference's
    long_taps = rng.standard_normal(129).astype(np.float32)
    ref = np.asarray(jops.conv_valid(jnp.asarray(x.real), jnp.asarray(long_taps)))
    got = tops.conv_valid(t(x.real), t(long_taps)).numpy()
    assert got.shape == ref.shape and snr_db(ref, got) >= 100.0


# --- spectrum --------------------------------------------------------------------------


def test_spectrogram_sampled_matches(rng):
    fs, n = 1_000_000, 40_000
    x = fm_tone(rng, n, fs, carrier=123_456.0, dev=5000.0, amp=0.5)
    x = x + (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    ref = np.asarray(jops.spectrogram_sampled(jnp.asarray(x), 2048, n_out=2))
    got = tops.spectrogram_sampled(t(x), 2048, n_out=2).numpy()
    assert got.shape == ref.shape == (2, 2048)
    # two f32 FFT libraries: |dB| <= 0.05 on bins within 60 dB of the peak
    strong = ref >= ref.max() - 60.0
    assert float(np.max(np.abs(got - ref)[strong])) <= 0.05
    p_ref = np.asarray(jops.power_spectrum(jnp.asarray(x), 2048))
    p_got = tops.power_spectrum(t(x), 2048).numpy()
    strong = p_ref >= p_ref.max() - 60.0
    assert float(np.max(np.abs(p_got - p_ref)[strong])) <= 0.05


@pytest.mark.parametrize("n,fft,hop,average", [(8192, 1024, 512, 1), (8192, 1024, None, 1), (20_000, 512, 256, 4),
                                                (100, 256, None, 1), (0, 256, 128, 1)])
def test_spectrogram_matches(rng, n, fft, hop, average):
    """All frames of a block (``tests/test_ops_core.py:278-280``; a block
    shorter than a frame and an empty block, ``tests/test_empty_blocks.py:76-78``)."""
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    ref = np.asarray(jops.spectrogram(jnp.asarray(x), fft_size=fft, hop=hop, average=average))
    got = tops.spectrogram(t(x), fft_size=fft, hop=hop, average=average).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    if ref.size:  # two f32 FFT libraries: |dB| <= 0.05 on bins within 60 dB of the peak
        strong = ref >= ref.max() - 60.0
        assert float(np.max(np.abs(got - ref)[strong])) <= 0.05
    if (n, fft, hop) == (8192, 1024, 512):
        assert got.shape == (15, 1024)


@pytest.mark.parametrize("freq", [1000.0, -2345.5, 0.0])
def test_real_osc_matches(freq):
    """The real cosine oscillator: the same phase words, cos within an ulp
    of the other library's; a carried phase continues it."""
    fs, p0 = 48_000.0, 123_456_789
    ref, ref_nxt = jops.real_osc(5000, freq, fs, jnp.uint32(p0))
    got, nxt = tops.real_osc(5000, freq, fs, t(np.uint32(p0)))
    assert got.shape == (5000,) and int(nxt) == int(ref_nxt)
    assert float(np.max(np.abs(got.numpy() - np.asarray(ref)))) <= 2e-7
    ref0, _ = jops.real_osc(300, freq, fs)
    got0, nxt0 = tops.real_osc(300, freq, fs, device="cpu")
    assert nxt0.device.type == "cpu"
    assert float(np.max(np.abs(got0.numpy() - np.asarray(ref0)))) <= 2e-7


def test_module_constants_match():
    from wavecap_tpu.models.p25 import cqpsk as jq
    from wavecap_tpu_torch.models.p25 import cqpsk as tq

    assert tpipe.NARROW_MODES == jpipe.NARROW_MODES
    assert (tq.INTERP_TAIL, tq.EQ_NFFT) == (jq.INTERP_TAIL, jq.EQ_NFFT)
    assert set(jops.__all__) <= set(tops.__all__)


# --- transport -----------------------------------------------------------------------


def test_to_complex_words_bit_exact(rng):
    iq = rng.integers(-32768, 32768, (5000, 2)).astype(np.int16)
    iq[:4] = [[-32768, 32767], [32767, -32768], [-1, 0], [0, -1]]
    words = iq.view(np.int32).ravel()
    ref = np.asarray(jpipe._to_complex(jnp.asarray(words)))
    got = tpipe._to_complex(t(words)).numpy()
    np.testing.assert_array_equal(got, ref)
    f = rng.standard_normal(400).astype(np.float32)
    np.testing.assert_array_equal(
        tpipe._to_complex(t(f)).numpy(), np.asarray(jpipe._to_complex(jnp.asarray(f)))
    )


def test_pack_i16_words_matches_engine_expression(rng):
    blocks = [
        (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)).astype(np.complex64) * 0.6
        for _ in range(3)
    ]
    blocks[0][:3] = [1.5 + 0j, -2.0 - 2.0j, 0.5 / 32767 + 0j]  # clip and round-half cases
    # the i16 branch of the reference engine's host conversion
    ref = np.stack([
        np.clip(np.round(np.ascontiguousarray(b).view(np.float32) * 32767.0), -32768, 32767)
        .astype(np.int16).view(np.int32)
        for b in blocks
    ])
    got = pack_i16_words(blocks)
    assert got.dtype == np.int32 and got.shape == (3, 3000)
    np.testing.assert_array_equal(got, ref)
