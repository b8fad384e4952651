"""The port's vocoders (``imbe_vocoder``, ``voice``, ``ambe_vocoder``) and
the Phase 2 voice bursts against the JAX package's, on the CPU.

Each case runs the same seeded inputs through both packages and requires
the results equal exactly (``tests/test_torch_decoders_fec.py:run_case``):
the same numpy operations run on both sides, so the PCM is bit-equal.
The cases follow ``tests/test_imbe_vocoder.py`` (its recorder case, which
writes a WAV through ``trunking.recorder`` and ``utils.wavio``, waits for
the slices that port those: ROADMAP.md) and ``tests/test_ambe_vocoder.py``
(its DMR superframe case is in ``test_torch_decoders_dmr.py``).  Then the
hand-over: a vocoder stopped mid-stream in the reference and finished in
the port (``convert.decoder_state_from_reference``) gives the reference's
PCM.
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_decoders_fec import PORT, REF, canon, run_case
from wavecap_tpu_torch import convert


def vowel(seconds=1.0, f0=120.0, fs=8000, level=0.3) -> np.ndarray:
    t = np.arange(int(seconds * fs)) / fs
    sig = np.zeros_like(t)
    for h in range(1, 25):
        amp = np.exp(-(((h * f0 - 500) / 400) ** 2)) + 0.7 * np.exp(-(((h * f0 - 1500) / 500) ** 2))
        sig += amp * np.cos(2 * np.pi * h * f0 * t + h)
    return (level / np.max(np.abs(sig))) * sig


def voiced(f0=150.0, seconds=0.6, fs=8000) -> np.ndarray:
    t = np.arange(int(seconds * fs)) / fs
    x = np.zeros_like(t)
    for k, a in ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3), (5, 0.2)):
        x += a * np.sin(2 * np.pi * f0 * k * t)
    return (0.3 * x / np.max(np.abs(x))).astype(np.float32)


# --- IMBE FEC and quantization (tests/test_imbe_vocoder.py) ----------------------------


def golay23(d, rng):
    out = []
    for _ in range(100):
        v = int(rng.integers(0, 1 << 12))
        cw = d.voice.golay23_encode(v)
        for p in rng.choice(23, 3, replace=False):
            cw ^= 1 << int(p)
        out.append((cw, d.voice.golay23_decode(cw)))
    return out


def hamming15(d, rng):
    out = []
    for _ in range(100):
        cw = d.voice.hamming15_encode(int(rng.integers(0, 1 << 11))) ^ (1 << int(rng.integers(0, 15)))
        out.append((cw, d.voice.hamming15_decode(cw)))
    return out


def imbe_codewords(d, rng):
    out = []
    for _ in range(25):
        u = [int(rng.integers(0, 1 << w)) for w in d.iv.U_WIDTHS]
        bits = d.voice.imbe_fec_encode(u)
        b2 = bits.copy()
        for sp in rng.choice(92, 2, replace=False):
            b2[(int(sp) % 6) * 24 + int(sp) // 6] ^= 1
        out += [bits, d.voice.imbe_fec_decode(bits), d.voice.imbe_fec_decode(b2)]
    noise = rng.integers(0, 2, (10, 144)).astype(np.uint8)
    return out + [d.voice.imbe_fec_decode(n) for n in noise]


def imbe_params(d, rng):
    iv = d.iv
    prev = iv.ImbeParams.initial()
    out = []
    for b0 in (20, 80, 150, 200):
        w0 = iv.fundamental_from_b0(b0)
        L = iv.harmonics_for(w0)
        K = iv.bands_for(L)
        p = iv.ImbeParams(w0=w0, L=L, K=K, voiced=np.array([iv.band_of(x, K) % 2 == 0 for x in range(1, L + 1)]),
                          log2M=np.linspace(-3, -7, L) + rng.normal(0, 0.3, L))
        u = iv.encode_params(p, prev)
        prev = iv.decode_params(u, prev)
        out += [u, prev]
    return out


def imbe_tables(d, rng):
    iv = d.iv
    out = []
    for b0 in range(0, 208):
        w0 = iv.fundamental_from_b0(b0)
        L = iv.harmonics_for(w0)
        out += [w0, iv.b0_from_period(2.0 * np.pi / w0), L, iv.bands_for(L), iv.bit_allocation(L, iv.bands_for(L))]
    return out + [[iv._gain_decode(i) for i in range(64)], [iv._gain_encode(iv._gain_decode(i)) for i in range(64)]]


def imbe_voicing(d, rng):
    iv = d.iv
    prev = iv.ImbeParams.initial()
    w0 = iv.fundamental_from_b0(60)
    L = iv.harmonics_for(w0)
    K = iv.bands_for(L)
    out = []
    for _ in range(16):
        bands = rng.integers(0, 2, K).astype(bool)
        p = iv.ImbeParams(w0=w0, L=L, K=K, voiced=np.asarray([bands[iv.band_of(l, K)] for l in range(1, L + 1)]),
                          log2M=np.full(L, -2.0))
        out.append(iv.decode_params(iv.encode_params(p, prev), prev))
    return out


# --- IMBE synthesis ---------------------------------------------------------------------


def imbe_speech(d, rng):
    us = d.iv.ImbeEncoder().encode(vowel())
    dec = d.voice.VoiceDecoder()
    return [us, dec.decode_codewords([d.voice.imbe_fec_encode(u) for u in us]), dec.frames_decoded, dec.frames_failed]


def imbe_silence(d, rng):
    us = d.iv.ImbeEncoder().encode(np.zeros(8000))
    return d.voice.VoiceDecoder().decode_codewords([d.voice.imbe_fec_encode(u) for u in us])


def imbe_concealment(d, rng):
    us = d.iv.ImbeEncoder().encode(vowel(seconds=0.5))
    dec = d.voice.VoiceDecoder()
    first = dec.decode_codewords([d.voice.imbe_fec_encode(u) for u in us])
    return [first, dec.decode_codewords([rng.integers(0, 2, 144).astype(np.uint8) for _ in range(10)]), dec]


def imbe_unvoiced(d, rng):
    iv = d.iv
    w0 = iv.fundamental_from_b0(100)
    L = iv.harmonics_for(w0)
    p = iv.ImbeParams(w0=w0, L=L, K=iv.bands_for(L), voiced=np.zeros(L, bool), log2M=np.full(L, -4.0))
    syn = iv.ImbeSynthesizer()
    return [syn.synth(p) for _ in range(20)] + [syn.synth(None), syn]


# --- AMBE+2 half rate (tests/test_ambe_vocoder.py) ------------------------------------------


def ambe_fec(d, rng):
    a = d.ambe
    out = []
    for _ in range(20):
        b = rng.integers(0, 2, a.B_BITS).astype(np.uint8)
        frame = a.ambe_fec_encode(b)
        out += [frame, a.ambe_fec_decode(frame)]
    b = rng.integers(0, 2, a.B_BITS).astype(np.uint8)
    frame = a.ambe_fec_encode(b)
    for serials in ((0, 7, 20, 25, 30, 44), (0, 5, 9, 14), (3,), (50, 60, 70)):
        bad = frame.copy()
        for i in serials:
            bad[(i % 6) * 12 + i // 6] ^= 1
        out.append(a.ambe_fec_decode(bad))
    return out


def ambe_codec(d, rng, f0: float):
    frames = d.ambe.AmbeEncoder().encode(voiced(f0))
    dec = d.ambe.AmbeDecoder()
    pcm = dec.decode_frames(frames)
    lost = [dec.decode_frame(None) for _ in range(12)]
    return [frames, pcm, lost, dec.frames_decoded, dec.frames_failed]


def ambe_edges(d, rng):
    garbage = rng.integers(0, 2, (30, d.ambe.FRAME_BITS)).astype(np.uint8)
    t = np.arange(int(0.6 * 8000)) / 8000.0
    tone = (0.3 * np.sin(2 * np.pi * 160.0 * t)).astype(np.float32)
    frames = d.ambe.AmbeEncoder().encode(tone)
    return [d.ambe.AmbeDecoder().decode_frames(np.zeros((0, 72), np.uint8)),
            d.ambe.AmbeEncoder().encode(np.zeros(10, np.float32)), d.ambe.AmbeDecoder().decode_frames(garbage),
            frames, d.ambe.AmbeDecoder().decode_frames(frames)]


def p2_voice_bursts(d, rng):
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    out = []
    for with_sync in (False, True):
        burst = d.p2.build_voice_burst(frames, with_sync=with_sync)
        out += [burst, d.p2.extract_voice_frames(burst)]
    return out


def p2_voice_fragment(d, rng):
    t = np.arange(int(0.4 * 8000)) / 8000.0
    x = np.sin(2 * np.pi * 140.0 * t) + 0.4 * np.sin(2 * np.pi * 280.0 * t)
    frames = d.ambe.AmbeEncoder().encode((0.3 * x / np.max(np.abs(x))).astype(np.float32))
    frag = np.zeros(d.p2.FRAGMENT_DIBITS, np.uint8)
    for k in range(4):
        frag[180 * k:180 * (k + 1)] = d.p2.build_voice_burst(frames[4 * k:4 * k + 4], with_sync=k >= 2)
    frag = d.p2.build_test_fragment(frag)
    soft = d.p2.DIBIT_SYMBOLS[frag]
    found = d.p2.P25P2SuperFrameDetector().process(np.concatenate([soft, soft, np.zeros(800, np.float32)]))
    dec = d.ambe.AmbeDecoder()
    pcm = [dec.decode_frames(d.p2.extract_voice_frames(b)) for ts, b in found[0].bursts() if ts == 0]
    return [frames, found, pcm]


CASES = {
    "golay23": golay23,
    "hamming15": hamming15,
    "imbe_codewords": imbe_codewords,
    "imbe_params": imbe_params,
    "imbe_tables": imbe_tables,
    "imbe_voicing": imbe_voicing,
    "imbe_speech": imbe_speech,
    "imbe_silence": imbe_silence,
    "imbe_concealment": imbe_concealment,
    "imbe_unvoiced": imbe_unvoiced,
    "ambe_fec": ambe_fec,
    **{f"ambe_codec_{int(f)}": (lambda d, rng, f=f: ambe_codec(d, rng, f)) for f in (150.0, 200.0)},
    "ambe_edges": ambe_edges,
    "p2_voice_bursts": p2_voice_bursts,
    "p2_voice_fragment": p2_voice_fragment,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_vocoders_match_reference(name):
    run_case(CASES[name])


def test_voice_facade_backend():
    """Both facades report the same backend; the port's has a vocoder
    always (its own IMBE synthesizer without libmbe)."""
    assert PORT.voice.vocoder_backend() == REF.voice.vocoder_backend()
    assert PORT.voice.vocoder_available() and REF.voice.vocoder_available()
    dec = PORT.voice.VoiceDecoder()
    assert type(dec._native).__module__ == "wavecap_tpu_torch.decoders.imbe_vocoder"


def test_imbe_speech_is_audible():
    """The equal PCM is speech-like, not silence or noise."""
    pcm = run_case(imbe_speech)[1]
    body = pcm[480:]
    assert 0.05 < float(np.sqrt(np.mean(body ** 2))) < 0.6


@pytest.mark.parametrize("cls", ["VoiceDecoder", "ImbeDecoder", "AmbeDecoder"])
def test_vocoder_hand_over_mid_stream(cls):
    """The reference decodes the first frames, hands its vocoder over, the
    port decodes the rest: the PCM and the final state equal the
    reference's alone."""
    if cls == "AmbeDecoder":
        frames = list(REF.ambe.AmbeEncoder().encode(voiced(170.0)))
        frames[9] = None  # a lost frame: concealment state crosses the hand-over
        make = lambda d: d.ambe.AmbeDecoder()  # noqa: E731
        step = lambda dec, fs: [dec.decode_frame(f) for f in fs]  # noqa: E731
    elif cls == "ImbeDecoder":
        frames = [REF.voice.imbe_fec_decode(REF.voice.imbe_fec_encode(u)).u
                  for u in REF.iv.ImbeEncoder().encode(vowel(seconds=0.6))]
        make = lambda d: d.iv.ImbeDecoder()  # noqa: E731
        step = lambda dec, fs: [dec.decode_frame(u) for u in fs]  # noqa: E731
    else:
        frames = [REF.voice.imbe_fec_encode(u) for u in REF.iv.ImbeEncoder().encode(vowel(seconds=0.6))]
        make = lambda d: d.voice.VoiceDecoder()  # noqa: E731
        step = lambda dec, fs: [dec.decode_codewords(fs)]  # noqa: E731
    head, tail = frames[:13], frames[13:]
    alone = make(REF)
    want = step(alone, head) + step(alone, tail)
    ref = make(REF)
    got = step(ref, head)
    port = convert.decoder_state_from_reference(ref)
    assert type(port).__module__.startswith("wavecap_tpu_torch.decoders.")
    got += step(port, tail)
    assert canon(got) == canon(want)
    skip = {"lib", "_mbelib"}
    assert canon({k: v for k, v in vars(port).items() if k not in skip}) == \
        canon({k: v for k, v in vars(alone).items() if k not in skip})
