"""WAV file I/O for IQ recordings and demodulated audio (stdlib only).

Mirrors the reference's SDRTrunk-style baseband handling
(reference ``backend/test_baseband_decode.py:22-51``: 2-channel WAV =
complex I/Q, int16 or float32) and PCM output packing
(reference ``capture.py:102-144``).

The port's copy of ``wavecap_tpu/utils/wavio.py``, with the same public names.
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_iq_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a 2-channel baseband WAV as complex64 IQ.  Returns (iq, rate)."""
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if channels != 2:
        raise ValueError(f"expected 2-channel IQ WAV, got {channels}")
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    data = data.reshape(-1, 2)
    return (data[:, 0] + 1j * data[:, 1]).astype(np.complex64), rate


def write_iq_wav(path: str | Path, iq: np.ndarray, rate: int) -> None:
    """Write complex64 IQ as a 2-channel int16 WAV."""
    iq = np.asarray(iq)
    data = np.empty((len(iq), 2), np.int16)
    data[:, 0] = np.clip(iq.real * 32767.0, -32768, 32767).astype(np.int16)
    data[:, 1] = np.clip(iq.imag * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def read_audio_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a mono/stereo audio WAV as float32 in [-1, 1].  Returns (audio, rate)."""
    with wave.open(str(path), "rb") as w:
        n = w.getnframes()
        rate = w.getframerate()
        channels = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, rate


def write_audio_wav(path: str | Path, audio: np.ndarray, rate: int = 48_000) -> None:
    """Write mono float32 audio as int16 WAV (reference pack_pcm16 semantics)."""
    pcm = pack_pcm16(audio)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def pack_pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 [-1,1] -> int16 PCM (reference capture.py:120-130 semantics).

    Non-finite samples are zeroed first: ``NaN.astype(int16)`` is
    platform-defined garbage and a DSP edge case must not corrupt WAV
    files or PCM streams (reference ``validation.py:37-53``)."""
    from wavecap_tpu_torch.utils.validation import sanitize_audio

    a = sanitize_audio(np.asarray(audio))
    return np.clip(a * 32767.0, -32768.0, 32767.0).astype(np.int16)


def pack_iq16(iq: np.ndarray) -> np.ndarray:
    """complex64 -> interleaved int16 I/Q (reference capture.py:102)."""
    out = np.empty(2 * len(iq), np.int16)
    out[0::2] = np.clip(np.asarray(iq).real * 32767.0, -32768, 32767).astype(np.int16)
    out[1::2] = np.clip(np.asarray(iq).imag * 32767.0, -32768, 32767).astype(np.int16)
    return out


def pack_f32(audio: np.ndarray) -> bytes:
    from wavecap_tpu_torch.utils.validation import sanitize_audio

    return np.asarray(sanitize_audio(np.asarray(audio)), np.float32).tobytes()
