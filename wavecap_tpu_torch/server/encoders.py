"""Compressed audio encoders (MP3/Opus/AAC) via ffmpeg subprocess pipes.

Reference parity: ``encoders/__init__.py:28`` (``AudioEncoder`` ABC, lazy
start/stop with subscriber refcount).  ffmpeg is an optional external
binary — when absent, ``available_formats()`` reports only raw PCM/f32
and the WS layer serves those.

The port's copy of ``wavecap_tpu/server/encoders.py``, with the same public names.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import threading
from abc import ABC, abstractmethod
from functools import lru_cache

import numpy as np

logger = logging.getLogger(__name__)


@lru_cache(maxsize=1)
def ffmpeg_path() -> str | None:
    return shutil.which("ffmpeg")


def available_formats() -> list[str]:
    base = ["pcm16", "f32"]
    if ffmpeg_path():
        base += ["mp3", "opus", "aac"]
    return base


_FFMPEG_ARGS = {
    "mp3": ["-f", "mp3", "-b:a", "128k"],
    "opus": ["-f", "opus", "-b:a", "64k"],
    "aac": ["-f", "adts", "-b:a", "96k"],
}


class AudioEncoder(ABC):
    @abstractmethod
    def encode(self, pcm: np.ndarray) -> bytes: ...

    @abstractmethod
    def close(self) -> None: ...


class PassthroughEncoder(AudioEncoder):
    def __init__(self, fmt: str = "pcm16"):
        self.fmt = fmt

    def encode(self, pcm: np.ndarray) -> bytes:
        if self.fmt == "f32":
            return np.asarray(pcm, np.float32).tobytes()
        return (
            np.clip(np.asarray(pcm) * 32767.0, -32768, 32767)
            .astype(np.int16)
            .tobytes()
        )

    def close(self) -> None:
        pass


class FfmpegEncoder(AudioEncoder):
    """Pipe PCM through an ffmpeg subprocess (lazy-started)."""

    def __init__(self, fmt: str, sample_rate: int = 48_000):
        if fmt not in _FFMPEG_ARGS:
            raise ValueError(f"unknown format {fmt}")
        path = ffmpeg_path()
        if path is None:
            raise RuntimeError("ffmpeg not available")
        self.proc = subprocess.Popen(
            [
                path,
                "-hide_banner",
                "-loglevel",
                "error",
                "-f",
                "s16le",
                "-ar",
                str(sample_rate),
                "-ac",
                "1",
                "-i",
                "pipe:0",
                *_FFMPEG_ARGS[fmt],
                "pipe:1",
            ],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
        )
        self._out = b""
        self._lock = threading.Lock()
        self._reader = threading.Thread(target=self._drain, daemon=True)
        self._reader.start()

    def _drain(self) -> None:
        assert self.proc.stdout is not None
        while True:
            chunk = self.proc.stdout.read(4096)
            if not chunk:
                return
            with self._lock:
                self._out += chunk

    def encode(self, pcm: np.ndarray) -> bytes:
        assert self.proc.stdin is not None
        data = (
            np.clip(np.asarray(pcm) * 32767.0, -32768, 32767).astype(np.int16).tobytes()
        )
        try:
            self.proc.stdin.write(data)
            self.proc.stdin.flush()
        except BrokenPipeError:
            return b""
        with self._lock:
            out, self._out = self._out, b""
        return out

    def close(self) -> None:
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
            self.proc.terminate()
        except OSError:
            pass


def make_encoder(fmt: str, sample_rate: int = 48_000) -> AudioEncoder:
    if fmt in ("pcm16", "f32"):
        return PassthroughEncoder(fmt)
    return FfmpegEncoder(fmt, sample_rate)
