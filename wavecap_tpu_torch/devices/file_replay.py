"""File-replay device: stream recorded IQ (WAV or raw) as a device.

Mirrors the reference CLI's offline decode paths (reference ``cli.py:123``
capture-iq / ``cli.py:620`` decode-iq reading SDRTrunk baseband WAVs) as a
first-class device driver so the whole server stack can run against
recordings.

The port's copy of ``wavecap_tpu/devices/file_replay.py``, with the same public names.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .base import Device, DeviceConfig, DeviceDriver, DeviceInfo, StreamHandle
from wavecap_tpu_torch.utils.wavio import read_iq_wav


class FileReplayStream(StreamHandle):
    def __init__(self, iq: np.ndarray, loop: bool):
        self.iq = iq
        self.loop = loop
        self._pos = 0
        self._closed = False

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        if self._closed:
            raise RuntimeError("stream closed")
        out = np.empty(n, np.complex64)
        filled = 0
        while filled < n:
            if self._pos >= len(self.iq):
                if self.loop:
                    self._pos = 0
                else:
                    out[filled:] = 0
                    break
            take = min(n - filled, len(self.iq) - self._pos)
            out[filled : filled + take] = self.iq[self._pos : self._pos + take]
            self._pos += take
            filled += take
        return out, False

    @property
    def exhausted(self) -> bool:
        return not self.loop and self._pos >= len(self.iq)

    def close(self) -> None:
        self._closed = True


class FileReplayDevice(Device):
    def __init__(self, info: DeviceInfo, path: str | Path, loop: bool = True):
        self.info = info
        self.config = DeviceConfig()
        self.path = Path(path)
        self.loop = loop
        self._iq: np.ndarray | None = None
        self._rate: int | None = None

    def _load(self) -> None:
        if self._iq is not None:
            return
        if self.path.suffix.lower() == ".wav":
            self._iq, self._rate = read_iq_wav(self.path)
        elif self.path.suffix.lower() in (".cf32", ".fc32", ".raw"):
            data = np.fromfile(self.path, np.float32)
            self._iq = (data[0::2] + 1j * data[1::2]).astype(np.complex64)
        elif self.path.suffix.lower() in (".cs16", ".sc16"):
            data = np.fromfile(self.path, np.int16).astype(np.float32) / 32768.0
            self._iq = (data[0::2] + 1j * data[1::2]).astype(np.complex64)
        else:
            raise ValueError(f"unknown IQ file format: {self.path.suffix}")

    @property
    def file_rate(self) -> int | None:
        self._load()
        return self._rate

    def configure(self, config: DeviceConfig) -> None:
        self._load()
        if self._rate is not None and config.sample_rate != self._rate:
            # WAV knows its true rate; honor the recording.
            config.sample_rate = self._rate
        self.config = config

    def start_stream(self) -> StreamHandle:
        self._load()
        assert self._iq is not None
        return FileReplayStream(self._iq, self.loop)


class FileReplayDriver(DeviceDriver):
    name = "file"

    def __init__(self, path: str | Path, loop: bool = True):
        self.path = Path(path)
        self.loop = loop

    def enumerate(self) -> list[DeviceInfo]:
        return [
            DeviceInfo(
                id="file0",
                driver="file",
                label=f"Replay {self.path.name}",
                extra={"path": str(self.path)},
            )
        ]

    def open(self, device_id: str) -> Device:
        return FileReplayDevice(self.enumerate()[0], self.path, self.loop)
