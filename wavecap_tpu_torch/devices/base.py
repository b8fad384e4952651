"""Device abstraction: drivers, devices, and block IQ streams.

Same contract shape as the reference (reference ``devices/base.py:29-90``):
``DeviceDriver.enumerate()/open()``, ``Device.configure()/start_stream()``,
``StreamHandle.read(n) -> (complex64 samples, overflow)``.  The overflow
flag propagates downstream and resets carried DSP state (reference
``capture.py:3058-3064`` contract).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
import numpy as np


@dataclass
class DeviceInfo:
    id: str
    driver: str
    label: str = ""
    serial: str = ""
    extra: dict = field(default_factory=dict)


@dataclass
class DeviceConfig:
    center_hz: float = 100_000_000.0
    sample_rate: int = 2_400_000
    gain_db: float | None = None
    bandwidth_hz: float | None = None
    ppm: float = 0.0
    antenna: str | None = None
    agc: bool = False


class StreamHandle(abc.ABC):
    """A running IQ stream."""

    @abc.abstractmethod
    def read(self, n: int) -> tuple[np.ndarray, bool]:
        """Read exactly ``n`` complex64 samples.  Returns (samples, overflow)."""

    @abc.abstractmethod
    def close(self) -> None: ...


class Device(abc.ABC):
    info: DeviceInfo
    config: DeviceConfig

    @abc.abstractmethod
    def configure(self, config: DeviceConfig) -> None: ...

    @abc.abstractmethod
    def start_stream(self) -> StreamHandle: ...

    def close(self) -> None:
        pass


class DeviceDriver(abc.ABC):
    name: str = "base"

    @abc.abstractmethod
    def enumerate(self) -> list[DeviceInfo]: ...

    @abc.abstractmethod
    def open(self, device_id: str) -> Device: ...
