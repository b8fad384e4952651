"""Fake device driver: synthesizes IQ for hardware-free integration tests.

Reference semantics: ``devices/fake.py:76`` (complex exponential at +5 kHz
plus noise).  Extended with multi-station synthesis so channel-bank and
trunking tests can run against realistic wideband scenes, and with
deterministic timing (no wall-clock pacing unless ``realtime=True``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .base import Device, DeviceConfig, DeviceDriver, DeviceInfo, StreamHandle


@dataclass
class FakeStation:
    offset_hz: float  # from capture center
    kind: str = "tone"  # tone | nbfm | wbfm | am | carrier | iq_loop
    tone_hz: float = 1000.0
    deviation_hz: float = 4000.0
    amplitude: float = 0.5
    iq_loop: np.ndarray | None = None  # for kind="iq_loop": looped baseband


class FakeStream(StreamHandle):
    def __init__(
        self,
        config: DeviceConfig,
        stations: list[FakeStation],
        noise: float = 0.001,
        realtime: bool = False,
        seed: int = 42,
        device: "FakeDevice | None" = None,
    ):
        self.config = config
        self.stations = stations
        self.noise = noise
        self.realtime = realtime
        # Stations are defined by offset from the center at stream start;
        # anchor them to absolute RF so a live retune (configure() while
        # streaming, like a real SDR front end) shifts them in the passband.
        self._center0 = float(config.center_hz)
        self._device = device
        self._pos = 0
        self._rng = np.random.default_rng(seed)
        self._closed = False
        # Pre-generated complex noise pool served by random offset: a real
        # SDR read is a USB-buffer memcpy, so per-read gaussian synthesis
        # (~40 ms/block at 2.4 Msps) would charge the capture loop for cost
        # real hardware doesn't have.
        self._noise_pool: np.ndarray | None = None

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        if self._closed:
            raise RuntimeError("stream closed")
        if self._device is not None:
            self.config = self._device.config
        fs = float(self.config.sample_rate)
        center_shift = float(self.config.center_hz) - self._center0
        if not self.stations and self.noise > 0:
            # noise-only stream (throughput benchmarks): serve slices of a
            # pre-generated pool instead of synthesizing per read
            out = self._noise_slice(n) * np.float32(self.noise)
            self._pos += n
            if self.realtime:
                time.sleep(n / fs)
            return out, False
        t = (self._pos + np.arange(n, dtype=np.float64)) / fs
        x = np.zeros(n, np.complex128)
        for s in self.stations:
            off = s.offset_hz - center_shift
            if s.kind == "tone" or s.kind == "carrier":
                x += s.amplitude * np.exp(2j * np.pi * off * t)
            elif s.kind in ("nbfm", "wbfm"):
                audio = np.sin(2 * np.pi * s.tone_hz * t)
                # integrate audio for FM phase; continuous via absolute time
                phase = 2 * np.pi * (
                    off * t
                    - s.deviation_hz * np.cos(2 * np.pi * s.tone_hz * t)
                    / (2 * np.pi * s.tone_hz)
                )
                x += s.amplitude * np.exp(1j * phase)
            elif s.kind == "am":
                mod = 1.0 + 0.6 * np.sin(2 * np.pi * s.tone_hz * t)
                x += s.amplitude * mod * np.exp(2j * np.pi * off * t)
            elif s.kind == "iq_loop" and s.iq_loop is not None:
                idx = (self._pos + np.arange(n)) % len(s.iq_loop)
                base = s.iq_loop[idx]
                if off:
                    base = base * np.exp(2j * np.pi * off * t)
                x += s.amplitude * base
        if self.noise > 0:
            x += self.noise * self._noise_slice(n)
        self._pos += n
        if self.realtime:
            time.sleep(n / fs)
        return x.astype(np.complex64), False

    def _noise_slice(self, n: int) -> np.ndarray:
        pool = self._noise_pool
        if pool is None or len(pool) < 2 * n:
            m = max(1 << 21, 2 * n)
            pool = (
                self._rng.standard_normal(m) + 1j * self._rng.standard_normal(m)
            ).astype(np.complex64)
            self._noise_pool = pool
        off = int(self._rng.integers(0, len(pool) - n + 1))
        return pool[off : off + n]

    def close(self) -> None:
        self._closed = True


class FakeDevice(Device):
    def __init__(self, info: DeviceInfo, stations: list[FakeStation] | None = None):
        self.info = info
        self.config = DeviceConfig()
        # Default: reference FakeDriver behavior — one tone at +5 kHz.
        self.stations = stations if stations is not None else [
            FakeStation(offset_hz=5000.0, kind="tone", amplitude=0.5)
        ]
        self.realtime = False

    def configure(self, config: DeviceConfig) -> None:
        self.config = config

    def start_stream(self) -> StreamHandle:
        return FakeStream(
            self.config, self.stations, realtime=self.realtime, device=self
        )


class FakeDriver(DeviceDriver):
    name = "fake"

    def __init__(self, n_devices: int = 2, stations: list[FakeStation] | None = None):
        self.n_devices = n_devices
        self.stations = stations

    def enumerate(self) -> list[DeviceInfo]:
        return [
            DeviceInfo(id=f"fake{i}", driver="fake", label=f"Fake SDR {i}")
            for i in range(self.n_devices)
        ]

    def open(self, device_id: str) -> Device:
        infos = {d.id: d for d in self.enumerate()}
        if device_id not in infos:
            raise KeyError(f"no such device {device_id!r}")
        return FakeDevice(infos[device_id], self.stations)
