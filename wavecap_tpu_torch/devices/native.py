"""Native C++ ingest driver (ctypes binding to ``native/libwavecap_ingest.so``).

The per-sample producer path runs in C++ on a dedicated thread with a
lock-free SPSC ring (the reference's SDRplay shared-memory ring pattern,
reference ``devices/sdrplay_proxy.py:58-210``); Python only drains whole
blocks.  The library is built on demand with ``make`` (g++) and the driver
gates gracefully when no toolchain is available.

The port's copy of ``wavecap_tpu/devices/native.py``, with the same public names.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from .base import Device, DeviceConfig, DeviceDriver, DeviceInfo, StreamHandle
from .fake import FakeStation

logger = logging.getLogger(__name__)

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libwavecap_ingest.so"

_KINDS = {"tone": 0, "carrier": 0, "nbfm": 1, "wbfm": 1, "am": 2}


@lru_cache(maxsize=1)
def load_ingest_lib():
    """Build (if needed) and load the native library; None when unavailable."""
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (subprocess.SubprocessError, FileNotFoundError) as e:
            logger.warning("native ingest build failed: %s", e)
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        logger.warning("cannot load native ingest: %s", e)
        return None
    lib.wavecap_ring_create.restype = ctypes.c_void_p
    lib.wavecap_ring_create.argtypes = [ctypes.c_double, ctypes.c_size_t, ctypes.c_int]
    lib.wavecap_ring_add_station.argtypes = [
        ctypes.c_void_p,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_double,
        ctypes.c_int,
    ]
    lib.wavecap_ring_set_noise.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.wavecap_ring_start.argtypes = [ctypes.c_void_p]
    lib.wavecap_ring_read.restype = ctypes.c_int
    lib.wavecap_ring_read.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_size_t,
        ctypes.c_double,
    ]
    lib.wavecap_ring_overflows.restype = ctypes.c_uint64
    lib.wavecap_ring_overflows.argtypes = [ctypes.c_void_p]
    lib.wavecap_ring_available.restype = ctypes.c_size_t
    lib.wavecap_ring_available.argtypes = [ctypes.c_void_p]
    lib.wavecap_ring_stop.argtypes = [ctypes.c_void_p]
    lib.wavecap_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.wavecap_soapy_available.restype = ctypes.c_int
    return lib


def native_available() -> bool:
    return load_ingest_lib() is not None


class NativeStream(StreamHandle):
    def __init__(
        self,
        lib,
        config: DeviceConfig,
        stations,
        realtime: bool,
        ring_capacity: int | None = None,
    ):
        self.lib = lib
        self.config = config
        # 1 s of samples unless overridden (tests shrink it to exercise
        # overflow deterministically)
        capacity = ring_capacity or max(int(config.sample_rate), 1_000_000)
        self._h = lib.wavecap_ring_create(
            float(config.sample_rate), capacity, 1 if realtime else 0
        )
        for s in stations:
            lib.wavecap_ring_add_station(
                self._h,
                float(s.offset_hz),
                float(s.tone_hz),
                float(s.deviation_hz),
                float(s.amplitude),
                _KINDS.get(s.kind, 0),
            )
        lib.wavecap_ring_set_noise(self._h, 0.001)
        lib.wavecap_ring_start(self._h)
        self._closed = False

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        if self._closed:
            raise RuntimeError("stream closed")
        out = np.empty(2 * n, np.float32)
        rc = self.lib.wavecap_ring_read(
            self._h,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n,
            10.0,
        )
        if rc < 0:
            raise RuntimeError("native ring read timeout/stopped")
        iq = out.view(np.complex64)
        return iq, rc == 1

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.lib.wavecap_ring_destroy(self._h)


class NativeDevice(Device):
    def __init__(
        self,
        info: DeviceInfo,
        stations,
        realtime: bool = True,
        ring_capacity: int | None = None,
    ):
        self.info = info
        self.config = DeviceConfig()
        self.stations = stations
        self.realtime = realtime
        self.ring_capacity = ring_capacity

    def configure(self, config: DeviceConfig) -> None:
        self.config = config

    def start_stream(self) -> StreamHandle:
        lib = load_ingest_lib()
        if lib is None:
            raise RuntimeError("native ingest library unavailable")
        return NativeStream(
            lib, self.config, self.stations, self.realtime,
            ring_capacity=self.ring_capacity,
        )


class NativeDriver(DeviceDriver):
    """Synthetic stations through the C++ ring (hardware-free native path)."""

    name = "native"

    def __init__(
        self,
        stations=None,
        realtime: bool = True,
        ring_capacity: int | None = None,
    ):
        self.stations = stations or [FakeStation(offset_hz=5000.0, kind="tone")]
        self.realtime = realtime
        self.ring_capacity = ring_capacity

    def enumerate(self) -> list[DeviceInfo]:
        if not native_available():
            return []
        return [DeviceInfo(id="native0", driver="native", label="Native ingest ring")]

    def open(self, device_id: str) -> Device:
        return NativeDevice(
            self.enumerate()[0], self.stations, self.realtime,
            ring_capacity=self.ring_capacity,
        )
