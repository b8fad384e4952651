"""SoapySDR device driver via ctypes (hardware gate).

The reference binds SoapySDR through its Python package (reference
``devices/soapy.py``); here we bind the C API directly with ctypes so no
Python package is required — only ``libSoapySDR`` at runtime.  When the
library is absent (this build environment), the driver reports no
devices and the stack falls back to fake/native/file drivers, matching
the reference's graceful degradation.

The port's copy of ``wavecap_tpu/devices/soapy.py``, with the same public names.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
from functools import lru_cache

import numpy as np

from .base import Device, DeviceConfig, DeviceDriver, DeviceInfo, StreamHandle

logger = logging.getLogger(__name__)

SOAPY_SDR_RX = 1
SOAPY_SDR_CF32 = b"CF32"


@lru_cache(maxsize=1)
def load_soapy():
    for name in ("SoapySDR", "libSoapySDR.so", "libSoapySDR.so.0.8"):
        path = ctypes.util.find_library(name) if not name.startswith("lib") else name
        if not path:
            continue
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            continue
        try:
            lib.SoapySDRDevice_enumerate.restype = ctypes.c_void_p
            return lib
        except AttributeError:
            continue
    return None


def soapy_available() -> bool:
    return load_soapy() is not None


class SoapyStream(StreamHandle):  # pragma: no cover - requires hardware
    def __init__(self, lib, dev, stream, mtu: int):
        self.lib = lib
        self.dev = dev
        self.stream = stream
        self.mtu = mtu
        self._closed = False

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        out = np.empty(n, np.complex64)
        got = 0
        overflow = False
        flags = ctypes.c_int(0)
        time_ns = ctypes.c_longlong(0)
        while got < n:
            want = min(self.mtu, n - got)
            buf = out[got : got + want]
            buf_ptr = buf.ctypes.data_as(ctypes.c_void_p)
            buffs = (ctypes.c_void_p * 1)(buf_ptr)
            ret = self.lib.SoapySDRDevice_readStream(
                self.dev,
                self.stream,
                buffs,
                want,
                ctypes.byref(flags),
                ctypes.byref(time_ns),
                ctypes.c_long(1_000_000),
            )
            if ret == -4:  # SOAPY_SDR_OVERFLOW
                overflow = True
                continue
            if ret < 0:
                raise RuntimeError(f"SoapySDR readStream error {ret}")
            got += ret
        return out, overflow

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self.lib.SoapySDRDevice_deactivateStream(self.dev, self.stream, 0, 0)
            self.lib.SoapySDRDevice_closeStream(self.dev, self.stream)


class SoapyDevice(Device):  # pragma: no cover - requires hardware
    def __init__(self, lib, info: DeviceInfo, args_str: str):
        self.lib = lib
        self.info = info
        self.config = DeviceConfig()
        self._args = args_str.encode()
        self._dev = None

    def _open(self):
        if self._dev is None:
            self.lib.SoapySDRDevice_makeStrArgs.restype = ctypes.c_void_p
            self._dev = self.lib.SoapySDRDevice_makeStrArgs(self._args)
            if not self._dev:
                raise RuntimeError("SoapySDRDevice_make failed")
        return self._dev

    def configure(self, config: DeviceConfig) -> None:
        dev = self._open()
        self.config = config
        self.lib.SoapySDRDevice_setSampleRate(
            dev, SOAPY_SDR_RX, 0, ctypes.c_double(config.sample_rate)
        )
        self.lib.SoapySDRDevice_setFrequency(
            dev, SOAPY_SDR_RX, 0, ctypes.c_double(config.center_hz), None
        )
        if config.gain_db is not None:
            self.lib.SoapySDRDevice_setGain(
                dev, SOAPY_SDR_RX, 0, ctypes.c_double(config.gain_db)
            )
        if config.agc:
            self.lib.SoapySDRDevice_setGainMode(dev, SOAPY_SDR_RX, 0, True)
        if config.bandwidth_hz:
            self.lib.SoapySDRDevice_setBandwidth(
                dev, SOAPY_SDR_RX, 0, ctypes.c_double(config.bandwidth_hz)
            )
        if config.ppm:
            self.lib.SoapySDRDevice_setFrequencyCorrection(
                dev, SOAPY_SDR_RX, 0, ctypes.c_double(config.ppm)
            )
        if config.antenna:
            self.lib.SoapySDRDevice_setAntenna(
                dev, SOAPY_SDR_RX, 0, config.antenna.encode()
            )

    def start_stream(self) -> StreamHandle:
        dev = self._open()
        self.lib.SoapySDRDevice_setupStream.restype = ctypes.c_void_p
        channels = (ctypes.c_size_t * 1)(0)
        stream = self.lib.SoapySDRDevice_setupStream(
            dev, SOAPY_SDR_RX, SOAPY_SDR_CF32, channels, 1, None
        )
        if not stream:
            raise RuntimeError("setupStream failed")
        self.lib.SoapySDRDevice_activateStream(dev, stream, 0, 0, 0)
        mtu = self.lib.SoapySDRDevice_getStreamMTU(dev, stream) or 8192
        return SoapyStream(self.lib, dev, stream, int(mtu))

    def close(self) -> None:
        if self._dev is not None:
            self.lib.SoapySDRDevice_unmake(self._dev)
            self._dev = None


class SoapyDriver(DeviceDriver):
    name = "soapy"

    def __init__(self, device_args: dict | None = None):
        self.device_args = device_args or {}

    def enumerate(self) -> list[DeviceInfo]:
        lib = load_soapy()
        if lib is None:
            return []
        length = ctypes.c_size_t(0)
        lib.SoapySDRDevice_enumerate.restype = ctypes.c_void_p
        results = lib.SoapySDRDevice_enumerate(None, ctypes.byref(length))
        infos = []
        for i in range(length.value):  # pragma: no cover - requires hardware
            infos.append(
                DeviceInfo(id=f"soapy{i}", driver="soapy", label=f"SoapySDR #{i}")
            )
        if results:
            lib.SoapySDRKwargsList_clear(results, length)
        return infos

    def open(self, device_id: str) -> Device:  # pragma: no cover - hardware
        lib = load_soapy()
        if lib is None:
            raise RuntimeError("SoapySDR not available")
        idx = int(device_id.replace("soapy", "") or 0)
        args = ",".join(f"{k}={v}" for k, v in self.device_args.items())
        return SoapyDevice(
            lib,
            DeviceInfo(id=device_id, driver="soapy", label=f"SoapySDR #{idx}"),
            args,
        )
