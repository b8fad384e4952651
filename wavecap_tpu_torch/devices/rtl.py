"""Direct librtlsdr driver via ctypes (no pyrtlsdr dependency).

The reference drives RTL-SDRs through the ``pyrtlsdr`` package
(reference ``devices/rtl.py:14-34``); here the C API is bound directly
with ctypes so only ``librtlsdr`` itself is needed at runtime.  When the
library is absent (this build environment) the driver reports no
devices and the stack falls back to soapy/native/fake, matching the
reference's graceful degradation.

Architecture notes (accelerator-first capture loop):

  * a dedicated USB reader thread pulls fixed-size ``rtlsdr_read_sync``
    chunks into a bounded ring so the capture thread — which is busy
    uploading batches to the accelerator — never blocks on USB latency;
  * when the ring fills (consumer fell behind) the oldest chunks are
    dropped and the next ``read()`` reports ``overflow=True``, which the
    engine turns into a DSP-state reset (same contract as every other
    driver, reference ``capture.py:3058-3064``);
  * 8-bit offset-binary IQ is converted with a precomputed 256-entry
    lookup table ((x - 127.5)/127.5), one vectorized gather per chunk.

The low-level calls go through :class:`RtlLib`, a thin wrapper whose
surface is plain Python (ints in, numpy out) — tests inject a fake
implementation to exercise enumerate/configure/stream/overflow without
hardware.

The port's copy of ``wavecap_tpu/devices/rtl.py``, with the same public names.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging
import threading
from collections import deque
from functools import lru_cache

import numpy as np

from .base import Device, DeviceConfig, DeviceDriver, DeviceInfo, StreamHandle

logger = logging.getLogger(__name__)

# offset-binary u8 -> float32 in [-1, 1): (x - 127.5) / 127.5
_U8_LUT = ((np.arange(256, dtype=np.float32) - 127.5) / 127.5).astype(np.float32)


@lru_cache(maxsize=1)
def _load_librtlsdr():
    for name in ("rtlsdr", "librtlsdr.so", "librtlsdr.so.0", "librtlsdr.so.2"):
        path = ctypes.util.find_library(name) if not name.startswith("lib") else name
        if not path:
            continue
        try:
            lib = ctypes.CDLL(path)
            lib.rtlsdr_get_device_count.restype = ctypes.c_uint32
            lib.rtlsdr_get_device_name.restype = ctypes.c_char_p
            return lib
        except (OSError, AttributeError):
            continue
    return None


def rtl_available() -> bool:
    return _load_librtlsdr() is not None


class RtlLib:
    """Plain-Python surface over librtlsdr's C API.

    Every method takes/returns ordinary Python values so a fake can be
    substituted in tests; only this class touches ctypes.
    """

    def __init__(self, lib=None):
        self._lib = lib if lib is not None else _load_librtlsdr()
        if self._lib is None:  # pragma: no cover - gated by rtl_available
            raise RuntimeError("librtlsdr not available")

    # -- enumeration --------------------------------------------------------

    def device_count(self) -> int:
        return int(self._lib.rtlsdr_get_device_count())

    def device_name(self, index: int) -> str:
        name = self._lib.rtlsdr_get_device_name(ctypes.c_uint32(index))
        return (name or b"").decode(errors="replace")

    def usb_strings(self, index: int) -> tuple[str, str, str]:
        m = ctypes.create_string_buffer(256)
        p = ctypes.create_string_buffer(256)
        s = ctypes.create_string_buffer(256)
        r = self._lib.rtlsdr_get_device_usb_strings(ctypes.c_uint32(index), m, p, s)
        if r != 0:
            return "", "", ""
        return (
            m.value.decode(errors="replace"),
            p.value.decode(errors="replace"),
            s.value.decode(errors="replace"),
        )

    # -- device handle ------------------------------------------------------

    def open(self, index: int):
        dev = ctypes.c_void_p()
        r = self._lib.rtlsdr_open(ctypes.byref(dev), ctypes.c_uint32(index))
        if r != 0 or not dev:
            raise RuntimeError(f"rtlsdr_open({index}) failed: {r}")
        return dev

    def close(self, dev) -> None:
        self._lib.rtlsdr_close(dev)

    def set_center_freq(self, dev, hz: int) -> None:
        self._lib.rtlsdr_set_center_freq(dev, ctypes.c_uint32(int(hz)))

    def set_sample_rate(self, dev, hz: int) -> None:
        self._lib.rtlsdr_set_sample_rate(dev, ctypes.c_uint32(int(hz)))

    def set_freq_correction(self, dev, ppm: int) -> None:
        if int(ppm):  # librtlsdr returns -2 for ppm=0 ("already 0")
            self._lib.rtlsdr_set_freq_correction(dev, ctypes.c_int(int(ppm)))

    def set_tuner_gain_mode(self, dev, manual: bool) -> None:
        self._lib.rtlsdr_set_tuner_gain_mode(dev, ctypes.c_int(1 if manual else 0))

    def set_tuner_gain(self, dev, tenths_db: int) -> None:
        self._lib.rtlsdr_set_tuner_gain(dev, ctypes.c_int(int(tenths_db)))

    def set_agc_mode(self, dev, on: bool) -> None:
        self._lib.rtlsdr_set_agc_mode(dev, ctypes.c_int(1 if on else 0))

    def set_tuner_bandwidth(self, dev, hz: int) -> None:
        # 0 = automatic; absent on very old librtlsdr builds
        fn = getattr(self._lib, "rtlsdr_set_tuner_bandwidth", None)
        if fn is not None:
            fn(dev, ctypes.c_uint32(int(hz)))

    def tuner_gains(self, dev) -> list[int]:
        n = self._lib.rtlsdr_get_tuner_gains(dev, None)
        if n <= 0:
            return []
        buf = (ctypes.c_int * n)()
        self._lib.rtlsdr_get_tuner_gains(dev, buf)
        return list(buf)

    def reset_buffer(self, dev) -> None:
        self._lib.rtlsdr_reset_buffer(dev)

    def read_chunk(self, dev, n_bytes: int) -> np.ndarray:
        """Blocking sync read; returns interleaved u8 IQ (may be short)."""
        buf = np.empty(n_bytes, np.uint8)
        n_read = ctypes.c_int(0)
        r = self._lib.rtlsdr_read_sync(
            dev,
            buf.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(n_bytes),
            ctypes.byref(n_read),
        )
        if r != 0:
            raise RuntimeError(f"rtlsdr_read_sync failed: {r}")
        return buf[: n_read.value]


class RtlStream(StreamHandle):
    """Bounded-ring stream fed by a USB reader thread."""

    # 16384 samples (32 KiB) per USB transfer: librtlsdr requires multiples
    # of 512 bytes; ~6.8 ms at 2.4 Msps keeps retune/stop latency low
    CHUNK_BYTES = 32_768
    RING_CHUNKS = 64  # ~0.44 s of buffer at 2.4 Msps

    def __init__(self, lib: RtlLib, dev):
        self.lib = lib
        self.dev = dev
        self._ring: deque[np.ndarray] = deque()
        self._cv = threading.Condition()
        self._overflow = False
        self._closed = False
        self._error: str | None = None
        self._leftover = np.empty(0, np.complex64)
        lib.reset_buffer(dev)
        self._thread = threading.Thread(
            target=self._reader, name="RtlReader", daemon=True
        )
        self._thread.start()

    def _reader(self) -> None:
        while not self._closed:
            try:
                chunk = self.lib.read_chunk(self.dev, self.CHUNK_BYTES)
            except RuntimeError as e:
                with self._cv:
                    if not self._closed:
                        self._error = str(e)
                    self._cv.notify_all()
                return
            with self._cv:
                self._ring.append(chunk)
                if len(self._ring) > self.RING_CHUNKS:
                    # consumer fell behind: drop oldest, flag overflow so
                    # the engine resets carried DSP state
                    while len(self._ring) > self.RING_CHUNKS // 2:
                        self._ring.popleft()
                    self._overflow = True
                self._cv.notify_all()

    def read(self, n: int) -> tuple[np.ndarray, bool]:
        out = np.empty(n, np.complex64)
        got = min(n, len(self._leftover))
        out[:got] = self._leftover[:got]
        self._leftover = self._leftover[got:]
        while got < n:
            with self._cv:
                while not self._ring and not self._closed and not self._error:
                    self._cv.wait(0.2)
                if self._error:
                    raise RuntimeError(self._error)
                if self._closed and not self._ring:
                    return out[:got], True
                raw = self._ring.popleft()
                overflow, self._overflow = self._overflow, False
            if overflow:
                self._leftover = np.empty(0, np.complex64)
                return out[:got], True
            f = _U8_LUT[raw]
            iq = (f[0::2] + 1j * f[1::2]).astype(np.complex64)
            take = min(n - got, len(iq))
            out[got : got + take] = iq[:take]
            self._leftover = iq[take:]
            got += take
        return out, False

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        # rtlsdr_read_sync unblocks once the next USB transfer completes
        self._thread.join(timeout=3.0)


class RtlDevice(Device):
    def __init__(self, lib: RtlLib, index: int, info: DeviceInfo):
        self.lib = lib
        self.index = index
        self.info = info
        self.config = DeviceConfig()
        self._dev = None
        self._stream: RtlStream | None = None

    def _ensure_open(self):
        if self._dev is None:
            self._dev = self.lib.open(self.index)
        return self._dev

    def configure(self, config: DeviceConfig) -> None:
        dev = self._ensure_open()
        self.config = config
        self.lib.set_sample_rate(dev, int(config.sample_rate))
        self.lib.set_center_freq(dev, int(config.center_hz))
        self.lib.set_freq_correction(dev, int(config.ppm))
        self.lib.set_tuner_bandwidth(dev, int(config.bandwidth_hz or 0))
        if config.agc or config.gain_db is None:
            # tuner AGC + digital AGC (reference rtl.py:66-69 semantics)
            self.lib.set_tuner_gain_mode(dev, manual=False)
            self.lib.set_agc_mode(dev, True)
        else:
            self.lib.set_tuner_gain_mode(dev, manual=True)
            gains = self.lib.tuner_gains(dev)
            want = int(round(config.gain_db * 10))
            if gains:  # snap to the nearest supported step
                want = min(gains, key=lambda g: abs(g - want))
            self.lib.set_tuner_gain(dev, want)
            self.lib.set_agc_mode(dev, False)

    def start_stream(self) -> StreamHandle:
        dev = self._ensure_open()
        self._stream = RtlStream(self.lib, dev)
        return self._stream

    def close(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        if self._dev is not None:
            self.lib.close(self._dev)
            self._dev = None


class RtlDriver(DeviceDriver):
    """Enumerate + open RTL-SDRs through librtlsdr directly."""

    def __init__(self, lib: RtlLib | None = None):
        self._lib = lib

    @property
    def lib(self) -> RtlLib | None:
        if self._lib is None and rtl_available():
            self._lib = RtlLib()
        return self._lib

    def enumerate(self) -> list[DeviceInfo]:
        lib = self.lib
        if lib is None:
            return []
        out = []
        for i in range(lib.device_count()):
            manufact, product, serial = lib.usb_strings(i)
            label = " ".join(x for x in (manufact, product) if x) or lib.device_name(i)
            out.append(
                DeviceInfo(id=f"rtl{i}", driver="rtl", label=label, serial=serial)
            )
        return out

    def open(self, device_id: str) -> Device:
        lib = self.lib
        if lib is None:
            raise RuntimeError("librtlsdr not available")
        index = int(device_id.removeprefix("rtl")) if device_id else 0
        infos = self.enumerate()
        info = next(
            (d for d in infos if d.id == device_id),
            DeviceInfo(id=device_id or "rtl0", driver="rtl"),
        )
        return RtlDevice(lib, index, info)
