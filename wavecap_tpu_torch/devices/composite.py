"""Composite device driver: real hardware first, fake only when asked.

Reference ``devices/composite.py``: wrap the available hardware drivers
(librtlsdr direct, SoapySDR, native shm ingest) and hide the fake/test
devices whenever real hardware enumerates, unless ``show_fake_device``
explicitly keeps them visible.  ``driver: auto`` in the config selects
this driver.

The port's copy of ``wavecap_tpu/devices/composite.py``, with the same public names.
"""

from __future__ import annotations

import logging

from .base import Device, DeviceDriver, DeviceInfo
from .fake import FakeDriver

logger = logging.getLogger(__name__)


class CompositeDriver(DeviceDriver):
    name = "composite"

    def __init__(
        self,
        drivers: list[DeviceDriver] | None = None,
        show_fake_device: bool = False,
        fake: DeviceDriver | None = None,
    ):
        self.drivers = drivers if drivers is not None else _hardware_drivers()
        self.fake = fake if fake is not None else FakeDriver()
        self.show_fake_device = show_fake_device

    def enumerate(self) -> list[DeviceInfo]:
        real: list[DeviceInfo] = []
        for drv in self.drivers:
            try:
                real.extend(drv.enumerate())
            except Exception as e:  # a broken driver must not hide the rest
                logger.warning("%s enumerate failed: %s", drv.name, e)
        if real and not self.show_fake_device:
            return real
        return real + self.fake.enumerate()

    def open(self, device_id: str) -> Device:
        for drv in [*self.drivers, self.fake]:
            try:
                ids = {d.id for d in drv.enumerate()}
            except Exception:
                continue
            if device_id in ids:
                return drv.open(device_id)
        raise KeyError(f"unknown device {device_id!r}")


def _hardware_drivers() -> list[DeviceDriver]:
    """Every hardware driver whose native library is actually loadable."""
    out: list[DeviceDriver] = []
    try:
        from .rtl import RtlDriver, rtl_available

        if rtl_available():
            out.append(RtlDriver())
    except Exception:  # pragma: no cover - import guard
        pass
    try:
        from .soapy import SoapyDriver, soapy_available

        if soapy_available():
            out.append(SoapyDriver())
    except Exception:  # pragma: no cover
        pass
    # the native shm-ring driver is an explicit transport (driver: native),
    # not discoverable hardware — it must not hide the fakes in auto mode
    return out
