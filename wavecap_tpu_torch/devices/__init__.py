"""IQ sources: the fake synthesizer (numpy copies of the JAX package's)."""

from .base import (
    Device,
    DeviceConfig,
    DeviceDriver,
    DeviceInfo,
    StreamHandle,
)
from .fake import FakeDevice, FakeDriver, FakeStation, FakeStream

__all__ = [n for n in dir() if not n.startswith("_")]
