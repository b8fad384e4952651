"""IQ sources: fake synthesizer, file replay, hardware gates (numpy copies
of the JAX package's ``devices``)."""

from .base import (
    Device,
    DeviceConfig,
    DeviceDriver,
    DeviceInfo,
    StreamHandle,
)
from .fake import FakeDevice, FakeDriver, FakeStation, FakeStream
from .file_replay import FileReplayDriver, FileReplayDevice

__all__ = [n for n in dir() if not n.startswith("_")]
