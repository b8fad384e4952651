"""Capture runtime of the port: the block program and the host engine."""

from .engine import (
    Capture,
    CaptureConfig,
    CaptureManager,
    ChannelSpec,
    ChannelHandle,
)
from .pipeline import (
    CapturePipelineConfig,
    CaptureState,
    CaptureControl,
    capture_step,
    pipeline_init,
    control_init,
)

__all__ = [n for n in dir() if not n.startswith("_")]
