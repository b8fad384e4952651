"""P25 trunking control plane.

The port's copy of ``wavecap_tpu/trunking/__init__.py``, with the same public names.
"""

from .config import (
    HuntMode,
    TalkgroupConfig,
    TrunkingProtocol,
    TrunkingSystemConfig,
    load_talkgroups_csv,
)
from .control import ControlChannelMonitor, ControlChannelStats
from .recorder import CallInfo, RecorderPool, VoiceRecorder
from .system import TrunkingSystem, SystemIdentity
from .manager import TrunkingManager

__all__ = [n for n in dir() if not n.startswith("_")]
