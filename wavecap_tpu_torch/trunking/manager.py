"""In-process trunking manager (reference ``trunking/manager.py:49``).

The port's copy of ``wavecap_tpu/trunking/manager.py``, with the same public names.
Its systems run on the torch device of the ``CaptureManager`` it is given
(``device``: the CUDA card unless that manager was made with ``"cpu"``).
"""

from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Any, Callable

from wavecap_tpu_torch.capture import CaptureManager
from .config import TrunkingSystemConfig
from .system import TrunkingSystem

logger = logging.getLogger(__name__)


class TrunkingManager:
    def __init__(
        self,
        capture_manager: CaptureManager,
        state_dir: str | Path | None = None,
    ):
        self.capture_manager = capture_manager
        # the port's device: the one the capture manager runs its captures on
        self.device = capture_manager.device
        self.state_dir = state_dir
        self.systems: dict[str, TrunkingSystem] = {}
        self._lock = threading.RLock()
        self.on_event: Callable[[str, dict], None] | None = None

    def create_system(self, config: TrunkingSystemConfig) -> TrunkingSystem:
        with self._lock:
            if config.id in self.systems:
                raise ValueError(f"trunking system {config.id!r} exists")
            sys_ = TrunkingSystem(config, self.capture_manager, self.state_dir)
            sys_.on_event = self._forward_event
            self.systems[config.id] = sys_
            return sys_

    def _forward_event(self, event_type: str, evt: dict) -> None:
        if self.on_event:
            self.on_event(event_type, evt)

    def get(self, system_id: str) -> TrunkingSystem:
        return self.systems[system_id]

    def remove_system(self, system_id: str) -> None:
        with self._lock:
            sys_ = self.systems.pop(system_id, None)
        if sys_:
            sys_.stop()

    def start(self, system_id: str | None = None) -> None:
        for sid, sys_ in self.systems.items():
            if system_id in (None, sid):
                sys_.start()

    def stop_all(self) -> None:
        for sys_ in list(self.systems.values()):
            sys_.stop()

    def status(self) -> list[dict]:
        return [s.status() for s in self.systems.values()]
