"""Device failure recovery: service restarts and USB power-cycling.

Behavioral port of reference ``sdrplay_recovery.py:86`` (health monitor,
service restart with cooldown + hourly caps) and ``uhubctl.py`` (USB hub
power-cycle).  All side effects go through an injectable command runner,
so the policy state machine is fully testable without hardware, and the
real runner shells out only when the relevant binaries exist.

The port's copy of ``wavecap_tpu/devices/recovery.py``, with the same public names.
"""

from __future__ import annotations

import logging
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from typing import Callable

logger = logging.getLogger(__name__)


def _real_runner(cmd: list[str], timeout: float = 30.0) -> tuple[int, str]:
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
        return out.returncode, (out.stdout + out.stderr)[-2000:]
    except (subprocess.SubprocessError, FileNotFoundError) as e:
        return 127, str(e)


@dataclass
class RecoveryPolicy:
    cooldown_s: float = 60.0
    max_per_hour: int = 4
    service_name: str = "sdrplay"


@dataclass
class RecoveryState:
    last_attempt: float = 0.0
    attempts: list = field(default_factory=list)
    total_restarts: int = 0
    total_denied: int = 0


class ServiceRecovery:
    """Restart a system service with cooldown and hourly caps."""

    def __init__(
        self,
        policy: RecoveryPolicy | None = None,
        runner: Callable | None = None,
        clock: Callable[[], float] = time.time,
    ):
        self.policy = policy or RecoveryPolicy()
        self.runner = runner or _real_runner
        self.clock = clock
        self.state = RecoveryState()

    def can_attempt(self) -> tuple[bool, str]:
        now = self.clock()
        if now - self.state.last_attempt < self.policy.cooldown_s:
            return False, "cooldown"
        recent = [t for t in self.state.attempts if now - t < 3600]
        if len(recent) >= self.policy.max_per_hour:
            return False, "hourly cap"
        return True, ""

    def restart_service(self) -> dict:
        ok, why = self.can_attempt()
        if not ok:
            self.state.total_denied += 1
            return {"ok": False, "reason": why}
        now = self.clock()
        self.state.last_attempt = now
        self.state.attempts = [t for t in self.state.attempts if now - t < 3600]
        self.state.attempts.append(now)
        self.state.total_restarts += 1
        rc, output = self.runner(
            ["systemctl", "restart", self.policy.service_name]
        )
        if rc != 0:  # try service(8) form
            rc, output = self.runner(
                ["service", self.policy.service_name, "restart"]
            )
        return {"ok": rc == 0, "returncode": rc, "output": output}

    def status(self) -> dict:
        ok, why = self.can_attempt()
        return {
            "service": self.policy.service_name,
            "canAttempt": ok,
            "blockedReason": why or None,
            "totalRestarts": self.state.total_restarts,
            "totalDenied": self.state.total_denied,
        }


class UsbPowerCycler:
    """uhubctl-based USB port power cycling (reference ``uhubctl.py``)."""

    def __init__(self, runner: Callable | None = None):
        self.runner = runner or _real_runner

    @staticmethod
    def available() -> bool:
        return shutil.which("uhubctl") is not None

    def list_hubs(self) -> list[dict]:
        rc, output = self.runner(["uhubctl"])
        if rc != 0:
            return []
        hubs = []
        current = None
        for line in output.splitlines():
            if line.startswith("Current status for hub"):
                current = {"hub": line.split()[4].rstrip(","), "ports": []}
                hubs.append(current)
            elif current is not None and line.strip().startswith("Port"):
                parts = line.split()
                current["ports"].append(
                    {"port": parts[1].rstrip(":"), "status": " ".join(parts[3:])}
                )
        return hubs

    def power_cycle(self, hub: str, port: str, delay_s: float = 2.0) -> dict:
        rc, out = self.runner(
            ["uhubctl", "-l", hub, "-p", str(port), "-a", "cycle", "-d", str(delay_s)],
            timeout=delay_s + 20,
        )
        return {"ok": rc == 0, "output": out}
