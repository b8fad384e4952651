"""Process-per-device trunking manager (reference ``trunking/process_manager.py:262``).

Groups trunking systems by device, spawns one worker process per group
(``multiprocessing``), RPCs over a command pipe with timeouts, pumps the
event pipe into callbacks, and restarts dead workers (liveness loop,
reference ``_WorkerHandle`` :252 and the liveness tests at
``tests/unit/test_trunking_worker_liveness.py``).

Process creation is injectable (``process_factory``) so liveness and
grouping logic is testable with fake process handles — the reference's
"multi-node without a cluster" strategy (SURVEY §4).

In the port the manager carries the workers' torch device (``device``:
the CUDA card unless ``"cpu"`` is asked for) into each worker's config.

The port's copy of ``wavecap_tpu/trunking/process_manager.py``, with the same public names.
"""

from __future__ import annotations

import itertools
import logging
import multiprocessing as mp
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..utils.torchenv import DeviceLike, resolve_device

logger = logging.getLogger(__name__)


@dataclass
class WorkerHandle:
    key: str  # device group key
    process: Any
    cmd_conn: Any
    evt_conn: Any
    worker_cfg: dict
    last_seen: float = field(default_factory=time.time)
    restarts: int = 0
    _rpc_ids: Any = field(default_factory=lambda: itertools.count(1))
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def alive(self) -> bool:
        return self.process is not None and self.process.is_alive()

    def rpc(self, cmd: str, timeout: float = 5.0, **kwargs) -> Any:
        rid = next(self._rpc_ids)
        with self._lock:
            self.cmd_conn.send({"id": rid, "cmd": cmd, **kwargs})
            deadline = time.time() + timeout
            while time.time() < deadline:
                if self.cmd_conn.poll(0.1):
                    msg = self.cmd_conn.recv()
                    if msg.get("id") == rid:
                        if "error" in msg:
                            raise RuntimeError(msg["error"])
                        return msg.get("result")
        raise TimeoutError(f"worker {self.key} rpc {cmd!r} timed out")


def _default_process_factory(target, args) -> Any:
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=target, args=args, daemon=True)
    p.start()
    return p


# -- orphan reaping (reference app.py:44 boot-time worker cleanup) ----------
#
# A SIGKILLed service leaves its (daemonic, but reparented) worker
# processes running and holding SDR devices open.  The manager records
# every spawned worker's (pid, /proc starttime) in ``workers.json``; the
# next boot kills EXACTLY those pids, and only if the starttime still
# matches (so a recycled pid of an unrelated process is never touched).


def proc_starttime(pid: int) -> int | None:
    """Kernel start time of ``pid`` (clock ticks since boot), or None."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            data = f.read()
        # comm can contain spaces/parens; fields resume after the last ')'
        return int(data.rsplit(b") ", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return None


def reap_orphan_workers(state_dir: str | None) -> list[int]:
    """Kill workers recorded by a previous (crashed) run.  Returns pids
    actually signalled."""
    import json
    import os
    import signal
    from pathlib import Path

    if not state_dir:
        return []
    path = Path(state_dir) / "workers.json"
    if not path.exists():
        return []
    try:
        entries = json.loads(path.read_text())
    except (OSError, ValueError):
        entries = []
    killed = []
    for ent in entries:
        pid, start = ent.get("pid"), ent.get("start")
        if not pid or pid == os.getpid():
            continue
        if start is None or proc_starttime(pid) != start:
            continue  # exited, or the pid was recycled: leave it alone
        try:
            os.kill(pid, signal.SIGTERM)
            killed.append(pid)
        except OSError:
            continue
    deadline = time.time() + 3.0
    for pid in killed:
        while proc_starttime(pid) is not None and time.time() < deadline:
            time.sleep(0.05)
        if proc_starttime(pid) is not None:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
    if killed:
        logger.warning("reaped %d orphan trunking worker(s): %s", len(killed), killed)
    try:
        path.unlink()
    except OSError:
        pass
    return killed


class TrunkingProcessManager:
    """Spawn + supervise one trunking worker per device group."""

    LIVENESS_INTERVAL = 2.0
    MAX_RESTARTS = 5

    def __init__(
        self,
        state_dir=None,
        driver: str = "fake",
        process_factory: Callable | None = None,
        pipe_factory: Callable | None = None,
        stations: list[dict] | None = None,
        device: DeviceLike = None,
    ):
        self.state_dir = str(state_dir) if state_dir else None
        self.driver = driver
        # the workers' torch device: the CUDA card unless "cpu" is asked
        # for (raises here with no card); passed to each worker by name
        self.device = resolve_device(device)
        # synthetic-station scene for fake/native worker drivers
        # (tests/harness; real drivers ignore it)
        self.stations = stations
        self.process_factory = process_factory or _default_process_factory
        self.pipe_factory = pipe_factory or (lambda: mp.get_context("spawn").Pipe())
        self.workers: dict[str, WorkerHandle] = {}
        self.system_configs: list[dict] = []
        self.on_event: Callable[[str, dict], None] | None = None
        # streaming taps forwarded from workers (reference
        # process_manager.py:262+: FFT 30 FPS + 20 ms audio chunks)
        self.on_spectrum: Callable[[str, dict], None] | None = None
        self.on_voice: Callable[[str, int, bytes], None] | None = None
        self.latest_spectrum: dict[str, dict] = {}  # system id -> frame
        self.latest_status: dict[str, list] = {}
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._lock = threading.RLock()
        # boot-time cleanup: workers a crashed previous run left behind
        reap_orphan_workers(self.state_dir)

    # -- grouping ----------------------------------------------------------

    @staticmethod
    def group_key(sys_cfg: dict) -> str:
        return str(sys_cfg.get("device_id") or sys_cfg.get("deviceId") or "default")

    def group_systems(self) -> dict[str, list[dict]]:
        groups: dict[str, list[dict]] = {}
        for cfg in self.system_configs:
            groups.setdefault(self.group_key(cfg), []).append(cfg)
        return groups

    # -- lifecycle ---------------------------------------------------------

    def add_system(self, sys_cfg: dict) -> None:
        self.system_configs.append(sys_cfg)

    def start(self) -> None:
        self._stop.clear()
        for key, systems in self.group_systems().items():
            if key not in self.workers:
                self._spawn(key, systems)
        t = threading.Thread(target=self._liveness_loop, daemon=True)
        t.start()
        self._threads.append(t)

    def _spawn(self, key: str, systems: list[dict]) -> WorkerHandle:
        from .process_worker import run_trunking_worker

        cmd_parent, cmd_child = self.pipe_factory()
        evt_parent, evt_child = self.pipe_factory()
        worker_cfg = {
            "driver": self.driver,
            "state_dir": self.state_dir,
            "systems": systems,
            "auto_start": True,
            "device": str(self.device),
        }
        if self.stations:
            worker_cfg["stations"] = self.stations
        proc = self.process_factory(
            run_trunking_worker, (cmd_child, evt_child, worker_cfg)
        )
        handle = WorkerHandle(
            key=key,
            process=proc,
            cmd_conn=cmd_parent,
            evt_conn=evt_parent,
            worker_cfg=worker_cfg,
        )
        with self._lock:
            self.workers[key] = handle
            self._record_workers()
        pump = threading.Thread(
            target=self._event_pump, args=(handle,), daemon=True
        )
        pump.start()
        self._threads.append(pump)
        return handle

    def _event_pump(self, handle: WorkerHandle) -> None:
        while not self._stop.is_set() and self.workers.get(handle.key) is handle:
            try:
                if handle.evt_conn.poll(0.2):
                    msg = handle.evt_conn.recv()
                    handle.last_seen = time.time()
                    if msg.get("type") == "status":
                        self.latest_status[handle.key] = msg.get("systems", [])
                    elif msg.get("type") == "event" and self.on_event:
                        evt = msg.get("event", {})
                        self.on_event(evt.get("type", "event"), evt)
                    elif msg.get("type") == "spectrum":
                        sid = msg.get("systemId", "")
                        self.latest_spectrum[sid] = msg
                        if self.on_spectrum:
                            self.on_spectrum(sid, msg)
                    elif msg.get("type") == "voice_pcm":
                        if self.on_voice:
                            self.on_voice(
                                msg.get("systemId", ""),
                                int(msg.get("recorderId", 0)),
                                msg.get("pcm", b""),
                            )
                    elif msg.get("type") == "worker_error":
                        logger.error(
                            "worker %s error:\n%s", handle.key, msg.get("traceback")
                        )
            except (EOFError, OSError):
                return

    def _liveness_loop(self) -> None:
        while not self._stop.is_set():
            time.sleep(self.LIVENESS_INTERVAL)
            self.check_liveness()

    def check_liveness(self) -> list[str]:
        """Restart dead workers; returns the keys restarted."""
        restarted = []
        with self._lock:
            items = list(self.workers.items())
        for key, handle in items:
            if handle.alive():
                continue
            if handle.restarts >= self.MAX_RESTARTS:
                logger.error("worker %s exceeded restart cap", key)
                continue
            logger.warning("worker %s dead; restarting", key)
            systems = self.group_systems().get(key, [])
            new = self._spawn(key, systems)
            new.restarts = handle.restarts + 1
            restarted.append(key)
        return restarted

    # -- control -----------------------------------------------------------

    def status(self) -> list[dict]:
        out = []
        for key, handle in self.workers.items():
            out.append(
                {
                    "worker": key,
                    "alive": handle.alive(),
                    "restarts": handle.restarts,
                    "systems": self.latest_status.get(key, []),
                }
            )
        return out

    def rpc(self, key: str, cmd: str, timeout: float = 5.0, **kwargs) -> Any:
        return self.workers[key].rpc(cmd, timeout=timeout, **kwargs)

    def stop_all(self) -> None:
        self._stop.set()
        for handle in list(self.workers.values()):
            try:
                if handle.alive():
                    handle.rpc("shutdown", timeout=5.0)
            except (TimeoutError, RuntimeError, OSError):
                pass
            if handle.process is not None and hasattr(handle.process, "join"):
                handle.process.join(timeout=5)
                if handle.alive() and hasattr(handle.process, "terminate"):
                    handle.process.terminate()
        self.workers.clear()
        self._record_workers()

    def _record_workers(self) -> None:
        """Persist live worker (pid, starttime) pairs for boot-time reaping."""
        import json
        from pathlib import Path

        if not self.state_dir:
            return
        entries = []
        for handle in self.workers.values():
            pid = getattr(handle.process, "pid", None)
            if isinstance(pid, int):
                entries.append({"pid": pid, "start": proc_starttime(pid)})
        try:
            Path(self.state_dir).mkdir(parents=True, exist_ok=True)
            (Path(self.state_dir) / "workers.json").write_text(json.dumps(entries))
        except OSError:  # pragma: no cover
            pass
