"""Trunking worker process body (reference ``trunking/process_worker.py:32``).

Each worker process hosts its own CaptureManager + TrunkingManager for
one SDR device's systems, isolated from the main server (the reference's
motivation: the SDRplay API tolerates one device per process; ours adds
JAX-runtime isolation).  RPC commands arrive on ``cmd_conn``; events,
periodic status, FPS-capped spectrum frames, and voice PCM chunks flow
back on ``evt_conn`` (reference forwards FFT at 30 FPS + 20 ms audio
chunks, ``process_manager.py:262+``), so clients of the main server can
stream spectrum and listen to calls from process-isolated systems.

In the port the worker's ``CaptureManager`` runs on the torch device named
by the worker config's ``device`` (the CUDA card by default, ``"cpu"`` when
asked for), in place of the JAX platform setup: the child imports torch and
this package only.

The port's copy of ``wavecap_tpu/trunking/process_worker.py``, with the same public names.
"""

from __future__ import annotations

import logging
import time
import traceback

logger = logging.getLogger(__name__)

SPECTRUM_FPS_CAP = 30.0  # reference caps worker FFT forwarding at 30 FPS


def make_worker_driver(worker_cfg: dict):
    """Device driver for a worker: any production kind, not just fakes
    (round-2 gap: workers could only host fake/native drivers, leaving
    per-device mode deaf).  ``stations`` (list of dicts) parameterizes
    the synthetic drivers for tests/harness."""
    from wavecap_tpu_torch.devices import FakeDriver, FakeStation

    kind = worker_cfg.get("driver", "fake")
    stations = worker_cfg.get("stations")
    st_objs = [FakeStation(**s) for s in stations] if stations else None
    if kind == "native":
        from wavecap_tpu_torch.devices.native import NativeDriver

        return NativeDriver(stations=st_objs)
    if kind == "rtl":
        from wavecap_tpu_torch.devices.rtl import RtlDriver

        return RtlDriver()
    if kind == "soapy":
        from wavecap_tpu_torch.devices.soapy import SoapyDriver

        return SoapyDriver()
    if kind == "file":
        from wavecap_tpu_torch.devices.file_replay import FileReplayDriver

        return FileReplayDriver(worker_cfg.get("file_path", ""))
    if kind == "auto":
        from wavecap_tpu_torch.devices.composite import CompositeDriver

        return CompositeDriver()
    return FakeDriver(stations=st_objs)


def run_trunking_worker(cmd_conn, evt_conn, worker_cfg: dict) -> None:
    """Entry point executed in the child process."""
    try:
        _worker_main(cmd_conn, evt_conn, worker_cfg)
    except Exception:
        try:
            evt_conn.send(
                {"type": "worker_error", "traceback": traceback.format_exc()}
            )
        except (OSError, BrokenPipeError):
            pass


class _StreamTaps:
    """Per-system subscriptions forwarding spectrum + voice over the
    event pipe.  Attached lazily once a system is running (its capture
    and recorder pool only exist after ``start()``)."""

    def __init__(self, evt_conn):
        self.evt_conn = evt_conn
        self.spectrum_subs: dict[str, object] = {}  # system id -> Subscription
        self.voice_subs: dict[tuple[str, int], object] = {}
        self._last_spectrum: dict[str, float] = {}

    def attach(self, manager) -> None:
        for sid, sys_ in list(manager.systems.items()):
            cap = getattr(sys_, "capture", None)
            if cap is not None and sid not in self.spectrum_subs:
                self.spectrum_subs[sid] = cap.spectrum_subs.subscribe(maxsize=2)
            pool = getattr(sys_, "pool", None)
            if pool is not None:
                for rec in pool.recorders:
                    key = (sid, rec.id)
                    if key not in self.voice_subs:
                        self.voice_subs[key] = rec.audio.subscribe(maxsize=16)
            if cap is None:  # stopped system: drop stale taps
                sub = self.spectrum_subs.pop(sid, None)
                if sub is not None:
                    sub.close()
                for key in [k for k in self.voice_subs if k[0] == sid]:
                    self.voice_subs.pop(key).close()

    def pump(self, manager) -> bool:
        """Drain pending frames/chunks onto the pipe; True if any moved."""
        import numpy as np

        moved = False
        now = time.time()
        for sid, sub in list(self.spectrum_subs.items()):
            spec = sub.get_nowait()
            if spec is None:
                continue
            moved = True
            if now - self._last_spectrum.get(sid, 0.0) < 1.0 / SPECTRUM_FPS_CAP:
                continue  # FPS cap: drop, the next frame supersedes it
            self._last_spectrum[sid] = now
            frame = spec[-1] if getattr(spec, "ndim", 1) == 2 else spec
            sys_ = manager.systems.get(sid)
            cap = getattr(sys_, "capture", None)
            _safe_send(
                self.evt_conn,
                {
                    "type": "spectrum",
                    "systemId": sid,
                    "centerHz": cap.config.center_hz if cap else 0.0,
                    "sampleRate": cap.config.sample_rate if cap else 0,
                    "db": np.asarray(frame, np.float32),
                },
            )
        for (sid, rid), sub in list(self.voice_subs.items()):
            pcm = sub.get_nowait()
            if pcm is None:
                continue
            moved = True
            pcm16 = np.clip(
                np.asarray(pcm, np.float32) * 32767.0, -32768, 32767
            ).astype(np.int16)
            _safe_send(
                self.evt_conn,
                {
                    "type": "voice_pcm",
                    "systemId": sid,
                    "recorderId": rid,
                    "pcm": pcm16.tobytes(),
                },
            )
        return moved


def _worker_main(cmd_conn, evt_conn, worker_cfg: dict) -> None:
    from wavecap_tpu_torch.utils.torchenv import resolve_device

    # the worker's device: the CUDA card unless the config asks for the
    # CPU; with no card this raises (reported as ``worker_error``)
    device = resolve_device(worker_cfg.get("device"))

    from wavecap_tpu_torch.capture import CaptureManager
    from .config import TrunkingSystemConfig
    from .manager import TrunkingManager

    driver = make_worker_driver(worker_cfg)
    captures = CaptureManager(driver, device=device)
    manager = TrunkingManager(captures, state_dir=worker_cfg.get("state_dir"))
    manager.on_event = lambda et, evt: _safe_send(evt_conn, {"type": "event", "event": evt})

    for sys_cfg in worker_cfg.get("systems", []):
        manager.create_system(TrunkingSystemConfig.from_dict(sys_cfg))
    if worker_cfg.get("auto_start", True):
        manager.start()

    taps = _StreamTaps(evt_conn)
    last_status = 0.0
    last_attach = 0.0
    while True:
        if cmd_conn.poll(0.02):
            try:
                msg = cmd_conn.recv()
            except (EOFError, OSError):
                break
            rid = msg.get("id")
            cmd = msg.get("cmd")
            try:
                if cmd == "status":
                    result = manager.status()
                elif cmd == "start":
                    manager.start(msg.get("systemId"))
                    result = {"ok": True}
                elif cmd == "stop_system":
                    manager.get(msg["systemId"]).stop()
                    result = {"ok": True}
                elif cmd == "ping":
                    result = {"pong": time.time()}
                elif cmd == "shutdown":
                    cmd_conn.send({"id": rid, "result": {"ok": True}})
                    break
                else:
                    result = {"error": f"unknown command {cmd}"}
                cmd_conn.send({"id": rid, "result": result})
            except Exception as e:
                _safe_send(cmd_conn, {"id": rid, "error": str(e)})
        now = time.time()
        if now - last_attach > 1.0:
            taps.attach(manager)
            last_attach = now
        taps.pump(manager)
        if now - last_status > 2.0:
            _safe_send(evt_conn, {"type": "status", "systems": manager.status()})
            last_status = now
    manager.stop_all()


def _safe_send(conn, obj) -> None:
    try:
        conn.send(obj)
    except (OSError, BrokenPipeError):  # pragma: no cover
        pass
