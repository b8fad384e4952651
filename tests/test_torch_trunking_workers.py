"""The port's trunking worker processes (``trunking/process_manager.py``,
``trunking/process_worker.py``) against the JAX package's, on the CPU.

``tests/test_trunking_workers.py``'s cases run on both packages with the
same fake process handles and real ``multiprocessing`` pipes: grouping,
liveness and the restart cap, RPC over a real pipe and its timeout,
orphan reaping by exact (pid, start time), the workers file, and the
event pump's routing of status, events, spectrum and voice.  The results
(spawned worker configs, restart counts, RPC answers, routed messages)
are equal between the packages, except that the port's worker config
carries the worker's torch device (``"device": "cpu"`` here).  Then a
real worker of the port's, spawned as the manager spawns it, on the CPU:
it answers ``status`` and ``ping`` within its own timeout, and
``stop_all`` leaves no worker.  The server's streaming of worker voice
and spectrum (``TestWorkerStreaming::test_server_streams_worker_voice_and_spectrum``)
needs the server, which the port does not have yet.
"""

from __future__ import annotations

import importlib
import json
import multiprocessing as mp
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tests.test_torch_decoders_fec import canon

REF, PORT = PKGS = ("wavecap_tpu", "wavecap_tpu_torch")


def pm(pkg: str):
    return importlib.import_module(f"{pkg}.trunking.process_manager")


class _AliveProcess:
    def __init__(self):
        self.terminated = False

    def is_alive(self):
        return not self.terminated

    def join(self, timeout=None):
        pass

    def terminate(self):
        self.terminated = True


class _DeadProcess(_AliveProcess):
    def is_alive(self):
        return False


def make_manager(pkg: str, proc_cls=_AliveProcess, **kw):
    spawned = []

    def factory(target, args):
        p = proc_cls()
        spawned.append((p, target, args))
        return p

    if pkg == PORT:
        kw.setdefault("device", "cpu")
    mgr = pm(pkg).TrunkingProcessManager(process_factory=factory, pipe_factory=mp.Pipe, **kw)
    mgr._spawned = spawned
    return mgr


def configs(mgr) -> list:
    """The spawned workers' configs, the port's device aside."""
    out = []
    for _, target, (_, _, cfg) in mgr._spawned:
        assert target.__module__ == mgr.__module__.replace("process_manager", "process_worker")
        out.append({k: v for k, v in cfg.items() if k != "device"})
    return out


def grouping(pkg):
    mgr = make_manager(pkg)
    for sid, dev in (("a", "dev1"), ("b", "dev1"), ("c", "dev2")):
        mgr.add_system({"id": sid, "device_id": dev, "control_channels": [851e6]})
    mgr.add_system({"id": "d", "deviceId": "dev3", "control_channels": [854e6]})
    mgr.add_system({"id": "e", "control_channels": [855e6]})
    groups = mgr.group_systems()
    assert set(groups) == {"dev1", "dev2", "dev3", "default"} and [s["id"] for s in groups["dev1"]] == ["a", "b"]
    mgr.start()
    try:
        assert set(mgr.workers) == set(groups) and len(mgr._spawned) == 4
        if pkg == PORT:
            assert all(args[2]["device"] == "cpu" for _, _, args in mgr._spawned)
        return dict(groups=groups, configs=configs(mgr), status=mgr.status())
    finally:
        mgr._stop.set()


def liveness(pkg):
    mgr = make_manager(pkg, _DeadProcess)
    mgr.add_system({"id": "a", "device_id": "dev1", "control_channels": [851e6]})
    mgr.start()
    try:
        first = mgr.check_liveness()
        assert first == ["dev1"] and mgr.workers["dev1"].restarts == 1
        for _ in range(10):
            mgr.check_liveness()
        assert mgr.workers["dev1"].restarts == mgr.MAX_RESTARTS
        return dict(first=first, restarts=mgr.workers["dev1"].restarts, spawned=len(mgr._spawned),
                    status=mgr.status())
    finally:
        mgr._stop.set()


def rpc(pkg):
    parent, child = mp.Pipe()
    handle = pm(pkg).WorkerHandle(key="k", process=_AliveProcess(), cmd_conn=parent, evt_conn=None, worker_cfg={})

    def fake_worker():
        for _ in range(3):
            msg = child.recv()
            if msg["cmd"] == "boom":
                child.send({"id": msg["id"], "error": "no such thing"})
            else:
                # a stale answer first: the handle skips ids not its own
                child.send({"id": -1, "result": "stale"})
                child.send({"id": msg["id"], "result": {"pong": 1, "args": {k: v for k, v in msg.items()
                                                                          if k not in ("id", "cmd")}}})

    t = threading.Thread(target=fake_worker, daemon=True)
    t.start()
    got = [handle.rpc("ping"), handle.rpc("status", systemId="s1")]
    with pytest.raises(RuntimeError, match="no such thing"):
        handle.rpc("boom")
    t.join(timeout=10)
    assert got[0]["pong"] == 1 and got[1]["args"] == {"systemId": "s1"}
    with pytest.raises(TimeoutError):
        handle.rpc("ping", timeout=0.3)
    return got


def orphan_reaping(pkg, tmp_path):
    m = pm(pkg)
    child = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
    try:
        start = m.proc_starttime(child.pid)
        assert start is not None
        (tmp_path / "workers.json").write_text(json.dumps([
            {"pid": child.pid, "start": start}, {"pid": child.pid, "start": start - 12345},
            {"pid": 2 ** 22 + 999, "start": 1}]))
        killed = m.reap_orphan_workers(tmp_path)
        assert killed == [child.pid]
        child.wait(timeout=10)
        assert not (tmp_path / "workers.json").exists()
    finally:
        if child.poll() is None:
            child.kill()
    (tmp_path / "workers.json").write_text(json.dumps([
        {"pid": os.getpid(), "start": m.proc_starttime(os.getpid())}, {"pid": os.getppid(), "start": -1}]))
    assert m.reap_orphan_workers(tmp_path) == []
    (tmp_path / "workers.json").write_text("not json")
    assert m.reap_orphan_workers(tmp_path) == [] and m.reap_orphan_workers(None) == []
    return dict(killed=len(killed))


def workers_file(pkg, tmp_path):
    class _PidProcess(_AliveProcess):
        pid = os.getpid()

    kw = {"device": "cpu"} if pkg == PORT else {}
    mgr = pm(pkg).TrunkingProcessManager(state_dir=tmp_path, process_factory=lambda t, a: _PidProcess(),
                                        pipe_factory=mp.Pipe, **kw)
    mgr.add_system({"id": "s1", "device_id": "dev0", "control_channels": [851e6]})
    mgr.start()
    try:
        recs = json.loads((tmp_path / "workers.json").read_text())
        assert recs and recs[0]["pid"] == os.getpid() and recs[0]["start"] is not None
    finally:
        mgr.workers["dev0"].process.terminated = True
        mgr.stop_all()
    after = json.loads((tmp_path / "workers.json").read_text())
    assert after == [] and not mgr.workers
    return dict(n=len(recs), after=after)


def event_pump(pkg):
    mgr = make_manager(pkg)
    mgr.add_system({"id": "s1", "control_channels": [851e6]})
    mgr.start()
    spectra, voices, events = [], [], []
    mgr.on_spectrum = lambda sid, msg: spectra.append((sid, msg))
    mgr.on_voice = lambda sid, rid, pcm: voices.append((sid, rid, pcm))
    mgr.on_event = lambda et, evt: events.append((et, evt))
    _, _, (_, evt_child, _) = mgr._spawned[0]
    evt_child.send({"type": "status", "systems": [{"id": "s1", "synced": True}]})
    evt_child.send({"type": "event", "event": {"type": "call_start", "tgid": 7}})
    evt_child.send({"type": "spectrum", "systemId": "s1", "centerHz": 851.5e6, "sampleRate": 960_000,
                    "db": np.full(16, -70.0, np.float32)})
    evt_child.send({"type": "voice_pcm", "systemId": "s1", "recorderId": 1, "pcm": b"\x01\x02" * 160})
    evt_child.send({"type": "worker_error", "traceback": "x"})
    t0 = time.time()
    while time.time() - t0 < 10 and not (spectra and voices and events and mgr.latest_status):
        time.sleep(0.01)
    try:
        assert spectra and spectra[0][0] == "s1" and mgr.latest_spectrum["s1"]["centerHz"] == 851.5e6
        assert voices == [("s1", 1, b"\x01\x02" * 160)] and events == [("call_start", {"type": "call_start",
                                                                                      "tgid": 7})]
        return dict(spectra=spectra, voices=voices, events=events, status=mgr.status(), latest=mgr.latest_status)
    finally:
        for h in mgr.workers.values():
            h.process.terminated = True  # no worker to answer the shutdown RPC
        mgr.stop_all()


@pytest.mark.parametrize("case", [grouping, liveness, rpc, event_pump], ids=lambda f: f.__name__)
def test_worker_supervision_matches_reference(case):
    out = {pkg: case(pkg) for pkg in PKGS}
    assert canon(out[PORT]) == canon(out[REF])


@pytest.mark.parametrize("case", [orphan_reaping, workers_file], ids=lambda f: f.__name__)
def test_worker_records_match_reference(case, tmp_path):
    out = {}
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
        out[pkg] = case(pkg, tmp_path / pkg)
    assert canon(out[PORT]) == canon(out[REF])


def test_worker_driver_kinds_match_reference(tmp_path):
    """``make_worker_driver``: each kind gives the package's own driver of
    the same class, stations passed to the fake."""
    kinds = ("fake", "native", "file", "auto")
    got = {}
    for pkg in PKGS:
        w = importlib.import_module(f"{pkg}.trunking.process_worker")
        got[pkg] = []
        for kind in kinds:
            drv = w.make_worker_driver({"driver": kind, "file_path": str(tmp_path / "x.wav"),
                                        "stations": [{"offset_hz": 1000.0, "kind": "tone"}]})
            assert type(drv).__module__.startswith(pkg + ".devices"), (pkg, kind, type(drv))
            got[pkg].append(type(drv).__name__)
        fake = w.make_worker_driver({"stations": [{"offset_hz": 1000.0, "kind": "tone"}]})
        assert [s.offset_hz for s in fake.stations] == [1000.0]
    assert got[PORT] == got[REF]


def test_manager_passes_its_device_to_the_worker():
    mgr = make_manager(PORT)
    assert str(mgr.device) == "cpu"
    mgr.add_system({"id": "a", "control_channels": [851e6]})
    mgr.start()
    try:
        assert mgr.workers["default"].worker_cfg["device"] == "cpu"
    finally:
        mgr._stop.set()


def test_real_worker_on_the_cpu_answers_status(tmp_path):
    """A real spawned worker (``spawn``, as the manager starts it) on the
    CPU: ``status`` names the system, ``ping`` answers, ``stop_all`` leaves
    no worker and the process ends."""
    mgr = pm(PORT).TrunkingProcessManager(state_dir=tmp_path, driver="fake", device="cpu")
    mgr.add_system({"id": "w1", "control_channels": [851.2e6], "sample_rate": 800_000, "max_voice_channels": 1,
                    "recording_dir": str(tmp_path / "rec")})
    errors = []
    mgr.start()
    try:
        proc = mgr.workers["default"].process
        t0, st = time.time(), None
        while time.time() - t0 < 90 and st is None:
            try:
                st = mgr.rpc("default", "status", timeout=5.0)
            except (TimeoutError, RuntimeError) as e:
                errors.append(repr(e))
                assert proc.is_alive(), errors
        assert st, f"the worker did not answer status within 90 s: {errors[-3:]}"
        assert st[0]["id"] == "w1" and st[0]["state"] == "running"
        assert mgr.rpc("default", "ping")["pong"] > 0
    finally:
        mgr.stop_all()
    assert not mgr.workers
    proc.join(timeout=30)
    assert not proc.is_alive()
