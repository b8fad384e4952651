"""The port's harness (``wavecap_tpu_torch/harness.py``) against the JAX
package's, on the CPU, and the port's cold boot.

Each preset runs through both harnesses (each boots its package's server
with the fake driver; the port's on ``device="cpu"``, its client the
standard library's).  The reports must agree on every field the scene
fixes: analog ``preset``, ``duration_s``, ``samples``, ``audio_rate``,
``dominant_hz`` equal and ``rms`` / ``peak`` within 1 % (the fake
driver streams in real time, so which blocks fill the window is the
clock's); trunking ``preset``, ``synced``, ``nac``, ``systemId``,
``siteId``, ``calls`` and ``tsbkCrcRateSteady`` equal, ``tsbkCountSteady``
>= 30 on both (the counts and ``tsbkCrcRate`` grow with wall time, which
the harness polls).  Then ``tests/test_harness_and_replay.py``'s
assertions hold on the port's reports.  ``realtime_factor`` and
``wall_s`` are the clock's.

The cold boot (``tests/test_cold_boot.py``) runs ``python -m
wavecap_tpu_torch serve`` from the shipped example config with
``WAVECAP_TORCH_DEVICE=cpu``; it is marked ``slow`` as the reference's is.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

from tests.test_cold_boot import _free_port, _get
from wavecap_tpu import harness as jharness
from wavecap_tpu_torch import harness as tharness
from wavecap_tpu_torch.utils.wavio import read_audio_wav

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def both(run: str, preset: str, duration: float, tmp_path: Path) -> tuple[dict, dict]:
    reports = []
    for name, mod, kw in (("ref", jharness, {}), ("port", tharness, {"device": "cpu"})):
        args = argparse.Namespace(preset=preset, duration=duration, iq_file=None, out_dir=str(tmp_path / name))
        rep = asyncio.run(getattr(mod, run)(args, **kw))
        reports.append(rep if isinstance(rep, dict) else asdict(rep))
    return reports[0], reports[1]


def test_tone_preset_report_matches_reference(tmp_path):
    ref, port = both("run_harness", "tone", 1.5, tmp_path)
    fixed = ("preset", "duration_s", "samples", "audio_rate", "dominant_hz")
    assert {k: port[k] for k in fixed} == {k: ref[k] for k in fixed}
    for k in ("rms", "peak"):
        assert port[k] == pytest.approx(ref[k], rel=0.01), k
    assert Path(port["wav_path"]).name == Path(ref["wav_path"]).name
    # tests/test_harness_and_replay.py's assertions on the port's report
    assert port["samples"] >= 1.5 * 48_000 and port["rms"] > 0.01
    assert abs(port["dominant_hz"] - 1000.0) < 25.0
    audio, rate = read_audio_wav(port["wav_path"])
    assert rate == 48_000 and len(audio) == port["samples"]
    assert (tmp_path / "port" / "harness_tone.json").exists()


@pytest.mark.parametrize("preset", ["p25-trunk", "p25-phase2-trunk"])
def test_trunking_preset_report_matches_reference(tmp_path, preset):
    ref, port = both("run_trunking_harness", preset, 3.0, tmp_path)
    fixed = ("preset", "synced", "nac", "systemId", "siteId", "calls", "tsbkCrcRateSteady")
    assert {k: port[k] for k in fixed} == {k: ref[k] for k in fixed}
    assert set(port) == set(ref)
    # tests/test_harness_and_replay.py's assertions on the port's report
    assert port["synced"] and port["nac"] == 0x293
    assert port["tsbkCount"] > 3 and port["tsbkCrcRate"] > 0.5
    assert port["tsbkCountSteady"] >= 30 and ref["tsbkCountSteady"] >= 30
    assert port["tsbkCrcRateSteady"] >= 0.95
    assert port["systemId"] == 0x123 and port["calls"] >= 1
    assert json.loads((tmp_path / "port" / f"harness_{preset}.json").read_text()) == port


@pytest.mark.slow
def test_serve_boots_from_example_config(tmp_path):
    """``tests/test_cold_boot.py`` on the port: the shipped example config,
    the fake driver, the autostarted ``fm`` capture processing blocks."""
    shutil.copy(REPO / "wavecap.yaml.example", tmp_path / "wavecap.yaml")
    port = _free_port()
    env = dict(os.environ, WAVECAP_TORCH_DEVICE="cpu")
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-m", "wavecap_tpu_torch", "serve", "--port", str(port)],
                            cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    base = f"http://127.0.0.1:{port}/api/v1"
    try:
        deadline, health = time.monotonic() + 90.0, None
        while time.monotonic() < deadline and health is None:
            if proc.poll() is not None:
                pytest.fail(f"serve exited rc={proc.returncode}:\n{proc.stdout.read().decode()[-3000:]}")
            try:
                health = _get(f"{base}/health")
            except OSError:
                time.sleep(0.5)
        assert health and health["status"] == "ok"
        deadline, blocks = time.monotonic() + 90.0, 0
        while time.monotonic() < deadline and not blocks:
            cap = next(c for c in _get(f"{base}/captures") if c["id"] == "fm")
            assert cap["state"] != "error", cap
            if cap["state"] == "running" and cap.get("blocksProcessed", 0) > 0:
                blocks = cap["blocksProcessed"]
            else:
                time.sleep(0.5)
        assert blocks > 0 and cap["device"] == "cpu"
        systems = _get(f"{base}/trunking/systems")
        assert systems and systems[0]["controlChannelHz"] == pytest.approx(851.2e6)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
