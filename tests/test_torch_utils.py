"""The port's host utilities (``wavecap_tpu_torch/utils``: ``validation``,
``wavio``, ``namers``, ``config`` and ``observability``) against the JAX
package's, on the CPU.

Host code on both sides: each case runs the same seeded inputs
(``np.random.default_rng(seed)``) through the reference's module and the
port's, and the two results must be equal exactly (``canon``: arrays bit
for bit, floats by their bits, dataclasses field by field; files byte for
byte).  Wall-clock stamps (``time`` fields) are left out of the
comparison.  The cases follow ``tests/test_validation.py``, the WAV,
namer and band-plan cases of ``tests/test_utils.py``, the overlay cases
of ``tests/test_config.py`` and ``tests/test_observability.py``.  Then:
the port's ``utils/config.py``, every module of the port and
``chip_smoke.py`` import with PyYAML blocked.
"""

from __future__ import annotations

import ast
import importlib
import json
import logging
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_decoders_fec import canon

ROOT = Path(__file__).resolve().parent.parent


def both(path: str):
    """(reference module, port module) for a path under the packages."""
    return (importlib.import_module(f"wavecap_tpu.{path}"),
            importlib.import_module(f"wavecap_tpu_torch.{path}"))


def same(case, path: str, *args, seed: int = 16):
    """``case(module, rng, *args)`` through both packages with one seed:
    equal results, the reference's returned."""
    ref, port = both(path)
    a = case(ref, np.random.default_rng(seed), *args)
    b = case(port, np.random.default_rng(seed), *args)
    assert canon(b) == canon(a)
    return a


# --- validation ------------------------------------------------------------------------


def validation_bounds(v, rng):
    freqs = [851.2e6, 154.1e6, 0.0, -851e6, float("nan"), float("inf"), 99e9, None, "x", 25e6, 1.3e9,
             *rng.uniform(1e6, 2e9, 64).tolist()]
    idens = [(851.0, 12.5, 12.5), (0.0, 12.5, 12.5), (851.0, 0.0, 12.5), (851.0, -12.5, 12.5),
             (851.0, 5000.0, 12.5), (float("nan"), 12.5, 12.5), ("a", 1, 1),
             *[tuple(x) for x in rng.uniform(-10.0, 2000.0, (64, 3)).tolist()]]
    return [v.plausible_rf_hz(f) for f in freqs], [v.plausible_iden(*x) for x in idens]


def validation_sanitize(v, rng):
    clean = np.linspace(-1, 1, 64, dtype=np.float32)
    dirty = rng.standard_normal(256).astype(np.float32) * 3
    dirty[rng.integers(0, 256, 20)] = np.nan
    dirty[rng.integers(0, 256, 5)] = np.inf
    dirty[rng.integers(0, 256, 5)] = -np.inf
    runaway = (rng.standard_normal(64) * 1e9).astype(np.float32)
    return (v.sanitize_audio(clean) is clean, v.sanitize_audio(dirty), v.sanitize_audio(runaway),
            v.sanitize_audio(np.zeros(0, np.float32)), v.sanitize_audio(dirty.astype(np.float64), clip=2.0))


@pytest.mark.parametrize("case", [validation_bounds, validation_sanitize], ids=lambda f: f.__name__)
def test_validation_matches_reference(case):
    same(case, "utils.validation")


def test_validation_cases_hold_on_the_port():
    from wavecap_tpu_torch.utils.validation import plausible_iden, plausible_rf_hz, sanitize_audio

    assert plausible_rf_hz(851.2e6) and not plausible_rf_hz(float("nan")) and not plausible_rf_hz(None)
    assert plausible_iden(851.0, 12.5, 12.5) and not plausible_iden(851.0, 5000.0, 12.5)
    a = np.array([0.5, np.nan, np.inf, -np.inf, -0.5], np.float32)
    out = sanitize_audio(a)
    assert np.isfinite(out).all() and out[1] == 0.0 and np.abs(sanitize_audio(a * 1e9)).max() <= 4.0


# --- wavio -----------------------------------------------------------------------------


def wav_iq(w, rng, tmp: Path):
    iq = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)) * 0.2
    iq = (np.clip(iq.real, -1.2, 1.2) + 1j * np.clip(iq.imag, -1.2, 1.2)).astype(np.complex64)
    p = tmp / f"iq_{w.__name__}.wav"
    w.write_iq_wav(p, iq, 48_000)
    back, rate = w.read_iq_wav(p)
    return p.read_bytes(), back, rate


def wav_audio(w, rng, tmp: Path):
    audio = (rng.standard_normal(4800) * 0.6).astype(np.float32)
    audio[::97] = np.nan
    audio[5] = 3.0
    p = tmp / f"a_{w.__name__}.wav"
    w.write_audio_wav(p, audio, 8000)
    back, rate = w.read_audio_wav(p)
    return p.read_bytes(), back, rate


def wav_stereo_and_wide(w, rng, tmp: Path):
    """A 2-channel 32-bit audio WAV (mean of the channels) and a 32-bit IQ WAV."""
    import wave

    data = rng.integers(-2 ** 31, 2 ** 31 - 1, (2000, 2), dtype=np.int64).astype(np.int32)
    p = tmp / f"s_{w.__name__}.wav"
    with wave.open(str(p), "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(4)
        f.setframerate(22_050)
        f.writeframes(data.tobytes())
    return w.read_audio_wav(p), w.read_iq_wav(p)


def wav_packing(w, rng, tmp: Path):
    audio = np.concatenate([[0.0, 0.5, -0.5, 1.0, -1.0, np.nan, np.inf], rng.uniform(-2, 2, 100)]).astype(np.float32)
    iq = (rng.standard_normal(100) + 1j * rng.standard_normal(100)).astype(np.complex64)
    return w.pack_pcm16(audio), w.pack_iq16(iq), w.pack_f32(audio)


@pytest.mark.parametrize("case", [wav_iq, wav_audio, wav_stereo_and_wide, wav_packing], ids=lambda f: f.__name__)
def test_wavio_matches_reference(case, tmp_path):
    same(lambda w, rng: case(w, rng, tmp_path), "utils.wavio")


def test_wavio_cases_hold_on_the_port(tmp_path):
    from wavecap_tpu_torch.utils.wavio import pack_iq16, pack_pcm16, read_audio_wav, write_audio_wav

    p16 = pack_pcm16(np.array([0.0, 0.5, -0.5, 1.0, -1.0], np.float32))
    assert p16.dtype == np.int16 and p16[3] == 32767
    i16 = pack_iq16(np.array([0.25 + 0.5j], np.complex64))
    assert abs(int(i16[0]) - 8192) <= 1 and abs(int(i16[1]) - 16384) <= 1
    write_audio_wav(tmp_path / "c.wav", np.array([2.0, -2.0, 0.5], np.float32), 8000)
    back, _ = read_audio_wav(tmp_path / "c.wav")
    assert np.all(np.abs(back) <= 1.0) and back[0] > 0.9 and back[1] < -0.9


# --- namers ----------------------------------------------------------------------------


def namers_lookup(n, rng):
    freqs = [100.1e6, 156.8e6, 121.5e6, 50e3, 453.2125e6, 851.2e6, 930.1e6, 1090e6, 162.4e6,
             *rng.uniform(20e6, 1.5e9, 200).tolist()]
    return ([n.band_for(f) for f in freqs], [n.frequency_name(f) for f in freqs],
            [n.mode_hint(f) for f in freqs], [n.marine_channel(f) for f in freqs],
            [n.capture_name(f, "RTL 0001") for f in freqs[:20]])


def namers_nicknames(n, rng):
    labels = ["Generic RTL2832U OEM", "RTLSDRBlog V4", "SDRplay RSPdx", "Fake SDR 0", "Native ingest ring",
              "Mystery Radio"]
    return [n.device_nickname(lb, s, i) for lb in labels for s, i in (("", 0), ("", 3), ("00012345", 1))]


def namers_band_plans(n, rng, tmp: Path):
    p = tmp / f"bands_{n.__name__}.yaml"
    p.write_text("bands:\n"
                 "  - { low_mhz: 87.5, high_mhz: 108.0, name: 'FM Broadcast', mode_hint: wbfm }\n"
                 "  - { low_mhz: 400.0, high_mhz: 410.0, name: 'Test Band', mode_hint: nbfm }\n"
                 "  - { low_mhz: x }\n")
    return n.load_band_plan(str(p)), n.load_band_plan(), n.load_band_plan(str(tmp / "missing.yaml"))


@pytest.mark.parametrize("case", [namers_lookup, namers_nicknames, "band_plans"],
                         ids=lambda f: f if isinstance(f, str) else f.__name__)
def test_namers_match_reference(case, tmp_path):
    if case == "band_plans":
        plans = same(lambda n, rng: namers_band_plans(n, rng, tmp_path), "utils.namers")
        names = [b.name for b in plans[0]]
        assert "Test Band" in names and names.count("FM Broadcast") == 1 and "Marine VHF" in names
        assert any(b.name == "800 MHz Trunking" for b in plans[1])
    else:
        same(case, "utils.namers")


# --- config ----------------------------------------------------------------------------


def config_overlay(c, rng, tmp: Path):
    d = tmp / c.__name__.replace(".", "_")
    d.mkdir()
    base = d / "wavecap.yaml"
    base.write_text("server:\n  port: 8087\n  host: 0.0.0.0\nstream:\n  audio_rate: 48000\n"
                    "pocsag_aliases:\n  '100': Base Name\n")
    (d / "wavecap.local.yaml").write_text("server:\n  port: 9000\npocsag_aliases:\n  '200': Local Name\n")
    only = d / "only.yaml"
    only.write_text("server:\n  port: 8500\n")
    cfgs = [c.load_config(base), c.load_config(only), c.load_config(d / "absent.yaml")]
    for cfg in cfgs:  # the paths are per package's folder
        cfg.config_paths = [Path(p).name for p in cfg.config_paths]
    return cfgs


def config_from_dicts(c, rng):
    example = __import__("yaml").safe_load((ROOT / "wavecap.yaml.example").read_text())
    return [
        c.config_from_dict({"captures": [{"id": "c1", "centerHz": 100e6, "sampleRate": 1_000_000,
                                          "autoStart": False,
                                          "channels": [{"id": "ch", "frequencyHz": 100.1e6, "squelchDb": -60,
                                                        "dsp": {"notch_frequencies": [1000.0, 2000.0]}}]}],
                            "trunkingSystems": [{"id": "t1"}]}),
        c.config_from_dict({"pocsag_aliases": {"abc": "X", "42": "Y", "-7": "Z"}}),
        c.config_from_dict({"server": {"port": 1, "unknown": 2}, "limits": {"max_captures": 9}}),
        c.config_from_dict(example),
        c.log_level_from_env(),
    ]


@pytest.mark.parametrize("case", ["overlay", config_from_dicts], ids=lambda f: f if isinstance(f, str) else f.__name__)
def test_config_matches_reference(case, tmp_path):
    if case == "overlay":
        cfgs = same(lambda c, rng: config_overlay(c, rng, tmp_path), "utils.config")
        assert cfgs[0].server.port == 9000 and cfgs[0].server.host == "0.0.0.0"
        assert cfgs[0].pocsag_aliases == {100: "Base Name", 200: "Local Name"} and len(cfgs[0].config_paths) == 2
        assert cfgs[1].server.port == 8500
    else:
        cfgs = same(case, "utils.config")
        assert cfgs[3].captures[0].sample_rate == 2_400_000


# --- observability ---------------------------------------------------------------------


def obs_error_tracker(o, rng):
    t = o.ErrorTracker()
    for i, k in enumerate(rng.integers(0, 3, 40)):
        t.record(["dsp", "io", "usb"][k], f"src{i % 4}", f"boom {i}")
    recent = [(e.kind, e.source, e.message) for e in t.recent(7)]
    return recent, t.rates(), len(t.recent(5000))


def obs_profiler(o, rng):
    p = o.Profiler("test")
    for s in rng.integers(0, 3, 30):
        with p.measure(f"s{s}"):
            pass
    counts = {k: v["count"] for k, v in p.report().items()}
    reset = {k: v["count"] for k, v in p.report(reset=True).items()}
    off = o.Profiler("off", enabled=False)
    with off.measure("x"):
        pass
    return counts, reset, p.report(), off.report()


def obs_log_ring(o, rng):
    ring = o.LogRing(capacity=5)
    got = []
    cancel = ring.subscribe(got.append)
    for i in range(8):
        ring.emit(logging.LogRecord("test.logger", logging.INFO, __file__, 1, f"m{i}", (), None))
    cancel()
    ring.emit(logging.LogRecord("test.logger", logging.WARNING, __file__, 1, "after", (), None))

    def strip(e):
        return {k: v for k, v in e.items() if k != "time"}
    return [strip(e) for e in ring.tail(10)], [strip(e) for e in ring.tail(2)], [strip(e) for e in got]


def obs_rate_limit(o, rng):
    f = o.RateLimitFilter(min_interval_s=10.0)
    recs = [logging.LogRecord("hot", logging.WARNING, __file__, int(n), "spam", (), None)
            for n in rng.integers(40, 44, 30)]
    return [f.filter(r) for r in recs]


def obs_state_broadcaster(o, rng):
    b = o.StateBroadcaster()
    got = []

    def boom(evt):
        raise RuntimeError("subscriber bug")

    b.subscribe(boom)
    cancel = b.subscribe(got.append)
    b.publish("capture", "cap1", "created", {"state": "running"})
    b.publish("channel", "ch1", "updated")
    cancel()
    b.publish("capture", "cap1", "deleted")
    return [{k: v for k, v in e.items() if k != "time"} for e in got]


def obs_system_metrics(o, rng):
    m = o.system_metrics()
    return sorted(m), sorted(m.get("memory", {})), sorted(m.get("loadavg", {}))


@pytest.mark.parametrize("case", [obs_error_tracker, obs_profiler, obs_log_ring, obs_rate_limit,
                                  obs_state_broadcaster, obs_system_metrics], ids=lambda f: f.__name__)
def test_observability_matches_reference(case):
    same(case, "utils.observability")


def test_observability_rates_and_intervals_on_the_port():
    from wavecap_tpu_torch.utils.observability import (ERROR_TRACKER, LOG_RING, STATE_BROADCASTER, LogRing,
                                                        RateLimitFilter, StateBroadcaster)

    assert isinstance(LOG_RING, LogRing) and isinstance(STATE_BROADCASTER, StateBroadcaster)
    from wavecap_tpu_torch.capture import engine

    assert engine.ERROR_TRACKER is ERROR_TRACKER  # the engine's health monitor records here
    f = RateLimitFilter(min_interval_s=0.01)
    rec = logging.LogRecord("hot", logging.WARNING, __file__, 1, "x", (), None)
    assert f.filter(rec) and not f.filter(rec)
    time.sleep(0.02)
    assert f.filter(rec)


# --- the port without PyYAML -----------------------------------------------------------


def test_config_and_the_port_import_without_yaml():
    """With ``yaml`` blocked (``sys.modules["yaml"] = None``), the port's
    ``utils/config.py``, every module of the port and ``chip_smoke.py``
    import, ``config_from_dict`` works, and ``load_config`` asks for
    PyYAML only when it parses a file."""
    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                     for p in (ROOT / "wavecap_tpu_torch").rglob("*.py"))
    code = (
        "import sys, importlib, json\n"
        "sys.modules['yaml'] = None\n"
        "from wavecap_tpu_torch.utils import config\n"
        "cfg = config.config_from_dict({'server': {'port': 9}})\n"
        f"for name in {modules!r}: importlib.import_module(name)\n"
        "import chip_smoke\n"
        "try:\n"
        "    config.load_config('wavecap.yaml.example')\n"
        "    err = None\n"
        "except ImportError as e:\n"
        "    err = isinstance(e, ImportError)\n"
        "print(json.dumps([cfg.server.port, err]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [9, True]


def test_no_module_level_yaml_import():
    """No module of the port and not ``chip_smoke.py`` imports ``yaml`` at
    module level (only inside the functions that parse YAML)."""
    for path in sorted((ROOT / "wavecap_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.parse(path.read_text()).body:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] == "yaml" for n in names), path
