"""The port's control-channel scanner (``trunking/cc_scanner.py``) and the
system's probe flow against the JAX package's, on the CPU.

``tests/test_cc_scanner.py``'s unit and probe-flow cases run once through
each package with the same inputs (the same TSDU symbols, the same seeded
noise) under one virtual clock (``tests.test_torch_trunking.VClock``):
the measurements, the probe results, the retunes and the events are
equal (``canon``), and each reference assertion holds on the port.  Then
the scan on each package's engine: a loud sync-less carrier (FM by a
tone) and a quiet P25 control channel at 960 kHz, SCAN hunting from the carrier, driven
inline (``start_inline`` / ``drive``): both probe both candidates, lock
the quiet control channel, and give the same measurements (power within
0.2 dB) and events.
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest

from tests.test_torch_decoders_fec import canon
from tests.test_torch_trunking import clock  # noqa: F401  (the virtual clock fixture)
from tests.test_torch_trunking import (
    PORT, REF, T0, both, drive, make_system, manager, mods, scene_blocks, start_inline, stop_inline,
)
from tests.test_trunking import make_p25_cc_iq


def tsdu_soft(nac=0x293, n=3):
    r = mods(REF)
    blk = r.pf.encode_tsbk_block(r.tsbk.TSBKOpcode.IDEN_UP, r.tsbk.make_iden_up_data(identifier=1,
                                                                                     base_freq_mhz=851.0))
    return np.tile(r.pf.DIBIT_SYMBOLS[r.pf.build_tsdu_frame(nac, [blk])].astype(np.float32), n)


# --- TestScannerUnit ----------------------------------------------------------------------


def sync_beats_louder_carrier(pkg, path):
    s = mods(pkg).cc_scanner
    sc = s.CCScanner()
    sc.measurements[852e6] = s.CCMeasurement(852e6, power_db=-40, snr_db=40, sync_detected=False, time=1.0)
    sc.measurements[851.2e6] = s.CCMeasurement(851.2e6, power_db=-75, snr_db=5, sync_detected=True, crc_ok=3,
                                               time=1.0)
    assert sc.best([852e6, 851.2e6]) == 851.2e6
    return dict(best=sc.best([852e6, 851.2e6]), status=sc.status(), none=sc.best([]))


def spectrum_power_and_snr(pkg, path):
    sc = mods(pkg).cc_scanner.CCScanner(power_ema=1.0)
    nfft, fs, center = 256, 2_560_000, 851e6
    frame = np.full(nfft, -90.0, np.float32)
    f = 851e6 + 200_000.0
    frame[int(round((f - center) / (fs / nfft))) + nfft // 2] = -40.0
    sc.update_spectrum(frame, fs, center, [f, 851e6 - 100e6], now=1.0)
    assert abs(sc.measurements[f].power_db - (-40.0)) < 1e-6 and sc.measurements[f].snr_db > 45
    assert 851e6 - 100e6 not in sc.measurements
    # the EMA, a 2-D frame (its last row) and a frame too short to score
    ema = mods(pkg).cc_scanner.CCScanner(power_ema=0.5)
    rng = np.random.default_rng(3)
    for _ in range(3):
        ema.update_spectrum(np.stack([frame, frame + rng.normal(0, 1, nfft).astype(np.float32)]), fs, center, [f],
                            now=2.0)
    ema.update_spectrum(frame[:4], fs, center, [f], now=3.0)
    return dict(m=sc.measurements, ema=ema.measurements)


def probe_counts_frames_and_crc(pkg, path):
    sc = mods(pkg).cc_scanner.CCScanner(probe_window_s=0.5)
    sc.start_probe(851.2e6, "voice0", now=0.0)
    sc.feed("voice0", tsdu_soft(), now=0.05)
    sc.feed("voice0", tsdu_soft(), now=0.1)
    sc.feed("voiceOTHER", tsdu_soft(), now=0.1)
    assert sc.poll(0.2) is None
    m = sc.poll(1.0)
    assert m is not None and m.sync_detected and m.frames >= 1 and m.crc_ok >= 1
    return dict(m=m, status=sc.status())


def probe_skips_stale_batch(pkg, path):
    sc = mods(pkg).cc_scanner.CCScanner(probe_window_s=0.5)
    sc.start_probe(851.2e6, "voice0", now=0.0)
    sc.feed("voice0", tsdu_soft(), now=0.05)
    m = sc.poll(10.0)
    assert m is None and sc.probe is not None
    return dict(probe=(sc.probe.skipped, sc.probe.fed, sc.probe.first_fed))


def probe_without_data_aborts(pkg, path):
    sc = mods(pkg).cc_scanner.CCScanner(probe_window_s=1.0)
    sc.start_probe(851.2e6, "voice0", now=0.0)
    assert sc.poll(2.0) is None and sc.probe is not None
    assert sc.poll(sc.probe_timeout_s + 1.0) is None and sc.probe is None
    assert 851.2e6 not in sc.measurements
    return dict(timeout=sc.probe_timeout_s, m=sc.measurements)


def should_roam_rules(pkg, path):
    s = mods(pkg).cc_scanner
    sc = s.CCScanner(roam_margin_db=6.0, roam_interval_s=30.0)
    now = 1000.0
    sc.measurements[851.2e6] = s.CCMeasurement(851.2e6, power_db=-70, time=now)
    sc.measurements[852e6] = s.CCMeasurement(852e6, power_db=-50, sync_detected=False, time=now)
    got = [sc.should_roam(851.2e6, now)]
    sc.measurements[853e6] = s.CCMeasurement(853e6, power_db=-66, sync_detected=True, time=now)
    got.append(sc.should_roam(851.2e6, now))
    sc.measurements[853e6].power_db = -63.5
    got.append(sc.should_roam(851.2e6, now))
    sc.measurements[853e6].time = now - 1000.0
    got.append(sc.should_roam(851.2e6, now))
    assert got == [None, None, 853e6, None]
    cands = [851.2e6, 852e6, 853e6, 854e6]
    rr = [sc.next_roam_candidate(cands, 851.2e6) for _ in range(4)]
    return dict(got=got, rr=rr, unverified=sc.unverified(cands, max_age_s=120.0, now=now),
                none=(sc.should_roam(None, now), sc.next_roam_candidate([851.2e6], 851.2e6)))


UNIT_CASES = [sync_beats_louder_carrier, spectrum_power_and_snr, probe_counts_frames_and_crc,
              probe_skips_stale_batch, probe_without_data_aborts, should_roam_rules]


@pytest.mark.parametrize("case", UNIT_CASES, ids=lambda f: f.__name__)
def test_scanner_unit_matches_reference(case, tmp_path, clock):
    both(case, tmp_path, clock)


# --- TestSystemProbeFlow ------------------------------------------------------------------


class _Mon:
    synced = False

    def reset(self):
        pass


class _NoSpectrum:
    def get_nowait(self):
        return None


def huntable(pkg, path, **cfg_kw):
    s = make_system(pkg, path)
    s.config.hunt_mode = mods(pkg).config.HuntMode.SCAN
    s.config.hunt_timeout_s = 0.0
    s.config.probe_window_s = 0.0
    for k, v in cfg_kw.items():
        setattr(s.config, k, v)
    s.scanner.probe_window_s = s.config.probe_window_s
    s.monitor, s._spectrum_sub = _Mon(), _NoSpectrum()
    s._voice_subs = {"voice0": None, "voice1": None}
    s.cc_index, s.cc_lock_time, s.last_tsbk_time = 0, 0.0, 0.0
    return s


def seen(s) -> dict:
    return dict(retunes=s.capture.retunes, events=list(s.events), m=s.scanner.measurements,
                current=s._cc_current_freq, probe_slot=s._probe_slot, calls=list(s.active_calls.values()),
                probe=None if s.scanner.probe is None else (s.scanner.probe.frequency_hz, s.scanner.probe.channel_id))


def scan_all_picks_quiet_cc(pkg, path):
    s = huntable(pkg, path)
    sc_mod = mods(pkg).cc_scanner
    carrier, cc = 852.0e6, 851.2e6
    s.config.control_channels = [carrier, cc]
    s._cc_current_freq = carrier
    s.scanner.measurements[carrier] = sc_mod.CCMeasurement(carrier, power_db=-40, snr_db=40)
    s.scanner.measurements[cc] = sc_mod.CCMeasurement(cc, power_db=-75, snr_db=5)
    rng = np.random.default_rng(7)
    clk = importlib.import_module(f"{pkg}.trunking.system").time  # the virtual clock
    s._check_hunt()
    assert s.scanner.probe is not None and s.capture.retunes[-1] == ("voice0", {"frequency_hz": carrier})
    for _ in range(2):
        s.scanner.feed("voice0", rng.normal(0.0, 0.3, 4000).astype(np.float32), now=clk.time())
    s._check_hunt()
    assert s.scanner.probe.frequency_hz == cc
    for _ in range(2):
        s.scanner.feed("voice0", tsdu_soft(), now=clk.time())
    s._check_hunt()
    assert s._cc_current_freq == cc and ("cc", {"frequency_hz": cc}) in s.capture.retunes
    assert s.scanner.measurements[cc].sync_detected
    return seen(s)


def locked_roam_to_stronger(pkg, path):
    s = huntable(pkg, path, roam_interval_s=0.0)
    sc_mod = mods(pkg).cc_scanner
    cur, other = 851.2e6, 851.5e6
    s.config.control_channels = [cur, other]
    s._cc_current_freq = cur
    s.monitor.synced = True
    s.scanner.measurements[cur] = sc_mod.CCMeasurement(cur, power_db=-70, time=T0)
    s.scanner.measurements[other] = sc_mod.CCMeasurement(other, power_db=-60, sync_detected=True, time=T0)
    s._check_hunt()
    assert s._cc_current_freq == other and any(e["type"] == "control_roam" for e in s.events)
    return seen(s)


def grant_aborts_probe(pkg, path):
    from tests.test_torch_trunking import grant, iden

    s = huntable(pkg, path)
    s.config.control_channels = [851e6, 852e6]
    s._check_hunt()
    assert s._probe_slot == "voice0"
    s._handle_tsbk({**iden(), "nac": 1}, None)
    s._handle_tsbk({**grant(9, channel=8, source=1), "nac": 1}, None)
    assert 9 in s.active_calls and s.scanner.probe is None and s._probe_slot is None
    return seen(s)


def probe_starves_while_busy(pkg, path):
    s = huntable(pkg, path, roam_interval_s=0.0)
    s.config.control_channels = [851.2e6, 851.5e6]
    s._cc_current_freq = 851.2e6
    s.monitor.synced = True
    s.last_tsbk_time = T0
    for rec in s.pool.recorders:
        rec.state = "recording"
    before = list(s.capture.retunes)
    s._check_hunt()
    assert s.scanner.probe is None and s._probe_slot is None
    assert all(r.recording for r in s.pool.recorders) and s.capture.retunes == before
    s.pool.recorders[1].state = "idle"
    s._check_hunt()
    assert s._probe_slot == "voice1" and ("voice1", {"frequency_hz": 851.5e6}) in s.capture.retunes
    assert s.pool.recorders[0].recording
    return seen(s)


FLOW_CASES = [scan_all_picks_quiet_cc, locked_roam_to_stronger, grant_aborts_probe, probe_starves_while_busy]


@pytest.mark.parametrize("case", FLOW_CASES, ids=lambda f: f.__name__)
def test_system_probe_flow_matches_reference(case, tmp_path, clock):
    both(case, tmp_path, clock)


# --- the scan on each package's engine (TestScannerIntegration, inline) -------------------

RATE, CENTER = 960_000, 851_500_000.0
CARRIER, CC = 851_800_000.0, 851_200_000.0
SCAN_BLOCKS = 36


def scan_system(pkg, path, clock, blocks):
    m = mods(pkg)
    tm = m.manager.TrunkingManager(manager(pkg), state_dir=path / "state")
    s = tm.create_system(m.config.TrunkingSystemConfig(
        id="scan1", control_channels=[CARRIER, CC], center_hz=CENTER, sample_rate=RATE, max_voice_channels=1,
        hunt_mode=m.config.HuntMode.SCAN, hunt_timeout_s=0.6, probe_window_s=0.6,
        recording_dir=str(path / "rec")))
    start_inline(s)
    try:
        if blocks is None:
            # a loud sync-less carrier, FM by a 1 kHz tone (2 kHz deviation): an
            # unmodulated one leaves the C4FM bank's symbol gain saturating
            # the wire for seconds after a retune, in both packages
            t = np.arange(RATE) / RATE
            carrier = np.exp(2j * np.pi * (CARRIER - CENTER) * t + 2j * np.sin(2 * np.pi * 1000.0 * t))
            blocks = scene_blocks([0.25 * make_p25_cc_iq(RATE, CC - CENTER), carrier], CENTER, SCAN_BLOCKS,
                                  s.capture.block_size)
        drive(s, blocks, clock)
        st = s.status()
        out = dict(events=list(s.events), synced=st["synced"], cc=st["controlChannelHz"],
                   meas=[{k: v for k, v in x.items() if k not in ("powerDb", "snrDb")} for x in st["ccMeasurements"]],
                   power={x["frequencyHz"]: x["powerDb"] for x in st["ccMeasurements"]}, tsbks=st["tsbkCount"])
    finally:
        stop_inline(s)
    return out, blocks


def test_scan_on_both_engines_locks_the_quiet_control_channel(tmp_path, clock):
    out, blocks = {}, None
    for pkg in (PORT, REF):
        clock.now = T0
        out[pkg], blocks = scan_system(pkg, tmp_path / pkg, clock, blocks)
    ref, port = out[REF], out[PORT]
    for f, p in ref["power"].items():
        assert abs(port["power"][f] - p) <= 0.2, (f, p, port["power"][f])
    assert canon({k: v for k, v in port.items() if k != "power"}) == canon({k: v for k, v in ref.items()
                                                                          if k != "power"})
    assert port["synced"] and port["cc"] == CC and port["tsbks"] > 0
    meas = {x["frequencyHz"]: x for x in port["meas"]}
    assert meas[CC]["syncDetected"] and not meas[CARRIER]["syncDetected"]
    assert port["power"][CARRIER] > port["power"][CC]  # the carrier is the louder one
    assert [e["type"] for e in port["events"] if e["type"].startswith("control_")][-2:] == \
        ["control_hunt", "control_locked"]
