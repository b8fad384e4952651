"""The port's trunking layer (``wavecap_tpu_torch/trunking``) and
``utils/radioreference.py`` against the JAX package's, on the CPU.

Every case runs once through each package with the same inputs: the same
parsed TSBK / CSBK dicts (parsed by the reference's ``parse_tsbk``), the
same symbol streams, the same IQ blocks.  Both packages' trunking modules
read the clock through a virtual ``time`` (``VClock``), set by the test,
so that events, calls, status and the persisted state are compared
exactly (``canon``), wall-clock fields included.

- The state machine (``tests/test_trunking.py``'s injected-TSBK cases,
  its recorder cases, the DMR terminator gating and the config surface):
  the events, the stub capture's retunes, ``status()``, the state file,
  the calls and the message log are equal, and each reference assertion
  holds on the port.
- The cases deferred to the trunking slice:
  ``test_p25_roundtrip.py::TestSteadyStateCounters``,
  ``test_p25_voice_meta.py::TestCallBookkeeping``,
  ``test_p25_mac.py::TestRecorderWiring``,
  ``test_imbe_vocoder.py::TestRecorderVoicePath``,
  ``test_cqpsk_phase2.py::TestPhase2TrunkingWiring``, the trunking half of
  ``test_config.py`` and the RadioReference cases of ``test_utils.py`` and
  ``test_recovery_and_imports.py``.
- The control channel through the engines: each package's
  ``CaptureManager`` -> ``TrunkingManager`` -> ``TrunkingSystem`` at
  960 kHz takes the same blocks through its capture's
  ``_dispatch_blocks`` (no reader, fetch or pump thread: ``start_inline``,
  then one pump step a published block, ``pump_step``), for P25 Phase 1
  (C4FM control channel and an LDU voice carrier), Phase 2 (CQPSK control
  channel, 6000-baud TDMA voice) and DMR Tier III.  The TSBK / CSBK
  sequence, the grants, the calls (frequency, slot, frames) and the
  events are equal; the control channel's measured power within 0.2 dB.
- The hand-over (``convert.decoder_state_from_reference``): a reference
  recorder handed over mid-call, the port's copy finishing the call with
  the same frames, PCM and sidecar; the monitors, the duplicate detector
  and the scanner; a state file written by the reference's system loading
  in the port's with an equal ``status()``.
"""

from __future__ import annotations

import importlib
import json
import threading
import time as _time
import types
from math import gcd
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import signal as sps

from tests.test_torch_decoders_fec import canon
from tests.test_trunking import make_dmr_stream_iq, make_p25_cc_iq

torch.set_num_threads(1)

REF, PORT = PKGS = ("wavecap_tpu", "wavecap_tpu_torch")
T0 = 1_700_000_000.0  # the virtual clock's start
CLOCKED = ("system", "control", "recorder", "events")


def mods(pkg: str) -> SimpleNamespace:
    """One package's modules by short name."""
    names = dict(
        config="trunking.config", control="trunking.control", events="trunking.events",
        recorder="trunking.recorder", system="trunking.system", manager="trunking.manager",
        cc_scanner="trunking.cc_scanner", trunking="trunking", rr="utils.radioreference",
        wavio="utils.wavio", capture="capture", devices="devices", pf="decoders.p25_frames",
        tsbk="decoders.p25_tsbk", dmr="decoders.dmr", mac="decoders.p25_mac", p2="decoders.p25_phase2",
        ambe="decoders.ambe_vocoder", p25v="decoders.p25_voice", lrrp="decoders.lrrp",
        voice="decoders.voice", iv="decoders.imbe_vocoder",
    )
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()})


class VClock:
    """``time`` as the trunking modules see it: ``time()`` is ``now``, which
    the test sets; everything else is the real module."""

    def __init__(self, now: float = T0):
        self.now = now

    def time(self) -> float:
        return self.now

    def __getattr__(self, name):
        return getattr(_time, name)


@pytest.fixture
def clock(monkeypatch):
    c = VClock()
    for pkg in PKGS:
        for name in CLOCKED:
            monkeypatch.setattr(importlib.import_module(f"{pkg}.trunking.{name}"), "time", c)
    return c


def manager(pkg: str, stations=None):
    m = mods(pkg)
    drv = m.devices.FakeDriver(stations=stations)
    return m.capture.CaptureManager(drv, device="cpu") if pkg == PORT else m.capture.CaptureManager(drv)


class StubCapture:
    def __init__(self, center_hz, sample_rate):
        self.config = SimpleNamespace(center_hz=center_hz, sample_rate=sample_rate)
        self.retunes = []

    def update_channel(self, cid, **kw):
        self.retunes.append((cid, kw))


def make_system(pkg: str, path, **cfg_kw):
    """``tests/test_trunking.py:make_system`` for ``pkg``: a stub capture and
    a pool of two recorders, no threads."""
    m = mods(pkg)
    cfg = m.config.TrunkingSystemConfig(**{"id": "sys1", "control_channels": [851_000_000.0],
                                           "sample_rate": 2_400_000, **cfg_kw})
    sys_ = m.system.TrunkingSystem(cfg, manager(pkg), state_dir=path)
    sys_.capture = StubCapture(851_000_000.0, 2_400_000)
    sys_.pool = m.recorder.RecorderPool(["voice0", "voice1"])
    return sys_


def observe(sys_) -> dict:
    path = sys_._state_path()
    return dict(events=list(sys_.events), retunes=list(getattr(sys_.capture, "retunes", [])),
                status=sys_.status(), state=json.loads(path.read_text()) if path.exists() else None,
                calls=list(sys_.active_calls.values()) + list(sys_.call_history),
                messages=list(sys_.message_log), identity=sys_.identity)


def tsbk_of(opcode, data, nac=0x293) -> dict:
    """A parsed TSBK (the reference's parser) with its NAC, as the monitor hands it on."""
    return {**mods(REF).tsbk.parse_tsbk(int(opcode), 0, data), "nac": nac}


def iden(identifier=1, base=851.0) -> dict:
    return tsbk_of(0x3D, mods(REF).tsbk.make_iden_up_data(identifier=identifier, base_freq_mhz=base))


def grant(tgid, band=1, channel=40, source=5_000_001, opcode=0x00) -> dict:
    return tsbk_of(opcode, mods(REF).tsbk.make_group_grant_data(
        tgid=tgid, source_id=source, band=band, channel_number=channel))


def both(case, tmp_path, clock) -> dict:
    """``case(pkg, path)`` for each package from the same clock; the port's
    result must equal the reference's."""
    out = {}
    for pkg in PKGS:
        clock.now = T0
        out[pkg] = case(pkg, tmp_path / pkg)
    assert canon(out[PORT]) == canon(out[REF])
    return out[PORT]


# --- the state machine: tests/test_trunking.py's injected-TSBK cases ---------------------


def sm_iden_then_grant(pkg, path):
    s = make_system(pkg, path)
    s._handle_tsbk(iden(), None)
    assert 1 in s.identifiers
    s._handle_tsbk(grant(1001), None)
    assert 1001 in s.active_calls
    assert abs(s.active_calls[1001].frequency_hz - (851e6 + 40 * 12500)) < 1
    assert s.capture.retunes and s.capture.retunes[0][0] == "voice0"
    return observe(s)


def sm_grant_without_iden(pkg, path):
    s = make_system(pkg, path)
    s._handle_tsbk(grant(1001, band=7), None)
    assert not s.active_calls
    return observe(s)


def sm_talkgroup_filter(pkg, path):
    m = mods(pkg)
    s = make_system(pkg, path, talkgroups={666: m.config.TalkgroupConfig(tgid=666, monitor=False)})
    s._handle_tsbk({**iden(), "nac": 1}, None)
    s._handle_tsbk({**grant(666, channel=4, source=1), "nac": 1}, None)
    assert not s.active_calls
    return observe(s)


def sm_grant_update_extends(pkg, path):
    s = make_system(pkg, path)
    s._handle_tsbk({**iden(), "nac": 1}, None)
    s._handle_tsbk({**grant(7, channel=4, source=1), "nac": 1}, None)
    n = len(s.capture.retunes)
    s._handle_tsbk({**grant(7, channel=4, source=1, opcode=0x02), "nac": 1}, None)
    assert len(s.capture.retunes) == n
    return observe(s)


def sm_rfss_status(pkg, path):
    s = make_system(pkg, path)
    s._handle_tsbk(tsbk_of(0x3A, mods(REF).tsbk.make_rfss_status_data(
        system_id=0x2F5, rfss_id=1, site_id=3, band=1, channel_number=5)), None)
    assert s.identity.system_id == 0x2F5 and s.identity.site_id == 3
    return observe(s)


def sm_state_roundtrip(pkg, path):
    s = make_system(pkg, path)
    s._handle_tsbk({**iden(identifier=2, base=770.0), "nac": 1}, None)
    s.cc_locked = 851_000_000.0
    s._save_state()
    s2 = make_system(pkg, path)
    assert 2 in s2.identifiers and abs(s2.identifiers[2].base_freq_mhz - 770.0) < 1e-6
    assert s2.cc_locked == 851_000_000.0
    return observe(s2)


class _Mon:
    synced = False

    def reset(self):
        pass


class _NoSpectrum:
    def get_nowait(self):
        return None


def sm_scan_prefers_strongest(pkg, path):
    m = mods(pkg)
    s = make_system(pkg, path)
    s.config.control_channels = [851.0e6, 852.0e6, 853.0e6]
    s.config.hunt_mode = m.config.HuntMode.SCAN
    s.config.hunt_timeout_s = 0.0
    s._cc_power = {851.0e6: -80.0, 852.0e6: -40.0, 853.0e6: -60.0}
    s.monitor, s._spectrum_sub = _Mon(), _NoSpectrum()
    s.cc_index, s.cc_lock_time, s.last_tsbk_time = 0, 0.0, 0.0
    s._check_hunt()
    assert s.config.control_channels[s.cc_index] == 852.0e6
    assert any(c[0] == "cc" for c in s.capture.retunes)
    s.monitor = None
    return observe(s)


def sm_adjacent_and_services(pkg, path):
    t = mods(REF).tsbk
    s = make_system(pkg, path)
    s._handle_tsbk(iden(), None)
    adj = tsbk_of(t.TSBKOpcode.ADJ_STS_BCAST, t.make_adjacent_status_data(
        system_id=0x2F5, rfss_id=2, site_id=9, band=1, channel_number=0x64))
    s._handle_tsbk(adj, None)
    s._handle_tsbk(tsbk_of(t.TSBKOpcode.SYS_SRV_BCAST, t.make_sys_srv_data(0xABCDEF)), None)
    st = s.status()
    assert len(st["adjacentSites"]) == 1 and st["adjacentSites"][0]["siteId"] == 9
    assert abs(st["adjacentSites"][0]["frequencyHz"] - (851e6 + 0x64 * 12500)) < 1
    assert st["services"]["services"] == 0xABCDEF
    s._handle_tsbk(adj, None)
    assert len(s.status()["adjacentSites"]) == 1
    return observe(s)


def sm_hunt_roams_to_adjacent(pkg, path):
    m, t = mods(pkg), mods(REF).tsbk
    s = make_system(pkg, path, hunt_mode=m.config.HuntMode.HUNT, hunt_timeout_s=0.0)
    s._handle_tsbk(iden(), None)
    s._handle_tsbk(tsbk_of(t.TSBKOpcode.ADJ_STS_BCAST, t.make_adjacent_status_data(
        system_id=0x2F5, rfss_id=2, site_id=9, band=1, channel_number=0x40)), None)
    s.monitor, s.last_tsbk_time, s.cc_lock_time, s._spectrum_sub = None, 0.0, 0.0, _NoSpectrum()
    seen = []
    for _ in range(4):
        s._check_hunt()
        if s.capture.retunes:
            seen.append(s.capture.retunes[-1][1].get("frequency_hz"))
    assert any(f and abs(f - (851e6 + 0x40 * 12500)) < 1 for f in seen), seen
    return dict(observe(s), seen=seen)


def sm_tdma_grant_slot(pkg, path):
    t = mods(REF).tsbk
    s = make_system(pkg, path)
    s._handle_tsbk(tsbk_of(t.TSBKOpcode.IDEN_UP_TDMA, t.make_iden_up_tdma_data(
        identifier=2, base_freq_mhz=851.0, channel_type=3)), None)
    ident = s.identifiers[2]
    assert ident.is_tdma and ident.slots_per_carrier == 2 and ident.slot(21) == 1
    s._handle_tsbk(grant(77, band=2, channel=21, source=5), None)
    assert s.active_calls[77].tdma_slot == 1
    return observe(s)


def sm_dmr_csbk_grants(pkg, path):
    """CSBK grants (parsed by the reference's ``parse_csbk``) through
    ``_handle_dmr_csbk`` on a 2-slot Tier III plan: both slots of one
    carrier, then a third talkgroup on a busy slot (skipped), an aloha."""
    m, d = mods(pkg), mods(REF).dmr
    s = make_system(pkg, path, protocol=m.config.TrunkingProtocol.DMR_TIER3, dmr_base_hz=851_000_000.0)
    s.pool = m.recorder.RecorderPool(["voice0", "voice1", "voice2"], protocol="dmr_tier3", dmr_stride=2)
    for bits in (d.make_csbk_bits(0x30, dst_id=800, src_id=900, channel=33),
                 d.make_csbk_bits(0x30, dst_id=801, src_id=901, channel=34),
                 d.make_csbk_bits(0x31, dst_id=802, src_id=902, channel=33),
                 d.make_csbk_bits(0x19, net=0x1234, site=7, ms_id=42)):
        s._handle_dmr_csbk({"colorCode": 1, **d.parse_csbk(bits)}, None)
    assert {800, 801} <= set(s.active_calls) and 802 not in s.active_calls
    assert s.active_calls[800].tdma_slot == 0 and s.active_calls[801].tdma_slot == 1
    assert any(e["type"] == "grant_same_carrier_busy" for e in s.events)
    return observe(s)


def sm_call_end_writes_recording(pkg, path):
    """A grant, LDUs with IMBE codewords into the granted recorder, the hold
    timeout: ``call_end`` and the recording (WAV, .imbe, JSON) as bytes."""
    from tests.test_imbe_vocoder import make_vowel

    m, r = mods(pkg), mods(REF)
    clk = importlib.import_module(f"{pkg}.trunking.system").time
    s = make_system(pkg, path / "state", recording_dir=str(path / "rec"))
    s._handle_tsbk(iden(), None)
    s._handle_tsbk(grant(2001, channel=56, source=42), None)
    rec = s.pool.for_tgid(2001)
    cws = [r.voice.imbe_fec_encode(u) for u in r.iv.ImbeEncoder().encode(make_vowel(seconds=0.8))]
    lc = r.p25v.encode_lc_hexbits(r.p25v.make_group_lc_bits(tgid=2001, source_id=4242))
    for i in range(0, len(cws) - 9, 9):
        clk.now += 0.18
        frame = r.pf.build_ldu_frame(0x293, r.pf.DUID.LDU1 if i % 18 == 0 else r.pf.DUID.LDU2, lc,
                                     imbe_codewords=cws[i:i + 9])
        rec.process_symbols(r.pf.DIBIT_SYMBOLS[frame].astype(np.float32))
    clk.now += s.config.call_hold_s + 0.1
    s._check_call_timeouts()
    assert not s.active_calls and len(s.call_history) == 1
    call = s.call_history[0]
    assert call.source_id == 4242 and call.imbe_frames == 9 * ((len(cws) - 10) // 9 + 1)
    files = {p.suffix: p.read_bytes() for p in (path / "rec" / "sys1").iterdir()}
    assert set(files) == {".wav", ".imbe", ".json"}
    return dict(observe(s), files=files)


STATE_CASES = [sm_iden_then_grant, sm_grant_without_iden, sm_talkgroup_filter, sm_grant_update_extends,
               sm_rfss_status, sm_state_roundtrip, sm_scan_prefers_strongest, sm_adjacent_and_services,
               sm_hunt_roams_to_adjacent, sm_tdma_grant_slot, sm_dmr_csbk_grants, sm_call_end_writes_recording]


@pytest.mark.parametrize("case", STATE_CASES, ids=lambda f: f.__name__)
def test_state_machine_matches_reference(case, tmp_path, clock):
    both(case, tmp_path, clock)


# --- the recorder: tests/test_trunking.py and the deferred recorder cases ----------------


def rec_lrrp(pkg, path):
    m, r = mods(pkg), mods(REF)
    rec = m.recorder.VoiceRecorder(0, "voice0")
    call = m.recorder.CallInfo(tgid=42, source_id=777, frequency_hz=851e6, start_time=0.0)
    rec.assign(call)
    got = []
    rec.on_location = got.append
    frame = r.pf.build_pdu_frame(0x293, r.pf.encode_pdu(
        sap=0x04, llid=777, data=r.lrrp.encode_location_report(47.6062, -122.3321)))
    rec.process_symbols(r.pf.DIBIT_SYMBOLS[frame].astype(np.float32), now=1.0)
    assert got and got[0].radio_id == 777 and abs(got[0].latitude - 47.6062) < 1e-4
    assert abs(call.source_location["longitude"] - (-122.3321)) < 1e-4
    call.source_location.pop("time")  # the report's wall clock (decoders/lrrp.py: its own time.time)
    return dict(call=call, got=[(g.radio_id, g.latitude, g.longitude) for g in got])


def rec_rs_metadata(pkg, path):
    m, r = mods(pkg), mods(REF)
    lc240 = r.p25v.encode_lc_hexbits(r.p25v.make_group_lc_bits(tgid=3141, source_id=271828)).copy()
    for w in np.random.default_rng(4).choice(24, 5, replace=False):
        lc240[10 * w: 10 * (w + 1)] ^= 1
    frame = r.pf.build_ldu_frame(0x293, r.pf.DUID.LDU1, lc240)
    rec = m.recorder.VoiceRecorder(0, "voice0")
    call = m.recorder.CallInfo(tgid=0, source_id=0, frequency_hz=851e6, start_time=0.0)
    rec.assign(call)
    rec.process_symbols(r.pf.DIBIT_SYMBOLS[frame].astype(np.float32), now=1.0)
    assert call.tgid == 3141 and call.source_id == 271828
    return dict(call=call, imbe=rec._imbe, pcm=rec._pcm)


def rec_phase2_bursts(pkg, path):
    m, r = mods(pkg), mods(REF)
    rng = np.random.default_rng(2)
    rec = m.recorder.VoiceRecorder(0, "voice0", protocol="p25_phase2")
    call = m.recorder.CallInfo(tgid=9, source_id=1, frequency_hz=851e6, start_time=0.0, tdma_slot=1)
    rec.assign(call)
    frag = r.p2.build_test_fragment()
    stream = np.concatenate([rng.integers(0, 4, 50).astype(np.uint8), frag, frag])
    rec.process_symbols(r.pf.DIBIT_SYMBOLS[stream].astype(np.float32), now=1.0)
    assert call.imbe_frames >= 2
    out = rec.finalize(path, min_duration_s=0.0, now=2.0)
    ambe = sorted(path.glob("*.ambe"))
    assert out is not None and ambe and ambe[0].stat().st_size >= 2 * 180
    return dict(out=out, files={p.name: p.read_bytes() for p in sorted(path.iterdir())})


def phase2_voice_fragment():
    """``test_recorder_synthesizes_phase2_voice_pcm``'s fragment: slot 1's
    bursts carry AMBE+2 frames of a 155 Hz harmonic tone."""
    r = mods(REF)
    t = np.arange(int(0.5 * 8000)) / 8000.0
    x = sum(a * np.sin(2 * np.pi * 155.0 * k * t) for k, a in ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3)))
    frames = r.ambe.AmbeEncoder().encode((0.3 * x / np.max(np.abs(x))).astype(np.float32))
    frag = np.zeros(r.p2.FRAGMENT_DIBITS, np.uint8)
    frag[180:360] = r.p2.build_voice_burst(frames[0:4])
    frag[540:720] = r.p2.build_voice_burst(frames[4:8], with_sync=True)
    return r.p2.build_test_fragment(frag)


def rec_phase2_pcm(pkg, path):
    m, r = mods(pkg), mods(REF)
    rec = m.recorder.VoiceRecorder(0, "voice0", protocol="p25_phase2")
    rec.assign(m.recorder.CallInfo(tgid=9, source_id=1, frequency_hz=851e6, start_time=0.0, tdma_slot=1))
    sub = rec.audio.subscribe(maxsize=16)
    soft = r.pf.DIBIT_SYMBOLS[phase2_voice_fragment()].astype(np.float32)
    rec.process_symbols(np.concatenate([soft, np.zeros(800, np.float32)]), now=1.0)
    live = sub.get_nowait()
    assert live is not None and len(live) == 4 * 160
    out = rec.finalize(path, min_duration_s=0.0, now=2.0)
    audio, rate = m.wavio.read_audio_wav(sorted(path.glob("*.wav"))[0])
    assert out.audio_seconds > 0 and rate == 8000 and len(audio) == 8 * 160
    seg = audio[320:] - np.mean(audio[320:])
    spec = np.abs(np.fft.rfft(seg * np.hanning(len(seg))))
    assert abs(float(np.fft.rfftfreq(len(seg), 1 / 8000)[np.argmax(spec)]) - 155.0) < 25.0
    return dict(out=out, live=live, audio=audio)


def rec_dmr_terminator(pkg, path):
    m, d = mods(pkg), mods(REF).dmr

    def burst(lc):
        return d.DIBIT_SYMBOLS[d.build_data_burst(lc, d.DataType.TERMINATOR_WITH_LC)].astype(np.float32)

    def term(dst):
        return d.make_full_lc_bits(d.DataType.TERMINATOR_WITH_LC, dst_id=dst)

    rec = m.recorder.VoiceRecorder(0, "v0", protocol="dmr_tier3", dmr_stride=1)
    rec.assign(m.recorder.CallInfo(tgid=800, source_id=0, frequency_hz=460.2e6, start_time=0.0))
    rec.last_activity = 5.0
    rec.process_symbols(burst(term(999)), now=6.0)
    seen = [rec.last_activity]
    lc = term(800)
    lc[8:16] ^= 1
    lc[16:24] ^= 1
    rec.process_symbols(burst(lc), now=6.0)
    seen.append(rec.last_activity)
    rec.process_symbols(burst(term(800)), now=6.0)
    seen.append(rec.last_activity)
    assert seen == [5.0, 5.0, 0.0]
    return seen


def p2_fragment_with(bursts):
    r = mods(REF)
    frag = np.zeros(r.p2.FRAGMENT_DIBITS, np.uint8)
    for i, b in enumerate(bursts):
        frag[i * 180:(i + 1) * 180] = b
    return r.p2.build_test_fragment(frag)


def rec_end_ptt(pkg, path):
    """``test_p25_mac.py::TestRecorderWiring::test_end_ptt_ends_call_promptly``."""
    m, r = mods(pkg), mods(REF)
    rec = m.recorder.VoiceRecorder(0, "voice0", protocol="p25_phase2")
    rec.assign(m.recorder.CallInfo(tgid=10, source_id=1, frequency_hz=852e6, start_time=3.0, tdma_slot=0))
    assert rec.recording
    facch = r.mac.encode_timeslot_burst(r.mac.BURST_FACCH, r.mac.make_mac_end_ptt(10, 1))
    voice = np.random.default_rng(0).integers(0, 4, 180).astype(np.uint8)
    soft = r.p2.DIBIT_SYMBOLS[p2_fragment_with([facch, voice, voice, voice])]
    rec.process_symbols(np.concatenate([np.zeros(50, np.float32), soft]), now=4.0)
    assert rec.last_activity == 0.0
    return dict(call=rec.call, bursts=rec._ambe_bursts, pcm=rec._pcm)


def rec_encrypted_ptt(pkg, path):
    """``test_p25_mac.py::TestRecorderWiring::test_encrypted_ptt_marks_call``."""
    m, r = mods(pkg), mods(REF)
    rec = m.recorder.VoiceRecorder(0, "voice0", protocol="p25_phase2")
    rec.assign(m.recorder.CallInfo(tgid=10, source_id=0, frequency_hz=852e6, start_time=3.0, tdma_slot=0))
    facch = r.mac.encode_timeslot_burst(r.mac.BURST_FACCH, r.mac.make_mac_ptt(tgid=10, source=4321, algid=0x84,
                                                                                 keyid=2))
    voice = np.random.default_rng(0).integers(0, 4, 180).astype(np.uint8)
    rec.process_symbols(r.p2.DIBIT_SYMBOLS[p2_fragment_with([facch, voice, voice, voice])].astype(np.float32),
                        now=4.0)
    assert rec.call.encrypted is True and rec.call.algid == 0x84 and rec.call.keyid == 2
    assert rec.call.source_id == 4321
    return dict(call=rec.call, pcm=rec._pcm)


def rec_ldu_voice_path(pkg, path):
    """``test_imbe_vocoder.py::TestRecorderVoicePath``: LDUs with IMBE
    codewords -> live PCM, an audible 8 kHz WAV and its sidecar."""
    from tests.test_imbe_vocoder import make_vowel

    m, r = mods(pkg), mods(REF)
    cws = [r.voice.imbe_fec_encode(u) for u in r.iv.ImbeEncoder().encode(make_vowel(seconds=1.0))]
    lc240 = r.p25v.encode_lc_hexbits(r.p25v.make_group_lc_bits(tgid=2001, source_id=42))
    rec = m.recorder.VoiceRecorder(0, "voice0")
    sub = rec.audio.subscribe()
    rec.assign(m.recorder.CallInfo(tgid=2001, source_id=42, frequency_hz=851e6, start_time=0.0))
    for i in range(0, len(cws) - 9, 9):
        frame = r.pf.build_ldu_frame(0x293, r.pf.DUID.LDU1, lc240, imbe_codewords=cws[i:i + 9])
        rec.process_symbols(r.pf.DIBIT_SYMBOLS[frame].astype(np.float32), now=1.0)
    live = []
    while (chunk := sub.get_nowait()) is not None:
        live.append(chunk)
    assert live
    done = rec.finalize(path, 0.0, now=2.0)
    assert done is not None and done.audio_seconds > 0.5
    audio, rate = m.wavio.read_audio_wav(str(sorted(path.glob("*.wav"))[0]))
    assert rate == 8000 and float(np.sqrt(np.mean(audio ** 2))) > 0.01
    meta = json.loads(sorted(path.glob("*.json"))[0].read_text())
    assert meta["vocoder"] == "native"
    return dict(done=done, live=live, files={p.suffix: p.read_bytes() for p in path.iterdir()})


def monitor_steady_counters(pkg, path):
    """``test_p25_roundtrip.py::TestSteadyStateCounters``."""
    m, r = mods(pkg), mods(REF)
    mon = m.control.ControlChannelMonitor()
    data = r.tsbk.make_iden_up_data(identifier=1, base_freq_mhz=851.0)
    frame = r.pf.build_tsdu_frame(0x293, [r.pf.encode_tsbk_block(r.tsbk.TSBKOpcode.IDEN_UP, data, last=k == 2)
                                          for k in range(3)])
    sym = r.pf.DIBIT_SYMBOLS[frame].astype(np.float32)
    bad = sym.copy()
    bad[60:200] = -bad[60:200]
    out = [mon.process_symbols(bad, now=0.0) for _ in range(4)]
    out += [mon.process_symbols(sym, now=0.0) for _ in range(m.control.STEADY_MIN_OK + 10)]
    st = mon.stats
    assert st.tsbk_total > st.tsbk_total_steady > 0 and st.crc_rate_steady == 1.0 and st.crc_rate < 1.0
    return dict(stats=st, out=out)


def call_bookkeeping(pkg, path):
    """``test_p25_voice_meta.py::TestCallBookkeeping``."""
    ev = mods(pkg).events
    d = ev.DuplicateDetector(window_s=10.0)
    sig = ev.CallSignature(tgid=1, frequency_hz=851e6)
    dup = [d.is_duplicate(sig, now=0.0), d.is_duplicate(sig, now=5.0), d.is_duplicate(sig, now=14.0),
           d.is_duplicate(ev.CallSignature(tgid=2, frequency_hz=851e6), now=5.0)]
    assert dup == [False, True, True, False]
    t = ev.CallEventTracker(stale_after_s=5, end_after_s=15)
    t.update(1, 851e6, source_id=9, now=0.0)
    t.update(1, 851e6, now=2.0)
    assert t.sweep(now=4.0) == [] and t.events[1].state == "active"
    t.sweep(now=8.0)
    assert t.events[1].state == "stale"
    ended = t.sweep(now=20.0)
    assert len(ended) == 1 and ended[0].updates == 1 and 1 not in t.events
    return dict(dup=dup, suppressed=d.suppressed, ended=ended)


RECORDER_CASES = [rec_lrrp, rec_rs_metadata, rec_phase2_bursts, rec_phase2_pcm, rec_dmr_terminator, rec_end_ptt,
                  rec_encrypted_ptt, rec_ldu_voice_path, monitor_steady_counters, call_bookkeeping]


@pytest.mark.parametrize("case", RECORDER_CASES, ids=lambda f: f.__name__)
def test_recorder_and_monitor_match_reference(case, tmp_path, clock):
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
    both(case, tmp_path, clock)


# --- the config surface, RadioReference, the Phase 2 system's wiring ----------------------


def config_surface(pkg, path):
    """``tests/test_trunking.py:906-952`` and ``test_config.py``'s trunking half."""
    import pathlib

    import yaml

    m = mods(pkg)
    cfg_mod = importlib.import_module(f"{pkg}.utils.config")
    c = m.config.TrunkingSystemConfig.from_dict({"id": "s1", "control_channels": [851.2e6], "modulation": "cqpsk",
                                                 "equalizerTaps": 127, "mesh": "stream=1,time=8"})
    assert (c.modulation, c.equalizer_taps, c.mesh) == ("cqpsk", 127, "stream=1,time=8")
    base = {"id": "s", "control_channels": [851.2e6]}
    taps = [m.config.TrunkingSystemConfig.from_dict({**base, **kw}).effective_equalizer_taps for kw in (
        {"modulation": "cqpsk"}, {}, {"protocol": "dmr_tier3"}, {"protocol": "p25_phase2"},
        {"modulation": "cqpsk", "mesh": "stream=1,time=8"}, {"modulation": "cqpsk", "equalizerTaps": 0},
        {"mesh": "stream=1,time=8", "equalizerTaps": 127}, {"protocol": "p25p2"}, {"protocol": "P25"})]
    assert taps == [41, 0, 0, 0, 0, 0, 127, 0, 0]
    s = make_system(pkg, path, modulation="cqpsk", equalizer_taps=127, mesh=None)
    st = s.status()
    assert (st["modulation"], st["equalizerTaps"], st["mesh"]) == ("cqpsk", 127, None)
    example = pathlib.Path(__file__).resolve().parents[1] / "wavecap.yaml.example"
    ts = m.config.TrunkingSystemConfig.from_dict(
        cfg_mod.config_from_dict(yaml.safe_load(example.read_text())).trunking_systems[0])
    assert ts.sample_rate == 2_400_000 and ts.control_channels[0] == pytest.approx(851.2e6)
    d = m.config.TrunkingSystemConfig(id="d")
    assert (d.sample_rate, d.transport, d.max_voice_channels) == (2_400_000, "i8", 4)
    return dict(c=c, taps=taps, status=st, example=ts, default=d)


RR_XML = """<soap:Envelope><soap:Body><getTrsTalkgroupsResponse><return>
<item><tgDec>101</tgDec><tgAlpha>PD Dispatch</tgAlpha><tgCat>Police</tgCat></item>
<item><tgDec>202</tgDec><tgAlpha></tgAlpha><tgDescr>Fire Tac</tgDescr></item>
<item><tgDec>abc</tgDec></item><item><bogus>x</bogus></item>
</return></getTrsTalkgroupsResponse></soap:Body></soap:Envelope>"""


def radioreference(pkg, path):
    """``test_utils.py``'s and ``test_recovery_and_imports.py``'s
    RadioReference cases: the SOAP response and the CSV export."""
    m = mods(pkg)
    tgs = m.rr.parse_talkgroups_response(RR_XML)
    assert set(tgs) == {101, 202} and tgs[101].name == "PD Dispatch" and tgs[101].category == "Police"
    assert tgs[202].name == "Fire Tac" and m.rr.parse_talkgroups_response("<xml/>") == {}
    p = path / "tg.csv"
    p.write_text("Decimal,Hex,Alpha Tag,Mode,Description,Tag,Category\n101,65,PD-1,D,Police Dispatch 1,Law Dispatch,"
                 "City\n202,CA,FD-1,D,Fire Dispatch,Fire Dispatch,City\nbad,,X,,,,\n303,,,,Ops,,\n")
    csv = m.config.load_talkgroups_csv(p)
    assert csv[101].name == "PD-1" and csv[202].tgid == 202 and csv[303].name == "Ops" and len(csv) == 3
    client = m.rr.RadioReferenceClient("u", "p", "k")
    return dict(tgs=tgs, csv=csv, parsed=m.config.parse_talkgroups_csv(p.read_text().splitlines()),
                client=(client.timeout_s, m.rr._RR_ENDPOINT), envelope=m.rr._ENVELOPE)


def phase2_wiring(pkg, path):
    """``test_cqpsk_phase2.py::TestPhase2TrunkingWiring``, started inline."""
    m = mods(pkg)
    cfg = m.config.TrunkingSystemConfig(id="p2sys", control_channels=[851_000_000.0], sample_rate=2_400_000,
                                        protocol=m.config.TrunkingProtocol.P25_PHASE2, max_voice_channels=3)
    s = m.system.TrunkingSystem(cfg, manager(pkg), state_dir=path)
    start_inline(s)
    try:
        cap = s.capture
        assert (cap.config.p25_capacity, cap.config.p25p2_capacity, cap.config.p25_modulation) == (2, 3, "cqpsk")
        assert cap.channels["cc"].mode_group == "p25" and cap.channels["probe"].mode_group == "p25"
        assert all(cap.channels[f"voice{i}"].mode_group == "p25p2" for i in range(3))
        for rec in s.pool.recorders:
            rec.state = "recording"
        assert s._can_probe()
        s._start_probe(852_000_000.0, now=0.0)
        assert s._probe_slot == "probe" and s.scanner.probe.channel_id == "probe"
        out = dict(config=cap.config, channels={c: (h.spec, h.mode_group, h.slot) for c, h in cap.channels.items()},
                   settle=s.scanner.settle_batches, status=s.status())
    finally:
        stop_inline(s)
    return out


@pytest.mark.parametrize("case", [config_surface, radioreference, phase2_wiring], ids=lambda f: f.__name__)
def test_config_and_wiring_match_reference(case, tmp_path, clock):
    for pkg in PKGS:
        (tmp_path / pkg).mkdir()
    both(case, tmp_path, clock)


def public_names(module) -> set:
    """A module's public names, without the modules it binds (a package's
    submodules appear there once anything has imported them)."""
    return {n for n, v in vars(module).items() if not n.startswith("_") and not isinstance(v, types.ModuleType)}


def test_public_names_match_reference():
    for name in ("trunking", "config", "control", "events", "recorder", "system", "manager", "cc_scanner", "rr"):
        ref, port = getattr(mods(REF), name), getattr(mods(PORT), name)
        assert public_names(ref) <= public_names(port), (name, public_names(ref) - public_names(port))
    for name in ("process_manager", "process_worker"):
        ref, port = (importlib.import_module(f"{pkg}.trunking.{name}") for pkg in PKGS)
        assert public_names(ref) <= public_names(port), (name, public_names(ref) - public_names(port))
    assert mods(PORT).trunking.__all__ == mods(REF).trunking.__all__


# --- the control channel through the engines ---------------------------------------------


class _Gate:
    """A stand-in for the system's stop event: ``is_set`` is False for
    ``steps`` calls, then True, so ``TrunkingSystem._run`` runs exactly that
    many pump iterations on the caller's thread."""

    def __init__(self, steps: int):
        self.steps = steps

    def clear(self):
        pass

    def is_set(self) -> bool:
        self.steps -= 1
        return self.steps < 0


def start_inline(sys_) -> None:
    """``sys_.start()`` without threads: the capture's reader, fetch and
    health threads are not started (blocks go in by ``_dispatch_blocks``),
    and the pump thread leaves at once (``pump_step`` runs its loop)."""
    mgr = sys_.capture_manager
    create = mgr.create_capture

    def no_threads(**kw):
        cap = create(**kw)
        cap.start = lambda: None
        cap._stream_realtime = False  # no adaptive transport: the blocks are not paced
        return cap

    mgr.create_capture = no_threads
    sys_._stop = _Gate(0)
    try:
        sys_.start()
    finally:
        del mgr.create_capture
    sys_._thread.join(timeout=30)
    assert not sys_._thread.is_alive() and sys_.state == "running", sys_.error
    sys_._thread = None


def pump_step(sys_) -> None:
    sys_._stop = _Gate(1)
    sys_._run()
    assert sys_.state == "running", sys_.error


def stop_inline(sys_) -> None:
    sys_._stop = threading.Event()
    sys_.stop()


def drive(sys_, blocks, clock) -> None:
    """The blocks through the system's capture, two a dispatch (its
    ``blocks_per_dispatch``); after each published block the clock moves
    on a block and the pump runs once; every subscription is drained."""
    cap = sys_.capture
    block_s = cap.block_size / cap.config.sample_rate
    for j in range(0, len(blocks), 2):
        cap._dispatch_blocks(blocks[j:j + 2])
        for _ in blocks[j:j + 2]:
            clock.now += block_s
            pump_step(sys_)
    subs = [sys_._cc_sub, *sys_._voice_subs.values()]
    assert all(s.get_nowait() is None and s.dropped == 0 for s in subs)


def scene_blocks(loops, center, n_blocks, block_size) -> list:
    m = mods(PORT)
    stations = [m.devices.FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=np.asarray(x, np.complex64),
                                      amplitude=1.0) for x in loops]
    dev = m.devices.FakeDriver(1, stations).open("fake0")
    dev.configure(m.devices.DeviceConfig(center_hz=center, sample_rate=RATE))
    stream = dev.start_stream()
    return [stream.read(block_size)[0] for _ in range(n_blocks)]


def at(iq48, rate, offset) -> np.ndarray:
    g = gcd(rate, 48_000)
    iq = sps.resample_poly(iq48, rate // g, 48_000 // g)
    return (iq * np.exp(2j * np.pi * offset * np.arange(len(iq)) / rate)).astype(np.complex64)


RATE = 960_000


def p1_scene():
    """The C4FM control channel of ``make_p25_cc_iq`` (IDEN_UP, a grant of
    talkgroup 2001 to channel 56, RFSS status) and, at the granted 851.7 MHz,
    LDU1s with IMBE codewords (``tests/test_mesh_capture.py:517-560``)."""
    from tests.test_imbe_vocoder import make_vowel

    r = mods(REF)
    center, cc = 851_500_000.0, 851_200_000.0
    cws = [r.voice.imbe_fec_encode(u) for u in r.iv.ImbeEncoder().encode(make_vowel(seconds=1.0))]
    lc = r.p25v.encode_lc_hexbits(r.p25v.make_group_lc_bits(tgid=2001, source_id=42))
    frames = [r.pf.build_ldu_frame(0x293, r.pf.DUID.LDU1, lc, imbe_codewords=cws[i:i + 9])
              for i in range(0, len(cws) - 9, 9)]
    c4fm = importlib.import_module(f"{PORT}.models.p25.c4fm")
    voice = at(c4fm.modulate_c4fm(np.concatenate(frames * 2), 48_000.0), RATE, 851e6 + 56 * 12_500.0 - center)
    cfg = dict(id="p1", control_channels=[cc], center_hz=center, sample_rate=RATE, max_voice_channels=2)
    return cfg, [make_p25_cc_iq(RATE, cc - center), voice]


def p2_scene():
    """``tests/test_trunking.py::TestPhase2Trunking``'s scene: a CQPSK
    control channel with IDEN_UP_TDMA and a slot-1 grant, and the 6000-baud
    voice carrier with slot-1 AMBE+2 fragments."""
    r = mods(REF)
    cqpsk = importlib.import_module(f"{PORT}.models.p25.cqpsk")
    center, cc = 851_500_000.0, 851_200_000.0
    blocks = [r.pf.encode_tsbk_block(r.tsbk.TSBKOpcode.IDEN_UP_TDMA, r.tsbk.make_iden_up_tdma_data(
                  identifier=2, base_freq_mhz=851.0, channel_type=3), last=False),
              r.pf.encode_tsbk_block(r.tsbk.TSBKOpcode.GRP_V_CH_GRANT, r.tsbk.make_group_grant_data(
                  tgid=901, source_id=77, band=2, channel_number=21)),
              r.pf.encode_tsbk_block(r.tsbk.TSBKOpcode.RFSS_STS_BCAST, r.tsbk.make_rfss_status_data(
                  system_id=0x2B7, rfss_id=1, site_id=4, band=2, channel_number=0), last=True)]
    cc_iq = at(cqpsk.modulate_cqpsk(np.concatenate([r.pf.build_tsdu_frame(0x293, blocks)] * 24), 48_000.0, 4800.0),
               RATE, cc - center)
    v_iq = at(cqpsk.modulate_cqpsk(np.concatenate([phase2_voice_fragment()] * 12), 48_000.0, 6000.0, alpha=1.0),
              RATE, 851_125_000.0 - center)
    cfg = dict(id="p2", protocol="p25_phase2", control_channels=[cc], center_hz=center, sample_rate=RATE,
               max_voice_channels=2)
    return cfg, [cc_iq, v_iq]


def dmr_scene():
    """``tests/test_trunking.py::TestDmrTier3Trunking``'s dual-slot scene:
    PV_GRANTs of talkgroups 800 / 801 to both slots of 460.2 MHz, and that
    carrier's two slots of AMBE voice."""
    r = mods(REF)
    center, cc = 460_150_000.0, 460_100_000.0
    cc_dibits = np.concatenate([
        r.dmr.build_data_burst(r.dmr.make_csbk_bits(0x30, dst_id=800, src_id=900, channel=33), r.dmr.DataType.CSBK),
        r.dmr.build_data_burst(r.dmr.make_csbk_bits(0x30, dst_id=801, src_id=901, channel=34), r.dmr.DataType.CSBK),
    ] * 8)

    def tone_frames(f0):
        t = np.arange(int(0.6 * 8000)) / 8000.0
        x = sum(a * np.sin(2 * np.pi * f0 * k * t) for k, a in ((1, 1.0), (2, 0.6), (3, 0.45)))
        return r.ambe.AmbeEncoder().encode((0.3 * x / np.max(np.abs(x))).astype(np.float32))[:18]

    voice = r.dmr.build_dual_slot_voice_stream(tone_frames(150.0), tone_frames(250.0))
    cfg = dict(id="dmr", protocol="dmr_tier3", control_channels=[cc], center_hz=center, sample_rate=RATE,
               max_voice_channels=2, dmr_base_hz=460_000_000.0, min_call_duration_s=0.0)
    return cfg, [make_dmr_stream_iq(RATE, cc - center, cc_dibits),
                 make_dmr_stream_iq(RATE, 460_200_000.0 - center, voice)]


ENGINE_BLOCKS = 8


def run_system(pkg, scene, path, clock, blocks=None) -> dict:
    """The scene through ``pkg``'s ``TrunkingManager`` -> ``TrunkingSystem``
    on its engine (the CPU for the port), inline."""
    m = mods(pkg)
    cfg_kw, loops = scene()
    mgr = manager(pkg)
    tm = m.manager.TrunkingManager(mgr, state_dir=path / "state")
    s = tm.create_system(m.config.TrunkingSystemConfig.from_dict({**cfg_kw, "recording_dir": str(path / "rec")}))
    start_inline(s)
    try:
        if blocks is None:
            blocks = scene_blocks(loops, cfg_kw["center_hz"], ENGINE_BLOCKS, s.capture.block_size)
        drive(s, blocks, clock)
        recs = [dict(call=r.call, imbe=r._imbe, pcm=r._pcm, ambe=r._ambe_bursts) for r in s.pool.recorders]
        st = s.status()
        power = {m_["frequencyHz"]: m_.pop("powerDb") for m_ in st["ccMeasurements"]}
        for m_ in st["ccMeasurements"]:
            m_.pop("snrDb")
        out = dict(messages=list(s.message_log), events=list(s.events), status=st, power=power, recorders=recs,
                   calls=list(s.active_calls.values()) + list(s.call_history), block_size=s.capture.block_size,
                   identifiers=s.identifiers)
    finally:
        stop_inline(s)
    out["state"] = json.loads(s._state_path().read_text())
    return out, blocks


def engines(scene, tmp_path, clock) -> dict:
    out, blocks = {}, None
    for pkg in (PORT, REF):
        clock.now = T0
        out[pkg], blocks = run_system(pkg, scene, tmp_path / pkg, clock, blocks)
    return out


def check_engines(out) -> dict:
    ref, port = out[REF], out[PORT]
    for f, p in ref["power"].items():
        assert abs(port["power"][f] - p) <= 0.2, (f, p, port["power"][f])
    strip = ("power",)
    assert canon({k: v for k, v in port.items() if k not in strip}) == \
        canon({k: v for k, v in ref.items() if k not in strip})
    return port


def test_phase1_control_channel_through_both_engines(tmp_path, clock):
    port = check_engines(engines(p1_scene, tmp_path, clock))
    st = port["status"]
    assert st["synced"] and st["nac"] == 0x293 and st["systemId"] == 0x123 and st["siteId"] == 7
    assert st["tsbkCount"] >= 3 * 6 and st["tsbkCrcRate"] > 0.5 and st["tsbkCrcRateSteady"] == 1.0
    call = next(c for c in port["calls"] if c.tgid == 2001)
    assert abs(call.frequency_hz - (851e6 + 56 * 12_500)) < 1 and call.imbe_frames >= 9
    assert any(r["pcm"] for r in port["recorders"])


def test_phase2_control_channel_through_both_engines(tmp_path, clock):
    port = check_engines(engines(p2_scene, tmp_path, clock))
    assert port["status"]["synced"] and port["status"]["systemId"] == 0x2B7
    call = next(c for c in port["calls"] if c.tgid == 901)
    assert abs(call.frequency_hz - 851_125_000.0) < 1 and call.tdma_slot == 1 and call.source_id == 77
    assert call.imbe_frames >= 8 and any(r["pcm"] for r in port["recorders"])


def test_dmr_tier3_through_both_engines(tmp_path, clock):
    port = check_engines(engines(dmr_scene, tmp_path, clock))
    assert port["status"]["synced"]
    calls = {c.tgid: c for c in port["calls"]}
    assert {800, 801} <= set(calls) and calls[800].tdma_slot == 0 and calls[801].tdma_slot == 1
    assert all(abs(calls[t].frequency_hz - 460_200_000.0) < 1 for t in (800, 801))
    assert any(m.get("type") == "PV_GRANT" for m in port["messages"])
    assert not any(e["type"] == "grant_same_carrier_busy" for e in port["events"])
    assert all(calls[t].imbe_frames > 0 for t in (800, 801))


# --- the hand-over: convert.decoder_state_from_reference ----------------------------------


def test_recorder_handed_over_mid_call_finishes_the_same(tmp_path, clock):
    """A reference recorder takes half a call's LDUs, the port's copy the
    rest: the frames, PCM, call and sidecar equal the reference recorder's
    alone."""
    from tests.test_imbe_vocoder import make_vowel
    from wavecap_tpu_torch import convert

    r = mods(REF)
    cws = [r.voice.imbe_fec_encode(u) for u in r.iv.ImbeEncoder().encode(make_vowel(seconds=1.0))]
    lc = r.p25v.encode_lc_hexbits(r.p25v.make_group_lc_bits(tgid=2001, source_id=42))
    soft = np.concatenate([r.pf.DIBIT_SYMBOLS[r.pf.build_ldu_frame(
        0x293, r.pf.DUID.LDU1 if i % 18 == 0 else r.pf.DUID.LDU2, lc, imbe_codewords=cws[i:i + 9])]
        for i in range(0, len(cws) - 9, 9)]).astype(np.float32)
    cut = len(soft) // 2 + 77  # inside a frame

    def fresh():
        rec = r.recorder.VoiceRecorder(1, "voice1")
        rec.assign(r.recorder.CallInfo(tgid=2001, source_id=0, frequency_hz=851.7e6, start_time=T0))
        return rec

    alone = fresh()
    alone.process_symbols(soft, now=T0 + 1)
    half = fresh()
    half.process_symbols(soft[:cut], now=T0 + 1)
    port = convert.decoder_state_from_reference(half)
    assert type(port).__module__ == "wavecap_tpu_torch.trunking.recorder"
    assert type(port.call).__module__ == "wavecap_tpu_torch.trunking.recorder"
    port.process_symbols(soft[cut:], now=T0 + 1)
    assert canon(port._imbe) == canon(alone._imbe) and canon(port._pcm) == canon(alone._pcm)
    assert canon(port.call) == canon(alone.call)
    files = {}
    for name, rec in (("ref", alone), ("port", port)):
        rec.finalize(tmp_path / name, 0.0, now=T0 + 3)
        files[name] = {p.name: p.read_bytes() for p in (tmp_path / name).iterdir()}
    assert files["port"] == files["ref"] and len(files["ref"]) == 3


def test_trunking_host_objects_hand_over(clock):
    """The monitors, the duplicate detector and the scanner (with a probe in
    flight) as the port's: the same state, and fed the same symbols from
    there the same output as the reference's."""
    from wavecap_tpu_torch import convert

    r = mods(REF)
    frame = r.pf.build_tsdu_frame(0x293, [r.pf.encode_tsbk_block(
        r.tsbk.TSBKOpcode.IDEN_UP, r.tsbk.make_iden_up_data(identifier=1, base_freq_mhz=851.0), last=True)])
    p25 = np.tile(r.pf.DIBIT_SYMBOLS[frame].astype(np.float32), 4)
    csbk = r.dmr.build_data_burst(r.dmr.make_csbk_bits(0x30, dst_id=800, src_id=900, channel=3), r.dmr.DataType.CSBK)
    dmr_soft = np.tile(r.dmr.DIBIT_SYMBOLS[csbk].astype(np.float32), 4)
    cut = 500
    for make, soft in ((r.control.ControlChannelMonitor, p25), (r.control.DmrControlMonitor, dmr_soft)):
        a, b = make(), make()
        out_a = a.process_symbols(soft, now=1.0)
        out_b = b.process_symbols(soft[:cut], now=1.0)
        port = convert.decoder_state_from_reference(b)
        assert type(port).__module__.startswith(PORT + ".") and canon(vars(port)) == canon(vars(b))
        out_b += port.process_symbols(soft[cut:], now=1.0)
        assert canon(out_b) == canon(out_a) and canon(port.stats) == canon(a.stats)
    d = r.events.DuplicateDetector(window_s=3.0)
    sig = r.events.CallSignature(tgid=5, frequency_hz=851e6)
    d.is_duplicate(sig, now=1.0)
    pd = convert.decoder_state_from_reference(d)
    assert pd.is_duplicate(mods(PORT).events.CallSignature(tgid=5, frequency_hz=851e6), now=2.0)
    assert d.is_duplicate(sig, now=2.0) and pd.suppressed == d.suppressed == 1
    sc = r.cc_scanner.CCScanner(probe_window_s=0.5)
    sc.measurements[852e6] = r.cc_scanner.CCMeasurement(852e6, power_db=-40, snr_db=40, time=1.0)
    sc.start_probe(851.2e6, "voice0", now=0.0)
    sc.feed("voice0", p25, now=0.05)
    sc.feed("voice0", p25[:cut], now=0.1)
    ps = convert.decoder_state_from_reference(sc)
    for x in (sc, ps):
        x.feed("voice0", p25[cut:], now=0.2)
    got = [x.poll(1.0) for x in (sc, ps)]
    assert got[0].sync_detected and canon(got[1]) == canon(got[0])
    assert ps.best([852e6, 851.2e6]) == sc.best([852e6, 851.2e6]) == 851.2e6
    with pytest.raises(TypeError):
        convert.decoder_state_from_reference(r.recorder.RecorderPool(["v0"]))


def test_reference_state_file_loads_in_the_port(tmp_path, clock):
    """A state file written by the reference's ``TrunkingSystem`` (IDEN_UP,
    TDMA identifier, identity, hunt index, locked CC) loads in the port's
    system: an equal ``status()``, and the port writes it back unchanged."""
    t = mods(REF).tsbk
    ref = make_system(REF, tmp_path, control_channels=[851e6, 852e6])
    for p in (iden(), iden(identifier=3, base=770.0), tsbk_of(t.TSBKOpcode.IDEN_UP_TDMA, t.make_iden_up_tdma_data(
            identifier=2, base_freq_mhz=851.0, channel_type=3)), tsbk_of(0x3A, t.make_rfss_status_data(
            system_id=0x2F5, rfss_id=1, site_id=3, band=1, channel_number=5))):
        ref._handle_tsbk(p, None)
    ref.cc_index, ref.cc_locked = 1, 852e6
    ref._save_state()
    written = ref._state_path().read_text()
    port = make_system(PORT, tmp_path, control_channels=[851e6, 852e6])
    fresh = make_system(REF, tmp_path, control_channels=[851e6, 852e6])
    assert canon(port.status()) == canon(fresh.status())
    assert port.cc_index == 1 and port.cc_locked == 852e6 and set(port.identifiers) == {1, 2, 3}
    port._save_state()
    assert port._state_path().read_text() == written
