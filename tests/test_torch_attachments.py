"""The port's channel attachments (``capture/attachments.py``) and scanner
(``capture/scanner.py``) against the JAX package's, on the CPU.

One seeded scene at 1.2 Msps (25 kHz bins, M = 48, 0.2 s blocks) carries
a 1200-baud POCSAG pager and a FLEX pager (FM at 4.5 and 4.8 kHz, as
``tests/test_attachments_live.py`` builds them), a WBFM station with RDS
(PI, PS, RadioText) and a DMR station of CSBK bursts
(``tests/test_dmr_csbk.py::TestDmrOverRF``).  Both packages'
``CaptureManager`` -> ``create_capture`` -> ``create_channel`` take the
same blocks through ``_dispatch_blocks`` (each batch drains inline); the
pagers' channels are ``nbfm`` with the server's attachment overrides,
the wide slot exports its baseband, the DMR channel is ``dmr`` on the
symbol bank.  Each package's attachments (``PocsagAttachment``,
``FlexAttachment``, ``RdsAttachment``, ``DmrAttachment``) decode its own
engine's published batches, block by block:

- the messages (wall-clock ``time`` left out) are equal, message for
  message, and they are what the stations sent (a page the block's end
  cut short is a prefix of the page sent);
- cross-feed: the port's attachments on the reference engine's batches
  give exactly the reference attachments' messages;
- the port's attachments on their own threads (``channel.audio`` /
  ``baseband`` / ``symbols`` subscriptions, waited for by their
  ``batches`` count) give the same messages as fed by hand.

The P25 and DMR attachment cases of ``tests/test_misc_components.py``
run through both packages on hand-fed fan-outs, and the scanner's cases
(``tests/test_aux_decoders.py::TestScanner``,
``tests/test_utils.py::TestScannerPauseSemantics``) through both
packages' ``ScannerService``.  Then the scanner on each package's engine
under a virtual clock (the scanner's ``time``, which dispatches each
block when its time comes): the same retunes and stops on both, only on
the entry with a carrier, and no program rebuilt.  Last, the port's one
divergence: ``RdsAttachment`` decodes at the wide slots' true IF rate
(10 Msps: 243,902 Hz), where the reference's ``WIDE_RATE`` finds no
group.
"""

from __future__ import annotations

import importlib
import time
from math import gcd
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import signal as sps

from tests.test_torch_decoders_fec import canon
from wavecap_tpu import capture as jcapture
from wavecap_tpu.devices import FakeDriver as JFakeDriver
from wavecap_tpu_torch import capture as tcapture
from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

torch.set_num_threads(1)

PKGS = ("wavecap_tpu", "wavecap_tpu_torch")
RATE, CENTER = 1_200_000, 152_000_000.0
N_BLOCKS = 12
PAGER_DSP = {"enable_highpass": False, "enable_lowpass": False}
POCSAG_PAGE = (133_7000, "HELLO WORLD")
FLEX_PAGE = (1_234_567, "TEST PAGE")
RDS = (0x2345, "WAVECAP ", "RDS ON THE PORT")
RDS_LEAD_BITS = 0.25  # where both parities of 0.2 s block decode (237.5 bits a block)
# channel: (mode, bin, dsp)
CHANNELS = {"pg": ("nbfm", 4, PAGER_DSP), "fx": ("nbfm", 8, PAGER_DSP), "fm": ("wbfm", -12, {}),
            "d": ("dmr", 14, {})}
CONFIG = dict(center_hz=CENTER, sample_rate=RATE, channel_bandwidth=25_000.0, block_seconds=0.2,
              narrow_capacity=2, wide_capacity=1, p25_capacity=1, transport="i16", adaptive_transport=False)


def att_mod(pkg: str):
    return importlib.import_module(f"{pkg}.capture.attachments")


def fm_at(audio48: np.ndarray, deviation: float, offset: float) -> np.ndarray:
    phase = 2 * np.pi * deviation * np.cumsum(np.asarray(audio48, np.float64)) / 48_000
    g = gcd(RATE, 48_000)
    iq = sps.resample_poly(np.exp(1j * phase), RATE // g, 48_000 // g)
    return iq * np.exp(2j * np.pi * offset * np.arange(len(iq)) / RATE)


def rds_station(offset: float) -> np.ndarray:
    """A WBFM station whose 240 kHz baseband carries a program tone, the
    pilot and RDS groups 0A (PS) and 2A (RadioText), at 75 kHz deviation
    (``tests/test_attachments_live.py:27-46``)."""
    from wavecap_tpu_torch.decoders import rds

    pi, ps, rt = RDS
    rt = rt.ljust(-(-len(rt) // 4) * 4)
    groups = [rds.encode_group(pi, 0, seg, 0xE201, (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])) for seg in range(4)]
    groups += [rds.encode_group(pi, 2, seg, (ord(rt[4 * seg]) << 8) | ord(rt[4 * seg + 1]),
                                (ord(rt[4 * seg + 2]) << 8) | ord(rt[4 * seg + 3])) for seg in range(len(rt) // 4)]
    fs_bb = 240_000
    base = np.asarray(rds.modulate_rds(np.concatenate(groups * 4), fs_bb, amplitude=0.12), np.float64)
    base = np.concatenate([np.zeros(int(round(RDS_LEAD_BITS * fs_bb / rds.RDS_BITRATE))), base])
    program = 0.4 * np.sin(2 * np.pi * 1000 * np.arange(len(base)) / fs_bb) + base
    up = sps.resample_poly(program, RATE // fs_bb, 1)
    phase = 2 * np.pi * 75_000 * np.cumsum(up) / RATE
    return np.exp(1j * phase) * np.exp(2j * np.pi * offset * np.arange(len(up)) / RATE)


def dmr_station(offset: float) -> np.ndarray:
    from wavecap_tpu_torch.decoders import dmr
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm

    csbk = dmr.make_csbk_bits(0x30, dst_id=800, src_id=900, channel=3)
    stream = np.concatenate([dmr.build_data_burst(csbk, dmr.DataType.CSBK)] * 40)
    iq48 = modulate_c4fm(stream, 48_000.0, deviation_hz=1944.0)
    g = gcd(RATE, 48_000)
    iq = sps.resample_poly(iq48, RATE // g, 48_000 // g)
    return iq * np.exp(2j * np.pi * offset * np.arange(len(iq)) / RATE)


_SCENE: dict = {}


def scene() -> dict:
    """The blocks and every package's published batches (computed once)."""
    if _SCENE:
        return _SCENE
    from wavecap_tpu_torch.decoders import flex, pocsag

    ch = ChannelizerConfig(sample_rate=float(RATE), channel_bandwidth=25_000.0)
    off = {cid: ch.channel_offset_hz(b % ch.channel_count) for cid, (_, b, _) in CHANNELS.items()}
    pager = pocsag.modulate_pocsag(pocsag.encode_message(*POCSAG_PAGE), 48_000, 1200)
    fx = flex.modulate_flex(flex.encode_frame(*FLEX_PAGE), 48_000)
    loops = [fm_at(np.concatenate([pager, np.zeros(4800, np.float32)]), 4500.0, off["pg"]),
             fm_at(np.concatenate([fx, np.zeros(9600, np.float32)]), 4800.0, off["fx"]),
             rds_station(off["fm"]), dmr_station(off["d"])]
    stations = [FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=(0.2 * x).astype(np.complex64), amplitude=1.0)
                for x in loops]
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(center_hz=CENTER, sample_rate=RATE))
    stream = dev.start_stream()
    jcap = jcapture.CaptureManager(JFakeDriver(1)).create_capture(config=jcapture.CaptureConfig(**CONFIG))
    tcap = tcapture.CaptureManager(FakeDriver(1), device="cpu").create_capture(config=tcapture.CaptureConfig(**CONFIG))
    assert jcap.block_size == tcap.block_size == 240_000
    blocks = [stream.read(tcap.block_size)[0] for _ in range(N_BLOCKS)]
    _SCENE.update(off=off, blocks=blocks, ref=run_engine(jcapture, jcap, blocks, off),
                  port=run_engine(tcapture, tcap, blocks, off, threaded=True))
    return _SCENE


def run_engine(cap_mod, cap, blocks, off, threaded: bool = False) -> dict:
    """Every channel's published batches, one per block: the pagers' audio,
    the wide slot's baseband (its export on, as ``RdsAttachment`` turns it
    on), the DMR channel's symbols.  With ``threaded`` the port's real
    attachments ride along on the channels, waited for after each block."""
    handles = {cid: cap.create_channel(cap_mod.ChannelSpec(id=cid, mode=mode, frequency_hz=CENTER + off[cid],
                                                           dsp=dict(dsp)))
               for cid, (mode, _, dsp) in CHANNELS.items()}
    cap.enable_wide_baseband()
    fans = {"pg": "audio", "fx": "audio", "fm": "baseband", "d": "symbols"}
    subs = {cid: getattr(handles[cid], fans[cid]).subscribe(maxsize=4) for cid in handles}
    atts = {}
    if threaded:
        a = att_mod(PKGS[1])
        atts = {"pg": a.PocsagAttachment(handles["pg"]), "fx": a.FlexAttachment(handles["fx"]),
                "fm": a.RdsAttachment(handles["fm"], capture=cap), "d": a.DmrAttachment(handles["d"])}
    out = {cid: [] for cid in subs}
    try:
        for k, block in enumerate(blocks):
            cap._dispatch_blocks([block])
            for cid, sub in subs.items():
                out[cid].append(sub.get_nowait())
                assert out[cid][-1] is not None and sub.get_nowait() is None and sub.dropped == 0
            t0 = time.time()
            while any(x.batches < k + 1 for x in atts.values()):
                assert time.time() - t0 < 60, "an attachment did not take its batch"
                time.sleep(0.002)
            assert all(x.errors == 0 and x._sub.dropped == 0 for x in atts.values())
    finally:
        for x in atts.values():
            x.stop()
    assert cap.blocks_processed == len(blocks) and cap.state != "failed"
    out["threaded"] = {cid: strip(x.messages) for cid, x in atts.items()}
    return out


def strip(msgs) -> list:
    return [{k: v for k, v in m.items() if k != "time"} for m in msgs]


def stand_in(pkg: str, cid: str):
    fan = importlib.import_module(f"{pkg}.utils.broadcast").FanOut
    return SimpleNamespace(id=cid, audio=fan(maxsize=4096), symbols=fan(maxsize=16), baseband=fan(maxsize=16))


def by_hand(pkg: str, batches: dict) -> dict:
    """Each channel's batches through a fresh attachment of ``pkg``,
    ``process`` called block by block on this thread."""
    a = att_mod(pkg)
    cap = SimpleNamespace(config=SimpleNamespace(sample_rate=RATE), enable_wide_baseband=lambda: None)
    atts = {"pg": a.PocsagAttachment(stand_in(pkg, "pg")), "fx": a.FlexAttachment(stand_in(pkg, "fx")),
            "fm": a.RdsAttachment(stand_in(pkg, "fm"), capture=cap), "d": a.DmrAttachment(stand_in(pkg, "d"))}
    try:
        out = {cid: [] for cid in atts}
        for cid, att in atts.items():
            for b in batches[cid]:
                payload = b if isinstance(b, dict) else np.asarray(b, np.float32)
                out[cid] += att.process(payload)
        return {cid: strip(m) for cid, m in out.items()}
    finally:
        for att in atts.values():
            att.stop()


def check_sent(msgs: dict) -> None:
    pages = [(m["address"], m["content"]) for m in msgs["pg"]]
    assert (POCSAG_PAGE[0], POCSAG_PAGE[1]) in pages, pages
    assert all(a == POCSAG_PAGE[0] and POCSAG_PAGE[1].startswith(c) for a, c in pages), pages
    frames = [(m["capcode"], m["content"]) for m in msgs["fx"]]
    assert FLEX_PAGE in frames and all(f == FLEX_PAGE for f in frames), frames
    last = msgs["fm"][-1]
    assert (last["pi"], last["ps"], last["radiotext"]) == RDS, last
    grants = [m for m in msgs["d"] if m.get("type") == "PV_GRANT"]
    assert len(grants) >= 10 and all((g["dst_id"], g["src_id"], g["channel"]) == (800, 900, 3) for g in grants)


def test_attachments_on_each_engine_match_reference():
    s = scene()
    ref = by_hand(PKGS[0], s["ref"])
    got = by_hand(PKGS[1], s["port"])
    assert canon(got) == canon(ref)
    check_sent(got)


def test_port_attachments_on_reference_batches():
    s = scene()
    assert canon(by_hand(PKGS[1], s["ref"])) == canon(by_hand(PKGS[0], s["ref"]))


def test_threaded_attachments_match_hand_fed():
    s = scene()
    assert canon(s["port"]["threaded"]) == canon(by_hand(PKGS[1], s["port"]))


def test_engine_batches_match_reference():
    """The published batches the attachments eat: audio and baseband >= 50
    dB against the reference engine's, the DMR symbols within a wire step."""
    from tests.conftest import snr_db

    s = scene()
    for cid in ("pg", "fx", "fm"):
        for k, (r, g) in enumerate(zip(s["ref"][cid], s["port"][cid])):
            assert r.shape == g.shape and snr_db(r, g) >= 50.0, (cid, k, snr_db(r, g))
    for k, (r, g) in enumerate(zip(s["ref"]["d"], s["port"]["d"])):
        assert np.max(np.abs(np.asarray(r["soft"], np.float64) - np.asarray(g["soft"], np.float64))) <= 1 / 16 + 1e-9


# --- the P25 and DMR attachments on hand-fed fan-outs (tests/test_misc_components.py) ---


def p25_case(pkg):
    from wavecap_tpu_torch.decoders import p25_frames as pf
    from wavecap_tpu_torch.decoders import p25_tsbk as tsbk

    ch = stand_in(pkg, "chx")
    att = att_mod(pkg).P25Attachment(ch)
    try:
        rfss = pf.encode_tsbk_block(tsbk.TSBKOpcode.RFSS_STS_BCAST, tsbk.make_rfss_status_data(
            system_id=0x111, rfss_id=1, site_id=4, band=1, channel_number=2))
        last = pf.encode_tsbk_block(tsbk.TSBKOpcode.IDEN_UP, tsbk.make_iden_up_data(identifier=1, base_freq_mhz=851.0),
                                    last=True)
        frame = pf.build_tsdu_frame(0x293, [rfss, rfss, last])
        ch.symbols.publish({"soft": pf.DIBIT_SYMBOLS[frame].astype(np.float32), "dibits": frame, "rssi": -40.0})
        t0 = time.time()
        while len(att.messages) < 3 and time.time() - t0 < 10:
            time.sleep(0.01)
        return strip(att.messages), att.status()
    finally:
        att.stop()


def dmr_case(pkg):
    from wavecap_tpu_torch.decoders import dmr
    from wavecap_tpu_torch.decoders.ambe_vocoder import AmbeEncoder

    ch = stand_in(pkg, "chd")
    att = att_mod(pkg).DmrAttachment(ch)
    pcm = ch.audio.subscribe(maxsize=16)
    try:
        burst = dmr.build_data_burst(dmr.make_csbk_bits(0x30, dst_id=800, src_id=900, channel=3), dmr.DataType.CSBK)
        t = np.arange(int(0.6 * 8000)) / 8000.0
        x = sum(a * np.sin(2 * np.pi * 160.0 * k * t) for k, a in ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3), (5, 0.2)))
        ambe = AmbeEncoder().encode((0.3 * x / np.max(np.abs(x))).astype(np.float32))[:18]
        voice = dmr.build_voice_superframe(ambe, rng=np.random.default_rng(21))
        ch.symbols.publish({"soft": dmr.DIBIT_SYMBOLS[np.concatenate([burst, voice])].astype(np.float32), "rssi": -50.0})
        t0 = time.time()
        while len(att.messages) < 2 and time.time() - t0 < 10:
            time.sleep(0.01)
        time.sleep(0.1)
        return strip(att.messages), att.status(), pcm.get_nowait()
    finally:
        pcm.close()
        att.stop()


@pytest.mark.parametrize("case", [p25_case, dmr_case], ids=lambda f: f.__name__)
def test_p25_and_dmr_attachments_match_reference(case):
    ref, got = case(PKGS[0]), case(PKGS[1])
    assert canon(got) == canon(ref)
    if case is p25_case:
        assert got[0][0]["type"] == "RFSS_STATUS" and got[0][0]["site_id"] == 4
        assert got[1]["syncCount"] >= 1 and got[1]["frames"].get("TSDU", 0) >= 1
    else:
        kinds = [m.get("type") for m in got[0]]
        assert "PV_GRANT" in kinds and "VOICE_SUPERFRAME" in kinds
        assert got[1]["voiceSuperframes"] == 1 and got[1]["ambeFramesDecoded"] == 18 and len(got[2]) == 18 * 160


def test_attachment_kinds_and_counters():
    ref, port = att_mod(PKGS[0]), att_mod(PKGS[1])
    assert sorted(port.ATTACHMENT_KINDS) == sorted(ref.ATTACHMENT_KINDS)
    assert all(port.ATTACHMENT_KINDS[k].kind == ref.ATTACHMENT_KINDS[k].kind for k in ref.ATTACHMENT_KINDS)

    class Boom(port.ChannelAttachment):
        kind = "boom"

        def process(self, audio):
            raise ValueError("decoder fault")

    ch = stand_in(PKGS[1], "b")
    att = Boom(ch)
    try:
        for _ in range(3):
            ch.audio.publish(np.zeros(16, np.float32))
        t0 = time.time()
        while att.batches < 3 and time.time() - t0 < 10:
            time.sleep(0.01)
        assert att.batches == 3 and att.errors == 3 and not att.messages
    finally:
        att.stop()


# --- the scanner (tests/test_aux_decoders.py::TestScanner, tests/test_utils.py) -----------


def scan_mod(pkg: str):
    return importlib.import_module(f"{pkg}.capture.scanner")


class FakeChan:
    def __init__(self):
        self.rssi_db = -120.0


class FakeCap:
    def __init__(self):
        self.channels = {"s1": FakeChan()}
        self.tunes = []

    def update_channel(self, cid, frequency_hz=None, **kw):
        self.tunes.append(frequency_hz)


def status(svc) -> dict:
    """A scanner's status without its id (each package numbers its
    scanners from its own counter)."""
    return {k: v for k, v in svc.status().items() if k != "id"}


def wait_for(pred, timeout=5.0):
    t0 = time.time()
    while not pred() and time.time() - t0 < timeout:
        time.sleep(0.01)
    return pred()


@pytest.mark.parametrize("pkg", PKGS)
def test_scanner_scans_and_holds_on_activity(pkg):
    s = scan_mod(pkg)
    cap = FakeCap()
    svc = s.ScannerService(cap, "s1", s.ScannerConfig(
        entries=[s.ScanEntry(155.0e6), s.ScanEntry(155.1e6), s.ScanEntry(155.2e6, locked_out=True)],
        dwell_s=0.05, hold_s=0.2, squelch_db=-60))
    svc.start()
    try:
        assert wait_for(lambda: 155.0e6 in cap.tunes and 155.1e6 in cap.tunes)
        assert 155.2e6 not in cap.tunes
        cap.channels["s1"].rssi_db = -30.0
        assert wait_for(lambda: svc.state == "holding")
        n = len(cap.tunes)
        time.sleep(0.2)
        assert len(cap.tunes) == n
        cap.channels["s1"].rssi_db = -120.0
        assert wait_for(lambda: svc.state == "scanning" and len(cap.tunes) > n)
        st = svc.status()
        assert st["state"] == "scanning" and sum(e["hits"] for e in st["entries"]) >= 1
    finally:
        svc.stop()
    assert svc.state == "stopped"


@pytest.mark.parametrize("pkg", PKGS)
def test_scanner_pause_sticks_and_restart_clears(pkg):
    s = scan_mod(pkg)
    cap = FakeCap()
    svc = s.ScannerService(cap, "s1", s.ScannerConfig(entries=[s.ScanEntry(155.0e6), s.ScanEntry(155.1e6)],
                                                      dwell_s=0.05, hold_s=0.05, squelch_db=-60.0))
    svc.start()
    try:
        cap.channels["s1"].rssi_db = -20.0
        assert wait_for(lambda: svc.state == "holding")
        svc.pause()
        cap.channels["s1"].rssi_db = -120.0
        time.sleep(0.4)
        n = len(cap.tunes)
        assert svc.state == "paused"
        time.sleep(0.2)
        assert len(cap.tunes) == n
        svc.resume()
        assert wait_for(lambda: len(cap.tunes) > n)
        svc.lock()
        assert svc.state == "locked"
        svc.unlock()
        svc.lockout(155.1e6)
        assert [e.locked_out for e in svc.config.entries] == [False, True]
        svc.clear_lockouts()
        svc.pause()
        svc.stop()
        cap.tunes.clear()
        svc.start()
        assert wait_for(lambda: bool(cap.tunes)), "a restarted scanner never retuned"
    finally:
        svc.stop()


@pytest.mark.parametrize("mode", ["priority", "activity"])
def test_scanner_orders_match_reference(mode):
    orders = []
    for pkg in PKGS:
        s = scan_mod(pkg)
        svc = s.ScannerService(FakeCap(), "s1", s.ScannerConfig(
            entries=[s.ScanEntry(150e6 + 1e5 * i, priority=p) for i, p in enumerate((5, 1, 3, 1, 9))],
            mode=s.ScanMode(mode)))
        svc.hits = {150.3e6: 4, 150.1e6: 2, 150.4e6: 9}
        svc.lockout(150.4e6)
        orders.append(([e.frequency_hz for e in svc._order()], status(svc)))
    assert canon(orders[1]) == canon(orders[0])


class VirtualTime:
    """The scanner module's ``time``: ``sleep`` moves a virtual clock and,
    as each block's time comes, dispatches it (on the scanner's own
    thread, so the run is one thread and deterministic); after the last
    block the scanner is stopped."""

    def __init__(self, cap, blocks, block_s: float):
        self.cap, self.blocks, self.block_s = cap, blocks, block_s
        self.t, self.next, self.svc, self.tuned = 0.0, 0, None, []

    def time(self) -> float:
        return self.t

    def sleep(self, dt: float) -> None:
        self.t += dt
        while self.next < len(self.blocks) and self.t >= (self.next + 1) * self.block_s:
            self.cap._dispatch_blocks([self.blocks[self.next]])
            self.tuned.append(self.cap.channels["scan"].spec.frequency_hz)
            self.next += 1
        if self.next == len(self.blocks):
            self.svc._stop.set()


def scanner_on_engine(pkg: str, cap_mod, cap, blocks, freqs, monkeypatch) -> dict:
    s = scan_mod(pkg)
    cap.create_channel(cap_mod.ChannelSpec(id="scan", mode="nbfm", frequency_hz=freqs[0]))
    cap._dispatch_blocks([np.zeros(cap.block_size, np.complex64)])  # build the program
    gen = cap._pipe_gen
    clock = VirtualTime(cap, blocks, cap.block_size / RATE)
    monkeypatch.setattr(s, "time", clock)
    svc = s.ScannerService(cap, "scan", s.ScannerConfig(entries=[s.ScanEntry(f) for f in freqs], dwell_s=0.25,
                                                        hold_s=0.2, squelch_db=-60.0))
    clock.svc = svc
    svc.start()
    svc._thread.join(timeout=300)
    assert not svc._thread.is_alive() and clock.next == len(blocks)
    svc.stop()
    assert cap._pipe_gen == gen  # every retune went through update_channel: no rebuild
    return dict(tuned=clock.tuned, hits=svc.hits, status=status(svc))


def test_scanner_on_engine_matches_reference(monkeypatch):
    """Four entries, one with a carrier for blocks 3-9 of 16 (0.1 s each):
    both packages' scanners on their engines tune the same frequency for
    every block and stop on the active entry only."""
    ch = ChannelizerConfig(sample_rate=float(RATE), channel_bandwidth=25_000.0)
    bins = (20, 23, 26, 29)
    freqs = [CENTER + ch.channel_offset_hz(b) for b in bins]
    block = 120_000
    n = 16 * block
    env = ((np.arange(n) >= 3 * block) & (np.arange(n) < 9 * block)).astype(np.float64)
    x = 0.05 * env * np.exp(2j * np.pi * ch.channel_offset_hz(bins[2]) * np.arange(n) / RATE)
    dev = FakeDriver(1, [FakeStation(offset_hz=0.0, kind="iq_loop", iq_loop=x.astype(np.complex64),
                                     amplitude=1.0)]).open("fake0")
    dev.configure(DeviceConfig(center_hz=CENTER, sample_rate=RATE))
    stream = dev.start_stream()
    blocks = [stream.read(block)[0] for _ in range(16)]
    cfg = dict(center_hz=CENTER, sample_rate=RATE, channel_bandwidth=25_000.0, block_seconds=0.1,
               narrow_capacity=1, wide_capacity=0, p25_capacity=0, transport="i16", adaptive_transport=False)
    jcap = jcapture.CaptureManager(JFakeDriver(1)).create_capture(config=jcapture.CaptureConfig(**cfg))
    tcap = tcapture.CaptureManager(FakeDriver(1), device="cpu").create_capture(config=tcapture.CaptureConfig(**cfg))
    ref = scanner_on_engine(PKGS[0], jcapture, jcap, blocks, freqs, monkeypatch)
    got = scanner_on_engine(PKGS[1], tcapture, tcap, blocks, freqs, monkeypatch)
    assert canon(got) == canon(ref)
    assert set(got["hits"]) == {freqs[2]} and got["hits"][freqs[2]] >= 1
    on = [k for k, f in enumerate(got["tuned"]) if f == freqs[2]]
    assert set(range(on[0], 9)) <= set(on), on  # held while the carrier was up
    assert set(got["tuned"]) == set(freqs)


# --- the divergence: RDS at the wide slots' true IF rate --------------------------------


def test_rds_attachment_decodes_at_the_wide_if_rate():
    """At 10 Msps the wide slots run at 10e6 // 41 = 243,902 Hz.  The
    port's ``RdsAttachment`` given the capture decodes that baseband; the
    reference's, at ``WIDE_RATE``, finds no group.  Below 10 Msps, where
    ``WIDE_RATE`` divides the capture's rate, the two agree."""
    from wavecap_tpu_torch.decoders import rds

    fs = 10_000_000 // 41
    pi, ps, _ = RDS
    groups = [rds.encode_group(pi, 0, seg, 0xE201, (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])) for seg in range(4)]
    x = np.asarray(rds.modulate_rds(np.concatenate(groups * 8), fs, amplitude=0.12))
    x = np.concatenate([np.zeros(int(0.25 * fs / rds.RDS_BITRATE), np.float32), x])
    n_block = 48_400  # a 10 Msps block of 1,984,400 samples at the IF rate
    cap = SimpleNamespace(config=SimpleNamespace(sample_rate=10_000_000), enable_wide_baseband=lambda: None)
    out = {}
    for pkg in PKGS:
        att = att_mod(pkg).RdsAttachment(stand_in(pkg, "fm"), capture=cap)
        try:
            msgs = [m for i in range(0, len(x) - n_block, n_block) for m in att.process(x[i:i + n_block])]
            out[pkg] = (att.decoder.sample_rate, att.decoder.data.pi, att.decoder.data.ps, len(msgs))
        finally:
            att.stop()
    assert out[PKGS[1]][:3] == (float(fs), pi, ps) and out[PKGS[1]][3] > 0
    assert out[PKGS[0]] == (240_000.0, None, "", 0)
    slow = SimpleNamespace(config=SimpleNamespace(sample_rate=RATE), enable_wide_baseband=lambda: None)
    rates = []
    for pkg in PKGS:
        att = att_mod(pkg).RdsAttachment(stand_in(pkg, "fm"), capture=slow)
        rates.append(att.decoder.sample_rate)
        att.stop()
    assert rates == [240_000.0, 240_000.0]
