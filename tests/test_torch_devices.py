"""The port's device drivers (``wavecap_tpu_torch/devices``: ``file_replay``,
``composite``, ``recovery``, ``rtl``, ``soapy`` and ``native``) against the
JAX package's, on the CPU.

Neither librtlsdr nor SoapySDR is on this machine, so the hardware gates
run on the stand-in libraries of the reference's own tests
(``tests/test_rtl_driver.py``, ``tests/test_soapy_and_lock.py``); the
recovery policy on a fake runner and clock (no ``systemctl``, no USB
hub).  Each case runs both packages' drivers on the same seeded inputs
and the two results must be equal exactly (``canon``): the samples a
stream reads bit for bit, the calls made on the library in order, the
devices listed.  The cases follow those files,
``tests/test_composite_driver.py``, ``tests/test_native_ingest.py``, the
recovery cases of ``tests/test_recovery_and_imports.py`` and the replay
half of ``tests/test_harness_and_replay.py``.
"""

from __future__ import annotations

import ctypes
import importlib
import time

import numpy as np
import pytest

from tests.test_torch_decoders_fec import canon

PKGS = ("wavecap_tpu", "wavecap_tpu_torch")


def dev_mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.devices.{name}")


def same(case, *args, seed: int = 16):
    """``case(pkg, rng, *args)`` for both packages with one seed: equal
    results, the reference's returned."""
    a = case(PKGS[0], np.random.default_rng(seed), *args)
    b = case(PKGS[1], np.random.default_rng(seed), *args)
    assert canon(b) == canon(a)
    return a


# --- file replay -----------------------------------------------------------------------


def replay_wav(pkg, rng, tmp):
    """A seeded IQ WAV written by the package's ``write_iq_wav``, replayed
    through its ``FileReplayDriver`` in odd-sized reads across the loop."""
    wavio = importlib.import_module(f"{pkg}.utils.wavio")
    base = dev_mod(pkg, "base")
    fr = dev_mod(pkg, "file_replay")
    n, rate = 10_000, 800_000
    iq = (0.5 * np.exp(2j * np.pi * 12_345.0 * np.arange(n) / rate)
          + 0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    (tmp / pkg).mkdir()
    p = tmp / pkg / "replay.wav"  # the label names the file
    wavio.write_iq_wav(p, iq, rate)
    driver = fr.FileReplayDriver(str(p))
    infos = driver.enumerate()
    dev = driver.open(infos[0].id)
    dev.configure(base.DeviceConfig(center_hz=100e6, sample_rate=1_000_000))  # the file's rate wins
    stream = dev.start_stream()
    reads = [stream.read(k) for k in (7_000, 7_000, 1, 12_345)]
    stream.close()
    with pytest.raises(RuntimeError):
        stream.read(10)
    once = fr.FileReplayStream(iq, loop=False)
    tail = [once.read(6_000), once.read(6_000)]
    return ([(i.id, i.driver, i.label) for i in infos], dev.config.sample_rate, dev.file_rate, reads, tail,
            once.exhausted, iq)


def replay_raw(pkg, rng, tmp):
    """The raw formats (``.cf32``, ``.cs16``) and an unknown suffix."""
    fr = dev_mod(pkg, "file_replay")
    base = dev_mod(pkg, "base")
    f32 = rng.standard_normal(4000).astype(np.float32)
    s16 = rng.integers(-32768, 32767, 4000).astype(np.int16)
    (tmp / f"{pkg}.cf32").write_bytes(f32.tobytes())
    (tmp / f"{pkg}.cs16").write_bytes(s16.tobytes())
    (tmp / f"{pkg}.xyz").write_bytes(b"\0" * 16)
    out = []
    for suffix in ("cf32", "cs16"):
        dev = fr.FileReplayDriver(tmp / f"{pkg}.{suffix}", loop=False).open("file0")
        dev.configure(base.DeviceConfig(sample_rate=250_000))
        s = dev.start_stream()
        out.append((dev.file_rate, dev.config.sample_rate, s.read(1500), s.read(1500), s.exhausted))
    with pytest.raises(ValueError, match="unknown IQ file format"):
        fr.FileReplayDriver(tmp / f"{pkg}.xyz").open("file0").start_stream()
    return out


@pytest.mark.parametrize("case", [replay_wav, replay_raw], ids=lambda f: f.__name__)
def test_file_replay_matches_reference(case, tmp_path):
    got = same(lambda pkg, rng: case(pkg, rng, tmp_path))
    if case is replay_wav:
        infos, rate, file_rate, reads, tail, exhausted, iq = got
        assert infos[0][1] == "file" and rate == file_rate == 800_000
        joined = np.concatenate([r[0] for r in reads])
        assert not any(r[1] for r in reads) and len(joined) == 26_346
        assert np.allclose(joined[10_000:10_500], iq[:500], atol=1e-3)  # the loop wraps (int16 steps)
        assert np.all(tail[1][0][4_000:] == 0) and exhausted


def test_the_port_exports_the_replay_driver():
    from wavecap_tpu_torch import devices
    from wavecap_tpu_torch.devices.file_replay import FileReplayDevice, FileReplayDriver

    assert devices.FileReplayDriver is FileReplayDriver and devices.FileReplayDevice is FileReplayDevice
    assert "FileReplayDriver" in devices.__all__


# --- composite -------------------------------------------------------------------------


def composite_cases(pkg, rng):
    base = dev_mod(pkg, "base")
    comp = dev_mod(pkg, "composite")
    fake = dev_mod(pkg, "fake")

    class Stub(base.DeviceDriver):
        def __init__(self, name, ids, broken=False):
            self.name, self._ids, self.broken, self.opened = name, ids, broken, []

        def enumerate(self):
            if self.broken:
                raise RuntimeError("driver exploded")
            return [base.DeviceInfo(id=i, driver=self.name, label=i) for i in self._ids]

        def open(self, device_id):
            self.opened.append(device_id)
            return device_id

    def ids(c):
        return [(d.id, d.driver) for d in c.enumerate()]

    out = [ids(comp.CompositeDriver(drivers=[Stub("rtl", ["rtl0", "rtl1"])], fake=fake.FakeDriver())),
           ids(comp.CompositeDriver(drivers=[Stub("rtl", [])], fake=fake.FakeDriver())),
           ids(comp.CompositeDriver(drivers=[Stub("rtl", ["rtl0"])], fake=fake.FakeDriver(), show_fake_device=True)),
           ids(comp.CompositeDriver(drivers=[Stub("soapy", [], broken=True), Stub("rtl", ["rtl0"])],
                                    fake=fake.FakeDriver()))]
    rtl, soapy = Stub("rtl", ["rtl0"]), Stub("soapy", ["soapy0"])
    c = comp.CompositeDriver(drivers=[rtl, soapy], fake=fake.FakeDriver())
    out.append((c.open("soapy0"), rtl.opened, soapy.opened))
    with pytest.raises(KeyError):
        c.open("nope99")
    out.append(type(c.open("fake1")).__name__)  # a hidden fake still opens by id
    out.append(ids(comp.CompositeDriver(fake=fake.FakeDriver(n_devices=3))))  # no hardware here: the fakes
    return out


def test_composite_matches_reference():
    got = same(composite_cases)
    assert got[0] == [("rtl0", "rtl"), ("rtl1", "rtl")] and got[3] == [("rtl0", "rtl")]
    assert got[4] == ("soapy0", [], ["soapy0"]) and got[5] == "FakeDevice"


# --- recovery --------------------------------------------------------------------------


def recovery_cases(pkg, rng):
    rec = dev_mod(pkg, "recovery")
    clock = [1000.0]
    calls = []

    def runner(cmd, timeout=30.0):
        calls.append(list(cmd))
        return 0, "ok"

    svc = rec.ServiceRecovery(rec.RecoveryPolicy(cooldown_s=60, max_per_hour=3), runner, lambda: clock[0])
    results = []
    for dt in rng.choice([0.0, 30.0, 61.0, 3600.0], 24):
        clock[0] += float(dt)
        results.append(svc.restart_service())
    fallback_calls = []

    def failing_systemctl(cmd, timeout=30.0):
        fallback_calls.append(list(cmd))
        return (1 if cmd[0] == "systemctl" else 0), ""

    fb = rec.ServiceRecovery(runner=failing_systemctl, clock=lambda: 1000.0).restart_service()
    listing = ("Current status for hub 1-1 [dead:beef]\n  Port 1: 0503 power highspeed enable connect\n"
               "  Port 2: 0100 power\nCurrent status for hub 2-1 [cafe:f00d]\n  Port 1: 0100 power\n")
    hubs = rec.UsbPowerCycler(runner=lambda cmd, timeout=30.0: (0, listing)).list_hubs()
    cyc_calls = []
    cycled = rec.UsbPowerCycler(runner=lambda cmd, timeout=30.0: (cyc_calls.append(list(cmd)) or 0, "")) \
        .power_cycle("1-1", "2")
    return results, calls, svc.status(), fb, fallback_calls, hubs, cycled, cyc_calls


def test_recovery_matches_reference():
    results, calls, status, fb, fb_calls, hubs, cycled, cyc_calls = same(recovery_cases)
    assert calls[0][:2] == ["systemctl", "restart"]
    assert {r.get("reason") for r in results if not r["ok"]} <= {"cooldown", "hourly cap"}
    assert fb["ok"] and fb_calls[1][0] == "service"
    assert len(hubs) == 2 and hubs[0]["hub"] == "1-1" and len(hubs[0]["ports"]) == 2
    assert cycled["ok"] and "-a" in cyc_calls[0] and "cycle" in cyc_calls[0]


# --- rtl -------------------------------------------------------------------------------


class FakeRtlLib:
    """Stand-in for ``RtlLib`` (``tests/test_rtl_driver.py``): devices
    serving a u8 tone plus seeded noise, every call recorded."""

    def __init__(self, rng, n_devices=1, tone_cycles_per_chunk=32.0):
        self.n, self.rng, self.tone_cycles = n_devices, rng, tone_cycles_per_chunk
        self.calls: list[tuple] = []
        self._phase = 0.0
        self.fail_reads = False

    def device_count(self):
        return self.n

    def device_name(self, i):
        return f"Generic RTL2832U {i}"

    def usb_strings(self, i):
        return "Realtek", "RTL2838UHIDIR", f"SN{i:08d}"

    def open(self, index):
        self.calls.append(("open", index))
        return ("dev", index)

    def __getattr__(self, name):
        if name.startswith(("set_", "close", "reset_buffer")):
            return lambda *a, **k: self.calls.append((name, *a[1:], *k.values()))
        raise AttributeError(name)

    def tuner_gains(self, dev):
        return [0, 90, 197, 297, 496]

    def read_chunk(self, dev, n_bytes):
        if self.fail_reads:
            raise RuntimeError("usb gone")
        n = n_bytes // 2
        k = np.arange(n) + self._phase
        self._phase += n
        w = 2 * np.pi * self.tone_cycles / n
        noise = self.rng.integers(-3, 4, (2, n))
        out = np.empty(2 * n, np.uint8)
        out[0::2] = np.clip(np.round(127.5 + 100 * np.cos(w * k)) + noise[0], 0, 255).astype(np.uint8)
        out[1::2] = np.clip(np.round(127.5 + 100 * np.sin(w * k)) + noise[1], 0, 255).astype(np.uint8)
        return out


def rtl_configure(pkg, rng):
    rtl = dev_mod(pkg, "rtl")
    base = dev_mod(pkg, "base")
    infos = rtl.RtlDriver(lib=FakeRtlLib(rng, n_devices=2)).enumerate()
    out = [[(i.id, i.driver, i.label, i.serial) for i in infos]]
    for cfg in (base.DeviceConfig(center_hz=100e6, sample_rate=2_400_000, gain_db=28.0),
                base.DeviceConfig(center_hz=100e6, sample_rate=960_000),
                base.DeviceConfig(center_hz=162.4e6, sample_rate=1_024_000, gain_db=60.0, ppm=-3.0,
                                  bandwidth_hz=300e3)):
        lib = FakeRtlLib(rng)
        dev = rtl.RtlDriver(lib=lib).open("rtl0")
        dev.configure(cfg)
        dev.close()
        out.append(lib.calls)
    return out, rtl._U8_LUT


def rtl_stream(pkg, rng):
    """Odd-sized reads across USB chunks; then a USB error surfaces."""
    rtl = dev_mod(pkg, "rtl")
    lib = FakeRtlLib(rng)
    dev = rtl.RtlDriver(lib=lib).open("rtl0")
    dev.configure(dev.config)
    stream = dev.start_stream()
    try:
        reads = [stream.read(n) for n in (10_000, 10_000, 10_000, 100, 100)]
        lib.fail_reads = True
        deadline = time.time() + 10
        err = None
        while time.time() < deadline and err is None:
            try:
                stream.read(100_000)
            except RuntimeError as e:
                err = str(e)
    finally:
        dev.close()
    return reads, err, [c for c in lib.calls if c[0] != "close"]


@pytest.mark.parametrize("case", [rtl_configure, rtl_stream], ids=lambda f: f.__name__)
def test_rtl_matches_reference(case):
    got = same(case)
    if case is rtl_configure:
        calls, lut = got
        assert ("set_tuner_gain", 297) in calls[1] and ("set_agc_mode", False) in calls[1]
        assert ("set_agc_mode", True) in calls[2]
        assert float(lut[255]) == 1.0 and float(lut[0]) == -1.0
    else:
        reads, err, _ = got
        x = np.concatenate([r[0] for r in reads[:3]])
        assert not any(r[1] for r in reads) and "usb gone" in err
        spec = np.abs(np.fft.fft(x))
        assert abs(np.argmax(spec) / len(x) - 32.0 / 16384) < 1e-4


@pytest.mark.parametrize("pkg", PKGS)
def test_rtl_overflow_reported_once(pkg):
    """The reader thread overfills the ring while the consumer idles: the
    next read reports the overflow, the one after is clean (both packages)."""
    rtl = dev_mod(pkg, "rtl")
    dev = rtl.RtlDriver(lib=FakeRtlLib(np.random.default_rng(3))).open("rtl0")
    stream = dev.start_stream()
    try:
        deadline = time.time() + 10
        while time.time() < deadline:
            with stream._cv:
                if stream._overflow:
                    break
            time.sleep(0.01)
        assert stream.read(1024)[1] and not stream.read(1024)[1]
    finally:
        dev.close()


# --- soapy -----------------------------------------------------------------------------


class FakeSoapyLib:
    """Stand-in for the ctypes CDLL (``tests/test_soapy_and_lock.py``):
    records calls, serves seeded samples in partial reads."""

    def __init__(self, rng, mtu: int = 100, overflow_at_call: int | None = None):
        self.rng, self.mtu, self.calls = rng, mtu, []
        self._read_calls = 0
        self._overflow_at = overflow_at_call
        self.SoapySDRDevice_setupStream = self._record("setupStream", ret=1234)
        self.SoapySDRDevice_makeStrArgs = self._record("make", ret=777)
        self.SoapySDRDevice_enumerate = self._record("enumerate", ret=None)

    def _record(self, name, ret):
        def fn(*a, **k):
            self.calls.append((name, tuple(x for x in a if isinstance(x, (int, float, bytes)))))
            return ret

        fn.restype = None
        return fn

    def __getattr__(self, name):
        return self._record(name, 0)

    def SoapySDRDevice_getStreamMTU(self, dev, stream):
        return self.mtu

    def SoapySDRDevice_readStream(self, dev, stream, buffs, want, flags, tn, timeout):
        self._read_calls += 1
        if self._overflow_at == self._read_calls:
            return -4  # SOAPY_SDR_OVERFLOW
        n = min(int(want), self.mtu, 37)  # partial reads force reassembly
        x = (self.rng.standard_normal(n) + 1j * self.rng.standard_normal(n)).astype(np.complex64)
        ctypes.memmove(buffs[0], x.ctypes.data, x.nbytes)
        return n


def soapy_cases(pkg, rng, monkeypatch):
    soapy = dev_mod(pkg, "soapy")
    base = dev_mod(pkg, "base")
    out = [soapy.SoapyStream(FakeSoapyLib(rng, mtu=100), dev=1, stream=2, mtu=100).read(200),
           soapy.SoapyStream(FakeSoapyLib(rng, mtu=64, overflow_at_call=2), dev=1, stream=2, mtu=64).read(120)]
    bad = FakeSoapyLib(rng)
    bad.SoapySDRDevice_readStream = lambda *a: -1
    with pytest.raises(RuntimeError, match="readStream error"):
        soapy.SoapyStream(bad, dev=1, stream=2, mtu=64).read(10)
    lib = FakeSoapyLib(rng)
    st = soapy.SoapyStream(lib, dev=1, stream=2, mtu=64)
    st.close()
    st.close()
    out.append(lib.calls)
    for cfg in (base.DeviceConfig(sample_rate=2.4e6, center_hz=100e6, gain_db=30.0),
                base.DeviceConfig(sample_rate=1e6, center_hz=100e6, agc=True)):
        lib = FakeSoapyLib(rng, mtu=4096)
        d = soapy.SoapyDevice(lib, base.DeviceInfo(id="soapy0", driver="soapy", label="fake"), "driver=rtlsdr")
        d.configure(cfg)
        s = d.start_stream()
        d.close()
        d.close()
        out.append((lib.calls, s.mtu))
    monkeypatch.setattr(soapy, "load_soapy", lambda: None)
    out.append(soapy.SoapyDriver().enumerate())
    with pytest.raises(RuntimeError, match="not available"):
        soapy.SoapyDriver().open("soapy0")
    lib = FakeSoapyLib(rng)
    monkeypatch.setattr(soapy, "load_soapy", lambda: lib)
    d = soapy.SoapyDriver({"driver": "sdrplay", "serial": "X1"}).open("soapy3")
    out.append((d._args, d.info.id))
    return out


def test_soapy_matches_reference(monkeypatch):
    got = same(lambda pkg, rng: soapy_cases(pkg, rng, monkeypatch))
    assert not got[0][1] and len(got[0][0]) == 200 and got[1][1] and len(got[1][0]) == 120
    names = [c[0] for c in got[2]]
    assert names.count("SoapySDRDevice_closeStream") == 1
    assert "SoapySDRDevice_setGainMode" not in [c[0] for c in got[3][0]]
    assert "SoapySDRDevice_setGainMode" in [c[0] for c in got[4][0]]
    assert got[5] == [] and got[6] == (b"driver=sdrplay,serial=X1", "soapy3")


def test_the_hardware_gates_report_no_library_here():
    for pkg in PKGS:
        assert dev_mod(pkg, "rtl").RtlDriver(lib=None).enumerate() == [] or dev_mod(pkg, "rtl").rtl_available()
        assert dev_mod(pkg, "soapy").soapy_available() == dev_mod(PKGS[0], "soapy").soapy_available()


# --- native ----------------------------------------------------------------------------


def native_stream(pkg, rng, kind: str):
    """The C++ ring at its deterministic (non-realtime) pace: a station's
    samples over reads that split its chunks."""
    native = dev_mod(pkg, "native")
    fake = dev_mod(pkg, "fake")
    base = dev_mod(pkg, "base")
    stations = {"tone": [fake.FakeStation(offset_hz=50_000.0, kind="tone", amplitude=0.5)],
                "nbfm": [fake.FakeStation(offset_hz=-20_000.0, kind="nbfm", tone_hz=800.0, deviation_hz=4000.0),
                         fake.FakeStation(offset_hz=120_000.0, kind="am", tone_hz=600.0, amplitude=0.2)]}[kind]
    drv = native.NativeDriver(stations=stations, realtime=False)
    infos = [(i.id, i.driver, i.label) for i in drv.enumerate()]
    dev = drv.open("native0")
    dev.configure(base.DeviceConfig(sample_rate=1_000_000))
    st = dev.start_stream()
    try:
        reads = [st.read(n) for n in (1 << 17, 5000, 5000, 33_333)]
    finally:
        st.close()
    return infos, reads


@pytest.mark.parametrize("kind", ["tone", "nbfm"])
def test_native_ring_matches_reference(kind):
    from wavecap_tpu_torch.devices.native import native_available

    assert native_available(), "the native ingest library did not build or load"
    infos, reads = same(lambda pkg, rng: native_stream(pkg, rng, kind))
    assert infos == [("native0", "native", "Native ingest ring")]
    iq = reads[0][0]
    assert not any(r[1] for r in reads) and iq.dtype == np.complex64
    if kind == "tone":
        f = np.fft.fftfreq(len(iq), 1e-6)
        assert abs(f[np.argmax(np.abs(np.fft.fft(iq)))] - 50_000.0) < 20
        dphi = np.angle(reads[2][0][0] * np.conj(reads[1][0][-1]))
        assert abs(dphi - 2 * np.pi * 50_000 / 1_000_000) < 0.2  # the phase continues across reads


@pytest.mark.parametrize("pkg", PKGS)
def test_native_overflow_and_oversized_chunks(pkg):
    """Realtime keeps the overflow-drop contract on a tiny ring; a chunk
    larger than the ring does not wedge the non-realtime writer."""
    native = dev_mod(pkg, "native")
    base = dev_mod(pkg, "base")
    dev = native.NativeDriver(stations=[], realtime=True, ring_capacity=20_000).open("native0")
    dev.configure(base.DeviceConfig(sample_rate=2_000_000))
    st = dev.start_stream()
    try:
        lib = native.load_ingest_lib()
        deadline = time.time() + 10.0
        while time.time() < deadline and lib.wavecap_ring_overflows(st._h) < 1:
            time.sleep(0.02)
        assert lib.wavecap_ring_overflows(st._h) >= 1 and st.read(1000)[1]
    finally:
        st.close()
    dev = native.NativeDriver(stations=[], realtime=False, ring_capacity=5_000).open("native0")
    dev.configure(base.DeviceConfig(sample_rate=2_000_000))
    st = dev.start_stream()
    try:
        assert len(st.read(4_000)[0]) == 4_000 and len(st.read(4_000)[0]) == 4_000
    finally:
        st.close()


def test_native_library_path_is_the_repos():
    from wavecap_tpu.devices import native as ref
    from wavecap_tpu_torch.devices import native as port

    assert port._LIB_PATH == ref._LIB_PATH and port._NATIVE_DIR.name == "native"
