"""The slice as a whole on the CPU: each package's capture engine and its
own decoders on one seeded scene.

A fake receiver at 960 kHz carries LSM control channels (TSDU loops of
IDEN_UP, GRP_V_CH_GRANT and RFSS_STS_BCAST, each station its own NAC and
site) in four cases: clean; AWGN at -1 dB (the point of
``tests/test_cqpsk_phase2.py:361-375``); +1 kHz carrier offset at 6 dB
(``:377-397``); and the 70 us simulcast echo at 10 dB (``:435-454``).
Both packages' ``CaptureManager`` -> ``create_capture`` ->
``create_channel`` take the same blocks through ``_dispatch_blocks``
(no reader or fetch thread: each batch drains inline) and every
subscriber is drained after each block.  Each package's
``Channel.symbols`` batches go into its own ``P25Framer`` ->
``decode_tsbk_payload`` -> ``parse_tsbk``.  TSBKs are counted from
block 3 on, as the chip smoke's programs count decisions.

- clean and +CFO: the CRC-valid TSBKs are the same list, message for
  message, and they are the station's own;
- AWGN and echo: the two pass rates within 2 percentage points, and
  every CRC-valid message one that the station sent;
- Phase 2: ``build_test_fragment`` loops through a ``p25p2`` channel of
  the same capture; each package's detector finds fragments, the counts
  within one of each other and >= 90 % of those sent;
- cross-feed: the port's decoders on the reference engine's symbols give
  exactly the reference decoders' frames and messages;
- hand-over: the reference framer (detector) takes the stream to a cut
  inside a frame, ``convert.decoder_state_from_reference`` hands it to
  the port, which finishes: the same frames as the reference alone.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from scipy import signal as sps

from tests.test_torch_decoders_fec import PORT, REF, canon
from wavecap_tpu import capture as jcapture
from wavecap_tpu.devices import FakeDriver as JFakeDriver
from wavecap_tpu_torch import convert
from wavecap_tpu_torch.capture import CaptureConfig, CaptureManager, ChannelSpec
from wavecap_tpu_torch.devices import DeviceConfig, FakeDriver, FakeStation
from wavecap_tpu_torch.models.p25.cqpsk import modulate_cqpsk_cyclic
from wavecap_tpu_torch.ops.channelizer import ChannelizerConfig

torch.set_num_threads(1)

RATE, CENTER = 960_000, 851_500_000.0
N_BLOCKS = 16
FIRST = 2  # TSBKs counted from block 3 on
LOOP_TSDUS = 12  # 4,320 symbols: 0.9 s
# case: (channelizer bin, NAC, site, SNR dB at 48 kHz or None, carrier offset Hz, echo)
CASES = {
    "clean": (4, 0x111, 1, None, 0.0, False),
    "awgn": (9, 0x222, 2, -1.0, 0.0, False),
    "cfo": (14, 0x333, 3, 6.0, 1000.0, False),
    "echo": (26, 0x444, 4, 10.0, 0.0, True),
}
P2_BIN = 31
P2_FRAGMENTS = 40  # the loop: 28,800 dibits, 4.8 s at 6000 baud
CONFIG = dict(center_hz=CENTER, sample_rate=RATE, block_seconds=0.1, narrow_capacity=0, wide_capacity=0,
              p25_capacity=len(CASES), p25_modulation="cqpsk", p25p2_capacity=1, transport="i16",
              adaptive_transport=False)


def station_tsbks(site: int) -> list:
    """The three TSBKs a station sends, as (opcode, data, last)."""
    t = PORT.tsbk
    return [(t.TSBKOpcode.IDEN_UP, t.make_iden_up_data(identifier=1, base_freq_mhz=851.0 + 0.1 * site), False),
            (t.TSBKOpcode.GRP_V_CH_GRANT,
             t.make_group_grant_data(tgid=2000 + site, source_id=700_000 + site, band=1, channel_number=56 + site),
             False),
            (t.TSBKOpcode.RFSS_STS_BCAST,
             t.make_rfss_status_data(system_id=0x123, rfss_id=1, site_id=site, band=1, channel_number=16 + site), True)]


def sent_messages(nac: int, site: int) -> set:
    return {repr(canon({"nac": nac, **PORT.tsbk.parse_tsbk(int(op), 0, data)})) for op, data, _ in station_tsbks(site)}


def loop_iq(rng, nac, site, snr_db, cfo, echo) -> np.ndarray:
    """A seamless LSM loop of TSDUs at 960 kHz with its impairments (the
    noise added at 48 kHz, in the channel's band)."""
    pf = PORT.pf
    frame = pf.build_tsdu_frame(nac, [pf.encode_tsbk_block(op, data, last=last)
                                      for op, data, last in station_tsbks(site)])
    x = modulate_cqpsk_cyclic(np.concatenate([frame] * LOOP_TSDUS), 48_000.0).astype(np.complex128)
    if echo:
        x = x + 0.5 * np.exp(1j * rng.uniform(0, 2 * np.pi)) * np.roll(x, int(round(70e-6 * 48_000)))
    if snr_db is not None:
        std = np.sqrt(np.mean(np.abs(x) ** 2) / 10 ** (snr_db / 10) / 2)
        x = x + std * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    if cfo:  # a whole number of cycles over the loop: the wrap stays continuous
        x = x * np.exp(2j * np.pi * round(cfo * len(x) / 48_000) * np.arange(len(x)) / len(x))
    return sps.resample(x, len(x) * RATE // 48_000).astype(np.complex64)


def p2_loop_iq() -> np.ndarray:
    frag = PORT.p2.build_test_fragment()
    x = modulate_cqpsk_cyclic(np.concatenate([frag] * P2_FRAGMENTS), 48_000.0, 6000.0, 1.0)
    return sps.resample(x, len(x) * RATE // 48_000).astype(np.complex64)


_SCENE: dict = {}


def scene():
    """The blocks, the channels' frequencies and every package's symbol
    batches (computed once for the file)."""
    if _SCENE:
        return _SCENE
    rng = np.random.default_rng(20261018)
    ch = ChannelizerConfig(sample_rate=float(RATE), channel_bandwidth=25_000.0)
    freqs, stations = {}, []
    for name, (b, nac, site, snr, cfo, echo) in CASES.items():
        freqs[name] = CENTER + ch.channel_offset_hz(b)
        stations.append(FakeStation(offset_hz=ch.channel_offset_hz(b), kind="iq_loop",
                                    iq_loop=loop_iq(rng, nac, site, snr, cfo, echo), amplitude=0.3))
    freqs["p2"] = CENTER + ch.channel_offset_hz(P2_BIN)
    stations.append(FakeStation(offset_hz=ch.channel_offset_hz(P2_BIN), kind="iq_loop", iq_loop=p2_loop_iq(),
                                amplitude=0.3))
    dev = FakeDriver(1, stations).open("fake0")
    dev.configure(DeviceConfig(center_hz=CENTER, sample_rate=RATE))
    stream = dev.start_stream()
    jcap = jcapture.CaptureManager(JFakeDriver(1)).create_capture(config=jcapture.CaptureConfig(**CONFIG))
    tcap = CaptureManager(FakeDriver(1), device="cpu").create_capture(config=CaptureConfig(**CONFIG))
    assert jcap.block_size == tcap.block_size
    blocks = [stream.read(tcap.block_size)[0] for _ in range(N_BLOCKS)]
    _SCENE.update(freqs=freqs, ref=run_engine(jcapture.ChannelSpec, jcap, blocks, freqs),
                  port=run_engine(ChannelSpec, tcap, blocks, freqs))
    return _SCENE


def run_engine(spec, cap, blocks, freqs) -> dict:
    """Every channel's symbol batches, one per block."""
    subs = {name: cap.create_channel(spec(id=name, mode="p25p2" if name == "p2" else "p25", frequency_hz=f))
            .symbols.subscribe(maxsize=4) for name, f in freqs.items()}
    out = {name: [] for name in subs}
    for block in blocks:
        cap._dispatch_blocks([block])
        for name, sub in subs.items():  # drained after every block: nothing can drop
            out[name].append(np.asarray(sub.get_nowait()["soft"], np.float32))
            assert sub.get_nowait() is None and sub.dropped == 0
    assert cap.blocks_processed == len(blocks) and cap.state != "failed"
    return out


def decode(d, softs) -> tuple:
    """The frames and, for each TSBK from block ``FIRST`` on, (NAC, CRC
    valid, parsed message)."""
    fr = d.framer.P25Framer()
    frames, tsbks = [], []
    for k, s in enumerate(softs):
        for f in fr.process(s):
            frames.append(f)
            if f.duid != d.pf.DUID.TSDU or k < FIRST:
                continue
            pl = d.pf.remove_status_dibits(f.dibits[57:], 57)
            sl = d.pf.remove_status_dibits(f.soft[57:], 57)
            for b in d.pf.decode_tsbk_payload(pl, sl):
                tsbks.append((f.nac, b.crc_valid, d.tsbk.parse_tsbk(b.opcode, b.mfid, b.data) if b.crc_valid else None))
    return frames, tsbks


def valid(tsbks) -> list:
    return [repr(canon({"nac": nac, **msg})) for nac, ok, msg in tsbks if ok]


@pytest.mark.parametrize("case", list(CASES))
def test_engine_and_decoders_match_reference(case):
    s = scene()
    _, nac, site, *_ = CASES[case]
    _, ref = decode(REF, s["ref"][case])
    _, got = decode(PORT, s["port"][case])
    sent = sent_messages(nac, site)
    assert len(ref) >= 30 and len(got) >= 30, (len(ref), len(got))
    for tsbks in (ref, got):
        assert set(valid(tsbks)) <= sent  # every CRC-valid message is one the station sent
    rate_ref, rate_got = len(valid(ref)) / len(ref), len(valid(got)) / len(got)
    if case in ("clean", "cfo"):
        assert valid(got) == valid(ref)
        assert rate_got >= 0.9, rate_got
    else:
        assert abs(rate_got - rate_ref) <= 0.02, (rate_ref, rate_got)
        assert rate_got >= 0.5, rate_got


def test_phase2_fragments_match_reference():
    s = scene()
    counts, fed = [], []
    for d, softs in ((REF, s["ref"]["p2"]), (PORT, s["port"]["p2"])):
        det = d.p2.P25P2SuperFrameDetector()
        counts.append(sum(len(det.process(x)) for x in softs))
        fed.append(sum(len(x) for x in softs))
    sent = fed[1] // PORT.p2.FRAGMENT_DIBITS
    assert abs(counts[0] - counts[1]) <= 1, counts
    assert counts[1] >= int(0.9 * sent), (counts, sent)


@pytest.mark.parametrize("case", ["clean", "awgn"])
def test_port_decoders_on_reference_symbols(case):
    """Cross-feed: the reference engine's symbols through the port's
    decoders give exactly the reference decoders' frames and messages."""
    softs = scene()["ref"][case]
    assert canon(decode(PORT, softs)) == canon(decode(REF, softs))


@pytest.mark.parametrize("case", ["clean", "echo"])
def test_framer_hand_over_mid_stream(case):
    softs = np.concatenate(scene()["ref"][case])
    cut = 2 * 360 + 157  # inside the third TSDU
    alone = REF.framer.P25Framer()
    want = alone.process(softs[:cut]) + alone.process(softs[cut:])
    ref = REF.framer.P25Framer()
    got = ref.process(softs[:cut])
    port = convert.decoder_state_from_reference(ref)
    assert type(port).__module__ == "wavecap_tpu_torch.decoders.framer"
    assert type(port.nac_tracker).__module__ == "wavecap_tpu_torch.decoders.nac_tracker"
    got += port.process(softs[cut:])
    assert len(want) >= 10 and canon(got) == canon(want)
    assert (port.sync_count, port.frame_count) == (alone.sync_count, alone.frame_count)


def test_phase2_detector_hand_over_mid_stream():
    softs = np.concatenate(scene()["ref"]["p2"])
    cut = 3 * 720 + 411
    alone = REF.p2.P25P2SuperFrameDetector()
    want = alone.process(softs[:cut]) + alone.process(softs[cut:])
    ref = REF.p2.P25P2SuperFrameDetector()
    got = ref.process(softs[:cut])
    port = convert.decoder_state_from_reference(ref)
    got += port.process(softs[cut:])
    assert len(want) >= 5 and canon(got) == canon(want)
    assert canon(vars(port)) == canon(vars(alone))


def test_hand_over_refuses_other_objects():
    with pytest.raises(TypeError):
        convert.decoder_state_from_reference(REF.iv.ImbeEncoder())
    with pytest.raises(TypeError):
        convert.decoder_state_from_reference(object())
