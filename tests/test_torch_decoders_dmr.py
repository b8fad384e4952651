"""The port's DMR decoder (``decoders/dmr.py``: bursts, slot type, CACH /
TACT, CSBK, full link control, voice superframes) against the JAX
package's, on the CPU.

Each case runs the same seeded inputs through both packages and requires
the results equal exactly (``tests/test_torch_decoders_fec.py:run_case``).
The cases follow ``tests/test_dmr_csbk.py`` (its BPTC and 3/4-rate
trellis cases are in ``test_torch_decoders_fec.py``, its confirmed-PDU
cases in ``test_torch_decoders_p25.py``; its RF case, which waits on a
live engine thread, becomes the engine cases of
``test_torch_p25_decode.py``) and the DMR superframe case of
``tests/test_ambe_vocoder.py``.  Then the hand-over of the burst decoder
and the voice tracker mid-stream (``convert.decoder_state_from_reference``).
"""

from __future__ import annotations

import numpy as np
import pytest

from tests.test_torch_decoders_fec import REF, canon, run_case
from wavecap_tpu_torch import convert


def slot_type(d, rng):
    out = []
    for cc in range(16):
        for dt in (d.dmr.DataType.CSBK, d.dmr.DataType.IDLE, d.dmr.DataType.VOICE_LC_HEADER):
            st = d.dmr.encode_slot_type(color_code=cc, data_type=dt)
            bad = st.copy()
            bad[rng.choice(20, int(rng.integers(0, 5)), replace=False)] ^= 1
            out += [st, d.dmr.decode_slot_type(st), d.dmr.decode_slot_type(bad)]
    return out


def csbk(d, rng):
    m = d.dmr
    bits = [m.make_csbk_bits(op, fid=0, channel=1234, slot=1, dst_id=777, src_id=123456, emergency=True)
            for op in (0x30, 0x31, 0x33, 0x34)]
    bits += [m.make_csbk_bits(0x3D, data_follows=True, blocks_to_follow=4, dst_id=9, src_id=8),
             m.make_csbk_bits(0x19, net=0x1234, site=7, ms_id=42)]
    bad = bits[1].copy()
    bad[40] ^= 1
    rand = [rng.integers(0, 2, 96).astype(np.uint8) for _ in range(20)]
    return bits + [m.parse_csbk(b) for b in bits + [bad] + rand]


def csbk_bursts(d, rng):
    m = d.dmr
    b = m.build_data_burst(m.make_csbk_bits(0x31, channel=101, slot=0, dst_id=2001, src_id=700123),
                           m.DataType.CSBK, color_code=7)
    dec = m.DMRDecoder()
    soft = np.concatenate([np.zeros(30, np.float32), m.DIBIT_SYMBOLS[b], np.zeros(30, np.float32)])
    soft = np.concatenate([soft, soft + rng.normal(0, 0.4, len(soft)).astype(np.float32)])
    bursts = []
    for i in range(0, len(soft), 97):  # odd chunks: the buffer crosses calls
        bursts += dec.process(soft[i:i + 97])
    return [b, bursts, [m.decode_burst(x) for x in bursts], dec.bursts_found]


def lc_bursts(d, rng):
    m = d.dmr
    idle = m.build_data_burst(np.zeros(96, np.uint8), m.DataType.IDLE)
    lc = m.make_full_lc_bits(m.DataType.VOICE_LC_HEADER, dst_id=300, src_id=400)
    hdr = m.build_data_burst(lc, m.DataType.VOICE_LC_HEADER, kind="BS_VOICE")
    term = m.make_full_lc_bits(m.DataType.TERMINATOR_WITH_LC, flco=0, dst_id=1234, src_id=567890)
    bad1, bad2 = term.copy(), term.copy()
    bad1[24:32] ^= 1
    bad2[24:32] ^= 1
    bad2[48:56] ^= 1
    burst = m.build_data_burst(m.make_csbk_bits(0x33, channel=55, dst_id=1, src_id=2), m.DataType.CSBK)
    burst[20] ^= 1
    burst[63] ^= 2
    return [m.decode_burst(m.DMRBurst(kind="BS_DATA", dibits=idle, sync_quality=1.0)),
            m.decode_burst(m.DMRBurst(kind="BS_VOICE", dibits=hdr, sync_quality=1.0)),
            m.parse_full_lc(bad1, m.DataType.TERMINATOR_WITH_LC), m.parse_full_lc(bad2, m.DataType.TERMINATOR_WITH_LC),
            m.parse_full_lc(term, m.DataType.VOICE_LC_HEADER),
            m.decode_burst(m.DMRBurst(kind="BS_DATA", dibits=burst, sync_quality=1.0))]


def cach(d, rng):
    m = d.dmr
    out = [m.decode_tact(m.encode_tact(at, tc, lcss)) for at in (0, 1) for tc in (0, 1) for lcss in range(4)]
    w0 = m.encode_tact(1, 0, 2)
    out += [m.decode_tact(np.bitwise_xor(w0, np.eye(7, dtype=w0.dtype)[p])) for p in range(7)]
    payload = rng.integers(0, 2, 17).astype(np.uint8)
    out.append(m.decode_cach(m.encode_cach(1, 1, 3, payload)))
    for slot in (0, 1):
        tb = m.build_test_burst("BS_DATA", tdma_slot=slot)
        out += [tb, m.burst_tdma_slot(tb)]
    burst = m.build_data_burst(m.make_csbk_bits(0x30, dst_id=800, src_id=900, channel=33), m.DataType.CSBK)
    c = m.encode_cach(1, 1, 0)
    burst[:12] = ((c[0::2] << 1) | c[1::2]).astype(np.uint8)
    bursts = m.DMRDecoder().process(m.DIBIT_SYMBOLS[burst].astype(np.float32))
    return out + [bursts, [m.decode_burst(b) for b in bursts]]


def voice_superframe(d, rng, stride: int):
    m = d.dmr
    ambe = rng.integers(0, 2, (18, 72)).astype(np.uint8)
    soft = m.DIBIT_SYMBOLS[m.build_voice_superframe(ambe, stride_bursts=stride, rng=rng)].astype(np.float32)
    tr = m.DMRVoiceTracker(stride_bursts=stride)
    sfs = []
    for i in range(0, len(soft), 301):
        sfs += tr.process(soft[i:i + 301])
    return [ambe, sfs, tr.superframes_found, m.DMRVoiceTracker().process(rng.normal(0, 1, 5000).astype(np.float32))]


def dual_slot(d, rng):
    m = d.dmr
    r = np.random.default_rng(21)
    a0, a1 = r.integers(0, 2, (18, 72)).astype(np.uint8), r.integers(0, 2, (18, 72)).astype(np.uint8)
    soft = m.DIBIT_SYMBOLS[m.build_dual_slot_voice_stream(a0, a1, rng=r)].astype(np.float32)
    out = []
    for slot in (0, 1):
        tr = m.DMRVoiceTracker(stride_bursts=2, tdma_slot=slot)
        sfs = []
        for i in range(0, len(soft), 307):
            sfs += tr.process(soft[i:i + 307])
        out += [sfs, tr.skipped_other_slot]
    single = m.DIBIT_SYMBOLS[m.build_voice_superframe(a0, stride_bursts=2, rng=rng, tdma_slot=0)].astype(np.float32)
    return out + [m.DMRVoiceTracker(stride_bursts=2, tdma_slot=s).process(single) for s in (1, 0)]


def voice_to_pcm(d, rng):
    """Encoder PCM -> AMBE frames -> DMR superframe -> tracker -> vocoder
    (``tests/test_ambe_vocoder.py:TestDmrVoiceEndToEnd``)."""
    t = np.arange(int(0.6 * 8000)) / 8000.0
    x = sum(a * np.sin(2 * np.pi * 150.0 * k * t) for k, a in ((1, 1.0), (2, 0.6), (3, 0.45), (4, 0.3), (5, 0.2)))
    frames = d.ambe.AmbeEncoder().encode((0.3 * x / np.max(np.abs(x))).astype(np.float32))
    soft = d.dmr.DIBIT_SYMBOLS[d.dmr.build_voice_superframe(ambe_bits=frames[:18])]
    sfs = d.dmr.DMRVoiceTracker().process(np.concatenate([soft, np.zeros(600, np.float32)]))
    return [frames, sfs, d.ambe.AmbeDecoder().decode_frames(sfs[0].ambe_bits)]


CASES = {
    "slot_type": slot_type,
    "csbk": csbk,
    "csbk_bursts": csbk_bursts,
    "lc_bursts": lc_bursts,
    "cach": cach,
    "voice_superframe": lambda d, rng: voice_superframe(d, rng, 1),
    "voice_superframe_stride2": lambda d, rng: voice_superframe(d, rng, 2),
    "dual_slot": dual_slot,
    "voice_to_pcm": voice_to_pcm,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_dmr_matches_reference(name):
    run_case(CASES[name])


def test_csbk_fields_decode():
    """The equal results are the sent fields, not two equal failures."""
    msgs = run_case(csbk_bursts)[2]
    assert len(msgs) == 2 and all(m["type"] == "TV_GRANT" and m["dst_id"] == 2001 for m in msgs)


@pytest.mark.parametrize("cls", ["DMRDecoder", "DMRVoiceTracker"])
def test_dmr_hand_over_mid_stream(cls):
    """The reference takes the stream up to a cut inside a burst, hands its
    decoder over, the port takes the rest: the bursts (superframes) equal
    the reference's alone."""
    m = REF.dmr
    rng = np.random.default_rng(31)
    if cls == "DMRDecoder":
        one = m.build_data_burst(m.make_csbk_bits(0x31, channel=9, dst_id=5, src_id=6), m.DataType.CSBK)
        soft = np.concatenate([m.DIBIT_SYMBOLS[one], rng.normal(0, 0.3, 40).astype(np.float32)] * 5)
        make = m.DMRDecoder
    else:
        ambe = rng.integers(0, 2, (18, 72)).astype(np.uint8)
        soft = np.concatenate([m.DIBIT_SYMBOLS[m.build_voice_superframe(ambe, rng=rng)].astype(np.float32)] * 2)
        make = m.DMRVoiceTracker
    cut = len(soft) // 2 + 17
    alone = make()
    want = alone.process(soft[:cut]) + alone.process(soft[cut:])
    ref = make()
    got = ref.process(soft[:cut])
    port = convert.decoder_state_from_reference(ref)
    assert type(port).__module__ == "wavecap_tpu_torch.decoders.dmr"
    got += port.process(soft[cut:])
    assert len(want) >= 2 and canon(got) == canon(want)
    assert canon(vars(port)) == canon(vars(alone))
