"""The port's P25 decoders (framer, NID / TSBK / PDU / LDU / HDU / TDULC
frames, link control and hexbit codecs, NAC tracker, LRRP, the Phase 2
MAC and superframe detector) against the JAX package's, on the CPU.

Each case runs the same seeded inputs through both packages and requires
the results equal exactly (``tests/test_torch_decoders_fec.py:run_case``).
The cases follow ``tests/test_nac_tracker.py``, ``tests/test_p25_roundtrip.py``,
``tests/test_p25_voice_meta.py``, the RS codec cases of ``tests/test_rs.py``,
the TSBK parser cases of ``tests/test_fec.py``, ``tests/test_p25_mac.py``
and the Phase 2 framing cases of ``tests/test_cqpsk_phase2.py:88-124``.
The modem round trips take their soft symbols from the port's own C4FM
demodulator on the CPU (the same symbols into both packages' framers).
Cases that need the trunking layer (``trunking.control``,
``trunking.events``, ``trunking.recorder``) wait for the slice that ports
it (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_decoders_fec import flip, run_case

torch.set_num_threads(1)

_SOFT: dict = {}


def c4fm_soft(key, iq: np.ndarray, block: int = 4800, **cfg) -> np.ndarray:
    """Per-block soft symbols of the port's C4FM demodulator (48 kHz,
    ``device="cpu"``), computed once per ``key``."""
    if key not in _SOFT:
        from wavecap_tpu_torch.models.p25 import c4fm

        c = c4fm.C4fmConfig(sample_rate=48_000, **cfg)
        st = c4fm.c4fm_init(c, device="cpu")
        out = []
        for i in range(len(iq) // block):
            soft, _, st = c4fm.c4fm_demodulate(torch.from_numpy(iq[i * block:(i + 1) * block].copy()), st, c)
            out.append(soft.numpy().copy())
        _SOFT[key] = out
    return _SOFT[key]


def modulate(dibits: np.ndarray) -> np.ndarray:
    from wavecap_tpu_torch.models.p25.c4fm import modulate_c4fm

    return modulate_c4fm(dibits, 48_000)


def control_dibits(d, nac=0x293, n_frames=8):
    """TSDU frames with idle dibits between them
    (``tests/test_p25_roundtrip.py:make_control_channel_dibits``)."""
    rng = np.random.default_rng(5)
    pieces = []
    for k in range(n_frames):
        grant = d.pf.encode_tsbk_block(d.tsbk.TSBKOpcode.GRP_V_CH_GRANT, d.tsbk.make_group_grant_data(
            tgid=100 + k, source_id=7_000_000 + k, band=1, channel_number=0x123))
        iden = d.pf.encode_tsbk_block(d.tsbk.TSBKOpcode.IDEN_UP,
                                      d.tsbk.make_iden_up_data(identifier=1, base_freq_mhz=851.00625))
        rfss = d.pf.encode_tsbk_block(d.tsbk.TSBKOpcode.RFSS_STS_BCAST, d.tsbk.make_rfss_status_data(
            system_id=0x2F5, rfss_id=1, site_id=3, band=1, channel_number=0x0AA), last=True)
        pieces += [d.pf.build_tsdu_frame(nac, [grant, iden, rfss]), rng.integers(0, 4, size=60).astype(np.uint8)]
    return np.concatenate(pieces)


def decode_frames(d, frames) -> list:
    """Each frame with what the consumers decode of it: TSBKs (parsed when
    their CRC holds), PDUs, LDUs."""
    out = []
    for f in frames:
        item = [f]
        if f.duid == d.pf.DUID.TSDU:
            pl = d.pf.remove_status_dibits(f.dibits[57:], 57)
            sl = d.pf.remove_status_dibits(f.soft[57:], 57)
            for b in d.pf.decode_tsbk_payload(pl, sl):
                item += [b, d.tsbk.parse_tsbk(b.opcode, b.mfid, b.data) if b.crc_valid else None]
        elif f.duid == d.pf.DUID.PDU:
            item.append(d.pf.decode_pdu(d.pf.remove_status_dibits(f.dibits[57:], 57),
                                        d.pf.remove_status_dibits(f.soft[57:], 57)))
        elif f.duid in (d.pf.DUID.LDU1, d.pf.DUID.LDU2):
            item.append(d.pf.decode_ldu(f.dibits))
        out.append(item)
    return out


def frame_stream(d, softs, skip: int = 0) -> list:
    fr = d.framer.P25Framer()
    out = []
    for i, s in enumerate(softs):
        frames = fr.process(s)
        if i >= skip:
            out += decode_frames(d, frames)
    return out + [fr.sync_count, fr.frame_count, fr.nid_fail_count, fr.nid_assist_count]


# --- NAC tracker (tests/test_nac_tracker.py) --------------------------------------------


def nac_counts(d, rng):
    t = d.nac.NacTracker()
    out = []
    for i in range(3):
        t.observe(0x293, now=float(i))
        out.append(t.dominant(now=float(i)))
    t2 = d.nac.NacTracker()
    for i in range(5):
        t2.observe(0x111, now=float(i))
    for i in range(3):
        t2.observe(0x222, now=float(i))
    t3 = d.nac.NacTracker(ttl_s=10.0)
    for i in range(4):
        t3.observe(0x293, now=float(i))
    t4 = d.nac.NacTracker(max_tracked=2)
    for i in range(4):
        t4.observe(0xAAA, now=float(i))
    t4.observe(0xBBB, now=4.0)
    t4.observe(0xCCC, now=5.0)
    return out + [t2.dominant(now=5.0), t3.dominant(now=5.0), t3.dominant(now=100.0), t4, t]


def nid_bits(d, nac, duid):
    clean = d.pf.encode_nid(nac, duid)
    bits = np.zeros(64, np.uint8)
    bits[0::2], bits[1::2] = (clean >> 1) & 1, clean & 1
    return bits


def to_nid_dibits(bits):
    return np.insert((bits[0::2] << 1) | bits[1::2], 11, 0)


def nac_assist(d, rng):
    bits = nid_bits(d, 0x293, d.pf.DUID.TSDU)
    bad = bits.copy()
    bad[:12] ^= 1
    bad[[20, 40]] ^= 1
    out = [d.pf.decode_nid(to_nid_dibits(bad)), d.pf.decode_nid(to_nid_dibits(bad), assist_nac=0x293)]
    for n_err in (0, 5, 20):
        b = bits.copy()
        b[rng.choice(63, size=n_err, replace=False)] ^= 1
        out += [d.pf.decode_nid(to_nid_dibits(b)), d.pf.decode_nid(to_nid_dibits(b), assist_nac=0x111)]
    return out


def framer_learns_nac(d, rng):
    fr = d.framer.P25Framer()
    blk = d.pf.encode_tsbk_block(d.tsbk.TSBKOpcode.RFSS_STS_BCAST, d.tsbk.make_rfss_status_data(
        system_id=0x123, rfss_id=1, site_id=7, band=1, channel_number=0), last=True)
    frame = d.pf.build_tsdu_frame(0x293, [blk, blk, blk])
    pad = np.zeros(50, np.float32)
    out = [fr.process(np.concatenate([pad, d.pf.DIBIT_SYMBOLS[frame], pad])) for _ in range(3)]
    mangled = frame.copy()
    mangled[24:30] ^= 3
    out.append(fr.process(np.concatenate([pad, d.pf.DIBIT_SYMBOLS[mangled], pad])))
    # the tracker's timestamps are the host's monotonic clock: its counts only
    return out + [fr.nac_tracker.dominant(), fr.nid_assist_count, fr.sync_count, fr.frame_count,
                  {nac: ent[0] for nac, ent in fr.nac_tracker._seen.items()}]


# --- frames (tests/test_p25_roundtrip.py) ------------------------------------------------


def tsdu_bits(d, rng):
    dib = control_dibits(d, n_frames=1)
    rx = dib.copy()
    rx[[80, 150]] ^= 2
    out = []
    for x in (dib, rx):
        f = d.pf.decode_tsdu(x)
        out += [f] + [d.tsbk.parse_tsbk(b.opcode, b.mfid, b.data) for b in f.tsbk_blocks]
    return out + [d.tsbk.iden_from_parsed(out[2]).frequency_hz(0x123)]


def modem_clean(d, rng):
    iq = modulate(control_dibits(d, n_frames=6))
    iq = np.concatenate([np.ones(2000, np.complex64), iq, np.ones(2000, np.complex64)])
    return frame_stream(d, c4fm_soft("clean", iq))


def modem_noise_cfo(d, rng):
    r = np.random.default_rng(11)
    iq = modulate(control_dibits(d, n_frames=6))
    iq = iq * np.exp(2j * np.pi * 150.0 * np.arange(len(iq)) / 48_000)
    iq = iq + 0.2 * (r.standard_normal(len(iq)) + 1j * r.standard_normal(len(iq))).astype(np.complex64) / np.sqrt(2)
    iq = np.concatenate([np.zeros(1000, np.complex64), iq]).astype(np.complex64)
    return frame_stream(d, c4fm_soft("noise_cfo", iq))


def modem_inverted(d, rng):
    return frame_stream(d, c4fm_soft("inverted", np.conj(modulate(control_dibits(d, n_frames=2)))))


def soft_decision(d, rng):
    frame = control_dibits(d, n_frames=1)[:360]
    clean = d.pf.DIBIT_SYMBOLS[frame].astype(np.float32)
    out = [d.pf.decode_tsbk_payload(d.pf.remove_status_dibits(frame[57:], 57),
                                    d.pf.remove_status_dibits(clean[57:], 57))]
    for _ in range(30):
        noisy = clean + rng.normal(0, 1.25, len(frame)).astype(np.float32)
        hard = np.where(noisy >= 0, np.where(np.abs(noisy) >= 2, 1, 0),
                        np.where(np.abs(noisy) >= 2, 3, 2)).astype(np.uint8)
        pd, ps = d.pf.remove_status_dibits(hard[57:], 57), d.pf.remove_status_dibits(noisy[57:], 57)
        out += [d.pf.decode_tsbk_payload(pd), d.pf.decode_tsbk_payload(pd, ps)]
    return out


def pdu_codec(d, rng):
    out = []
    for fmt in (d.pf.PDU_FMT_UNCONFIRMED, d.pf.PDU_FMT_CONFIRMED):
        for n in (0, 1, 11, 12, 13, 40, 64, 100):
            data = bytes((i * 7) & 0xFF for i in range(n))
            payload = d.pf.encode_pdu(sap=0x04, llid=0x123456, data=data, fmt=fmt)
            soft = d.pf.DIBIT_SYMBOLS[payload] + rng.normal(0, 0.5, len(payload)).astype(np.float32)
            out += [payload, d.pf.decode_pdu(payload), d.pf.decode_pdu(payload, soft)]
        payload = d.pf.encode_pdu(sap=1, llid=9, data=bytes(32), fmt=fmt)
        for lo, hi, x in ((150, 151, 2), (120, 160, 1), (120, 170, 2)):
            bad = payload.copy()
            bad[lo:hi] = (bad[lo:hi] + x) % 4 if x == 2 and hi - lo > 1 else bad[lo:hi] ^ x
            out.append(d.pf.decode_pdu(bad))
    return out


def pdu_modem(d, rng):
    data = b"LRRP-style payload \x01\x02\x03\x04" * 3
    frame = d.pf.build_pdu_frame(0x293, d.pf.encode_pdu(sap=0x04, llid=0xBEEF, data=data))
    r = np.random.default_rng(9)
    stream = np.concatenate([r.integers(0, 4, 50).astype(np.uint8), frame, r.integers(0, 4, 300).astype(np.uint8)])
    iq = np.concatenate([np.ones(2000, np.complex64), modulate(stream), np.ones(2000, np.complex64)])
    return frame_stream(d, c4fm_soft("pdu", iq))


def acquisition(d, rng, phase0: int):
    data = d.tsbk.make_iden_up_data(identifier=1, base_freq_mhz=851.0)
    blocks = [d.pf.encode_tsbk_block(d.tsbk.TSBKOpcode.IDEN_UP, data, last=k == 2) for k in range(3)]
    iq = modulate(np.concatenate([d.pf.build_tsdu_frame(0x293, blocks) for _ in range(20)]))
    return frame_stream(d, c4fm_soft(("acq", phase0), iq[phase0:]), skip=2)


def c4fm_equalizer(d, rng):
    dib = np.concatenate([control_dibits(d, n_frames=1)[:360]] * 8)
    iq0 = modulate(dib)
    sig_p = float(np.mean(np.abs(iq0) ** 2))
    r = np.random.default_rng(31)
    k = int(round(70e-6 * 48_000))
    sig = iq0 + np.concatenate([np.zeros(k, np.complex64), iq0[:-k]]) * (0.8 * np.exp(1j * 2.98))
    sig = sig + np.sqrt(sig_p / 20) * (r.standard_normal(len(sig)) + 1j * r.standard_normal(len(sig)))
    x = np.concatenate([np.zeros(1000, np.complex64), sig.astype(np.complex64)])
    return frame_stream(d, c4fm_soft("eq", x, equalizer_taps=127))


# --- link control, HDU, TDULC, LDU, hexbit codecs (tests/test_p25_voice_meta.py, test_rs.py)


def hexbit_codecs(d, rng):
    out = []
    for v in range(64):
        cw = d.p25v.hamming106_encode(v)
        out += [cw] + [d.p25v.hamming106_decode(flip(cw, p)) for p in range(10)]
    for v in (0, 0x15, 0x3F):
        cw = d.p25v.golay186_encode(v)
        out += [cw] + [d.p25v.golay186_decode(flip(cw, rng.choice(18, 3, replace=False))) for _ in range(10)]
    return out


def link_control(d, rng):
    bits = d.p25v.make_group_lc_bits(tgid=4321, source_id=6_123_456, emergency=True)
    coded = d.p25v.encode_lc_hexbits(bits)
    one = coded.copy()
    one[::10] ^= 1
    burst = coded.copy()
    for w in rng.choice(24, 6, replace=False):
        burst[10 * w:10 * (w + 1)] ^= 1
    hexbits = [d.p25v._bits_to_int(bits[6 * i:6 * (i + 1)]) for i in range(12)] + [0] * 12
    legacy = np.concatenate([d.p25v.hamming106_encode(h) for h in hexbits])
    return [bits, coded] + [d.p25v.decode_lc_hexbits(x) for x in (coded, one, burst, legacy)]


def hdu(d, rng):
    payload = d.p25v.encode_hdu_payload(tgid=777, algid=0x84, kid=0xBEEF, mi=bytes(range(9)))
    burst = payload.copy()
    for w in rng.choice(36, 8, replace=False):
        burst[18 * w:18 * (w + 1)] ^= 1
    frame_bits = d.p25v.encode_hdu_payload(tgid=888, algid=0x80, kid=0x55AA)
    head = np.concatenate([d.pf.FRAME_SYNC_DIBITS, d.pf.encode_nid(0x123, d.pf.DUID.HDU)])
    frame = np.concatenate([d.pf.insert_status_dibits(head, 0),
                            d.pf.insert_status_dibits(d.pf.bits_to_dibits(frame_bits), 57)])
    frame = np.pad(frame, (0, max(0, 396 - len(frame))))
    return [payload, d.p25v.decode_hdu_payload(payload), d.p25v.decode_hdu_payload(burst), d.pf.decode_hdu(frame)]


def tdulc(d, rng):
    payload = d.pf.encode_tdulc_payload(d.p25v.make_group_lc_bits(tgid=1234, source_id=777_777))
    head = np.concatenate([d.pf.FRAME_SYNC_DIBITS, d.pf.encode_nid(0x293, d.pf.DUID.TDULC)])
    frame = np.concatenate([d.pf.insert_status_dibits(head, 0),
                            d.pf.insert_status_dibits(d.pf.bits_to_dibits(payload), 57)])
    frame = np.pad(frame, (0, max(0, 216 - len(frame))))
    bad = frame.copy()
    bad[rng.choice(np.arange(60, 200), 4, replace=False)] ^= 1
    return [payload, d.pf.decode_tdulc(frame), d.pf.decode_tdulc(bad)]


def ldu(d, rng):
    lc240 = d.p25v.encode_lc_hexbits(d.p25v.make_group_lc_bits(tgid=2001, source_id=42))
    cws = [rng.integers(0, 2, 144).astype(np.uint8) for _ in range(9)]
    out = []
    for duid in (d.pf.DUID.LDU1, d.pf.DUID.LDU2):
        frame = d.pf.build_ldu_frame(0x293, duid, lc240, imbe_codewords=cws)
        bad = frame.copy()
        bad[rng.choice(np.arange(60, len(frame)), 6, replace=False)] ^= 1
        out += [frame, d.pf.decode_ldu(frame), d.pf.decode_ldu(bad)]
    fr = d.framer.P25Framer()
    stream = np.concatenate([d.pf.build_ldu_frame(0x293, d.pf.DUID.LDU1, lc240, imbe_codewords=cws)] * 3)
    soft = d.pf.DIBIT_SYMBOLS[stream] + rng.normal(0, 0.3, len(stream)).astype(np.float32)
    return out + decode_frames(d, fr.process(np.concatenate([np.zeros(40, np.float32), soft])))


def lrrp_codec(d, rng):
    pkt = d.lrrp.encode_location_report(47.6062, -122.3321, altitude_m=56)
    locs = [d.lrrp.parse_lrrp(pkt, radio_id=777), d.lrrp.parse_lrrp(b""),
            d.lrrp.parse_lrrp(bytes(rng.integers(0x80, 0xFF, 40)))]
    locs = [None if x is None else dataclasses.replace(x, time=0.0) for x in locs]
    cache = d.lrrp.LocationCache(ttl_s=0.1)
    cache.update(d.lrrp.RadioLocation(radio_id=1, latitude=1.0, longitude=2.0, time=4e9))
    cache.update(d.lrrp.RadioLocation(radio_id=2, latitude=3.0, longitude=4.0, time=0.0))
    return [pkt] + locs + [cache.get(1), cache.get(2)]


def tsbk_parser(d, rng):
    t = d.tsbk
    out = [t.parse_tsbk(0x00, 0x90, bytes(8)), t.parse_tsbk(0x2E, 0, bytes(8)),
           t.parse_tsbk(t.TSBKOpcode.UU_V_CH_GRANT, 0, bytes([0x10, 0x42, 1, 2, 3, 4, 5, 6])),
           t.parse_tsbk(t.TSBKOpcode.NET_STS_BCAST, 0, bytes([0, 0xAB, 0xCD, 0xE1, 0x23, 0x10, 0x05, 0x70]))]
    for ctype in (0, 3, 4, 5):
        out.append(t.parse_tsbk(t.TSBKOpcode.IDEN_UP_TDMA, 0,
                                t.make_iden_up_tdma_data(identifier=1, base_freq_mhz=800.0, channel_type=ctype)))
    out += [t.parse_tsbk(t.TSBKOpcode.GRP_V_CH_GRANT, 0, t.make_group_grant_data(
                tgid=2001, source_id=700123, band=1, channel_number=56)),
            t.parse_tsbk(t.TSBKOpcode.ADJ_STS_BCAST, 0, t.make_adjacent_status_data(
                system_id=0x123, rfss_id=2, site_id=9, band=1, channel_number=77)),
            t.parse_tsbk(t.TSBKOpcode.RFSS_STS_BCAST, 0, t.make_rfss_status_data(
                system_id=0x2AA, rfss_id=1, site_id=6, band=1, channel_number=9)),
            t.make_sys_srv_data(0x1F)]
    for op in range(64):  # every opcode on random octets
        out.append(t.parse_tsbk(op, int(rng.integers(0, 2)) * 0x90, bytes(rng.integers(0, 256, 8).tolist())))
    return out


# --- Phase 2 MAC and framing (tests/test_p25_mac.py, tests/test_cqpsk_phase2.py:88-124) ----


def mac_pdus(d, rng):
    m, t = d.mac, d.tsbk
    grant = m.make_mac_message(0x00, t.make_group_grant_data(tgid=1001, source_id=42, band=1, channel_number=88))
    iden = m.make_mac_message(0x3D, t.make_iden_up_data(identifier=1, base_freq_mhz=851.0))
    good = m.make_mac_message(0x00, bytes(8))
    pdus = [m.make_mac_ptt(tgid=0x1234, source=0xABCDE, algid=0x80),
            m.make_mac_ptt(tgid=7, source=9, algid=0xAA, keyid=0x0101, mi=bytes(range(9))),
            m.make_mac_end_ptt(tgid=55, source=777), m.make_mac_content(m.MAC_HANGTIME, [grant, iden]),
            m.make_mac_content(m.MAC_IDLE, [good, bytes([0x20]) + bytes(8), good])]
    return pdus + [m.parse_mac_pdu(p) for p in pdus]


def mac_bursts(d, rng):
    m = d.mac
    payload = m.make_mac_ptt(tgid=0x0FA0, source=0x00BEEF)[:16]
    burst = m.encode_burst(m.BURST_FACCH, payload)
    sacch = m.encode_burst(m.BURST_SACCH, b"\x03")
    bad = sacch.copy()
    for idx in rng.choice(np.arange(m.PAYLOAD_DIBITS - 20) + 20, size=3, replace=False):
        bad[idx] ^= 2
    ts = m.encode_timeslot_burst(m.BURST_SACCH, b"\x03", with_sync=True)
    return [burst, m.decode_burst(burst), m.decode_burst(bad), m.decode_burst(rng.integers(0, 4, 180).astype(np.uint8)),
            ts, m.decode_burst(ts), m.encode_timeslot_burst(m.BURST_FACCH, m.make_mac_end_ptt(10, 1))]


def p2_detection(d, rng):
    frags = [d.p2.build_test_fragment() for _ in range(4)]
    soft = d.p2.DIBIT_SYMBOLS[np.concatenate(frags)] + rng.normal(0, 0.2, 4 * d.p2.FRAGMENT_DIBITS).astype(np.float32)
    det = d.p2.P25P2SuperFrameDetector()
    found = []
    for i in range(0, len(soft), 500):
        found += det.process(soft[i:i + 500])
    return found + [[f.bursts() for f in found], det]


def p2_rotation(d, rng):
    frag = d.p2.build_test_fragment()
    out = []
    for r in range(4):
        soft = d.p2.DIBIT_SYMBOLS[d.p2.rotate_dibits(frag, r)]
        out += d.p2.P25P2SuperFrameDetector().process(np.concatenate([soft, soft]))
    return out + [d.p2.rotate_dibits(np.array([0, 1, 2, 3], np.uint8), k) for k in range(5)]


CASES = {
    "nac_counts": nac_counts,
    "nac_assist": nac_assist,
    "framer_learns_nac": framer_learns_nac,
    "tsdu_bits": tsdu_bits,
    "modem_clean": modem_clean,
    "modem_noise_cfo": modem_noise_cfo,
    "modem_inverted": modem_inverted,
    "soft_decision": soft_decision,
    "pdu_codec": pdu_codec,
    "pdu_modem": pdu_modem,
    **{f"acquisition_phase{p}": (lambda d, rng, p=p: acquisition(d, rng, p)) for p in range(0, 10, 2)},
    "c4fm_equalizer": c4fm_equalizer,
    "hexbit_codecs": hexbit_codecs,
    "link_control": link_control,
    "hdu": hdu,
    "tdulc": tdulc,
    "ldu": ldu,
    "lrrp": lrrp_codec,
    "tsbk_parser": tsbk_parser,
    "mac_pdus": mac_pdus,
    "mac_bursts": mac_bursts,
    "p2_detection": p2_detection,
    "p2_rotation": p2_rotation,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_p25_decoders_match_reference(name):
    run_case(CASES[name])


def test_modem_cases_decode():
    """The port's demodulator feeds the framers real frames: the modem
    cases are not equal because both found nothing."""
    clean = run_case(modem_clean)
    tsbks = [x for item in clean[:-4] for x in item[1:] if isinstance(x, dict)]
    assert len(tsbks) >= 12 and any(t.get("tgid") == 100 for t in tsbks)
    eq = run_case(c4fm_equalizer)
    assert sum(isinstance(x, dict) for item in eq[:-4] for x in item[1:]) >= 12
    pdus = [item[1] for item in run_case(pdu_modem)[:-4] if len(item) > 1]
    assert pdus and pdus[0].crc32_valid
