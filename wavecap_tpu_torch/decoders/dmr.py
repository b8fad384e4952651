"""DMR decoder: basic framing + CACH/CSBK surface (reference ``decoders/dmr.py``).

DMR is 4FSK at 4800 symbols/s like P25 C4FM (different deviation map), so
the same on-device demodulator feeds this host-side framer.  Scope
mirrors the reference's "basic DMR framing, CSBK callback" — burst sync
detection (BS/MS data & voice patterns), slot typing, and payload
extraction; voice goes to DSD/AMBE when available.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

logger = logging.getLogger(__name__)

# 48-bit DMR sync patterns (ETSI TS 102 361-1)
SYNC_PATTERNS = {
    "BS_DATA": 0xDFF57D75DF5D,
    "BS_VOICE": 0x755FD7DF75F7,
    "MS_DATA": 0xD5D7F77FD757,
    "MS_VOICE": 0x7F7D5DD57DFD,
}

DIBIT_SYMBOLS = np.array([1.0, 3.0, -1.0, -3.0], np.float32)


def _pattern_dibits(pattern: int) -> np.ndarray:
    return np.array([(pattern >> (46 - 2 * i)) & 3 for i in range(24)], np.uint8)


SYNC_DIBITS = {k: _pattern_dibits(v) for k, v in SYNC_PATTERNS.items()}
SYNC_SYMBOLS = {k: DIBIT_SYMBOLS[v] for k, v in SYNC_DIBITS.items()}

BURST_DIBITS = 144  # 288 bits per burst (incl. 48-bit sync mid-burst)
SYNC_OFFSET = 66  # sync starts at dibit 66 of the 144-dibit burst


@dataclass
class DMRBurst:
    kind: str  # BS_DATA | BS_VOICE | MS_DATA | MS_VOICE
    dibits: np.ndarray  # full 144-dibit burst
    sync_quality: float

    @property
    def payload_bits(self) -> np.ndarray:
        """196 info bits: 98 dibits surrounding the sync (no CACH)."""
        d = np.concatenate(
            [self.dibits[:SYNC_OFFSET], self.dibits[SYNC_OFFSET + 24 :]]
        )
        out = np.empty(2 * len(d), np.uint8)
        out[0::2] = (d >> 1) & 1
        out[1::2] = d & 1
        return out


class DMRDecoder:
    """Streaming soft-symbol DMR burst framer."""

    def __init__(self, sync_threshold: float = 0.75):
        self.sync_threshold = sync_threshold
        self._buf = np.zeros(0, np.float32)
        self.bursts_found = 0
        self.on_burst: Callable[[DMRBurst], None] | None = None

    def process(self, soft: np.ndarray) -> list[DMRBurst]:
        self._buf = np.concatenate([self._buf, np.asarray(soft, np.float32)])
        out: list[DMRBurst] = []
        while True:
            n = len(self._buf)
            if n < BURST_DIBITS:
                break
            win = np.lib.stride_tricks.sliding_window_view(self._buf, 24)
            energies = np.einsum("ij,ij->i", win, win)
            best_kind, best_off, best_q = None, -1, 0.0
            for kind, sym in SYNC_SYMBOLS.items():
                nc = (win @ sym) / np.sqrt(
                    np.maximum(energies * float(sym @ sym), 1e-12)
                )
                hits = np.nonzero(nc > self.sync_threshold)[0]
                if len(hits) and (best_off < 0 or hits[0] < best_off):
                    best_kind, best_off, best_q = kind, int(hits[0]), float(nc[hits[0]])
            if best_off < 0:
                keep = BURST_DIBITS
                if n > keep:
                    self._buf = self._buf[-keep:]
                break
            start = best_off - SYNC_OFFSET
            if start < 0:
                self._buf = self._buf[best_off + 1 :]
                continue
            if n - start < BURST_DIBITS:
                self._buf = self._buf[start:]
                break
            soft_burst = self._buf[start : start + BURST_DIBITS]
            pos = soft_burst >= 0
            outer = np.abs(soft_burst) >= 2.0
            dibits = np.where(pos, np.where(outer, 1, 0), np.where(outer, 3, 2)).astype(
                np.uint8
            )
            burst = DMRBurst(kind=best_kind, dibits=dibits, sync_quality=best_q)
            self.bursts_found += 1
            if self.on_burst:
                self.on_burst(burst)
            out.append(burst)
            self._buf = self._buf[start + BURST_DIBITS :]
        return out


def build_test_burst(
    kind: str = "BS_DATA", rng=None, tdma_slot: int | None = None
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    d = rng.integers(0, 4, BURST_DIBITS).astype(np.uint8)
    d[SYNC_OFFSET : SYNC_OFFSET + 24] = SYNC_DIBITS[kind]
    if tdma_slot is not None:
        cach = encode_cach(1, tdma_slot, 0, rng.integers(0, 2, 17))
        d[:12] = _bits_to_dibits(cach)
    return d


# ---------------------------------------------------------------------------
# Slot type, CSBK, and full-LC parsing (ETSI TS 102 361-1 / -4).
#
# The reference's DMR decoder stops at placeholder sync + hand-waved field
# extraction (reference ``decoders/dmr.py:120-157``); this implements the
# real burst anatomy: Golay(20,8)-protected slot type, BPTC(196,96) info
# field, CSBK with masked CRC-CCITT, Tier III grant/aloha/preamble opcodes,
# and the voice LC header fields.
# ---------------------------------------------------------------------------

from enum import IntEnum

from .fec import bptc as _bptc
from .fec import golay as _golay
from .fec.rs import RS_12_9 as _rs129


class DataType(IntEnum):
    PI_HEADER = 0
    VOICE_LC_HEADER = 1
    TERMINATOR_WITH_LC = 2
    CSBK = 3
    MBC_HEADER = 4
    MBC_CONTINUATION = 5
    DATA_HEADER = 6
    RATE_12_DATA = 7
    RATE_34_DATA = 8
    IDLE = 9
    RATE_1_DATA = 10


# burst dibit geometry: CACH 0-11, info 12-60, slot-type 61-65,
# sync 66-89, slot-type 90-94, info 95-143
_ST_FIRST = slice(61, 66)
_ST_SECOND = slice(90, 95)
_INFO_FIRST = slice(12, 61)
_INFO_SECOND = slice(95, 144)


def _dibits_to_bits(d: np.ndarray) -> np.ndarray:
    out = np.empty(2 * len(d), np.uint8)
    out[0::2] = (d >> 1) & 1
    out[1::2] = d & 1
    return out


def _bits_to_dibits(b: np.ndarray) -> np.ndarray:
    return ((b[0::2] << 1) | b[1::2]).astype(np.uint8)


def encode_slot_type(color_code: int, data_type: int) -> np.ndarray:
    """(CC, data type) -> 20 slot-type bits.

    Golay(20,8,7) = the extended Golay(24,12) shortened by the 4 leading
    (zero) data bits (ETSI B.3.4).
    """
    data8 = ((color_code & 0xF) << 4) | (data_type & 0xF)
    return _golay.encode(data8)[4:]


def decode_slot_type(bits20: np.ndarray) -> tuple[int, int, int] | None:
    """20 bits -> (color_code, data_type, corrected_errors) or None."""
    full = np.concatenate([np.zeros(4, np.uint8), np.asarray(bits20, np.uint8)])
    data12, errs = _golay.decode(full)
    if errs < 0 or data12 > 0xFF:
        return None
    return (data12 >> 4) & 0xF, data12 & 0xF, errs


# ---------------------------------------------------------------------------
# CACH / TACT (ETSI TS 102 361-1 7.1.3, B.3.2, B.4)
#
# The 24-bit Common Announcement CHannel opens every outbound (BS) burst:
# a Hamming(7,4,3)-protected TACT word — AT (access type), TC (the TDMA
# channel number of the burst this CACH opens), LCSS (short-LC/CSBK
# fragment state) — interleaved with 17 payload bits of the short-LC
# fragment stream.  Decoding TC is what lets two concurrent voice calls
# on ONE carrier be routed to their own recorders (round 5; the reference
# ``decoders/dmr.py`` stops at burst sync and has no CACH at all).
# ---------------------------------------------------------------------------

# TACT bit positions within the 24-bit CACH (ETSI B.4 interleaving);
# the remaining 17 positions carry the fragment payload.
TACT_POSITIONS = (0, 4, 8, 12, 14, 18, 22)
_CACH_PAYLOAD_POSITIONS = tuple(
    i for i in range(24) if i not in TACT_POSITIONS
)


def encode_tact(at: int, tc: int, lcss: int) -> np.ndarray:
    """(AT, TC, LCSS) -> 7 Hamming(7,4,3)-protected TACT bits.

    Parity per ETSI B.3.2: c5=i1^i2^i3, c6=i2^i3^i4, c7=i1^i2^i4 over the
    data word [AT, TC, LCSS1, LCSS0]."""
    i1, i2 = int(at) & 1, int(tc) & 1
    i3, i4 = (int(lcss) >> 1) & 1, int(lcss) & 1
    return np.array(
        [i1, i2, i3, i4, i1 ^ i2 ^ i3, i2 ^ i3 ^ i4, i1 ^ i2 ^ i4], np.uint8
    )


def _tact_syndrome_table() -> dict:
    """syndrome (3 bits as int) -> error position, for 1-bit correction."""
    table = {}
    base = encode_tact(0, 0, 0)
    for pos in range(7):
        w = base.copy()
        w[pos] ^= 1
        i1, i2, i3, i4 = w[:4]
        s = (
            ((i1 ^ i2 ^ i3 ^ w[4]) << 2)
            | ((i2 ^ i3 ^ i4 ^ w[5]) << 1)
            | (i1 ^ i2 ^ i4 ^ w[6])
        )
        table[int(s)] = pos
    return table


_TACT_SYNDROMES = _tact_syndrome_table()


def decode_tact(bits7: np.ndarray) -> tuple[int, int, int, int] | None:
    """7 TACT bits -> (at, tc, lcss, corrected_errors) or None."""
    w = np.asarray(bits7, np.uint8).copy()
    i1, i2, i3, i4 = w[:4]
    s = int(
        ((i1 ^ i2 ^ i3 ^ w[4]) << 2)
        | ((i2 ^ i3 ^ i4 ^ w[5]) << 1)
        | (i1 ^ i2 ^ i4 ^ w[6])
    )
    errs = 0
    if s:
        pos = _TACT_SYNDROMES.get(s)
        if pos is None:  # pragma: no cover - all 3-bit syndromes map
            return None
        w[pos] ^= 1
        errs = 1
    return int(w[0]), int(w[1]), int((w[2] << 1) | w[3]), errs


def encode_cach(
    at: int, tc: int, lcss: int, payload17: np.ndarray | None = None
) -> np.ndarray:
    """24 CACH bits: interleaved TACT + short-LC fragment payload."""
    out = np.zeros(24, np.uint8)
    out[list(TACT_POSITIONS)] = encode_tact(at, tc, lcss)
    if payload17 is not None:
        out[list(_CACH_PAYLOAD_POSITIONS)] = np.asarray(payload17, np.uint8)[:17]
    return out


def decode_cach(bits24: np.ndarray) -> dict | None:
    """24 CACH bits -> {'at', 'tc', 'lcss', 'payload', 'errors'} or None."""
    bits = np.asarray(bits24, np.uint8)
    tact = decode_tact(bits[list(TACT_POSITIONS)])
    if tact is None:
        return None
    at, tc, lcss, errs = tact
    return {
        "at": at,
        "tc": tc,
        "lcss": lcss,
        "payload": bits[list(_CACH_PAYLOAD_POSITIONS)],
        "errors": errs,
    }


def burst_cach_bits(dibits: np.ndarray) -> np.ndarray:
    """First 12 dibits of a burst -> the 24 CACH bits."""
    return _dibits_to_bits(np.asarray(dibits, np.uint8)[:12])


def burst_tdma_slot(dibits: np.ndarray) -> int | None:
    """Decode the burst's CACH TC bit (which timeslot this burst is)."""
    cach = decode_cach(burst_cach_bits(dibits))
    return None if cach is None else cach["tc"]


CSBK_CRC_MASK = 0xA5A5
# Full LC is RS(12,9)-protected over GF(256); the 3 parity bytes are XORed
# with a per-header-type mask (ETSI TS 102 361-1 B.2.1 / B.3.6).
FLC_PARITY_MASKS = {
    1: 0x969696,  # VOICE_LC_HEADER
    2: 0x999999,  # TERMINATOR_WITH_LC
}

CSBK_OPCODES = {
    0x19: "C_ALOHA",
    0x1F: "P_MAINT",
    0x26: "NACK_RSP",
    0x30: "PV_GRANT",
    0x31: "TV_GRANT",
    0x32: "BTV_GRANT",
    0x33: "PD_GRANT",
    0x34: "TD_GRANT",
    0x3D: "PREAMBLE",
}

_GRANT_OPS = frozenset({0x30, 0x31, 0x32, 0x33, 0x34})


def _bits_to_int(bits: np.ndarray, start: int, n: int) -> int:
    v = 0
    for b in bits[start : start + n]:
        v = (v << 1) | int(b)
    return v


def parse_csbk(bits96: np.ndarray) -> dict | None:
    """96 BPTC-decoded bits -> parsed CSBK dict, or None on bad CRC.

    Layout (ETSI TS 102 361-1 9.3.3): LB(1) PF(1) CSBKO(6) FID(8)
    data(64) CRC-CCITT(16) xor 0xA5A5.
    """
    bits = np.asarray(bits96, np.uint8)
    from .fec import crc as _crc

    rx_crc = _bits_to_int(bits, 80, 16) ^ CSBK_CRC_MASK
    if _crc.crc16_ccitt_bits(bits[:80], init=0xFFFF) != rx_crc:
        return None
    opcode = _bits_to_int(bits, 2, 6)
    fid = _bits_to_int(bits, 8, 8)
    out = {
        "type": CSBK_OPCODES.get(opcode, f"CSBK_{opcode:02X}"),
        "opcode": opcode,
        "fid": fid,
        "last_block": bool(bits[0]),
    }
    d = bits[16:80]
    if opcode in _GRANT_OPS:
        out.update(
            channel=_bits_to_int(d, 0, 12),
            slot=int(d[12]),
            high_rate=bool(d[13]),
            emergency=bool(d[14]),
            dst_id=_bits_to_int(d, 16, 24),
            src_id=_bits_to_int(d, 40, 24),
        )
    elif opcode == 0x3D:  # preamble: data/CSBK follows, group flag, count
        out.update(
            data_follows=bool(d[0]),
            group=bool(d[1]),
            blocks_to_follow=_bits_to_int(d, 8, 8),
            dst_id=_bits_to_int(d, 16, 24),
            src_id=_bits_to_int(d, 40, 24),
        )
    elif opcode == 0x19:  # C_ALOHA: random-access parameters + site ids
        out.update(
            service_function=_bits_to_int(d, 0, 8),
            mask=_bits_to_int(d, 8, 5),
            net=_bits_to_int(d, 16, 16),
            site=_bits_to_int(d, 32, 8),
            ms_id=_bits_to_int(d, 40, 24),
        )
    else:
        out["data"] = bytes(np.packbits(d))
    return out


def make_csbk_bits(opcode: int, fid: int = 0, **fields) -> np.ndarray:
    """Build the 96 CSBK bits (with masked CRC) for round-trip tests."""
    from .fec import crc as _crc

    bits = np.zeros(96, np.uint8)
    bits[0] = 1  # last block
    for i in range(6):
        bits[2 + i] = (opcode >> (5 - i)) & 1
    for i in range(8):
        bits[8 + i] = (fid >> (7 - i)) & 1
    d = bits[16:80]

    def put(start, n, v):
        for i in range(n):
            d[start + i] = (int(v) >> (n - 1 - i)) & 1

    if opcode in _GRANT_OPS:
        put(0, 12, fields.get("channel", 0))
        d[12] = int(fields.get("slot", 0))
        d[13] = int(bool(fields.get("high_rate", False)))
        d[14] = int(bool(fields.get("emergency", False)))
        put(16, 24, fields.get("dst_id", 0))
        put(40, 24, fields.get("src_id", 0))
    elif opcode == 0x3D:
        d[0] = int(bool(fields.get("data_follows", False)))
        d[1] = int(bool(fields.get("group", True)))
        put(8, 8, fields.get("blocks_to_follow", 0))
        put(16, 24, fields.get("dst_id", 0))
        put(40, 24, fields.get("src_id", 0))
    elif opcode == 0x19:
        put(0, 8, fields.get("service_function", 0))
        put(8, 5, fields.get("mask", 0))
        put(16, 16, fields.get("net", 0))
        put(32, 8, fields.get("site", 0))
        put(40, 24, fields.get("ms_id", 0))
    c = _crc.crc16_ccitt_bits(bits[:80], init=0xFFFF) ^ CSBK_CRC_MASK
    for i in range(16):
        bits[80 + i] = (c >> (15 - i)) & 1
    return bits


def parse_full_lc(bits96: np.ndarray, data_type: int | None = None) -> dict:
    """Voice LC header / terminator payload -> fields (ETSI 9.1.6).

    72 LC bits: PF(1) R(1) FLCO(6) FID(8) service options(8) dst(24)
    src(24); the trailing 24 bits are RS(12,9) parity over GF(256), XORed
    with a per-header-type mask.  With ``data_type`` given, the parity is
    verified and a single corrupted byte is corrected (``rsOk`` /
    ``rsErrors``); fields come from the corrected LC when decoding
    succeeds, from the raw bits otherwise.
    """
    bits = np.asarray(bits96, np.uint8)
    rs_ok = None
    rs_errors = None
    if data_type in FLC_PARITY_MASKS:
        cw = np.packbits(bits).astype(np.int64)
        mask = FLC_PARITY_MASKS[data_type]
        cw[9] ^= (mask >> 16) & 0xFF
        cw[10] ^= (mask >> 8) & 0xFF
        cw[11] ^= mask & 0xFF
        decoded = _rs129.decode(cw)
        if decoded is not None:
            data, rs_errors = decoded
            rs_ok = True
            bits = np.unpackbits(np.asarray(data, np.uint8))
        else:
            rs_ok = False
    out = {
        "protected": bool(bits[0]),
        "flco": _bits_to_int(bits, 2, 6),
        "fid": _bits_to_int(bits, 8, 8),
        "service_options": _bits_to_int(bits, 16, 8),
        "dst_id": _bits_to_int(bits, 24, 24),
        "src_id": _bits_to_int(bits, 48, 24),
    }
    if rs_ok is not None:
        out["rsOk"] = rs_ok
        if rs_errors is not None:
            out["rsErrors"] = int(rs_errors)
    return out


def make_full_lc_bits(
    data_type: int,
    flco: int = 0,
    fid: int = 0,
    service_options: int = 0,
    dst_id: int = 0,
    src_id: int = 0,
    protected: bool = False,
) -> np.ndarray:
    """Build the 96 full-LC bits (RS(12,9) parity, masked) for tests."""
    bits = np.zeros(96, np.uint8)

    def put(start: int, n: int, value: int) -> None:
        for i in range(n):
            bits[start + i] = (value >> (n - 1 - i)) & 1

    bits[0] = int(protected)
    put(2, 6, flco)
    put(8, 8, fid)
    put(16, 8, service_options)
    put(24, 24, dst_id)
    put(48, 24, src_id)
    data = np.packbits(bits[:72])
    parity = _rs129.encode(list(data))
    mask = FLC_PARITY_MASKS.get(data_type, 0)
    put(72, 8, parity[0] ^ ((mask >> 16) & 0xFF))
    put(80, 8, parity[1] ^ ((mask >> 8) & 0xFF))
    put(88, 8, parity[2] ^ (mask & 0xFF))
    return bits


def burst_info_bits(burst: "DMRBurst") -> np.ndarray:
    """The 196-bit BPTC info field (payload halves around slot type + sync)."""
    return np.concatenate(
        [
            _dibits_to_bits(burst.dibits[_INFO_FIRST]),
            _dibits_to_bits(burst.dibits[_INFO_SECOND]),
        ]
    )


def decode_burst(burst: "DMRBurst") -> dict | None:
    """Burst -> parsed message dict (slot type + typed payload), or None."""
    st = decode_slot_type(
        np.concatenate(
            [
                _dibits_to_bits(burst.dibits[_ST_FIRST]),
                _dibits_to_bits(burst.dibits[_ST_SECOND]),
            ]
        )
    )
    if st is None:
        return None
    color_code, dtype, errs = st
    out = {
        "colorCode": color_code,
        "dataType": int(dtype),
        "dataTypeName": DataType(dtype).name if dtype <= 10 else f"DT_{dtype}",
        "slotTypeErrors": errs,
        "kind": burst.kind,
        # CACH TC bit: which timeslot this burst is (BS streams only;
        # None when the TACT doesn't decode, e.g. MS bursts / noise)
        "cachSlot": burst_tdma_slot(burst.dibits),
    }
    if dtype == DataType.IDLE:
        return out
    info, clean = _bptc.decode_bptc_196(burst_info_bits(burst))
    out["bptcClean"] = clean
    if dtype == DataType.CSBK:
        parsed = parse_csbk(info)
        if parsed is not None:
            out.update(parsed)
        else:
            out["crcError"] = True
    elif dtype in (DataType.VOICE_LC_HEADER, DataType.TERMINATOR_WITH_LC):
        out.update(parse_full_lc(info, int(dtype)))
    else:
        out["data"] = bytes(np.packbits(info))
    return out


def build_data_burst(
    info_bits96: np.ndarray,
    data_type: int,
    color_code: int = 1,
    kind: str = "BS_DATA",
) -> np.ndarray:
    """Full 144-dibit burst: CACH zeros + BPTC info + slot type + sync."""
    coded = _bptc.encode_bptc_196(info_bits96)
    st = encode_slot_type(color_code, data_type)
    d = np.zeros(BURST_DIBITS, np.uint8)
    d[_INFO_FIRST] = _bits_to_dibits(coded[:98])
    d[_INFO_SECOND] = _bits_to_dibits(coded[98:])
    d[_ST_FIRST] = _bits_to_dibits(st[:10])
    d[_ST_SECOND] = _bits_to_dibits(st[10:])
    d[SYNC_OFFSET : SYNC_OFFSET + 24] = SYNC_DIBITS[kind]
    return d


# ---------------------------------------------------------------------------
# Voice superframes (ETSI TS 102 361-1 6.1): each voice burst carries
# three 72-bit AMBE+2 frames, the second straddling the 48-bit centre.
# Frame A of a superframe carries the voice sync; frames B-F replace it
# with EMB + embedded signalling, so they CANNOT be found by sync
# correlation — they are recovered by cadence from frame A.  The
# reference never gets here (its DMR decoder stops at burst sync); frames
# synthesize PCM through the native half-rate vocoder
# (decoders/ambe_vocoder.py) and also persist as .ambe.
# ---------------------------------------------------------------------------

_CACH_DIBITS = 12  # common announcement channel, start of burst
_VOICE_HALF = SYNC_OFFSET - _CACH_DIBITS  # 54 dibits = 108 bits per half
VOICE_FRAMES_PER_SUPERFRAME = 6
AMBE_FRAME_BITS = 72


def extract_ambe_frames(dibits: np.ndarray) -> np.ndarray:
    """(3, 72) AMBE+2 frame bits from one 144-dibit voice burst."""
    d = np.asarray(dibits, np.uint8)
    first = _dibits_to_bits(d[_CACH_DIBITS:SYNC_OFFSET])
    second = _dibits_to_bits(d[SYNC_OFFSET + 24 :])
    return np.stack(
        [
            first[:AMBE_FRAME_BITS],
            np.concatenate([first[AMBE_FRAME_BITS:], second[:36]]),
            second[36:],
        ]
    )


def burst_centre_bits(dibits: np.ndarray) -> np.ndarray:
    """48-bit burst centre: voice sync (frame A) or EMB + embedded
    signalling (frames B-F, reported raw)."""
    return _dibits_to_bits(np.asarray(dibits, np.uint8)[SYNC_OFFSET : SYNC_OFFSET + 24])


@dataclass
class DMRVoiceSuperframe:
    kind: str  # BS_VOICE | MS_VOICE
    ambe_bits: np.ndarray  # (18, 72) — six bursts x three frames
    embedded: np.ndarray  # (5, 48) raw centre bits of frames B-F
    sync_quality: float


class DMRVoiceTracker:
    """Streaming voice superframe assembler.

    ``stride_bursts=2`` models a repeater TDMA stream where the two
    timeslots alternate (consecutive frames of one slot are 288 dibits
    apart); ``1`` models a continuous single-slot transmission.

    ``tdma_slot`` (round 5): route by the anchor burst's CACH TC bit —
    only superframes whose frame-A CACH decodes to this timeslot are
    assembled, so two trackers (two recorders) on one repeater carrier
    each follow their own call instead of double-capturing mixed audio.
    ``None`` keeps the slot-blind behavior (single-slot streams, or MS
    transmissions which carry no CACH).
    """

    def __init__(
        self,
        sync_threshold: float = 0.75,
        stride_bursts: int = 1,
        tdma_slot: int | None = None,
    ):
        self._dec = DMRDecoder(sync_threshold)
        self.stride = int(stride_bursts)
        self.tdma_slot = tdma_slot
        self._buf = np.zeros(0, np.float32)
        self.superframes_found = 0
        self.skipped_other_slot = 0

    def process(self, soft: np.ndarray) -> list[DMRVoiceSuperframe]:
        self._buf = np.concatenate([self._buf, np.asarray(soft, np.float32)])
        out: list[DMRVoiceSuperframe] = []
        span = BURST_DIBITS * (1 + (VOICE_FRAMES_PER_SUPERFRAME - 1) * self.stride)
        while True:
            # find the next voice-sync burst with a full superframe behind it
            n = len(self._buf)
            win_ok = n >= BURST_DIBITS
            start = -1
            kind, quality = "", 0.0
            if win_ok:
                win = np.lib.stride_tricks.sliding_window_view(self._buf, 24)
                energies = np.einsum("ij,ij->i", win, win)
                for k in ("BS_VOICE", "MS_VOICE"):
                    sym = SYNC_SYMBOLS[k]
                    nc = (win @ sym) / np.sqrt(
                        np.maximum(energies * float(sym @ sym), 1e-12)
                    )
                    hits = np.nonzero(nc > self._dec.sync_threshold)[0]
                    for h in hits:
                        s = int(h) - SYNC_OFFSET
                        if s >= 0 and (start < 0 or s < start):
                            start, kind, quality = s, k, float(nc[h])
                            break
            if start < 0:
                keep = span
                if n > keep:
                    self._buf = self._buf[-keep:]
                break
            if self.tdma_slot is not None:
                # CACH slot routing: need the anchor burst's first dibits
                if n - start < BURST_DIBITS:
                    self._buf = self._buf[start:]
                    break
                anchor = self._buf[start : start + BURST_DIBITS]
                pos = anchor >= 0
                outer = np.abs(anchor) >= 2.0
                d = np.where(
                    pos, np.where(outer, 1, 0), np.where(outer, 3, 2)
                ).astype(np.uint8)
                slot = burst_tdma_slot(d)
                if slot != self.tdma_slot:
                    # other timeslot's transmission (or undecodable TACT):
                    # step past this burst; the next anchor candidate is
                    # the other slot's frame A one burst later
                    self.skipped_other_slot += 1
                    self._buf = self._buf[start + BURST_DIBITS :]
                    continue
            if n - start < span:
                self._buf = self._buf[start:]
                break
            frames = []
            embedded = []
            for i in range(VOICE_FRAMES_PER_SUPERFRAME):
                a = start + i * self.stride * BURST_DIBITS
                soft_burst = self._buf[a : a + BURST_DIBITS]
                pos = soft_burst >= 0
                outer = np.abs(soft_burst) >= 2.0
                d = np.where(
                    pos, np.where(outer, 1, 0), np.where(outer, 3, 2)
                ).astype(np.uint8)
                frames.append(extract_ambe_frames(d))
                if i > 0:
                    embedded.append(burst_centre_bits(d))
            out.append(
                DMRVoiceSuperframe(
                    kind=kind,
                    ambe_bits=np.concatenate(frames),
                    embedded=np.stack(embedded),
                    sync_quality=quality,
                )
            )
            self.superframes_found += 1
            self._buf = self._buf[start + span :]
        return out


def build_voice_superframe(
    ambe_bits: np.ndarray | None = None,
    kind: str = "BS_VOICE",
    stride_bursts: int = 1,
    rng=None,
    tdma_slot: int | None = None,
) -> np.ndarray:
    """Synthesize a 6-burst voice superframe's dibits (tests).

    ``ambe_bits`` is (18, 72); defaults to random frames.  With
    ``stride_bursts=2`` the other slot's positions are filled with data
    bursts, modelling a repeater TDMA stream.  ``tdma_slot`` writes a
    real CACH (TACT TC = slot) into every voice burst — and tags the
    stride filler bursts with the OTHER slot — so CACH slot routing is
    exercised end to end.
    """
    rng = rng or np.random.default_rng(0)
    if ambe_bits is None:
        ambe_bits = rng.integers(0, 2, (18, AMBE_FRAME_BITS)).astype(np.uint8)
    assert ambe_bits.shape == (18, AMBE_FRAME_BITS)
    other = (1 - tdma_slot) if tdma_slot in (0, 1) else None
    bursts = []
    for i in range(VOICE_FRAMES_PER_SUPERFRAME):
        f1, f2, f3 = ambe_bits[3 * i : 3 * i + 3]
        first = np.concatenate([f1, f2[:36]])
        second = np.concatenate([f2[36:], f3])
        d = np.zeros(BURST_DIBITS, np.uint8)
        if tdma_slot is None:
            d[:_CACH_DIBITS] = rng.integers(0, 4, _CACH_DIBITS)
        else:
            d[:_CACH_DIBITS] = _bits_to_dibits(
                encode_cach(1, tdma_slot, 0, rng.integers(0, 2, 17))
            )
        d[_CACH_DIBITS:SYNC_OFFSET] = _bits_to_dibits(first)
        d[SYNC_OFFSET + 24 :] = _bits_to_dibits(second)
        if i == 0:
            d[SYNC_OFFSET : SYNC_OFFSET + 24] = SYNC_DIBITS[kind]
        else:  # EMB + embedded signalling stand-in (opaque to the tracker)
            d[SYNC_OFFSET : SYNC_OFFSET + 24] = rng.integers(0, 4, 24)
        bursts.append(d)
        for _ in range(stride_bursts - 1):
            bursts.append(build_test_burst("BS_DATA", rng=rng, tdma_slot=other))
    return np.concatenate(bursts)


def build_dual_slot_voice_stream(
    ambe_slot0: np.ndarray | None = None,
    ambe_slot1: np.ndarray | None = None,
    kind: str = "BS_VOICE",
    rng=None,
) -> np.ndarray:
    """Interleaved repeater TDMA stream: TWO concurrent voice calls, one
    per timeslot, each a 6-burst superframe with its CACH TC tag — the
    exact on-air shape a Tier III carrier has when both slots are granted
    (tests; the single-slot tracker double-captures this, the slot-routed
    trackers separate it)."""
    rng = rng or np.random.default_rng(0)
    a = build_voice_superframe(
        ambe_slot0, kind=kind, stride_bursts=1, rng=rng, tdma_slot=0
    ).reshape(VOICE_FRAMES_PER_SUPERFRAME, BURST_DIBITS)
    b = build_voice_superframe(
        ambe_slot1, kind=kind, stride_bursts=1, rng=rng, tdma_slot=1
    ).reshape(VOICE_FRAMES_PER_SUPERFRAME, BURST_DIBITS)
    out = np.empty((2 * VOICE_FRAMES_PER_SUPERFRAME, BURST_DIBITS), np.uint8)
    out[0::2] = a
    out[1::2] = b
    return out.reshape(-1)
