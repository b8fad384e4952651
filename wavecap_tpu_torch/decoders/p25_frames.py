"""P25 Phase 1 frame structure: sync, NID, TSDU/TSBK extraction + synthesis.

Protocol facts (TIA-102.BAAA / .AABB, layout cross-checked against the
reference's SDRTrunk-derived implementation, reference
``decoders/p25_frames.py``):

  * one 48-bit frame sync ``0x5575F5FF77FF`` for all frame types
    (dibits ``1`` -> +3 and ``3`` -> -3 symbols only);
  * status symbols every 36 transmitted dibits (0-based positions 35,
    71, 107, ...), never part of the protected payload;
  * NID = NAC(12) + DUID(4) protected by BCH(63,16,23) + 1 pad bit
    (32 dibits on air; a status symbol lands at NID dibit 11);
  * TSDU carries up to 3 TSBKs, each 196 bits interleaved (formula-
    generated pattern: input group g of 4 bits -> output group
    ``(g%13)*4 + g//13``) over a 1/2-rate trellis, 96 bits decoded:
    LB(1) P(1) OPCODE(6) MFID(8) DATA(64) CRC(16).

Everything here is host-side numpy at symbol rate (not a hot path).
The synthesis half exists so the decoders can be round-trip tested and
so test signals can be generated (reference ``encoders/trunking/p25.py``
pattern).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from .fec import bch, crc, trellis

# ---------------------------------------------------------------------------
# Constants
# ---------------------------------------------------------------------------

FRAME_SYNC_PATTERN = 0x5575F5FF77FF
FRAME_SYNC_DIBITS = np.array(
    [(FRAME_SYNC_PATTERN >> (46 - 2 * i)) & 3 for i in range(24)], np.uint8
)
# Symbol values for dibits 0..3 (P25 C4FM constellation)
DIBIT_SYMBOLS = np.array([1.0, 3.0, -1.0, -3.0], np.float32)
SYNC_SYMBOLS = DIBIT_SYMBOLS[FRAME_SYNC_DIBITS]

STATUS_INTERVAL = 36  # a status symbol every 36 dibits (positions 35, 71, …)

SYNC_LEN = 24
NID_LEN = 33  # 32 data dibits + embedded status symbol


class DUID(IntEnum):
    HDU = 0x0
    TDU = 0x3
    LDU1 = 0x5
    TSDU = 0x7
    LDU2 = 0xA
    PDU = 0xC
    TDULC = 0xF


# Frame body length AFTER sync+NID, in on-air dibits (including statuses),
# per TIA frame sizes: total frame bits / 2 - 57.
FRAME_BODY_DIBITS = {
    DUID.HDU: 396 - 57,
    DUID.TDU: 72 - 57,
    DUID.LDU1: 864 - 57,
    DUID.LDU2: 864 - 57,
    DUID.TSDU: 360 - 57,
    DUID.PDU: 360 - 57,  # minimum; PDU is variable-length
    DUID.TDULC: 216 - 57,
}


def interleave_table() -> np.ndarray:
    """196-bit interleave: OUTPUT[table[i]] = input[i] when deinterleaving."""
    t = np.empty(196, np.int32)
    starts = [0, 13, 25, 37]  # row 0 has 13 groups, rows 1-3 have 12
    for g in range(49):
        row = 0 if g < 13 else 1 + (g - 13) // 12
        col = g - starts[row]
        og = 4 * col + row
        for b in range(4):
            t[4 * g + b] = 4 * og + b
    return t


_DEINT = interleave_table()


def deinterleave_196(bits: np.ndarray) -> np.ndarray:
    out = np.empty(196, np.uint8)
    out[_DEINT] = np.asarray(bits, np.uint8)
    return out


def interleave_196(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, np.uint8)[_DEINT]


def dibits_to_bits(dibits: np.ndarray) -> np.ndarray:
    d = np.asarray(dibits, np.uint8)
    out = np.empty(2 * len(d), np.uint8)
    out[0::2] = (d >> 1) & 1
    out[1::2] = d & 1
    return out


def bits_to_dibits(bits: np.ndarray) -> np.ndarray:
    b = np.asarray(bits, np.uint8)
    return ((b[0::2] << 1) | b[1::2]).astype(np.uint8)


def bits_to_int(bits: np.ndarray, start: int, width: int) -> int:
    v = 0
    for b in bits[start : start + width]:
        v = (v << 1) | int(b)
    return v


def remove_status_dibits(dibits: np.ndarray, frame_offset: int) -> np.ndarray:
    """Drop dibits at *frame* positions where (pos+1) % 36 == 0.

    ``frame_offset`` is the frame position of ``dibits[0]``.
    """
    idx = np.arange(len(dibits)) + frame_offset
    keep = (idx + 1) % STATUS_INTERVAL != 0
    return np.asarray(dibits)[keep]  # dtype-preserving (dibits or soft)


def insert_status_dibits(
    dibits: np.ndarray, frame_offset: int, status: int = 1
) -> np.ndarray:
    """Insert status symbols so the output occupies frame positions
    ``frame_offset...`` with statuses at every 36th position."""
    out = []
    pos = frame_offset
    i = 0
    d = np.asarray(dibits, np.uint8)
    while i < len(d):
        if (pos + 1) % STATUS_INTERVAL == 0:
            out.append(status)
        else:
            out.append(int(d[i]))
            i += 1
        pos += 1
    if (pos + 1) % STATUS_INTERVAL == 0:
        out.append(status)  # frames end on a status slot (e.g. TSDU pos 359)
    return np.array(out, np.uint8)


# ---------------------------------------------------------------------------
# NID
# ---------------------------------------------------------------------------


@dataclass
class NID:
    nac: int
    duid: DUID
    errors: int = 0
    assisted: bool = False  # recovered via dominant-NAC substitution


def decode_nid(
    nid_dibits: np.ndarray,
    has_status: bool = True,
    assist_nac: int | None = None,
) -> NID | None:
    """Decode the 33-dibit (or 32 pre-stripped) NID.

    With ``assist_nac`` (the channel's dominant NAC from
    ``nac_tracker.NacTracker``), a failed BCH decode is retried with the
    12 NAC bits overwritten — removing up to 12 bit errors so the
    BCH(63,16,23) can correct the remainder (reference
    ``decoders/nac_tracker.py`` / SDRTrunk NACTracker technique).
    """
    d = np.asarray(nid_dibits, np.uint8)
    if has_status:
        if len(d) < NID_LEN:
            return None
        d = np.delete(d[:NID_LEN], 11)  # frame pos 35 == NID pos 11
    else:
        if len(d) < 32:
            return None
        d = d[:32]
    bits = dibits_to_bits(d)
    data, errors = bch.decode(bits[:63])
    if errors < 0 and assist_nac is not None:
        retry = bits.copy()
        for i in range(12):
            retry[i] = (assist_nac >> (11 - i)) & 1
        data, errors = bch.decode(retry[:63])
        if errors >= 0 and ((data >> 4) & 0xFFF) == (assist_nac & 0xFFF):
            try:
                return NID(
                    nac=assist_nac & 0xFFF,
                    duid=DUID(data & 0xF),
                    errors=errors,
                    assisted=True,
                )
            except ValueError:
                return None
        errors = -1
    if errors < 0:
        # Fallback extraction (keeps the framer moving; marked unreliable)
        nac = bits_to_int(bits, 0, 12)
        duid_val = bits_to_int(bits, 12, 4)
        try:
            return NID(nac=nac, duid=DUID(duid_val), errors=99)
        except ValueError:
            return None
    nac = (data >> 4) & 0xFFF
    try:
        duid = DUID(data & 0xF)
    except ValueError:
        return None
    return NID(nac=nac, duid=duid, errors=errors)


def encode_nid(nac: int, duid: DUID) -> np.ndarray:
    """NAC+DUID -> 32 on-air dibits (without the embedded status symbol)."""
    cw = bch.encode(((nac & 0xFFF) << 4) | (int(duid) & 0xF))
    bits64 = np.concatenate([cw, [0]]).astype(np.uint8)  # pad/parity bit
    return bits_to_dibits(bits64)


# ---------------------------------------------------------------------------
# TSBK / TSDU
# ---------------------------------------------------------------------------


@dataclass
class TSBKBlock:
    last_block: bool
    protect: bool
    opcode: int
    mfid: int
    data: bytes  # 8 bytes
    crc_valid: bool
    error_metric: int = 0


@dataclass
class TSDUFrame:
    nid: NID
    tsbk_blocks: list


# dibit-level deinterleave (2 bits move together in the 196-bit pattern)
_DEINT_DIBITS = np.array([_DEINT[2 * j] // 2 for j in range(98)], np.int32)


def decode_tsbk_payload(
    payload_dibits: np.ndarray, payload_soft: np.ndarray | None = None
) -> list:
    """Decode up to 3 TSBKs from status-stripped TSDU payload dibits.

    With ``payload_soft`` (aligned soft symbols), trellis decoding uses
    Euclidean soft metrics and falls back to hard decisions if the CRC
    fails — worth ~1.5-2 dB at the sensitivity edge.
    """
    blocks = []
    d = np.asarray(payload_dibits, np.uint8)
    soft = None if payload_soft is None else np.asarray(payload_soft, np.float32)
    for i in range(3):
        chunk = d[i * 98 : (i + 1) * 98]
        if len(chunk) < 98:
            break
        bits = dibits_to_bits(chunk)
        deint = deinterleave_196(bits)
        decoded = None
        err = 0
        if soft is not None and len(soft) >= (i + 1) * 98:
            soft_chunk = soft[i * 98 : (i + 1) * 98]
            soft_deint = np.empty(98, np.float32)
            soft_deint[_DEINT_DIBITS] = soft_chunk
            sd, serr = trellis.viterbi_decode_soft(soft_deint.reshape(49, 2))
            cand = np.empty(96, np.uint8)
            cand[0::2] = (sd >> 1) & 1
            cand[1::2] = sd & 1
            if crc.tsbk_crc_check(cand):
                decoded = np.concatenate([cand, np.zeros(2, np.uint8)])
                err = int(serr)
        if decoded is None:
            decoded, err = trellis.viterbi_decode_bits(deint)
        ok = crc.tsbk_crc_check(decoded[:96])
        b = decoded
        block = TSBKBlock(
            last_block=bool(b[0]),
            protect=bool(b[1]),
            opcode=bits_to_int(b, 2, 6),
            mfid=bits_to_int(b, 8, 8),
            data=bytes(bits_to_int(b, 16 + 8 * j, 8) for j in range(8)),
            crc_valid=ok,
            error_metric=err,
        )
        blocks.append(block)
        if block.last_block and block.crc_valid:
            break
    return blocks


def decode_tsdu(
    frame_dibits: np.ndarray, frame_soft: np.ndarray | None = None
) -> TSDUFrame | None:
    """Full TSDU frame (starting at sync) -> NID + TSBKs."""
    d = np.asarray(frame_dibits, np.uint8)
    if len(d) < SYNC_LEN + NID_LEN + 98:
        return None
    nid = decode_nid(d[SYNC_LEN : SYNC_LEN + NID_LEN])
    if nid is None:
        return None
    payload = remove_status_dibits(d[57:], frame_offset=57)
    soft = (
        remove_status_dibits(frame_soft[57:], frame_offset=57)
        if frame_soft is not None
        else None
    )
    return TSDUFrame(nid=nid, tsbk_blocks=decode_tsbk_payload(payload, soft))


# ---------------------------------------------------------------------------
# LDU (voice) frames
# ---------------------------------------------------------------------------

# LDU payload layout after sync+NID, status symbols removed (bits):
# IMBE1 IMBE2 LC1 IMBE3 LC2 IMBE4 LC3 IMBE5 LC4 IMBE6 LC5 IMBE7 LC6 IMBE8
# LSD IMBE9  — IMBE codewords are 144 bits, LC chunks 40, LSD 32
# (TIA-102.BAAA voice LDU structure; the reference's extractor at
# decoders/p25_frames.py:986 is a simplified contiguous layout — we use
# the spec geometry).
_LDU_LAYOUT: list[tuple[str, int]] = [
    ("imbe", 144), ("imbe", 144),
    ("lc", 40), ("imbe", 144), ("lc", 40), ("imbe", 144),
    ("lc", 40), ("imbe", 144), ("lc", 40), ("imbe", 144),
    ("lc", 40), ("imbe", 144), ("lc", 40), ("imbe", 144),
    ("lsd", 32), ("imbe", 144),
]


@dataclass
class LDUFrame:
    nid: NID
    imbe_codewords: list  # 9 x 144-bit arrays (raw, pre vocoder FEC)
    lc_bits: np.ndarray  # 240 bits (LDU1: link control; LDU2: enc sync)
    lsd_bits: np.ndarray  # 32 bits


def decode_ldu(frame_dibits: np.ndarray) -> LDUFrame | None:
    """Full LDU frame (from sync) -> raw IMBE codewords + LC/LSD bits."""
    d = np.asarray(frame_dibits, np.uint8)
    if len(d) < 864:
        return None
    nid = decode_nid(d[SYNC_LEN : SYNC_LEN + NID_LEN])
    if nid is None:
        return None
    payload = remove_status_dibits(d[57:864], frame_offset=57)
    bits = dibits_to_bits(payload)
    imbe, lc, lsd = [], [], []
    pos = 0
    for kind, width in _LDU_LAYOUT:
        chunk = bits[pos : pos + width]
        pos += width
        if kind == "imbe":
            imbe.append(chunk)
        elif kind == "lc":
            lc.append(chunk)
        else:
            lsd.append(chunk)
    return LDUFrame(
        nid=nid,
        imbe_codewords=imbe,
        lc_bits=np.concatenate(lc) if lc else np.zeros(0, np.uint8),
        lsd_bits=np.concatenate(lsd) if lsd else np.zeros(0, np.uint8),
    )


# ---------------------------------------------------------------------------
# HDU / TDU / TDULC frames
# ---------------------------------------------------------------------------


def decode_hdu(frame_dibits: np.ndarray):
    """HDU frame (from sync) -> (NID, HduFields) or None."""
    from .p25_voice import decode_hdu_payload

    d = np.asarray(frame_dibits, np.uint8)
    if len(d) < 396:
        return None
    nid = decode_nid(d[SYNC_LEN : SYNC_LEN + NID_LEN])
    if nid is None:
        return None
    payload = remove_status_dibits(d[57:396], frame_offset=57)
    fields = decode_hdu_payload(dibits_to_bits(payload))
    return nid, fields


def decode_tdulc(frame_dibits: np.ndarray):
    """TDULC frame -> (NID, LinkControl) or None.

    Payload: 12 Golay(24,12) words carrying 24 hexbits (LC + RS parity).
    """
    from .fec import golay as golay_mod
    from .p25_voice import parse_link_control, _int_to_bits

    d = np.asarray(frame_dibits, np.uint8)
    if len(d) < 216:
        return None
    nid = decode_nid(d[SYNC_LEN : SYNC_LEN + NID_LEN])
    if nid is None:
        return None
    payload = remove_status_dibits(d[57:216], frame_offset=57)
    bits = dibits_to_bits(payload)
    hexbits = []
    errs = 0
    for i in range(12):
        if 24 * (i + 1) > len(bits):
            break
        data12, n = golay_mod.decode(bits[24 * i : 24 * (i + 1)])
        errs += 4 if n < 0 else n
        hexbits += [(data12 >> 6) & 0x3F, data12 & 0x3F]
    if len(hexbits) < 12:
        return None
    if len(hexbits) == 24 and any(hexbits[12:]):
        from .fec.rs import RS_24_12

        rs = RS_24_12.decode(hexbits)
        if rs is not None:
            lc_bits = np.concatenate([_int_to_bits(int(h), 6) for h in rs[0]])
            return nid, parse_link_control(lc_bits, errs + rs[1])
    lc_bits = np.concatenate([_int_to_bits(h, 6) for h in hexbits[:12]])
    return nid, parse_link_control(lc_bits, errs)


def build_ldu_frame(
    nac: int,
    duid: DUID,
    lc_bits240: np.ndarray,
    imbe_codewords: list | None = None,
    lsd_bits32: np.ndarray | None = None,
) -> np.ndarray:
    """Assemble a complete on-air LDU1/LDU2 frame (inverse of decode_ldu)."""
    imbe = list(imbe_codewords or [])
    while len(imbe) < 9:
        imbe.append(np.zeros(144, np.uint8))
    lc = np.asarray(lc_bits240, np.uint8)
    assert len(lc) == 240
    lsd = (
        np.asarray(lsd_bits32, np.uint8)
        if lsd_bits32 is not None
        else np.zeros(32, np.uint8)
    )
    pieces, ii, li = [], 0, 0
    for kind, width in _LDU_LAYOUT:
        if kind == "imbe":
            pieces.append(np.asarray(imbe[ii], np.uint8)[:144])
            ii += 1
        elif kind == "lc":
            pieces.append(lc[li : li + width])
            li += width
        else:
            pieces.append(lsd[:width])
    bits = np.concatenate(pieces)
    payload = bits_to_dibits(bits)
    head = insert_status_dibits(
        np.concatenate([FRAME_SYNC_DIBITS, encode_nid(nac, duid)]), 0
    )
    return np.concatenate(
        [head, insert_status_dibits(payload, 57)]
    ).astype(np.uint8)


def encode_tdulc_payload(lc_bits72: np.ndarray) -> np.ndarray:
    """72-bit LC -> 288 coded payload bits with real RS(24,12) parity."""
    from .fec import golay as golay_mod
    from .fec.rs import RS_24_12
    from .p25_voice import _bits_to_int

    data = [_bits_to_int(lc_bits72[6 * i : 6 * (i + 1)]) for i in range(12)]
    hexbits = data + RS_24_12.encode(data)
    out = []
    for i in range(12):
        data12 = (hexbits[2 * i] << 6) | hexbits[2 * i + 1]
        out.append(golay_mod.encode(data12))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# Synthesis (tests / encoders)
# ---------------------------------------------------------------------------


def encode_tsbk_block(
    opcode: int, data8: bytes, mfid: int = 0, last: bool = False, protect: bool = False
) -> np.ndarray:
    """Build one 98-dibit on-air TSBK (interleaved trellis-coded)."""
    assert len(data8) == 8
    bits = np.zeros(80, np.uint8)
    bits[0] = 1 if last else 0
    bits[1] = 1 if protect else 0
    for i in range(6):
        bits[2 + i] = (opcode >> (5 - i)) & 1
    for i in range(8):
        bits[8 + i] = (mfid >> (7 - i)) & 1
    for j, byte in enumerate(data8):
        for i in range(8):
            bits[16 + 8 * j + i] = (byte >> (7 - i)) & 1
    block96 = np.concatenate([bits, crc.tsbk_crc_encode(bits)])
    coded = trellis.encode_bits(block96)  # 196 bits
    return bits_to_dibits(interleave_196(coded))


def build_tsdu_frame(nac: int, tsbk_dibit_blocks: list) -> np.ndarray:
    """Assemble a complete on-air TSDU: sync + NID + payload + statuses.

    A standard-length TSDU carries exactly 3 TSBK blocks (TIA-102.BAAA);
    the streaming framer consumes the fixed TSDU body length, so frames
    built with fewer blocks only decode via the offline TSBK parser, not
    the live path — pass 3 blocks (repeat or end-mark) for on-air use."""
    payload = np.concatenate(list(tsbk_dibit_blocks))
    head = np.concatenate([FRAME_SYNC_DIBITS, encode_nid(nac, DUID.TSDU)])
    # statuses within head region: position 35 (inside NID)
    head_with_status = insert_status_dibits(head, 0)
    assert len(head_with_status) == 57
    body_with_status = insert_status_dibits(payload, 57)
    return np.concatenate([head_with_status, body_with_status]).astype(np.uint8)


# ---------------------------------------------------------------------------
# PDU (Packet Data Unit, DUID 0xC) — TIA-102.BAAA-A data header/blocks.
#
# The reference only *classifies* PDU frames (reference ``decoders/p25.py:1413,
# 2255`` maps DUID 0xC to a fixed display length); here the header and
# unconfirmed / Alternate-MBT data blocks are fully decoded: each 98-dibit
# block is deinterleaved and 1/2-rate-trellis decoded exactly like a TSBK,
# the header carries a TSBK-style CRC16, and the assembled packet carries a
# trailing CRC32.  Confirmed data blocks use the 3/4-rate trellis (144 info
# bits: 7-bit serial + CRC-9 + 16 data octets per block) — the reference
# carries the 3/4 table but never wires it to PDUs.
# ---------------------------------------------------------------------------

PDU_FMT_UNCONFIRMED = 0b10101
PDU_FMT_CONFIRMED = 0b10110
PDU_FMT_AMBT = 0b10111  # Alternate Multi-Block Trunking control

PDU_SAP_TRUNKING = 0x3D


@dataclass
class PDUHeader:
    ack_needed: bool
    outbound: bool
    fmt: int
    sap: int
    mfid: int
    llid: int
    full_message: bool
    blocks_to_follow: int
    pad_count: int
    ns: int
    fsnf: int
    data_header_offset: int
    crc_valid: bool
    opcode: int | None = None  # AMBT only (octet 7 low 6 bits)


@dataclass
class PDUFrame:
    header: PDUHeader
    data: bytes  # assembled payload octets (pad + CRC32 stripped)
    crc32_valid: bool
    block_crc_ok: int  # decoded blocks (all trellis paths complete)
    block_total: int


def _decode_trellis_chunk(
    chunk_dibits: np.ndarray, chunk_soft: np.ndarray | None
) -> np.ndarray:
    """98 on-air dibits -> 96 decoded bits (soft metrics when available)."""
    if chunk_soft is not None:
        soft_deint = np.empty(98, np.float32)
        soft_deint[_DEINT_DIBITS] = np.asarray(chunk_soft, np.float32)
        sd, _ = trellis.viterbi_decode_soft(soft_deint.reshape(49, 2))
        out = np.empty(96, np.uint8)
        out[0::2] = (sd >> 1) & 1
        out[1::2] = sd & 1
        return out
    deint = deinterleave_196(dibits_to_bits(chunk_dibits))
    decoded, _ = trellis.viterbi_decode_bits(deint)
    return decoded[:96]


def _decode_trellis_chunk_34(
    chunk_dibits: np.ndarray, chunk_soft: np.ndarray | None
) -> np.ndarray:
    """98 on-air dibits -> 144 decoded bits via the 3/4-rate trellis."""
    if chunk_soft is not None:
        soft_deint = np.empty(98, np.float32)
        soft_deint[_DEINT_DIBITS] = np.asarray(chunk_soft, np.float32)
        tri, _ = trellis.viterbi_decode_soft_34(soft_deint.reshape(49, 2))
        out = np.empty(3 * len(tri), np.uint8)
        out[0::3] = (tri >> 2) & 1
        out[1::3] = (tri >> 1) & 1
        out[2::3] = tri & 1
        return out[:144]
    deint = deinterleave_196(dibits_to_bits(chunk_dibits))
    decoded, _ = trellis.viterbi_decode_bits_34(deint)
    return decoded[:144]


def decode_pdu_header(
    header_dibits: np.ndarray, header_soft: np.ndarray | None = None
) -> PDUHeader:
    """98 status-stripped dibits -> decoded PDU data header."""
    bits = _decode_trellis_chunk(np.asarray(header_dibits, np.uint8), header_soft)
    ok = crc.tsbk_crc_check(bits)
    fmt = bits_to_int(bits, 3, 5)
    return PDUHeader(
        ack_needed=bool(bits[1]),
        outbound=bool(bits[2]),
        fmt=fmt,
        sap=bits_to_int(bits, 10, 6),
        mfid=bits_to_int(bits, 16, 8),
        llid=bits_to_int(bits, 24, 24),
        full_message=bool(bits[48]),
        blocks_to_follow=bits_to_int(bits, 49, 7),
        pad_count=bits_to_int(bits, 59, 5),
        ns=bits_to_int(bits, 65, 3),
        fsnf=bits_to_int(bits, 68, 4),
        data_header_offset=bits_to_int(bits, 74, 6),
        crc_valid=ok,
        opcode=bits_to_int(bits, 58, 6) if fmt == PDU_FMT_AMBT else None,
    )


def decode_pdu(
    payload_dibits: np.ndarray, payload_soft: np.ndarray | None = None
) -> PDUFrame | None:
    """Status-stripped PDU payload (header + N data blocks) -> PDUFrame."""
    d = np.asarray(payload_dibits, np.uint8)
    if len(d) < 98:
        return None
    soft = None if payload_soft is None else np.asarray(payload_soft, np.float32)
    hdr = decode_pdu_header(d[:98], soft[:98] if soft is not None else None)
    n_blocks = min(hdr.blocks_to_follow, (len(d) - 98) // 98)
    confirmed = hdr.fmt == PDU_FMT_CONFIRMED
    data_bits: list[np.ndarray] = []
    blk_ok = 0
    for i in range(n_blocks):
        sl = slice(98 * (i + 1), 98 * (i + 2))
        s = soft[sl] if soft is not None else None
        if confirmed:
            b144 = _decode_trellis_chunk_34(d[sl], s)
            crc9_rx = bits_to_int(b144, 7, 9)
            db = b144[16:]
            if crc.crc9_p25(np.concatenate([b144[:7], db])) == crc9_rx:
                blk_ok += 1
            data_bits.append(db)
        else:
            data_bits.append(_decode_trellis_chunk(d[sl], s))
            blk_ok += 1
    crc32_ok = False
    payload = b""
    if data_bits:
        allbits = np.concatenate(data_bits)
        if len(allbits) >= 32:
            crc32_ok = crc.crc32_p25(allbits[:-32]) == bits_to_int(
                allbits, len(allbits) - 32, 32
            )
        octets = np.packbits(allbits).tobytes()
        # strip trailing CRC32 (4 octets) and pad (AMBT has no pad field —
        # the opcode occupies those header bits)
        pad = hdr.pad_count if hdr.fmt != PDU_FMT_AMBT else 0
        payload = octets[: max(0, len(octets) - 4 - pad)]
    return PDUFrame(
        header=hdr,
        data=payload,
        crc32_valid=crc32_ok,
        block_crc_ok=blk_ok,
        block_total=hdr.blocks_to_follow,
    )


def pdu_body_onair_dibits(blocks_to_follow: int) -> int:
    """On-air body length (incl. statuses) after sync+NID for a PDU with N
    data blocks: payload is 98*(1+N) dibits starting at frame position 57."""
    payload = 98 * (1 + blocks_to_follow)
    # statuses at absolute frame positions where (pos+1) % 36 == 0
    length = payload
    while True:
        n_status = (57 + length) // STATUS_INTERVAL - 57 // STATUS_INTERVAL
        need = payload + n_status
        if need == length:
            return length
        length = need


def encode_pdu(
    sap: int,
    llid: int,
    data: bytes,
    fmt: int = PDU_FMT_UNCONFIRMED,
    mfid: int = 0,
    outbound: bool = True,
    opcode: int = 0,
) -> np.ndarray:
    """Build status-stripped PDU payload dibits (header + data blocks).

    ``fmt=PDU_FMT_CONFIRMED`` emits 3/4-rate blocks (16 data octets each,
    7-bit serial + CRC-9 per block); other formats emit 1/2-rate blocks.
    """
    confirmed = fmt == PDU_FMT_CONFIRMED
    bits_per_block = 128 if confirmed else 96
    total_bits = len(data) * 8 + 32  # data + CRC32
    n_blocks = (total_bits + bits_per_block - 1) // bits_per_block
    pad = (n_blocks * bits_per_block - total_bits) // 8
    hdr = np.zeros(80, np.uint8)
    hdr[1] = 0  # A/N
    hdr[2] = 1 if outbound else 0
    for i in range(5):
        hdr[3 + i] = (fmt >> (4 - i)) & 1
    for i in range(6):
        hdr[10 + i] = (sap >> (5 - i)) & 1
    for i in range(8):
        hdr[16 + i] = (mfid >> (7 - i)) & 1
    for i in range(24):
        hdr[24 + i] = (llid >> (23 - i)) & 1
    hdr[48] = 1  # full message
    for i in range(7):
        hdr[49 + i] = (n_blocks >> (6 - i)) & 1
    if fmt == PDU_FMT_AMBT:
        for i in range(6):
            hdr[58 + i] = (opcode >> (5 - i)) & 1
    else:
        for i in range(5):
            hdr[59 + i] = (pad >> (4 - i)) & 1
    header96 = np.concatenate([hdr, crc.tsbk_crc_encode(hdr)])
    chunks = [bits_to_dibits(interleave_196(trellis.encode_bits(header96)))]
    data_bits = np.unpackbits(np.frombuffer(data, np.uint8))
    # pad sits between data and the trailing CRC32; the CRC covers data+pad
    pre = np.concatenate([data_bits, np.zeros(pad * 8, np.uint8)])
    crc32 = crc.crc32_p25(pre)
    crc_bits = np.array([(crc32 >> (31 - i)) & 1 for i in range(32)], np.uint8)
    allbits = np.concatenate([pre, crc_bits])
    for i in range(n_blocks):
        blk = allbits[bits_per_block * i : bits_per_block * (i + 1)]
        if confirmed:
            serial = np.array([(i >> (6 - j)) & 1 for j in range(7)], np.uint8)
            c9 = crc.crc9_p25(np.concatenate([serial, blk]))
            c9_bits = np.array([(c9 >> (8 - j)) & 1 for j in range(9)], np.uint8)
            block144 = np.concatenate([serial, c9_bits, blk])
            chunks.append(
                bits_to_dibits(interleave_196(trellis.encode_bits_34(block144)))
            )
        else:
            chunks.append(bits_to_dibits(interleave_196(trellis.encode_bits(blk))))
    return np.concatenate(chunks)


def build_pdu_frame(nac: int, payload_dibits: np.ndarray) -> np.ndarray:
    """Assemble a complete on-air PDU frame: sync + NID + payload + statuses."""
    head = insert_status_dibits(
        np.concatenate([FRAME_SYNC_DIBITS, encode_nid(nac, DUID.PDU)]), 0
    )
    assert len(head) == 57
    return np.concatenate(
        [head, insert_status_dibits(np.asarray(payload_dibits, np.uint8), 57)]
    ).astype(np.uint8)
