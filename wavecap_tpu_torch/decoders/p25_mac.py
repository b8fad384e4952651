"""P25 Phase 2 MAC layer: xCCH (SACCH/FACCH) bursts and MAC PDUs.

The reference captures Phase 2 timeslot bursts but never decodes the
control content (``decoders/p25_phase2.py`` stops at superframe/burst
framing) — this module goes further and implements the MAC message
layer of TIA-102.BBAC:

  * **MAC PDU structures**: MAC_PTT (mic: MI/ALGID/KEYID + talkgroup +
    source), MAC_END_PTT, MAC_IDLE / MAC_ACTIVE / MAC_HANGTIME content
    frames carrying packed MAC messages;
  * **abbreviated MAC message space**: opcodes ``0x40 | tsbk_opcode``
    reuse the Phase 1 TSBK octet layouts (grants, IDEN, RFSS/NET/ADJ
    status), so parsing delegates to the proven
    :mod:`wavecap_tpu_torch.decoders.p25_tsbk` parser;
  * **burst codec**: a CRC-gated ½-rate-trellis channel codec that maps
    MAC PDUs onto 180-dibit timeslot bursts with a majority-decoded
    burst-type marker (4V / 2V / SACCH / FACCH).

Fidelity note: MAC PDU field layouts and the abbreviated opcode mapping
follow TIA-102.BBAC; the burst-level interleave/FEC schedule is this
framework's own (the ½-rate trellis + CRC16 convention shared with the
Phase 1 stack) because the exact Annex interleave tables are not
reproducible here.  Encode and decode are exactly consistent within the
framework, and every structure is pinned by round-trip tests — the same
validation stance the reference applies to its TSBK encoders.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np

from wavecap_tpu_torch.decoders import p25_tsbk as tsbk
from wavecap_tpu_torch.decoders.fec.crc import crc16_ccitt_bits
from wavecap_tpu_torch.decoders.fec.trellis import encode_dibits, viterbi_decode_dibits

logger = logging.getLogger(__name__)

# -- MAC PDU opcodes (TIA-102.BBAC) -----------------------------------------

MAC_SIGNAL = 0x00  # LCCH signalling content
MAC_PTT = 0x01
MAC_END_PTT = 0x02
MAC_IDLE = 0x03
MAC_ACTIVE = 0x04
MAC_HANGTIME = 0x05

# abbreviated Phase 1 message space: 0x40 | TSBK opcode, same octet layout
# as the TSBK's 8 data octets
_ABBREV_BASE = 0x40
_ABBREV_LEN = 9  # 1 opcode + 8 TSBK-layout octets

# burst types carried by the marker field
BURST_4V = 0
BURST_2V = 1
BURST_SACCH = 2
BURST_FACCH = 3
BURST_NAMES = {0: "4V", 1: "2V", 2: "SACCH", 3: "FACCH"}

# burst geometry: 180 dibits per timeslot.  Fragment positions 2/3 carry
# the in-fragment sync in their first 20 dibits, so two codec widths
# exist (mirrors the spec, where sync-adjacent bursts carry less):
#   full  (sync-free positions): 12-dibit marker + 168 trellis dibits
#         -> 83 data dibits = 166 bits -> 18 payload octets + CRC16
#   short (sync positions, last 160 dibits): 12-dibit marker + 148
#         trellis dibits -> 73 data dibits -> 16 octets + CRC16
# 18 octets is exactly MAC_PTT's size — the largest PDU FACCH must carry.
BURST_DIBITS_FULL = 180
PAYLOAD_DIBITS = 160  # short variant
_MARKER_DIBITS = 12


def _geometry(total_dibits: int) -> tuple[int, int, int]:
    """(trellis dibits, data dibits, max payload octets) for a width."""
    trellis = total_dibits - _MARKER_DIBITS
    data = trellis // 2 - 1
    return trellis, data, (data * 2 - 16) // 8


_, _, MAX_PAYLOAD_OCTETS = _geometry(PAYLOAD_DIBITS)  # 16
_, _, MAX_PAYLOAD_OCTETS_FULL = _geometry(BURST_DIBITS_FULL)  # 18


# -- MAC PDU synthesis --------------------------------------------------------


def make_mac_ptt(
    tgid: int,
    source: int,
    algid: int = 0x80,
    keyid: int = 0,
    mi: bytes = b"\x00" * 9,
) -> bytes:
    """MAC_PTT: 9-octet message indicator, ALGID, KEYID, group, source
    (TIA-102.BBAC push-to-talk layout; ALGID 0x80 = clear)."""
    assert len(mi) == 9
    return (
        bytes([MAC_PTT])
        + mi
        + bytes([algid & 0xFF])
        + int(keyid).to_bytes(2, "big")
        + int(tgid).to_bytes(2, "big")
        + int(source).to_bytes(3, "big")
    )


def make_mac_end_ptt(tgid: int, source: int) -> bytes:
    return (
        bytes([MAC_END_PTT, 0xFF, 0xFF])
        + int(tgid).to_bytes(2, "big")
        + int(source).to_bytes(3, "big")
    )


def make_mac_message(tsbk_opcode: int, data8: bytes) -> bytes:
    """One abbreviated MAC message: Phase 1 TSBK layout under 0x40|op."""
    assert len(data8) == 8
    return bytes([_ABBREV_BASE | (tsbk_opcode & 0x3F)]) + data8


def make_mac_content(kind: int, messages: list[bytes] = ()) -> bytes:
    """MAC_IDLE / MAC_ACTIVE / MAC_HANGTIME frame with packed messages."""
    assert kind in (MAC_IDLE, MAC_ACTIVE, MAC_HANGTIME, MAC_SIGNAL)
    return bytes([kind]) + b"".join(messages)


# -- MAC PDU parse ------------------------------------------------------------


def parse_mac_pdu(octets: bytes) -> dict[str, Any] | None:
    """Parse one MAC PDU into a typed dict (None if empty/unknown)."""
    if not octets:
        return None
    op = octets[0]
    if op == MAC_PTT and len(octets) >= 18:
        return {
            "mac": "PTT",
            "mi": octets[1:10].hex(),
            "algid": octets[10],
            "keyid": int.from_bytes(octets[11:13], "big"),
            "encrypted": octets[10] != 0x80,
            "tgid": int.from_bytes(octets[13:15], "big"),
            "source_id": int.from_bytes(octets[15:18], "big"),
        }
    if op == MAC_END_PTT and len(octets) >= 8:
        return {
            "mac": "END_PTT",
            "tgid": int.from_bytes(octets[3:5], "big"),
            "source_id": int.from_bytes(octets[5:8], "big"),
        }
    if op in (MAC_IDLE, MAC_ACTIVE, MAC_HANGTIME, MAC_SIGNAL):
        name = {
            MAC_IDLE: "IDLE",
            MAC_ACTIVE: "ACTIVE",
            MAC_HANGTIME: "HANGTIME",
            MAC_SIGNAL: "SIGNAL",
        }[op]
        return {"mac": name, "messages": parse_mac_messages(octets[1:])}
    return {"mac": "UNKNOWN", "opcode": op, "data": octets[1:].hex()}


def parse_mac_messages(content: bytes) -> list[dict[str, Any]]:
    """Packed abbreviated MAC messages -> list of TSBK-style dicts.

    Messages are consumed until a null opcode (0x00) or an opcode outside
    the abbreviated space terminates the list (unknown lengths cannot be
    skipped safely)."""
    out: list[dict[str, Any]] = []
    i = 0
    while i + _ABBREV_LEN <= len(content):
        op = content[i]
        if op == 0x00:
            break
        if not (_ABBREV_BASE <= op < _ABBREV_BASE + 0x40):
            logger.debug("MAC message opcode 0x%02x outside abbreviated space", op)
            break
        parsed = tsbk.parse_tsbk(op & 0x3F, 0, content[i + 1 : i + _ABBREV_LEN])
        out.append(parsed)
        i += _ABBREV_LEN
    return out


# -- burst codec --------------------------------------------------------------


def encode_burst(
    burst_type: int, payload: bytes = b"", width: int = PAYLOAD_DIBITS
) -> np.ndarray:
    """MAC payload -> coded burst dibits (type marker + trellis + CRC16)."""
    assert 0 <= burst_type <= 3
    _, data_dibits_n, max_octets = _geometry(width)
    if len(payload) > max_octets:
        raise ValueError(f"payload > {max_octets} octets at width {width}")
    marker = np.full(_MARKER_DIBITS, burst_type, np.uint8)
    bits = np.zeros(data_dibits_n * 2, np.uint8)
    pb = np.unpackbits(np.frombuffer(payload.ljust(max_octets, b"\0"), np.uint8))
    bits[: len(pb)] = pb
    crc = crc16_ccitt_bits(bits[:-16]) ^ 0xFFFF
    bits[-16:] = [(crc >> (15 - k)) & 1 for k in range(16)]
    data_dibits = (bits[0::2] << 1) | bits[1::2]
    coded = encode_dibits(data_dibits)  # appends flush: 2*(data+1) dibits
    return np.concatenate([marker, coded]).astype(np.uint8)


def _decode_at_width(d: np.ndarray, width: int) -> tuple[int, bytes] | None:
    if len(d) < width:
        return None
    d = d[-width:]
    _, _, max_octets = _geometry(width)
    marker = d[:_MARKER_DIBITS]
    vals, counts = np.unique(marker, return_counts=True)
    btype = int(vals[np.argmax(counts)])
    if int(np.max(counts)) < _MARKER_DIBITS * 2 // 3:
        return None  # marker too noisy to trust
    data_dibits, _err = viterbi_decode_dibits(d[_MARKER_DIBITS:])
    bits = np.zeros(len(data_dibits) * 2, np.uint8)
    bits[0::2] = (data_dibits >> 1) & 1
    bits[1::2] = data_dibits & 1
    crc = crc16_ccitt_bits(bits[:-16]) ^ 0xFFFF
    got = 0
    for k in range(16):
        got = (got << 1) | int(bits[-16 + k])
    if got != crc:
        return None
    payload = np.packbits(bits[:-16][: max_octets * 8]).tobytes()
    return btype, payload


def decode_burst(dibits: np.ndarray) -> tuple[int, bytes] | None:
    """Timeslot burst dibits -> (type, MAC octets), or None when no width's
    CRC validates (e.g. a voice burst).  Tries the full 180-dibit codec
    first (sync-free positions), then the short 160-dibit one (sync-
    bearing positions)."""
    d = np.asarray(dibits, np.uint8)
    if len(d) >= BURST_DIBITS_FULL:
        out = _decode_at_width(d, BURST_DIBITS_FULL)
        if out is not None:
            return out
    return _decode_at_width(d, PAYLOAD_DIBITS)


def encode_timeslot_burst(
    burst_type: int, payload: bytes = b"", with_sync: bool = False
) -> np.ndarray:
    """Full 180-dibit timeslot burst.  Sync-free fragment positions (0/1)
    use the whole burst (fits an 18-octet MAC_PTT); positions 2/3 start
    with the in-fragment sync and carry the short codec after it."""
    from wavecap_tpu_torch.decoders.p25_phase2 import BURST_DIBITS, SYNC_DIBITS

    if not with_sync:
        return encode_burst(burst_type, payload, width=BURST_DIBITS)
    body = encode_burst(burst_type, payload, width=PAYLOAD_DIBITS)
    return np.concatenate([SYNC_DIBITS, body]).astype(np.uint8)
