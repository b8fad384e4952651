"""P25 voice-frame metadata: link control, encryption sync, HDU fields.

Codecs for the hexbit-protected structures inside voice frames:

  * LDU1 link control: 24 hexbits, each in Hamming(10,6,3), carrying
    LC(72 bits) + RS(24,12) parity.  Unlike the reference (systematic
    extraction only, reference ``decoders/p25_frames.py:1027``), the
    outer RS code is actually decoded (fec/rs.py), correcting up to 6
    hexbit symbols; zero-parity legacy streams fall back to systematic;
  * LDU2 encryption sync: same layout carrying MI(72)+ALGID(8)+KID(16);
  * HDU: 36 hexbits in shortened Golay(18,6,8) carrying
    MI(72)+MFID(8)+ALGID(8)+KID(16)+TGID(16) + RS(36,20) parity;
  * TDULC: 24 hexbit-pairs in Golay(24,12) carrying LC + RS(24,12).

The Hamming(10,6,3) parity matrix is a distance-3 systematic code kept
self-consistent with our encoders; substitute the TIA matrix bit-for-bit
when validating against recorded off-air signals.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .fec import golay

# Hamming(10,6,3): G = [I6 | P]; all P rows distinct, weight>=2 -> d=3
_P_ROWS = [0b1110, 0b1101, 0b1011, 0b0111, 0b1100, 0b0110]
_P = np.array([[(_P_ROWS[i] >> (3 - j)) & 1 for j in range(4)] for i in range(6)], np.uint8)


def hamming106_encode(data6: int) -> np.ndarray:
    d = np.array([(data6 >> (5 - i)) & 1 for i in range(6)], np.uint8)
    p = (d @ _P) % 2
    return np.concatenate([d, p.astype(np.uint8)])


def hamming106_decode(bits10: np.ndarray) -> tuple[int, int]:
    """-> (data6, n_corrected); single-error correcting."""
    w = np.asarray(bits10, np.uint8).copy()
    d, p = w[:6], w[6:]
    syn = tuple(((d @ _P) % 2) ^ p)
    if sum(syn) == 0:
        pass
    else:
        # single error: syndrome matches a P row (data bit) or unit (parity)
        fixed = False
        for i in range(6):
            if tuple(_P[i]) == syn:
                d[i] ^= 1
                fixed = True
                break
        if not fixed:
            for j in range(4):
                unit = tuple(1 if k == j else 0 for k in range(4))
                if unit == syn:
                    fixed = True
                    break
        if not fixed:
            return _bits_to_int(d), -1
        return _bits_to_int(d), 1
    return _bits_to_int(d), 0


def golay186_encode(data6: int) -> np.ndarray:
    """Shortened Golay(18,6,8): (24,12) with the high 6 data bits zero."""
    cw24 = golay.encode(data6 & 0x3F)
    return np.concatenate([cw24[6:12], cw24[12:]])  # 6 data + 12 parity


def golay186_decode(bits18: np.ndarray) -> tuple[int, int]:
    w = np.asarray(bits18, np.uint8)
    cw24 = np.concatenate([np.zeros(6, np.uint8), w[:6], w[6:]])
    data12, n = golay.decode(cw24)
    if n < 0:
        return _bits_to_int(w[:6]), -1
    return data12 & 0x3F, n


def _bits_to_int(bits) -> int:
    v = 0
    for b in bits:
        v = (v << 1) | int(b)
    return v


def _int_to_bits(v: int, n: int) -> np.ndarray:
    return np.array([(v >> (n - 1 - i)) & 1 for i in range(n)], np.uint8)


# ---------------------------------------------------------------------------
# Link control (LDU1 / TDULC)
# ---------------------------------------------------------------------------


@dataclass
class LinkControl:
    lcf: int = 0
    mfid: int = 0
    tgid: int = 0
    source_id: int = 0
    target_id: int = 0
    emergency: bool = False
    encrypted: bool = False
    errors: int = 0
    raw: bytes = b""


def decode_lc_hexbits(bits240: np.ndarray) -> LinkControl | None:
    """240 Hamming-coded bits -> 72-bit LC (first 12 of 24 hexbits)."""
    b = np.asarray(bits240, np.uint8)
    if len(b) < 240:
        return None
    hexbits = []
    errs = 0
    for i in range(24):
        d, n = hamming106_decode(b[10 * i : 10 * (i + 1)])
        if n < 0:
            errs += 3
        else:
            errs += n
        hexbits.append(d)
    from .fec.rs import RS_24_12

    # zero parity marks a legacy/reference systematic stream: RS would
    # miscorrect sparse data toward the all-zero codeword — skip it
    rs = RS_24_12.decode(hexbits) if any(hexbits[12:]) else None
    if rs is not None:
        data, n_err = rs
        lc_bits = np.concatenate([_int_to_bits(int(h), 6) for h in data])
        # RS success is syndrome-verified: report only the RS symbol count
        return parse_link_control(lc_bits, n_err)
    # RS failure (or legacy zero-parity stream): systematic fallback
    lc_bits = np.concatenate([_int_to_bits(h, 6) for h in hexbits[:12]])
    return parse_link_control(lc_bits, errs)


def encode_lc_hexbits(lc_bits72: np.ndarray) -> np.ndarray:
    """72-bit LC -> 240 bits with real RS(24,12) parity."""
    from .fec.rs import RS_24_12

    data = [_bits_to_int(lc_bits72[6 * i : 6 * (i + 1)]) for i in range(12)]
    hexbits = data + RS_24_12.encode(data)
    return np.concatenate([hamming106_encode(h) for h in hexbits])


def parse_link_control(bits72: np.ndarray, errors: int = 0) -> LinkControl:
    lc = LinkControl(errors=errors)
    b = np.asarray(bits72, np.uint8)
    lc.lcf = _bits_to_int(b[0:8])
    lc.mfid = _bits_to_int(b[8:16])
    lc.raw = bytes(_bits_to_int(b[8 * i : 8 * i + 8]) for i in range(9))
    if lc.lcf == 0x00:  # group voice channel user
        svc = _bits_to_int(b[16:24])
        lc.emergency = bool(svc & 0x80)
        lc.encrypted = bool(svc & 0x40)
        lc.tgid = _bits_to_int(b[24:40])
        lc.source_id = _bits_to_int(b[48:72])
    elif lc.lcf == 0x03:  # unit to unit
        lc.target_id = _bits_to_int(b[24:48])
        lc.source_id = _bits_to_int(b[48:72])
    return lc


def make_group_lc_bits(tgid: int, source_id: int, emergency=False) -> np.ndarray:
    svc = 0x80 if emergency else 0
    bits = np.zeros(72, np.uint8)
    bits[16:24] = _int_to_bits(svc, 8)
    bits[24:40] = _int_to_bits(tgid & 0xFFFF, 16)
    bits[48:72] = _int_to_bits(source_id & 0xFFFFFF, 24)
    return bits


# ---------------------------------------------------------------------------
# Encryption sync (LDU2)
# ---------------------------------------------------------------------------


@dataclass
class EncryptionSync:
    mi: bytes = bytes(9)
    algid: int = 0x80  # 0x80 = clear
    kid: int = 0
    errors: int = 0

    @property
    def encrypted(self) -> bool:
        return self.algid != 0x80


def decode_ess_hexbits(bits240: np.ndarray) -> EncryptionSync | None:
    b = np.asarray(bits240, np.uint8)
    if len(b) < 240:
        return None
    hexbits = []
    errs = 0
    for i in range(24):
        d, n = hamming106_decode(b[10 * i : 10 * (i + 1)])
        errs += 3 if n < 0 else n
        hexbits.append(d)
    from .fec.rs import RS_24_16

    rs = RS_24_16.decode(hexbits) if any(hexbits[16:]) else None
    if rs is not None:
        hexbits = list(rs[0]) + hexbits[16:]
        errs = rs[1]
    bits96 = np.concatenate([_int_to_bits(int(h), 6) for h in hexbits[:16]])
    mi = bytes(_bits_to_int(bits96[8 * i : 8 * i + 8]) for i in range(9))
    algid = _bits_to_int(bits96[72:80])
    kid = _bits_to_int(bits96[80:96])
    return EncryptionSync(mi=mi, algid=algid, kid=kid, errors=errs)


# ---------------------------------------------------------------------------
# HDU
# ---------------------------------------------------------------------------


@dataclass
class HduFields:
    mi: bytes = bytes(9)
    mfid: int = 0
    algid: int = 0x80
    kid: int = 0
    tgid: int = 0
    errors: int = 0


def decode_hdu_payload(bits648: np.ndarray) -> HduFields | None:
    """36 Golay(18,6) hexbits -> MI/MFID/ALGID/KID/TGID (first 20 data)."""
    b = np.asarray(bits648, np.uint8)
    if len(b) < 36 * 18:
        return None
    hexbits = []
    errs = 0
    for i in range(36):
        d, n = golay186_decode(b[18 * i : 18 * (i + 1)])
        errs += 4 if n < 0 else n
        hexbits.append(d)
    from .fec.rs import RS_36_20

    rs = RS_36_20.decode(hexbits) if any(hexbits[20:]) else None
    if rs is not None:
        hexbits = list(rs[0]) + hexbits[20:]
        errs = rs[1]
    bits120 = np.concatenate([_int_to_bits(int(h), 6) for h in hexbits[:20]])
    mi = bytes(_bits_to_int(bits120[8 * i : 8 * i + 8]) for i in range(9))
    return HduFields(
        mi=mi,
        mfid=_bits_to_int(bits120[72:80]),
        algid=_bits_to_int(bits120[80:88]),
        kid=_bits_to_int(bits120[88:104]),
        tgid=_bits_to_int(bits120[104:120]),
        errors=errs,
    )


def encode_hdu_payload(
    tgid: int, mi: bytes = bytes(9), mfid=0, algid=0x80, kid=0
) -> np.ndarray:
    bits120 = np.zeros(120, np.uint8)
    for i, byte in enumerate(mi[:9]):
        bits120[8 * i : 8 * i + 8] = _int_to_bits(byte, 8)
    bits120[72:80] = _int_to_bits(mfid, 8)
    bits120[80:88] = _int_to_bits(algid, 8)
    bits120[88:104] = _int_to_bits(kid, 16)
    bits120[104:120] = _int_to_bits(tgid, 16)
    from .fec.rs import RS_36_20

    data = [_bits_to_int(bits120[6 * i : 6 * (i + 1)]) for i in range(20)]
    hexbits = data + RS_36_20.encode(data)
    return np.concatenate([golay186_encode(h) for h in hexbits])
