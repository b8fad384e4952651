"""CRC routines for P25 (host-side).

TSBK CRC16 (TIA-102.AABB): bit-serial CRC-CCITT (poly 0x1021) computed
with zero initial register over the 80 message bits; the transmitted CRC
is the ones-complement of the remainder.  The check accepts residuals of
0 or 0xFFFF, tolerating both complement conventions (the same acceptance
the reference's table-driven check implements, reference
``decoders/p25_frames.py:567-620``).
"""

from __future__ import annotations

import numpy as np


def crc16_ccitt_bits(bits, poly: int = 0x1021, init: int = 0x0000) -> int:
    crc = init & 0xFFFF
    for b in np.asarray(bits, np.uint8):
        fb = ((crc >> 15) & 1) ^ int(b)
        crc = (crc << 1) & 0xFFFF
        if fb:
            crc ^= poly
    return crc


def tsbk_crc_encode(bits80) -> np.ndarray:
    """Return the 16 CRC bits (complemented remainder) for an 80-bit TSBK."""
    crc = crc16_ccitt_bits(bits80) ^ 0xFFFF
    return np.array([(crc >> (15 - i)) & 1 for i in range(16)], np.uint8)


def tsbk_crc_check(bits96) -> bool:
    """Validate an 80+16-bit TSBK block (either complement convention)."""
    bits = np.asarray(bits96, np.uint8)
    crc = crc16_ccitt_bits(bits[:80])
    rx = 0
    for b in bits[80:96]:
        rx = (rx << 1) | int(b)
    residual = crc ^ rx
    return residual in (0x0000, 0xFFFF)


def crc9_p25(bits) -> int:
    """CRC-9 used by P25 confirmed data blocks (poly x^9+x^6+x^4+x^3+1)."""
    poly = 0x059
    crc = 0
    for b in np.asarray(bits, np.uint8):
        fb = ((crc >> 8) & 1) ^ int(b)
        crc = (crc << 1) & 0x1FF
        if fb:
            crc ^= poly
    return crc


def crc32_p25(bits) -> int:
    """CRC-32 (IEEE poly, MSB-first serial form) for P25 packet data."""
    poly = 0x04C11DB7
    crc = 0xFFFFFFFF
    for b in np.asarray(bits, np.uint8):
        fb = ((crc >> 31) & 1) ^ int(b)
        crc = (crc << 1) & 0xFFFFFFFF
        if fb:
            crc ^= poly
    return crc ^ 0xFFFFFFFF
