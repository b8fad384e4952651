"""Extended Golay(24,12,8) codec (P25 HDU hexbit protection).

Standard construction with the 12x12 B matrix (TIA-102.BAAA / classic
coding-theory form; reference ``dsp/fec/golay.py:33`` uses the same code).
Decode corrects up to 3 errors via the IMLD syndrome-weight algorithm.
"""

from __future__ import annotations

import numpy as np

# Classic B matrix rows (cyclic construction from quadratic residues of 11)
_B_ROWS = [
    0b110111000101,
    0b101110001011,
    0b011100010111,
    0b111000101101,
    0b110001011011,
    0b100010110111,
    0b000101101111,
    0b001011011101,
    0b010110111001,
    0b101101110001,
    0b011011100011,
    0b111111111110,
]
B = np.array(
    [[(_B_ROWS[i] >> (11 - j)) & 1 for j in range(12)] for i in range(12)], np.uint8
)
I12 = np.eye(12, dtype=np.uint8)
# G = [I | B]; codeword = [data | parity]
_ROW_WEIGHT_OK = all(int(B[i].sum()) in (7, 11) for i in range(12))


def encode(data12: int) -> np.ndarray:
    """12-bit value -> 24-bit codeword [data bits MSB-first | parity]."""
    d = np.array([(data12 >> (11 - i)) & 1 for i in range(12)], np.uint8)
    p = (d @ B) % 2
    return np.concatenate([d, p.astype(np.uint8)])


def _weight(v: np.ndarray) -> int:
    return int(np.sum(v))


def decode(bits24: np.ndarray) -> tuple[int, int]:
    """Decode 24-bit word -> (data12, n_corrected); -1 on failure (>3 errors)."""
    w = np.asarray(bits24, np.uint8).copy()
    r, q = w[:12], w[12:]
    s = (r @ B % 2) ^ q  # syndrome (12,)

    err = np.zeros(24, np.uint8)
    if _weight(s) <= 3:
        err[12:] = s
    else:
        found = False
        for i in range(12):
            t = s ^ B[i]
            if _weight(t) <= 2:
                err[i] = 1
                err[12:] = t
                found = True
                break
        if not found:
            # second syndrome sB
            sb = (s @ B) % 2
            if _weight(sb) <= 3:
                err[:12] = sb
                found = True
            else:
                for i in range(12):
                    t = sb ^ B[i]
                    if _weight(t) <= 2:
                        err[:12] = t
                        err[12 + i] = 1
                        found = True
                        break
        if not found:
            return _data(r), -1

    corrected = w ^ err
    n = _weight(err)
    # verify
    cs = (corrected[:12] @ B % 2) ^ corrected[12:]
    if _weight(cs) != 0:
        return _data(r), -1
    return _data(corrected[:12]), n


def _data(bits12: np.ndarray) -> int:
    v = 0
    for b in bits12:
        v = (v << 1) | int(b)
    return v
