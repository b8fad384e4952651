"""BPTC(196,96) product code for DMR bursts (ETSI TS 102 361-1 B.1.1).

The reference has no DMR FEC at all (its ``decoders/dmr.py`` is a
placeholder); this is a full implementation: 196 on-air bits are
deinterleaved with stride 181, packed into a 13x15 matrix (bit 0 unused),
whose 9 top rows are Hamming(15,11,3) codewords and whose 15 columns are
Hamming(13,9,3) codewords (ETSI tables B.14/B.15).  Iterative row/column
syndrome correction recovers the 96 payload bits (row 0 carries only 8
data bits; its first 3 are reserved).

Everything is vectorized numpy: rows/columns are corrected in one matrix
syndrome pass per iteration.
"""

from __future__ import annotations

import numpy as np

# Hamming(15,11,3) parity equations, ETSI TS 102 361-1 Table B.14
_H15_ROWS = [
    [0, 1, 2, 3, 5, 7, 8],
    [1, 2, 3, 4, 6, 8, 9],
    [2, 3, 4, 5, 7, 9, 10],
    [0, 1, 2, 4, 6, 7, 10],
]
# Hamming(13,9,3) parity equations, ETSI TS 102 361-1 Table B.15
_H13_ROWS = [
    [0, 1, 3, 5, 6],
    [0, 1, 2, 4, 6, 7],
    [0, 2, 3, 5, 7, 8],
    [0, 1, 2, 3, 4, 6, 8],
]


def _check_matrix(data_idx: list[list[int]], n: int, k: int) -> np.ndarray:
    """H (4 x n): parity equations incl. the identity over the parity bits."""
    H = np.zeros((n - k, n), np.uint8)
    for p, idxs in enumerate(data_idx):
        H[p, idxs] = 1
        H[p, k + p] = 1
    return H


_H15 = _check_matrix(_H15_ROWS, 15, 11)
_H13 = _check_matrix(_H13_ROWS, 13, 9)

# syndrome value -> correctable bit position (single-error patterns)
def _syndrome_table(H: np.ndarray) -> np.ndarray:
    n = H.shape[1]
    tab = np.full(16, -1, np.int32)
    weights = np.array([8, 4, 2, 1], np.int32)
    for i in range(n):
        s = int((H[:, i] * weights).sum())
        tab[s] = i
    return tab


_SYN15 = _syndrome_table(_H15)
_SYN13 = _syndrome_table(_H13)

_WEIGHTS = np.array([8, 4, 2, 1], np.int32)

# deinterleave: transmitted bit i came from matrix position (i*181) % 196
_INTERLEAVE = (np.arange(196) * 181) % 196
_DEINTERLEAVE = np.argsort(_INTERLEAVE)


def _hamming_encode(data: np.ndarray, rows: list[list[int]]) -> np.ndarray:
    """data (..., k) -> parity (..., 4)."""
    out = np.zeros(data.shape[:-1] + (4,), np.uint8)
    for p, idxs in enumerate(rows):
        out[..., p] = data[..., idxs].sum(axis=-1) % 2
    return out


def encode_bptc_196(bits96: np.ndarray) -> np.ndarray:
    """96 payload bits -> 196 interleaved on-air bits."""
    bits = np.asarray(bits96, np.uint8)
    if bits.shape != (96,):
        raise ValueError("expected 96 bits")
    M = np.zeros((13, 15), np.uint8)
    # row 0 data: 3 reserved zeros + first 8 payload bits
    M[0, 3:11] = bits[:8]
    M[1:9, :11] = bits[8:].reshape(8, 11)
    M[:9, 11:] = _hamming_encode(M[:9, :11], _H15_ROWS)
    M[9:, :] = _hamming_encode(M[:9, :].T, _H13_ROWS).T
    flat = np.zeros(196, np.uint8)
    flat[1:] = M.reshape(-1)
    return flat[_INTERLEAVE]


def decode_bptc_196(bits196: np.ndarray, iterations: int = 2) -> tuple[np.ndarray, bool]:
    """196 on-air bits -> (96 payload bits, clean) with row/col correction.

    ``clean`` is True when all syndromes are zero after correction.
    """
    rx = np.asarray(bits196, np.uint8)
    flat = rx[_DEINTERLEAVE].copy()
    M = flat[1:].reshape(13, 15)
    for _ in range(iterations):
        # column pass: Hamming(13,9) on each of the 15 columns
        syn = (_H13 @ M) % 2  # (4, 15)
        sval = (_WEIGHTS @ syn.astype(np.int32))  # (15,)
        for c in np.nonzero(sval)[0]:
            pos = _SYN13[sval[c]]
            if pos >= 0:
                M[pos, c] ^= 1
        # row pass: Hamming(15,11) on rows 0..8
        syn = (M[:9] @ _H15.T) % 2  # (9, 4)
        sval = syn.astype(np.int32) @ _WEIGHTS  # (9,)
        for r in np.nonzero(sval)[0]:
            pos = _SYN15[sval[r]]
            if pos >= 0:
                M[r, pos] ^= 1
    clean = (
        not ((_H13 @ M) % 2).any()
        and not ((M[:9] @ _H15.T) % 2).any()
    )
    out = np.empty(96, np.uint8)
    out[:8] = M[0, 3:11]
    out[8:] = M[1:9, :11].reshape(-1)
    return out, clean
