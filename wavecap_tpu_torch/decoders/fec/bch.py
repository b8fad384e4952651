"""BCH(63,16,23) codec for the P25 NID (NAC + DUID).

Protocol facts (TIA-102.BAAA; reference ``dsp/fec/bch.py:225``): narrow-sense
binary BCH over GF(2^6), primitive poly x^6+x+1, n=63, k=16, t=11.  The
64-bit NID is the 63-bit codeword plus one trailing parity/pad bit.

Implementation is self-contained: the degree-47 generator polynomial is
computed from minimal polynomials at import; decode is syndromes ->
Berlekamp-Massey -> Chien search (numpy, host-side — NIDs arrive at
~dozens/second, this is nowhere near the hot path).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .galois import GF

N = 63
K = 16
T = 11
PRIM_POLY = 0x43  # x^6 + x + 1


@lru_cache(maxsize=1)
def _field() -> GF:
    return GF(6, PRIM_POLY)


@lru_cache(maxsize=1)
def generator_poly() -> np.ndarray:
    """Binary generator polynomial, ascending coefficients, degree 47."""
    gf = _field()
    g = [1]
    included: set[frozenset] = set()
    for j in range(1, 2 * T + 1):
        cls = frozenset(
            (j * (1 << k)) % gf.n for k in range(gf.m)
        )
        if cls in included:
            continue
        included.add(cls)
        g = gf.poly_mul(g, gf.minimal_poly(j))
    arr = np.array(g, np.uint8)
    assert len(arr) == N - K + 1, len(arr)
    return arr


def encode(data16: int) -> np.ndarray:
    """Encode 16-bit value -> 63-bit systematic codeword (transmit order).

    Bit 0 of the returned array is transmitted first and is the MSB of the
    data (coefficient x^62).
    """
    g = generator_poly()
    # message polynomial: data bits as coefficients x^62..x^47
    reg = np.zeros(N, np.uint8)
    for i in range(K):
        reg[N - 1 - i] = (data16 >> (K - 1 - i)) & 1
    # long division to get remainder
    rem = reg.copy()
    for i in range(N - 1, N - K - 1, -1):
        if rem[i]:
            # subtract g(x) * x^(i-47)
            rem[i - (N - K) : i + 1] ^= g
    code = reg.copy()
    code[: N - K] = rem[: N - K]
    # transmit order: highest coefficient first
    return code[::-1].copy()


def decode(codeword63: np.ndarray) -> tuple[int, int]:
    """Decode a 63-bit received word (transmit order).

    Returns ``(data16, n_corrected)``; ``n_corrected = -1`` on failure.
    """
    gf = _field()
    if len(codeword63) != N:
        raise ValueError(f"expected {N}-bit codeword, got {len(codeword63)}")
    bits = np.asarray(codeword63, np.uint8)[::-1]  # coefficient order c_0..c_62
    positions = np.nonzero(bits)[0]

    # Syndromes S_j = sum over set positions of alpha^(i*j), j=1..2T
    syndromes = np.zeros(2 * T + 1, np.int32)
    any_nonzero = False
    for j in range(1, 2 * T + 1):
        s = 0
        for i in positions:
            s ^= gf.pow_alpha(int(i) * j)
        syndromes[j] = s
        if s:
            any_nonzero = True

    if not any_nonzero:
        return _extract(bits), 0

    # Berlekamp-Massey
    C = [1] + [0] * (2 * T)
    B = [1] + [0] * (2 * T)
    L, m_gap, b = 0, 1, 1
    for n_iter in range(2 * T):
        d = syndromes[n_iter + 1]
        for i in range(1, L + 1):
            d ^= gf.mul(C[i], int(syndromes[n_iter + 1 - i]))
        if d == 0:
            m_gap += 1
        elif 2 * L <= n_iter:
            Tp = C.copy()
            coef = gf.mul(d, gf.inv(b))
            for i in range(2 * T + 1 - m_gap):
                C[i + m_gap] ^= gf.mul(coef, B[i])
            L = n_iter + 1 - L
            B = Tp
            b = d
            m_gap = 1
        else:
            coef = gf.mul(d, gf.inv(b))
            for i in range(2 * T + 1 - m_gap):
                C[i + m_gap] ^= gf.mul(coef, B[i])
            m_gap += 1

    if L > T:
        return _extract(bits), -1

    # Chien search: roots alpha^-i  ->  error at position i
    err_pos = []
    for i in range(N):
        x = gf.pow_alpha((gf.n - i) % gf.n)
        if gf.poly_eval(C[: L + 1], x) == 0:
            err_pos.append(i)
    if len(err_pos) != L:
        return _extract(bits), -1

    corrected = bits.copy()
    for i in err_pos:
        corrected[i] ^= 1

    # Verify: recompute a couple of syndromes
    pos2 = np.nonzero(corrected)[0]
    for j in (1, 2):
        s = 0
        for i in pos2:
            s ^= gf.pow_alpha(int(i) * j)
        if s != 0:
            return _extract(bits), -1

    return _extract(corrected), len(err_pos)


def _extract(bits_coeff_order: np.ndarray) -> int:
    """Data bits are coefficients x^62..x^47 (MSB first)."""
    val = 0
    for i in range(K):
        val = (val << 1) | int(bits_coeff_order[N - 1 - i])
    return val
