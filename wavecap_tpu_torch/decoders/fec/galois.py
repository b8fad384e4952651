"""GF(2^m) arithmetic tables for the FEC codecs (host-side numpy).

P25's NID code is BCH(63,16,23) over GF(2^6) with primitive polynomial
x^6 + x + 1 (reference ``dsp/fec/bch.py:245`` documents the same field).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np


@lru_cache(maxsize=8)
def gf_tables(m: int, prim_poly: int) -> tuple[np.ndarray, np.ndarray]:
    """(exp, log) tables for GF(2^m).  exp has length 2^m (exp[2^m-1]=exp[0])."""
    n = (1 << m) - 1
    exp = np.zeros(n + 1, np.int32)
    log = np.zeros(n + 1, np.int32)
    x = 1
    for i in range(n):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & (1 << m):
            x ^= prim_poly
    exp[n] = exp[0]
    return exp, log


class GF:
    """Small-field GF(2^m) helper."""

    def __init__(self, m: int, prim_poly: int):
        self.m = m
        self.n = (1 << m) - 1
        self.exp, self.log = gf_tables(m, prim_poly)

    def mul(self, a: int, b: int) -> int:
        if a == 0 or b == 0:
            return 0
        return int(self.exp[(self.log[a] + self.log[b]) % self.n])

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError
        return int(self.exp[(self.n - self.log[a]) % self.n])

    def pow_alpha(self, e: int) -> int:
        return int(self.exp[e % self.n])

    def poly_mul(self, p: list[int], q: list[int]) -> list[int]:
        """Multiply polynomials with GF coefficients (ascending order)."""
        out = [0] * (len(p) + len(q) - 1)
        for i, a in enumerate(p):
            if a == 0:
                continue
            for j, b in enumerate(q):
                out[i + j] ^= self.mul(a, b)
        return out

    def poly_eval(self, p: list[int] | np.ndarray, x: int) -> int:
        """Evaluate polynomial (ascending coefficients) at x."""
        acc = 0
        for c in reversed(list(p)):
            acc = self.mul(acc, x) ^ int(c)
        return acc

    def minimal_poly(self, elt_log: int) -> list[int]:
        """Minimal polynomial (binary coefficients, ascending) of alpha^elt_log."""
        # Conjugacy class: elt_log * 2^k mod n
        seen = set()
        e = elt_log % self.n
        while e not in seen:
            seen.add(e)
            e = (e * 2) % self.n
        poly = [1]
        for e in sorted(seen):
            poly = self.poly_mul(poly, [self.pow_alpha(e), 1])  # (x - alpha^e)
        assert all(c in (0, 1) for c in poly), "minimal poly must be binary"
        return poly
