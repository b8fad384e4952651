"""Shortened Reed-Solomon codecs over GF(2^6) for P25 hexbit structures.

P25 protects voice-frame metadata with shortened RS codes over GF(64)
(TIA-102.BAAA-A): RS(24,12,13) for LDU1 link control and TDULC,
RS(24,16,9) for LDU2 encryption sync, RS(36,20,17) for the HDU.  The
reference does NOT implement RS correction — it extracts the systematic
data symbols and relies on the inner Hamming/Golay codes alone
(reference ``decoders/p25_frames.py:1027``).  This codec adds real
errors-only decoding (Berlekamp-Massey + Chien + Forney), worth up to
t = (n-k)/2 corrected hexbit symbols per structure.

Convention: systematic codewords ``data || parity``; symbol index 0 is
the highest-degree coefficient; generator roots alpha^1..alpha^(n-k)
with the same primitive polynomial x^6+x+1 the other P25 field codes
use.  Encode and decode are self-consistent; the on-air P25 generator
matrices are bit-reversed variants, so cross-vendor parity
interoperability is noted as a caveat in SURVEY terms.
"""

from __future__ import annotations

import numpy as np

from .galois import GF

_GF64 = GF(6, 0x43)  # x^6 + x + 1


class ReedSolomon:
    """Errors-only shortened RS(n, k) over a GF(2^m) field (default GF(64))."""

    def __init__(self, n: int, k: int, gf: GF | None = None):
        self.gf = gf = gf if gf is not None else _GF64
        assert 0 < k < n <= gf.n
        self.n = n
        self.k = k
        self.nparity = n - k
        self.t = (n - k) // 2
        g = [1]
        for i in range(1, self.nparity + 1):
            g = gf.poly_mul(g, [gf.pow_alpha(i), 1])  # (x - alpha^i)
        self._g = g  # ascending coefficients, monic

    # -- encode ------------------------------------------------------------

    def encode(self, data: list[int] | np.ndarray) -> list[int]:
        """k data symbols -> (n-k) parity symbols (systematic)."""
        gf = self.gf
        assert len(data) == self.k
        # remainder of data(x) * x^(n-k) mod g(x)
        rem = [0] * self.nparity
        for d in data:
            feedback = int(d) ^ rem[-1]
            rem = [0] + rem[:-1]
            if feedback:
                for i in range(self.nparity):
                    rem[i] ^= gf.mul(feedback, self._g[i])
        return list(reversed(rem))

    # -- decode ------------------------------------------------------------

    def decode(self, codeword: list[int] | np.ndarray) -> tuple[np.ndarray, int] | None:
        """n received hexbits -> (corrected k data hexbits, n_errors).

        Returns None if more than t symbols are corrupt (decoding failure).
        """
        gf = self.gf
        cw = [int(c) & gf.n for c in codeword]
        assert len(cw) == self.n
        # syndromes: S_j = C(alpha^j), j=1..2t, with C as a degree n-1 poly
        # whose highest-degree coefficient is cw[0] (shortened: implicit
        # leading zeros don't contribute)
        synd = []
        for j in range(1, self.nparity + 1):
            x = gf.pow_alpha(j)
            acc = 0
            for c in cw:
                acc = gf.mul(acc, x) ^ c
            synd.append(acc)
        if not any(synd):
            return np.array(cw[: self.k], np.uint8), 0

        # Berlekamp-Massey for the error locator sigma(x) (ascending)
        sigma = [1]
        B = [1]
        L = 0
        for i in range(self.nparity):
            d = synd[i]
            for j in range(1, min(L, len(sigma) - 1) + 1):
                d ^= gf.mul(sigma[j], synd[i - j])
            B = [0] + B  # B(x) <- x * B(x)
            if d != 0:
                T = [
                    (sigma[j] if j < len(sigma) else 0)
                    ^ (gf.mul(d, B[j]) if j < len(B) else 0)
                    for j in range(max(len(sigma), len(B)))
                ]
                if 2 * L <= i:
                    B = [gf.mul(gf.inv(d), c) for c in sigma]
                    sigma = T
                    L = i + 1 - L
                else:
                    sigma = T
        while len(sigma) > 1 and sigma[-1] == 0:
            sigma.pop()
        n_err = L
        if n_err > self.t:
            return None

        # Chien search over the n shortened positions. Position p (0-based
        # from the left / highest degree) corresponds to codeword-poly
        # degree n-1-p, i.e. locator root X = alpha^(n-1-p).
        err_pos = []
        for p in range(self.n):
            x_inv = gf.pow_alpha(-(self.n - 1 - p))
            if gf.poly_eval(sigma, x_inv) == 0:
                err_pos.append(p)
        if len(err_pos) != n_err:
            return None

        # Forney: error evaluator omega(x) = [S(x) sigma(x)] mod x^2t
        s_poly = synd  # ascending: S_1 + S_2 x + ...
        omega_full = gf.poly_mul(s_poly, sigma)
        omega = omega_full[: self.nparity]
        for p in err_pos:
            deg = self.n - 1 - p
            x_inv = gf.pow_alpha(-deg)
            # sigma'(x_inv): formal derivative keeps odd-degree terms
            denom = 0
            for j in range(1, len(sigma), 2):
                denom ^= gf.mul(sigma[j], gf.pow_alpha(-deg * (j - 1)))
            if denom == 0:
                return None
            # fcr=1 Forney: e = omega(X^-1) / sigma'(X^-1)
            mag = gf.mul(gf.poly_eval(omega, x_inv), gf.inv(denom))
            cw[p] ^= mag

        # verify: recompute syndromes
        for j in range(1, self.nparity + 1):
            x = gf.pow_alpha(j)
            acc = 0
            for c in cw:
                acc = gf.mul(acc, x) ^ c
            if acc:
                return None
        return np.array(cw[: self.k], np.uint8), n_err


RS_24_12 = ReedSolomon(24, 12)  # LDU1 LC, TDULC
RS_24_16 = ReedSolomon(24, 16)  # LDU2 ESS
RS_36_20 = ReedSolomon(36, 20)  # HDU

# DMR full link control: RS(12,9) over GF(256) with the ETSI field
# x^8+x^4+x^3+x^2+1 and generator roots alpha^1..alpha^3 (ETSI TS 102
# 361-1 B.3.6; generator coefficients [64, 56, 14, 1] ascending).  t=1:
# corrects a single byte error in the 96-bit FLC.
_GF256 = GF(8, 0x11D)
RS_12_9 = ReedSolomon(12, 9, _GF256)
