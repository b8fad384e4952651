"""The port's FEC codecs (``wavecap_tpu_torch/decoders/fec``) against the
JAX package's, on the CPU.

Host numpy code on both sides: each case feeds the same seeded inputs
(``np.random.default_rng(seed)``) through the reference's functions and
the port's, and the two results must be equal exactly (arrays bit for
bit, parsed fields by ``==``).  The cases follow ``tests/test_fec.py``
(without its check against an outside reference table),
``tests/test_fec_robustness.py``, ``tests/test_galois_field.py``,
``tests/test_rs.py`` and the BPTC and 3/4-rate trellis cases of
``tests/test_dmr_csbk.py``.

``Pkg``, ``canon`` and ``run_case`` are shared with the other
``test_torch_decoders_*`` files.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
from collections import deque

import numpy as np
import pytest

SHORT = {
    "bch": "fec.bch", "bptc": "fec.bptc", "crc": "fec.crc", "galois": "fec.galois",
    "golay": "fec.golay", "rs": "fec.rs", "trellis": "fec.trellis", "pf": "p25_frames",
    "tsbk": "p25_tsbk", "framer": "framer", "nac": "nac_tracker", "p25v": "p25_voice",
    "lrrp": "lrrp", "iv": "imbe_vocoder", "voice": "voice", "ambe": "ambe_vocoder",
    "p2": "p25_phase2", "mac": "p25_mac", "dmr": "dmr",
}


class Pkg:
    """One package's decoder modules by short name: ``Pkg("wavecap_tpu").pf``
    is ``wavecap_tpu.decoders.p25_frames``."""

    def __init__(self, root: str):
        self.root = root

    def __getattr__(self, name: str):
        return importlib.import_module(f"{self.root}.decoders.{SHORT[name]}")


REF, PORT = Pkg("wavecap_tpu"), Pkg("wavecap_tpu_torch")


def canon(x):
    """A comparable, package-free form of a decoder's result: arrays by
    dtype, shape and bytes, floats by their bits, dataclasses and objects
    by class name and fields, enum members by class name, name and value."""
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, np.generic):
        return canon(x.item())
    if isinstance(x, enum.Enum):
        return ("enum", type(x).__name__, x.name, x.value)
    if isinstance(x, bool) or x is None or isinstance(x, (int, str, bytes)):
        return x
    if isinstance(x, float):
        return ("f", x.hex())
    if isinstance(x, complex):
        return ("c", x.real.hex(), x.imag.hex())
    if isinstance(x, dict):
        return ("dict", tuple(sorted(((repr(canon(k)), canon(v)) for k, v in x.items()),
                                     key=lambda kv: kv[0])))
    if isinstance(x, (list, tuple, deque)):
        return ("seq", tuple(canon(v) for v in x))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, tuple((f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)))
    if isinstance(x, np.random.Generator):
        return ("rng", canon(x.bit_generator.state))
    if hasattr(x, "__dict__"):
        return (type(x).__name__, canon(dict(vars(x))))
    raise TypeError(f"no canonical form for {type(x)}")


def run_case(fn, seed: int = 12345):
    """``fn(pkg, rng)`` through both packages with the same seed; the two
    results equal, and returned (the reference's) for further checks."""
    ref = fn(REF, np.random.default_rng(seed))
    got = fn(PORT, np.random.default_rng(seed))
    assert canon(got) == canon(ref)
    return ref


def flip(x: np.ndarray, pos) -> np.ndarray:
    y = np.array(x, copy=True)
    y[np.asarray(pos)] ^= 1
    return y


# --- BCH(63,16,23) ---------------------------------------------------------------------


def bch_roundtrip(d, rng):
    out = []
    for _ in range(20):
        data = int(rng.integers(0, 1 << 16))
        cw = d.bch.encode(data)
        out.append((cw, d.bch.decode(cw)))
    return out


def bch_errors(d, rng, n_errors: int, trials: int = 10, data: int = 0xA5C3):
    cw = d.bch.encode(data)
    return [d.bch.decode(flip(cw, rng.choice(63, size=n_errors, replace=False))) for _ in range(trials)]


def bch_pairs(d, rng):
    cw = d.bch.encode(0xBEEF)
    out = []
    for i in range(0, 63, 7):
        one = flip(cw, [i])
        out.append(d.bch.decode(one))
        out += [d.bch.decode(flip(one, [j])) for j in range(i + 3, 63, 13)]
    return out


def bch_heavy(d, rng):
    out = []
    for _ in range(20):
        cw = d.bch.encode(int(rng.integers(0, 1 << 16)))
        out.append(d.bch.decode(flip(cw, rng.choice(63, int(rng.integers(1, 12)), replace=False))))
    return out


# --- Golay(24,12) ----------------------------------------------------------------------


def golay_roundtrip(d, rng):
    return [d.golay.decode(d.golay.encode(int(rng.integers(0, 1 << 12)))) for _ in range(50)]


def golay_errors(d, rng, n_errors: int, trials: int = 30, data: int = 0x7B5):
    cw = d.golay.encode(data)
    return [d.golay.decode(flip(cw, rng.choice(24, size=n_errors, replace=False))) for _ in range(trials)]


def golay_codewords(d, rng):
    return [d.golay.encode(1 << i) for i in range(12)] + [d.golay.encode(0), d.golay.B]


# --- the 1/2- and 3/4-rate trellis -----------------------------------------------------


def trellis_roundtrip(d, rng):
    bits = rng.integers(0, 2, 96).astype(np.uint8)
    tx = d.trellis.encode_bits(bits)
    return tx, d.trellis.viterbi_decode_bits(tx)


def trellis_dibit_errors(d, rng):
    tx = d.trellis.encode_bits(rng.integers(0, 2, 96).astype(np.uint8))
    out = []
    for _ in range(20):
        rx = tx.copy()
        for p in rng.choice(range(0, 98, 7), size=3, replace=False):
            rx[2 * p] ^= 1
        out.append(d.trellis.viterbi_decode_bits(rx))
    return out


def trellis_single_and_burst(d, rng):
    coded = d.trellis.encode_bits(rng.integers(0, 2, 96).astype(np.uint8))
    out = [d.trellis.viterbi_decode_bits(flip(coded, [p])) for p in (0, 40, 100, 190)]
    return out + [d.trellis.viterbi_decode_bits(flip(coded, range(40, 44)))]


def trellis_soft(d, rng):
    coded = d.trellis.encode_bits(rng.integers(0, 2, 96).astype(np.uint8))
    dib = (coded[0::2] << 1) | coded[1::2]
    soft = np.array([[1.0, 3.0, -1.0, -3.0][x] for x in dib], np.float32)
    noisy = soft + rng.normal(0, 0.9, soft.shape).astype(np.float32)
    return (d.trellis.viterbi_decode_soft(soft.reshape(-1, 2)), d.trellis.viterbi_decode_dibits(dib),
            d.trellis.viterbi_decode_soft(noisy.reshape(-1, 2)), d.trellis.OUTPUT_NIBBLE)


def trellis34_roundtrip(d, rng):
    bits = rng.integers(0, 2, 144).astype(np.uint8)
    tx = d.trellis.encode_bits_34(bits)
    return tx, d.trellis.viterbi_decode_bits_34(tx), d.trellis.viterbi_decode_bits_34(flip(tx, [11, 90]))


def trellis34_soft(d, rng):
    tx = d.trellis.encode_bits_34(rng.integers(0, 2, 144).astype(np.uint8))
    rxd = (tx[0::2] << 1) | tx[1::2]
    soft = d.trellis._DIBIT_VALUES[rxd].reshape(-1, 2)
    soft = soft + rng.normal(0, 0.6, soft.shape).astype(np.float32)
    return d.trellis.viterbi_decode_soft_34(soft), d.trellis.viterbi_decode_dibits_34(rxd)


# --- CRC --------------------------------------------------------------------------------


def crc_roundtrip(d, rng):
    out = []
    for _ in range(20):
        bits = rng.integers(0, 2, 80).astype(np.uint8)
        block = np.concatenate([bits, d.crc.tsbk_crc_encode(bits)])
        out.append((block, d.crc.tsbk_crc_check(block), d.crc.tsbk_crc_check(flip(block, [17]))))
    return out


def crc_edges(d, rng):
    out = []
    for fill in (0, 1):
        bits = np.full(80, fill, np.uint8)
        out.append(d.crc.tsbk_crc_check(np.concatenate([bits, d.crc.tsbk_crc_encode(bits)])))
    bits = rng.integers(0, 2, 80).astype(np.uint8)
    block = np.concatenate([bits, d.crc.tsbk_crc_encode(bits)])
    out += [d.crc.tsbk_crc_check(flip(block, [i])) for i in range(0, 96, 5)]
    long = rng.integers(0, 2, 256).astype(np.uint8)
    return out + [d.crc.crc32_p25(long), d.crc.crc32_p25(list(long)), d.crc.crc9_p25(long[:135]),
                  d.crc.crc16_ccitt_bits(long[:80]), d.crc.crc16_ccitt_bits(long[:64], init=0xFFFF)]


# --- GF(2^m) and Reed-Solomon ------------------------------------------------------------

FIELDS = [(6, 0x43), (8, 0x11D)]


def gf_field(d, rng, m: int, poly: int):
    gf = d.galois.GF(m, poly)
    pairs = rng.integers(0, gf.n + 1, (200, 2))
    return (gf.exp, gf.log, [gf.mul(int(a), int(b)) for a, b in pairs],
            [gf.inv(a) for a in range(1, gf.n + 1)], [gf.pow_alpha(e) for e in (0, 1, -1, gf.n, 7)],
            [gf.minimal_poly(e) for e in (1, 3, 5, 9)], gf.poly_mul([3, 7, 1], [19, 1]),
            gf.poly_eval([3, 7, 1, 5], 11))


def gf_inverse_of_zero(d, rng):
    with pytest.raises(ZeroDivisionError):
        d.galois.GF(6, 0x43).inv(0)
    return d.galois.gf_tables(6, 0x43) is d.galois.gf_tables(6, 0x43)


RS_CODES = ["RS_24_12", "RS_24_16", "RS_36_20"]


def rs_code(d, rng, name: str):
    rs = getattr(d.rs, name)
    out = []
    for ne in [0] + list(range(1, rs.t + 1)) + [rs.t + 3] * 4:
        data = rng.integers(0, 64, rs.k).tolist()
        cw = data + rs.encode(data)
        for p in rng.choice(rs.n, ne, replace=False):
            cw[p] ^= int(rng.integers(1, 64))
        out.append((cw, rs.decode(cw)))
    return out


def bptc_codec(d, rng):
    out = []
    for _ in range(20):
        b = rng.integers(0, 2, 96).astype(np.uint8)
        tx = d.bptc.encode_bptc_196(b)
        out += [tx, d.bptc.decode_bptc_196(tx), d.bptc.decode_bptc_196(flip(tx, rng.choice(196, 3, replace=False)))]
    return out


CASES = {
    "bch_roundtrip": bch_roundtrip,
    **{f"bch_{n}_errors": (lambda d, rng, n=n: bch_errors(d, rng, n)) for n in (1, 3, 7, 11)},
    "bch_20_errors": lambda d, rng: bch_errors(d, rng, 20, trials=30, data=0x1234),
    "bch_single_and_double": bch_pairs,
    "bch_heavy": bch_heavy,
    "bch_generator": lambda d, rng: d.bch.generator_poly(),
    "golay_roundtrip": golay_roundtrip,
    **{f"golay_{n}_errors": (lambda d, rng, n=n: golay_errors(d, rng, n)) for n in (1, 2, 3)},
    "golay_3_errors_many": lambda d, rng: golay_errors(d, rng, 3, trials=100, data=0x5A7),
    "golay_4_errors": lambda d, rng: golay_errors(d, rng, 4, trials=60, data=0x123),
    "golay_codewords": golay_codewords,
    "trellis_roundtrip": trellis_roundtrip,
    "trellis_dibit_errors": trellis_dibit_errors,
    "trellis_single_and_burst": trellis_single_and_burst,
    "trellis_soft": trellis_soft,
    "trellis34_roundtrip": trellis34_roundtrip,
    "trellis34_soft": trellis34_soft,
    "crc_roundtrip": crc_roundtrip,
    "crc_edges": crc_edges,
    **{f"gf_{m}": (lambda d, rng, m=m, p=p: gf_field(d, rng, m, p)) for m, p in FIELDS},
    "gf_inverse_of_zero": gf_inverse_of_zero,
    **{f"rs_{n[3:]}": (lambda d, rng, n=n: rs_code(d, rng, n)) for n in RS_CODES},
    "bptc": bptc_codec,
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fec_matches_reference(name):
    run_case(CASES[name])


def test_the_fec_package_exports_the_same_modules():
    assert PORT.bch.__name__ == "wavecap_tpu_torch.decoders.fec.bch"
    fec_ref = importlib.import_module("wavecap_tpu.decoders.fec")
    fec_port = importlib.import_module("wavecap_tpu_torch.decoders.fec")
    assert fec_port.__all__ == fec_ref.__all__
    for name in fec_port.__all__:
        assert getattr(fec_port, name).__name__ == f"wavecap_tpu_torch.decoders.fec.{name}"


def test_module_tables_are_the_ports_own():
    """The cached tables (GF exp/log, BCH's field and generator, the
    vocoder FEC tables) are each package's own objects: neither package
    reads the other's."""
    assert PORT.galois.gf_tables(6, 0x43) is not REF.galois.gf_tables(6, 0x43)
    assert PORT.bch._field() is not REF.bch._field()
    assert PORT.bch.generator_poly() is not REF.bch.generator_poly()
    assert PORT.golay.B is not REF.golay.B
    assert PORT.voice._load_mbelib is not REF.voice._load_mbelib
    assert PORT.iv.ImbeParams is not REF.iv.ImbeParams
