"""The port's audio-fed decoders (``wavecap_tpu_torch/decoders``:
``pocsag``, ``flex``, ``rds``) against the JAX package's, on the CPU.

Host numpy / scipy code on both sides: each case feeds the same seeded
audio or FM baseband (``np.random.default_rng(seed)``) through the
reference's decoder and the port's, and the decoded messages and the
decoder's state must be equal exactly (``canon``; the messages' wall
clock ``time`` left out).  The cases follow ``tests/test_aux_decoders.py``
(RDS and POCSAG) and the FLEX cases of ``tests/test_misc_components.py``,
with noise, several messages a stream and odd block splits added so that
the decoders' carried tails are exercised.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import pytest

from tests.test_torch_decoders_fec import canon

PKGS = ("wavecap_tpu", "wavecap_tpu_torch")


def dec(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.decoders.{name}")


def plain(msgs) -> list:
    """Messages as dicts without their wall-clock stamp."""
    return [{k: v for k, v in dataclasses.asdict(m).items() if k != "time"} for m in msgs]


def same(case, seed: int = 16):
    a = case(PKGS[0], np.random.default_rng(seed))
    b = case(PKGS[1], np.random.default_rng(seed))
    assert canon(b) == canon(a)
    return a


def blocks(x: np.ndarray, sizes) -> list:
    out, i, k = [], 0, 0
    while i < len(x):
        n = sizes[k % len(sizes)]
        out.append(x[i:i + n])
        i, k = i + n, k + 1
    return out


# --- POCSAG ----------------------------------------------------------------------------


def pocsag_bch(p, rng):
    data = rng.integers(0, 1 << 21, 200)
    cws = [p.bch3121_encode(int(d)) for d in data]
    flips = [cw ^ (1 << int(a)) ^ (1 << int(b)) for cw, (a, b) in zip(cws, rng.integers(0, 32, (200, 2)))]
    return cws, [p.bch3121_check(c) for c in cws + flips], [p.bch3121_syndrome(c) for c in flips]


def pocsag_messages(p, rng, baud: int, numeric: bool):
    """Three pages at one rate in noise, split into odd blocks."""
    if numeric:
        pages = [(42, "911 555"), (int(rng.integers(8, 1 << 21)), "0123456789"), (7, "U-()* 12")]
    else:
        pages = [(133_7003, "HELLO WORLD"), (int(rng.integers(8, 1 << 21)), "PAGE TWO %d" % rng.integers(1000)),
                 (2_000_001, "The quick brown fox")]
    audio = [np.zeros(int(rng.integers(2000, 9000)), np.float32)]
    for addr, text in pages:
        bits = p.encode_message(addr, text, numeric=numeric)
        audio += [p.modulate_pocsag(bits, 48_000, baud), np.zeros(int(rng.integers(3000, 20_000)), np.float32)]
    x = np.concatenate(audio)
    x = x + rng.normal(0, 0.25, len(x)).astype(np.float32)
    d = p.POCSAGDecoder(48_000)
    got = [plain(d.process_audio(b)) for b in blocks(x, [9600, 7001, 12_345])]
    return got, plain(d.messages), d._tail


@pytest.mark.parametrize("baud", [512, 1200, 2400])
@pytest.mark.parametrize("numeric", [False, True], ids=["alpha", "numeric"])
def test_pocsag_matches_reference(baud, numeric):
    got, every, _ = same(lambda pkg, rng: pocsag_messages(dec(pkg, "pocsag"), rng, baud, numeric))
    assert any(m["baud"] == baud for m in every)


def test_pocsag_codewords_match_reference():
    same(lambda pkg, rng: pocsag_bch(dec(pkg, "pocsag"), rng))


def test_pocsag_noise_and_roundtrip():
    def case(pkg, rng):
        p = dec(pkg, "pocsag")
        noise = p.POCSAGDecoder(48_000).process_audio(rng.standard_normal(48_000).astype(np.float32))
        d = p.POCSAGDecoder(48_000, bauds=(1200,))
        one = d.process_audio(p.modulate_pocsag(p.encode_message(133_7003, "HELLO WORLD"), 48_000, 1200))
        return plain(noise), plain(one)

    noise, one = same(case)
    assert noise == [] and one[0]["address"] == 133_7003 and one[0]["content"] == "HELLO WORLD"


# --- FLEX ------------------------------------------------------------------------------


def flex_frames(f, rng):
    pages = [(123456, "TEST PAGE"), (int(rng.integers(1, 1 << 21)), "FLEX %d" % rng.integers(10_000)),
             (1_999_999, "ABCDEFGHIJKLMNOPQRSTUVW")]
    audio = [np.zeros(int(rng.integers(1000, 5000)), np.float32)]
    for cap, text in pages:
        audio += [f.modulate_flex(f.encode_frame(cap, text)), np.zeros(int(rng.integers(10_000, 40_000)), np.float32)]
    x = np.concatenate(audio)
    x = -(x + rng.normal(0, 0.25, len(x)).astype(np.float32))  # the other polarity
    d = f.FlexDecoder(48_000)
    got = [plain(d.process_audio(b)) for b in blocks(x, [9600, 15_001])]
    noise = plain(f.FlexDecoder(48_000).process_audio(rng.normal(0, 1, 48_000).astype(np.float32)))
    return got, plain(d.messages), noise, f.encode_frame(77, "x")


def test_flex_matches_reference():
    got, every, noise, _ = same(lambda pkg, rng: flex_frames(dec(pkg, "flex"), rng))
    assert noise == [] and any(m["capcode"] == 123456 and m["content"].startswith("TEST PAGE") for m in every)


# --- RDS -------------------------------------------------------------------------------


def rds_groups(r, rng):
    """Groups straight into the link layer: PS (0A), RadioText (2A), with
    bit errors, and a syndrome sweep."""
    ps, text = "KEXP 903", "NOW PLAYING - TEST SONG".ljust(64)
    bits = []
    for seg in range(4):
        bits.append(r.encode_group(0x484F, 0, (5 << 5) | seg, 0xE201, (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])))
    for seg in range(16):
        c = (ord(text[4 * seg]) << 8) | ord(text[4 * seg + 1])
        d = (ord(text[4 * seg + 2]) << 8) | ord(text[4 * seg + 3])
        bits.append(r.encode_group(0x484F, 2, seg, c, d))
    x = np.concatenate(bits)
    x[rng.integers(0, len(x), 12)] ^= 1
    d = r.RDSDecoder(240_000)
    for part in np.array_split(x, 7):
        d._bits = np.concatenate([d._bits, part])
        d._decode_groups()
    data = [(int(v), r.block_syndrome(int(v))) for v in rng.integers(0, 1 << 26, 300)]
    return dataclasses.asdict(d.data), d._ps, d._rt, d._bits, data


def rds_baseband(r, rng, fs: int, block: int, lead: float):
    """The physical layer: a modulated 57 kHz subcarrier with its pilot,
    a program tone and noise, fed in blocks.  The decoder samples each
    block from its start, without clock recovery: blocks of 0.2 s are
    237.5 bits, so the bits start ``lead`` of a bit in, where both
    parities of block decode."""
    groups = []
    for seg in range(4):
        groups.append(r.encode_group(0x2345, 0, seg, 0xE201, (ord("WAVECAP!"[2 * seg]) << 8) | ord("WAVECAP!"[2 * seg + 1])))
    for seg in range(2):
        groups.append(r.encode_group(0x2345, 2, seg, (ord("H100 RDS"[4 * seg]) << 8) | ord("H100 RDS"[4 * seg + 1]),
                                     (ord("H100 RDS"[4 * seg + 2]) << 8) | ord("H100 RDS"[4 * seg + 3])))
    x = np.asarray(r.modulate_rds(np.concatenate(groups * 6), fs, amplitude=0.12))
    x = np.concatenate([np.zeros(int(round(lead * fs / r.RDS_BITRATE)), np.float32), x])
    t = np.arange(len(x)) / fs
    x = (x + 0.4 * np.sin(2 * np.pi * 1000 * t) + rng.normal(0, 0.02, len(x))).astype(np.float32)
    d = r.RDSDecoder(fs)
    snaps = [dataclasses.asdict(d.process_baseband(b)) for b in blocks(x, [block])]
    return snaps, d._bits


def test_rds_link_layer_matches_reference():
    data, ps, rt, _, _ = same(lambda pkg, rng: rds_groups(dec(pkg, "rds"), rng))
    assert data["pi"] == 0x484F and data["blocks_ok"] > 0 and data["blocks_bad"] > 0  # the flipped bits


@pytest.mark.parametrize("fs,block,lead", [(240_000, 48_000, 0.25), (240_000, 48_000, 0.0), (240_000, 60_000, 0.0),
                                           (250_000, 50_000, 0.25)])
def test_rds_physical_layer_matches_reference(fs, block, lead):
    snaps, _ = same(lambda pkg, rng: rds_baseband(dec(pkg, "rds"), rng, fs, block, lead))
    if lead or block != 48_000:
        assert snaps[-1]["pi"] == 0x2345 and snaps[-1]["ps"] == "WAVECAP!" and snaps[-1]["radiotext"] == "H100 RDS"
    else:
        assert snaps[-1]["pi"] is None  # at this phase every block samples the bits' edges


def test_rds_short_block_is_skipped():
    def case(pkg, rng):
        r = dec(pkg, "rds")
        d = r.RDSDecoder(240_000)
        return dataclasses.asdict(d.process_baseband(rng.standard_normal(4095).astype(np.float32))), d._bits

    data, bits = same(case)
    assert data["pi"] is None and len(bits) == 0
