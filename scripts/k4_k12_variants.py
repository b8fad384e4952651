#!/usr/bin/env python3
"""Where K4's and K12's time goes: the port's designs of the voice FIR
(``kernels/csrc/voice_fir.cu``) and the P25 block timing
(``kernels/csrc/p25_timing.cu``, K12 and K13's timing) before their
redesign, taken from a checkout of that commit, beside the current ones,
with the current ones' plans forced and the trials that lost applied as
patches, every design instrumented by stage, all timed in one process on
the card.

Run from the repository root on a machine with one NVIDIA card, with the
commit before the redesign unpacked into a directory
(``git archive a39609c | tar -x -C checkout_proof/parent``)::

    python3 scripts/k4_k12_variants.py --parent checkout_proof/parent [--out FILE]

* "before": the parent's ``voice_fir.cu`` and ``p25_timing.cu`` built as
  they are, and with ``OLD_STAMPS`` applied (clock64 in thread 0 of each
  CTA: K4 [0] start, [1] row staged, [2] filtered and its energy summed,
  [3] end; K12 [0] start, [1] row staged, [2] dc, [3] O&M line, [4] g0
  and g1, [5] g2, [6] symbols gathered, [7] end).  K4 one CTA of 256
  threads a slot row, the extended and the filtered row staged in shared
  memory, two shared loads an FMA (rows of at most 27,000 samples); K12 /
  K13 one CTA of 512 threads a row, the row and its symbols staged, ten
  dependent block reductions.
* the current kernels through their wrappers, built with ``K4_CLOCKS=1``
  / ``K12_CLOCKS=1`` (K4: each stage's cycles summed over a CTA's rows;
  K12 [0] start, [1] window bounds, [2] window staged, [3] dc, [4] the
  O&M line, [5] g0 and g1, [6] g2, [7] the gain or bias, [8] end), the
  trials that lost (``PATCHES``: the current source with one change,
  written beside the builds) and the current kernels with their plans
  forced (the wrapper's ``k4_plan`` / ``k12_plan`` replaced for the call;
  K4's "1 CTAs a row x 320 threads, 396 CTAs" at the slice is the plan
  the redesign first ran: every row whole, 8 CTAs taking a third).

Every variant runs behind the port's wrappers (the launcher's function is
swapped) at ``chip_smoke.py``'s ``K4_PATH_SHAPES`` and ``K12_PATH_SHAPES``,
is held against the plain version at ``chip_smoke.py``'s thresholds (K4:
audio >= 70 dB on open slots, shut slots silent, RSSI and tails exact;
K12 / K13: dibits equal, soft >= 60 dB, state within 1e-3) and timed as
device time from CUPTI (``chip_smoke.device_ms``).  A stage's time is the
median over the CTAs of SM cycles between its stamps.  One JSON line a
case and variant, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# --- the stamps of the designs before the redesign (the parent's sources)
STAMP_MACROS = r"""
#ifndef OLD_CLOCKS
#define OLD_CLOCKS 1
#endif
__device__ long long g_old_clocks[4096][8];
#define STAMP(k)                                                              \
    do {                                                                      \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_old_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
"""
STAMP_READER = r"""
WAVECAP_EXPORT int old_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));
}
"""
END_NS = "}  // namespace\n"


def after(anchor: str, text: str) -> tuple:
    return anchor, anchor + text


def before(anchor: str, text: str) -> tuple:
    return anchor, text + anchor


OLD_STAMPS = {
    "voice_fir.cu": [
        after('#include "common.cuh"\n', STAMP_MACROS),
        after("    const float* carry = tail + static_cast<long>(slot) * tl;\n", "    STAMP(0);\n"),
        after("    for (int i = threadIdx.x; i < s_len; i += blockDim.x) xin[tl + i] = row[i];\n"
              "    __syncthreads();\n", "    STAMP(1);\n"),
        after("    energy = block_sum(energy, scratch);  // its barrier also publishes y\n", "    STAMP(2);\n"),
        after("    if (threadIdx.x == 0) rssi_out[slot] = on ? rssi[slot] : -200.f;\n", "    STAMP(3);\n"),
        after(END_NS, STAMP_READER),
    ],
    "p25_timing.cu": [
        after('#include "p25_common.cuh"\n', STAMP_MACROS),
        after("    const V* src = rows_in + static_cast<long long>(r) * len;\n", "    STAMP(0);\n"),
        after("    for (int i = tid; i < len; i += bs) buf[i] = src[i];\n    __syncthreads();\n", "    STAMP(1);\n"),
        before("    // --- the O&M line at the symbol rate over the two block halves\n", "    STAMP(2);\n"),
        after("    den = block_sum(den, scratch);\n", "    STAMP(3);\n"),
        after("    const float g1 = gardner(__fadd_rn(d0, 0.5f));\n", "    STAMP(4);\n"),
        after("    delta = clip(ok ? __fsub_rn(delta, __fdiv_rn(g2, k)) : delta, -c.half, c.half);\n",
              "    STAMP(5);\n"),
        after("        sym[m] = sample(__fadd_rn(at(m, 0.f), ramp));\n    }\n    __syncthreads();\n",
              "    STAMP(6);\n"),
        after("        for (int q = 0; q < 6; ++q) out[q * rows + r] = vals[q];\n    }\n", "    STAMP(7);\n"),
        after(END_NS, STAMP_READER),
    ],
}

# --- the trials that lost, as changes to the current sources

# K12: the O&M line's weights computed in the kernel (the angle, then
# sincosf, or cosf and sinf) in place of the table of c4fm.py:_om_table
K12_TABLE = "                w[q] = __ldg(om_tab + (i - kTail));\n"
K12_ANGLE = ("                const float ang = __fdiv_rn(__fmul_rn(static_cast<float>(-6.283185307179586),\n"
             "                                                      static_cast<float>(i - kTail)), c.sps);\n")
K12_SINCOS = K12_ANGLE + "                sincosf(ang, &w[q].y, &w[q].x);\n"
K12_COS_SIN = K12_ANGLE + "                w[q] = make_float2(cosf(ang), sinf(ang));\n"
# K12: no dc exchange; every CTA sums the whole row from global memory
# (L2) in one order while its window lands, so each forms the same dc
K12_VALS = ("    constexpr int kVals[kSteps] = {kCqpsk ? 0 : 1, 5, 4, 2, 1};  // each step's sums\n"
            "    red.init(kVals);  // while the window's copies land\n")
K12_DC_EVERY_CTA = """    constexpr int kVals[kSteps] = {0, 5, 4, 2, 1};  // each step's sums: no dc exchange
    red.init(kVals);  // while the window's copies land
    float dc0 = 0.f;
    if constexpr (!kCqpsk) {
        float v = 0.f;
#pragma unroll 8
        for (int i = kTail + tid; i < len; i += bs) v += row[i];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if ((tid & 31) == 0) warps[tid >> 5][0] = v;
        __syncthreads();
        v = 0.f;
        for (int w = 0; w < (bs >> 5); ++w) v += warps[w][0];
        __syncthreads();
        dc0 = __fadd_rn(__fmul_rn(s4, 0.9f), __fmul_rn(__fdiv_rn(v, static_cast<float>(n)), 0.1f));
    }
"""
K12_DC = """    // --- dc (C4FM)
    float dc0 = 0.f;
    if constexpr (!kCqpsk) {
        float v[1] = {0.f};
        for (int i = b_lo + tid; i < b_hi; i += bs) v[0] += src[i];
        red.sum<1>(v, 0);
        dc0 = __fadd_rn(__fmul_rn(s4, 0.9f), __fmul_rn(__fdiv_rn(v[0], static_cast<float>(n)), 0.1f));
    }
"""
# K4's soft clip by the library's tanhf, and its outputs stored by each
# thread straight from registers (no out buffer, no bulk store)
K4_FAST_TANH = ("    const float e = __expf(2.f * (y * 1.5f));\n"
                "    return (1.f - __fdividef(2.f, e + 1.f)) * clip_gain;\n")
K4_TANHF = "    return tanhf(y * 1.5f) * clip_gain;\n"
K4_BULK = """            if (e0 < n) {
                float v[kR];
#pragma unroll
                for (int j = 0; j < kR; ++j) v[j] = open ? soft_clip(acc[j] * gain, clip_gain) : 0.f;
#pragma unroll
                for (int a = 0; a < kR / 4; ++a)
                    reinterpret_cast<float4*>(ob + e0)[a] = make_float4(v[4 * a], v[4 * a + 1], v[4 * a + 2], v[4 * a + 3]);
            }
            bulk_fence();
            __syncthreads();
            const int n4 = bulk ? n & ~3 : 0;
            if (tid == 0 && n4) bulk_store(out + lo, ob, 4 * n4);
            for (int i = n4 + tid; i < n; i += bs) out[lo + i] = ob[i];
"""
K4_DIRECT = """            if (e0 < n) {
                float v[kR];
#pragma unroll
                for (int j = 0; j < kR; ++j) v[j] = open ? soft_clip(acc[j] * gain, clip_gain) : 0.f;
                if (e0 + kR <= n && bulk) {
#pragma unroll
                    for (int a = 0; a < kR / 4; ++a)
                        reinterpret_cast<float4*>(out + lo + e0)[a] =
                            make_float4(v[4 * a], v[4 * a + 1], v[4 * a + 2], v[4 * a + 3]);
                } else {
#pragma unroll
                    for (int j = 0; j < kR; ++j)
                        if (e0 + j < n) out[lo + e0 + j] = v[j];
                }
            }
"""
# K4: the banded product on the tensor cores in 3xTF32 (the counterpart of
# the reference's _conv_valid_matmul) in place of the register ring: a
# warp's 512 outputs as 4 tiles of 16 groups x 8, A the staged inputs
# (A[q][j] = xin[8 q + j]), B the band of taps (B[j][r] = h[r + 126 - j]),
# 17 k-steps of 8, three mma.sync a k-step
K4_TC_FUNCTIONS = r"""
constexpr int kSteps = (kTaps + 7 + 7) / 8;  // k-steps of 8 over the band's 134 rows: 17

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi the nearest TF32, lo the f32 remainder (exact)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// the band as mma B fragments: a lane's (hi, lo) pairs at rows 8 ks + t
// and 8 ks + t + 4, column g
__device__ __forceinline__ void build_band(float4* band, const float* taps) {
    for (int i = threadIdx.x; i < kSteps * 32; i += blockDim.x) {
        const int ks = i >> 5, lane = i & 31, g = lane >> 2, t = lane & 3;
        const int k0 = g + kHalo - (8 * ks + t), k1 = k0 - 4;
        uint32_t h0, l0, h1, l1;
        tf32_split(k0 >= 0 && k0 < kTaps ? taps[k0] : 0.f, h0, l0);
        tf32_split(k1 >= 0 && k1 < kTaps ? taps[k1] : 0.f, h1, l1);
        band[i] = make_float4(__uint_as_float(h0), __uint_as_float(l0), __uint_as_float(h1),
                              __uint_as_float(l1));
    }
}

__device__ __forceinline__ void fir_mma(float (&acc)[kR], const float* xs, const float4* band) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const int e_row = 512 * w + 128 * mt + 8 * g + t;
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
            const int e = e_row + 8 * ks;
            uint32_t ah[4], al[4];
            tf32_split(xs[padded(e)], ah[0], al[0]);
            tf32_split(xs[padded(e + 64)], ah[1], al[1]);
            tf32_split(xs[padded(e + 4)], ah[2], al[2]);
            tf32_split(xs[padded(e + 68)], ah[3], al[3]);
            const float4 b = band[ks * 32 + lane];
            mma_tf32(d, al, __float_as_uint(b.x), __float_as_uint(b.z));  // the small products first
            mma_tf32(d, ah, __float_as_uint(b.y), __float_as_uint(b.w));
            mma_tf32(d, ah, __float_as_uint(b.x), __float_as_uint(b.z));
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[4 * mt + c] = d[c];
    }
}

// the local output of a thread's j-th sum, and whether its warp forms any
// of a pass's n_out
__device__ __forceinline__ int out_pos(int j) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    return 512 * w + 128 * (j >> 2) + 8 * (lane >> 2) + 2 * (lane & 3) + (j & 1) + 64 * ((j >> 1) & 1);
}
__device__ __forceinline__ bool forms(int n_out) { return (threadIdx.x >> 5) * 512 < n_out; }

"""
K4_TC = [
    before("// ops/clip.py:soft_clip of the normalized sample: tanh(x) = 1 - 2 / (e^2x +\n", K4_TC_FUNCTIONS),
    after("    __shared__ float4 h4[(kTaps + 3) / 4];\n", "    __shared__ float4 band[kSteps * 32];\n"),
    after("        reinterpret_cast<float*>(h4)[i] = i < kTaps ? taps[i] : 0.f;\n", "    build_band(band, taps);\n"),
    ("""            if (e0 < hi - lo) {
                fir16(acc, xb, h4);
#pragma unroll
                for (int j = 0; j < kR; ++j)
                    if (e0 + j < hi - lo) energy""", """            if (forms(hi - lo)) {
                fir_mma(acc, xb, band);
#pragma unroll
                for (int j = 0; j < kR; ++j)
                    if (out_pos(j) < hi - lo) energy"""),
    ("""                if (e0 < n_out) {
                    fir16(acc, xs, h4);
#pragma unroll
                    for (int j = 0; j < kR; ++j) {
                        if (e0 + j < n_out) {
                            energy = fmaf(acc[j], acc[j], energy);
                            out[t0 + e0 + j] = acc[j];""", """                if (forms(n_out)) {
                    fir_mma(acc, xs, band);
#pragma unroll
                    for (int j = 0; j < kR; ++j) {
                        if (out_pos(j) < n_out) {
                            energy = fmaf(acc[j], acc[j], energy);
                            out[t0 + out_pos(j)] = acc[j];"""),
    ("""            if (e0 < n) {
                float v[kR];
#pragma unroll
                for (int j = 0; j < kR; ++j) v[j] = open ? soft_clip(acc[j] * gain, clip_gain) : 0.f;
#pragma unroll
                for (int a = 0; a < kR / 4; ++a)
                    reinterpret_cast<float4*>(ob + e0)[a] = make_float4(v[4 * a], v[4 * a + 1], v[4 * a + 2], v[4 * a + 3]);
            }
""", """            if (forms(n)) {
#pragma unroll
                for (int j = 0; j < kR; ++j)
                    if (out_pos(j) < n) ob[out_pos(j)] = open ? soft_clip(acc[j] * gain, clip_gain) : 0.f;
            }
"""),
    ("                    const int n = t0 + e0 + j;\n", "                    const int n = t0 + out_pos(j);\n"),
]

# K12 / K13: CTAs of up to 1,024 threads (a row on one SM, 1,024 threads:
# block sums, no cluster exchange)
K12_512 = "constexpr int kMaxThreads = 512;\n"
K12_1024 = "constexpr int kMaxThreads = 1024;\n"

# K4: the rows left over first, then the whole rows, so the CTAs that cut
# a row do it while the SM is full and all end on whole rows
K4_WHOLE_FIRST = """    auto is_cut = [&](int it) { return it >= whole; };
    auto item_slot = [&](int it) {
        return it < whole ? static_cast<int>(blockIdx.x) + it * static_cast<int>(gridDim.x)
                          : whole * static_cast<int>(gridDim.x) + first + (it - whole) * stride;
    };
"""
K4_CUT_FIRST = """    const int n_cut = max(0, (n_slots - whole * static_cast<int>(gridDim.x) - first + stride - 1) / stride);
    auto is_cut = [&](int it) { return it < n_cut; };
    auto item_slot = [&](int it) {
        return it < n_cut ? whole * static_cast<int>(gridDim.x) + first + it * stride
               : it < n_cut + whole ? static_cast<int>(blockIdx.x) + (it - n_cut) * static_cast<int>(gridDim.x)
                                    : n_slots;
    };
"""

# name -> (source: the current one's name, or "parent:" and the parent's,
# its changes, the build's macros)
PATCHES = {
    "K4 before, instrumented": ("parent:voice_fir.cu", OLD_STAMPS["voice_fir.cu"], {}),
    "K12 before, instrumented": ("parent:p25_timing.cu", OLD_STAMPS["p25_timing.cu"], {}),
    "K4 current, tanhf": ("voice_fir.cu", [(K4_FAST_TANH, K4_TANHF)], {}),
    "K4 current, stores from registers": ("voice_fir.cu", [(K4_BULK, K4_DIRECT)], {}),
    "K4 current, the rows left cut first": ("voice_fir.cu", [(K4_WHOLE_FIRST, K4_CUT_FIRST)], {}),
    "K4 current, the rows left cut first, instrumented": ("voice_fir.cu", [(K4_WHOLE_FIRST, K4_CUT_FIRST)],
                                                           {"K4_CLOCKS": 1}),
    "K4 current, tensor cores (3xTF32)": ("voice_fir.cu", K4_TC, {}),
    "K4 current, tensor cores (3xTF32), instrumented": ("voice_fir.cu", K4_TC, {"K4_CLOCKS": 1}),
    "K12 current, the O&M weights by sincosf": ("p25_timing.cu", [(K12_TABLE, K12_SINCOS)], {}),
    "K12 current, the O&M weights by cosf and sinf": ("p25_timing.cu", [(K12_TABLE, K12_COS_SIN)], {}),
    "K12 current, dc summed whole by every CTA (no dc exchange)":
        ("p25_timing.cu", [(K12_VALS, K12_DC_EVERY_CTA), (K12_DC, "    // --- dc (C4FM): summed above\n")], {}),
    "K12 current, up to 1,024 threads a CTA": ("p25_timing.cu", [(K12_512, K12_1024)], {}),
    "K12 current, up to 1,024 threads a CTA, instrumented": ("p25_timing.cu", [(K12_512, K12_1024)],
                                                              {"K12_CLOCKS": 1}),
    "K12 current, dc summed whole by every CTA (no dc exchange), instrumented":
        ("p25_timing.cu", [(K12_VALS, K12_DC_EVERY_CTA), (K12_DC, "    // --- dc (C4FM): summed above\n")],
         {"K12_CLOCKS": 1}),
}

K4_FUNCTIONS = ("voice_fir_kernel",)
K12_FUNCTIONS = ("timing_kernel",)
# the current entries' plan arguments (before the stream) that the earlier
# designs' entries do not take
DROP = {"K4_voice_fir": 6, "K12_c4fm_timing": 4, "K13_cqpsk_timing": 4}
SKIP = {"K4_voice_fir": (), "K12_c4fm_timing": (2,), "K13_cqpsk_timing": (2,)}  # the O&M table
K12_SPANS_OLD = {"stage row": (0, 1), "dc": (1, 2), "O&M line": (2, 3), "g0 and g1": (3, 4), "g2": (4, 5),
                 "gather": (5, 6), "gain or detect": (6, 7), "cta": (0, 7)}
K4_SPANS_OLD = {"stage row": (0, 1), "FIR and energy": (1, 2), "scale and store": (2, 3), "cta": (0, 3)}
K12_SPANS = {"state and window bounds": (0, 1), "stage window": (1, 2), "dc": (2, 3), "O&M line": (3, 4),
             "g0 and g1": (4, 5), "g2": (5, 6), "gather and gain or bias": (6, 7), "rescale": (7, 8),
             "cta": (0, 8)}
# the current K4's stamps are each stage's cycles summed over the CTA's rows
K4_SPANS = {"wait for staged rows": (None, 1), "FIR and energy": (None, 2), "cluster sum": (None, 3),
            "scale and store": (None, 4), "cta": (None, 0), "rows": (None, 5)}

def patched(csrc: Path, parent_csrc: Path, vdir: Path, name: str) -> tuple:
    """One variant's source with its changes, written beside the builds:
    ``(path, the directory of its headers)``."""
    stem, changes, _ = PATCHES[name]
    base = parent_csrc if stem.startswith("parent:") else csrc
    stem = stem.removeprefix("parent:")
    text = (base / stem).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old.strip()[:60]!r} does not occur once in {base / stem}")
        text = text.replace(old, new)
    out = vdir / (re.sub(r"\W+", "_", name) + ".cu")
    out.write_text(text)
    return out, base


def build(vdir: Path, build_mod, parent: Path) -> dict:
    """Every variant's library, compiled in parallel: name -> (CDLL, ptxas lines)."""
    vdir.mkdir(parents=True, exist_ok=True)
    csrc = build_mod.CSRC
    parent_csrc = parent / "wavecap_tpu_torch" / "kernels" / "csrc"
    jobs = {
        "K4 before": (parent_csrc / "voice_fir.cu", parent_csrc, {}),
        "K12 before": (parent_csrc / "p25_timing.cu", parent_csrc, {}),
        "K4 current, instrumented": (csrc / "voice_fir.cu", csrc, {"K4_CLOCKS": 1}),
        "K12 current, instrumented": (csrc / "p25_timing.cu", csrc, {"K12_CLOCKS": 1}),
    }
    jobs.update({name: (*patched(csrc, parent_csrc, vdir, name), PATCHES[name][2]) for name in PATCHES})
    nvcc = build_mod._find_nvcc()
    procs = {}
    for i, (name, (src, include, macros)) in enumerate(jobs.items()):
        lib = vdir / f"libvariant{i}.so"
        cmd = build_mod.nvcc_command(src, lib, nvcc)
        cmd[1:1] = [f"-I{include}"] + [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build\n{text}")
        libs[name] = (ctypes.CDLL(str(lib)), [ln.strip() for ln in text.splitlines() if "registers" in ln])
    return libs


def swap(build_mod, kernel: str, lib, symbol: str, drop: int = 0, skip: tuple = ()):
    """Point the launcher's ``kernel`` at ``symbol`` of ``lib``; ``drop``:
    the wrapper's last int arguments before the stream that the symbol
    does not take (the earlier designs' entries take no plan); ``skip``:
    positions of other arguments it does not take (K12's table)."""
    fn = getattr(lib, symbol)
    types = build_mod.KERNELS[kernel][2]
    keep = [i for i in range(len(types) - 1 - drop) if i not in skip]
    fn.argtypes = tuple(types[i] for i in keep) + (types[-1],)
    fn.restype = ctypes.c_int
    lib.wavecap_error_string.argtypes = (ctypes.c_int,)
    lib.wavecap_error_string.restype = ctypes.c_char_p
    call = fn if not (drop or skip) else (lambda *a: fn(*(a[i] for i in keep), a[-1]))
    build_mod._FUNCTIONS[kernel] = (call, lib)


def median_cycles(stamps: np.ndarray, spans: dict) -> dict:
    """Median SM cycles over the CTAs of each named span ``(start, end)``
    (``(None, k)``: slot k holds the span itself)."""
    return {name: float(np.median(stamps[:, b] - (stamps[:, a] if a is not None else 0))) if len(stamps) else None
            for name, (a, b) in spans.items()}


def stamped(lib, symbol: str, run, width: int) -> np.ndarray:
    """The stamps of the CTAs that one call of ``run`` wrote anew."""
    import torch

    read = getattr(lib, symbol)
    read.argtypes = (ctypes.c_void_p,)
    before = np.zeros((4096, width), np.int64)
    after = np.zeros((4096, width), np.int64)
    torch.cuda.synchronize()
    assert read(before.ctypes.data) == 0
    run()
    torch.cuda.synchronize()
    assert read(after.ctypes.data) == 0
    return after[(after[:, 0] != before[:, 0]) & (after[:, 0] != 0)]


def k4_record(cs, got, ref, fm_args) -> dict:
    """K4 against its plain version at ``chip_smoke.py``'s thresholds."""
    assign = fm_args[3]
    rssi, sq, act = (cs.host(v) for v in (fm_args[2], assign.squelch_db, assign.active))
    open_ = act & (rssi >= sq)
    worst = min(cs.snr_db(ref[0][i], got[0][i]) for i in np.flatnonzero(open_))
    silent = not got[0][~open_].any()
    exact = bool(np.array_equal(got[1], ref[1]) and np.array_equal(got[2], ref[2]))
    return dict(worst_open_snr_db=worst, shut_silent=silent, rssi_tail_exact=exact,
                ok=bool(worst >= 70.0 and silent and exact))


def k12_record(cs, got, ref) -> dict:
    """K12 / K13 against its plain version at ``chip_smoke.py``'s thresholds."""
    dibits = bool(np.array_equal(got[1], ref[1]))
    snr = cs.snr_db(ref[0], got[0])
    d_state = float(np.max(np.abs(got[2] - ref[2])))
    return dict(dibits_equal=dibits, soft_snr_db=snr, state_max_abs=d_state,
                ok=bool(dibits and snr >= 60.0 and d_state <= 1e-3))


def main() -> int:
    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build as build_mod
    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.models.p25 import c4fm

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit before the redesign (its kernel sources are built)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k4_k12_variants: no CUDA device", file=sys.stderr)
        return 2
    build_mod.build_all()
    libs = build(build_mod.BUILD_DIR / "k4_k12_variants", build_mod, args.parent.resolve())
    card = cs.card_line()
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        line = json.dumps(dict(card=card, **obj), default=float)
        print(line, flush=True)
        lines.append(line)

    def run_variants(kernel, case, variants, kern, plain_out, judge, functions, width, spans_old, spans_new,
                     clocks_symbol):
        current = build_mod._function(kernel)
        for name, entry, forced in variants:
            build_mod._FUNCTIONS[kernel] = current
            undo = forced() if forced is not None else None
            if entry is not None:
                symbol = {"K4_voice_fir": "k4_voice_fir", "K12_c4fm_timing": "k12_c4fm_timing",
                          "K13_cqpsk_timing": "k13_cqpsk_timing"}[kernel]
                before = "before" in name
                swap(build_mod, kernel, entry[0], symbol, drop=DROP[kernel] if before else 0,
                     skip=SKIP[kernel] if before else ())
            rec = dict(kernel=kernel, case=case, variant=name, ptxas=entry[1] if entry else None)
            try:
                try:
                    got = [cs.host(v) for v in kern()]
                except (NotImplementedError, RuntimeError) as e:
                    if "before" not in name:  # only the earlier designs' launchers refuse rows
                        raise
                    emit(dict(rec, refused=str(e)))
                    continue
                rec.update(judge(got, plain_out))
                rec["ms"] = cs.device_ms(kern, functions)
                if name.endswith("instrumented"):
                    before = "before" in name
                    st = stamped(entry[0], "old_clocks" if before else clocks_symbol, kern, width[0 if before else 1])
                    rec["median_cycles"] = median_cycles(st, spans_old if before else spans_new)
                    rec["ctas_stamped"] = len(st)
                    if kernel == "K4_voice_fir" and not before and len(st):  # the global timer's [6] start, [7] end
                        rec["ctas_ns"] = dict(start_spread=int(st[:, 6].max() - st[:, 6].min()),
                                              first_to_last=int(st[:, 7].max() - st[:, 6].min()),
                                              median=float(np.median(st[:, 7] - st[:, 6])),
                                              max=int((st[:, 7] - st[:, 6]).max()))
                        # the CTAs by their count of rows: each stage's median, and their ns
                        rec["by_rows"] = {int(n): dict(ctas=int((st[:, 5] == n).sum()),
                                                       ns=float(np.median(st[st[:, 5] == n, 7] - st[st[:, 5] == n, 6])),
                                                       **median_cycles(st[st[:, 5] == n], spans_new))
                                          for n in np.unique(st[:, 5])}
                emit(rec)
            finally:
                if undo is not None:
                    undo()
        build_mod._FUNCTIONS[kernel] = current

    def setting(module, attr, value):
        """Set ``module.attr`` to ``value``; return the undo."""
        own = getattr(module, attr)
        setattr(module, attr, value)
        return lambda: setattr(module, attr, own)

    def forcing(module, attr, forced):
        """Replace ``module.attr`` (a plan) by one with ``forced``; return the undo."""
        own = getattr(module, attr)

        def undo():
            setattr(module, attr, own)

        setattr(module, attr, lambda *a, **k: own(*a, **k, forced=forced))
        return undo

    def designs(kernel: str) -> list:
        out = [(f"{kernel} current", None, None), (f"{kernel} before", libs[f"{kernel} before"], None),
               (f"{kernel} before, instrumented", libs[f"{kernel} before, instrumented"], None),
               (f"{kernel} current, instrumented", libs[f"{kernel} current, instrumented"], None)]
        return out + [(k, v, None) for k, v in libs.items()
                      if k.startswith(f"{kernel} current,") and k != f"{kernel} current, instrumented"
                      and "1,024" not in k]

    # --- K4 ---
    for what, slots, s in cs.K4_PATH_SHAPES:
        fm_args = cs.k4_path_case(dev, slots, s)
        ref = [cs.host(v) for v in cb.voice_fir_plain(*fm_args)]
        own = cb.k4_plan(slots, s)
        variants = designs("K4")
        forced = []
        if own.whole:  # every row whole on the CTAs the card holds (the first plan), then not persistent
            forced += [(1, own.threads, cb._k4_resident(own.threads)), (1, own.threads, slots)]
        forced += [(cl, th) for cl, th in ((1, 160), (2, 160), (2, 256), (4, 96), (8, 64))
                   if (cb.k4_plan(slots, s, forced=(cl, th)).cluster, th) != (own.cluster, own.threads)]
        for f in forced if s >= 4_920 else ():
            what_f = f"{f[0]} CTAs a row x {f[1]} threads" + (f", {f[2]} CTAs" if len(f) > 2 else "")
            variants.append((f"K4 current, forced {what_f}", None, lambda f=f: forcing(cb, "k4_plan", f)))
        if own.whole:  # the first plan instrumented
            f = (1, own.threads, cb._k4_resident(own.threads))
            variants.append((f"K4 current, forced 1 CTAs a row x {f[1]} threads, {f[2]} CTAs, instrumented",
                             libs["K4 current, instrumented"], lambda f=f: forcing(cb, "k4_plan", f)))
        for cl in (3, 4, 8) if own.whole else ():  # the rows left after the whole rows cut over cl CTAs
            variants.append((f"K4 current, the rows left cut over {cl} CTAs", None,
                             lambda cl=cl: setting(cb, "_K4_CUT_CLUSTER", cl)))
        run_variants("K4_voice_fir", what, variants, lambda: cb.voice_fir(*fm_args), ref,
                     lambda got, ref: dict(k4_record(cs, got, ref, fm_args), plan=cb.k4_plan(slots, s)._asdict()),
                     K4_FUNCTIONS, (8, 8), K4_SPANS_OLD, K4_SPANS, "k4_clocks")
        del fm_args

    # --- K12 and K13's timing ---
    for what, kind, rows, n in cs.K12_PATH_SHAPES:
        kfn, pfn, buf, st, n_sym, cfg = cs.k12_path_case(dev, kind, rows, n)
        ref = [cs.host(v) for v in pfn(buf, st, n_sym, cfg)]
        name = cs.K12_NAMES[kind]
        tc_ = c4fm.timing_consts(cfg.sps, cfg.max_clock_ppm, 0.0)
        variants = designs("K12")
        if n < 50_000:
            for cl, th in ((8, 256), (4, 128), (8, 128), (2, 512), (1, 512)):
                variants.append((f"K12 current, forced {cl} CTAs a row x {th} threads", None,
                                 lambda f=(cl, th): forcing(c4fm, "k12_plan", f)))
            wide = "K12 current, up to 1,024 threads a CTA"
            for cl, lib in ((1, wide), (2, wide), (1, f"{wide}, instrumented")):  # the patched kernel, a forced plan
                variants.append((f"{lib}, forced {cl} CTAs a row x 1024 threads".replace(", instrumented", "")
                                 + (", instrumented" if lib.endswith("instrumented") else ""), libs[lib],
                                 lambda f=(cl, 1024): forcing(c4fm, "k12_plan", f)))

        def judge(got, ref, buf=buf, n_sym=n_sym, tc_=tc_):
            plan = c4fm.k12_plan(buf.shape[0], n_sym, tc_, buf.element_size())
            return dict(k12_record(cs, got, ref), plan=plan._asdict())

        run_variants(name, what, variants, lambda: kfn(buf, st, n_sym, cfg), ref, judge, K12_FUNCTIONS,
                     (8, 10), K12_SPANS_OLD, K12_SPANS, "k12_clocks")
        del buf
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
