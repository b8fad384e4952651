#!/usr/bin/env python3
"""Where K10's time goes: the baseline design of the SAM PLL kernel (the
one before ``kernels/csrc/pll.cu``'s) changed one thing at a time, the
steps from it to the current design, latency probes, and the SASS of the
baseline kernel and the current one, all timed in one process on the card.

Run from the repository root on a machine with one NVIDIA card::

    python3 scripts/k10_variants.py [--out DIR]

* the baseline kernel (one thread a row, 32 x 32 shared-memory tiles loaded and
  stored between ``__syncwarp``s, the library's ``cosf``, ``sinf``,
  ``atan2f`` and ``fmodf``; ``TEMPLATE``) with switches: ``SINCOS=1`` the
  library's ``sincosf``, ``SINCOS=2`` ``k10_sincos`` of ``pll_math.cuh``;
  ``ATAN=1`` ``k10_atan_pos``; ``WRAP=1`` ``k10_costas_wrap``;
  ``NOLOADS=1`` a register value in place of each loaded sample.
* design 1 (``CURRENT``: one warp a block, which moves a row of the next
  and the previous tile each step), with the switches of its template;
  clock64 around row 0's run and nvidia-smi's SM clock during it.
* ``PACKED``: the warp-specialized design with 1, 2 or 5 stepping warps a
  block beside the moving warp, and each block's SM id.
* latency probes: dependent chains of one operation in one warp.
* ``kernels/csrc/pll.cu`` itself, through ``ops/pll.py``.

Every kernel is timed with CUDA events over 20 launches at (160, 4,920)
and (100, 4,920) rows x samples.  ``cuobjdump -sass`` of the baseline and
of the current kernel go to ``DIR`` (default ``kernels/build/k10_sass``).
One JSON line a variant or probe: ms, ns and SM cycles a step at the
card's maximum clock, ptxas' report and the card's name and power limit.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TEMPLATE = r"""
#include "common.cuh"
#include "pll_math.cuh"
#ifndef SINCOS
#define SINCOS 0
#endif
#ifndef ATAN
#define ATAN 0
#endif
#ifndef WRAP
#define WRAP 0
#endif
#ifndef NOLOADS
#define NOLOADS 0
#endif
namespace {
constexpr int kRows = 32;
constexpr int kSamples = 32;
__device__ __forceinline__ float sign_of(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }
template <int DETECTOR>
__global__ void pll_variant_kernel(const float2* __restrict__ iq, float2* __restrict__ out,
                                   const float* __restrict__ phase0, const float* __restrict__ freq0,
                                   float* __restrict__ phase1, float* __restrict__ freq1, int rows, int n,
                                   float a, float b, K10Coeffs k) {
    __shared__ float2 tile[kRows][kSamples + 1];
    const float pi = 3.14159265358979323846f;
    const float two_pi = 6.28318530717958647692f;
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * kRows;
    const int row = row0 + lane;
    const bool live = row < rows;
    float phase = live ? phase0[row] : 0.f;
    float integ = live ? freq0[row] : 0.f;
    for (int t0 = 0; t0 < n; t0 += kSamples) {
        const int len = min(kSamples, n - t0);
#if !NOLOADS
        for (int r = 0; r < kRows; ++r) {
            if (row0 + r < rows && lane < len)
                tile[r][lane] = iq[static_cast<long long>(row0 + r) * n + t0 + lane];
        }
#endif
        __syncwarp();
        if (live) {
            for (int t = 0; t < len; ++t) {
#if NOLOADS
                const float2 z = make_float2(0.3f, 1e-3f * static_cast<float>(t & 7));
#else
                const float2 z = tile[lane][t];
#endif
                float c, s;
#if SINCOS == 0
                c = cosf(-phase); s = sinf(-phase);
#elif SINCOS == 1
                sincosf(-phase, &s, &c);
#else
                k10_sincos<true>(-phase, k, s, c);
#endif
                const float2 m = make_float2(__fsub_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s)),
                                             __fadd_rn(__fmul_rn(z.x, s), __fmul_rn(z.y, c)));
                float err;
                if (DETECTOR == 0) {
#if ATAN
                    err = k10_atan_pos(m.y, __fadd_rn(fabsf(m.x), 1e-10f), k);
#else
                    err = atan2f(m.y, __fadd_rn(fabsf(m.x), 1e-10f));
#endif
                } else {
                    err = __fsub_rn(__fmul_rn(sign_of(m.x), m.y), __fmul_rn(sign_of(m.y), m.x));
                    err = fminf(fmaxf(err, -1.f), 1.f);
                }
                integ = __fadd_rn(integ, __fmul_rn(b, err));
                const float corr = __fadd_rn(__fmul_rn(a, err), integ);
                if (DETECTOR == 0) {
                    phase = __fadd_rn(phase, corr);
                    if (phase > pi) phase = __fsub_rn(phase, two_pi);
                    if (phase < -pi) phase = __fadd_rn(phase, two_pi);
                } else {
#if WRAP
                    phase = k10_costas_wrap<true>(__fadd_rn(__fadd_rn(phase, corr), pi), pi, two_pi);
#else
                    float r = fmodf(__fadd_rn(__fadd_rn(phase, corr), pi), two_pi);
                    if (r != 0.f && r < 0.f) r = __fadd_rn(r, two_pi);
                    phase = __fsub_rn(r, pi);
#endif
                }
                tile[lane][t] = m;
            }
        }
        __syncwarp();
        for (int r = 0; r < kRows; ++r) {
            if (row0 + r < rows && lane < len)
                out[static_cast<long long>(row0 + r) * n + t0 + lane] = tile[r][lane];
        }
        __syncwarp();
    }
    if (live) {
        phase1[row] = phase;
        freq1[row] = integ;
    }
}
}  // namespace
WAVECAP_EXPORT int k10_variant(const void* iq, void* out, const void* phase0, const void* freq0,
                               void* phase1, void* freq1, int rows, int n, float a, float b,
                               int detector, K10Coeffs coeffs, void* stream) {
    const int blocks = (rows + kRows - 1) / kRows;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto x = static_cast<const float2*>(iq);
    auto y = static_cast<float2*>(out);
    auto p0 = static_cast<const float*>(phase0);
    auto f0 = static_cast<const float*>(freq0);
    auto p1 = static_cast<float*>(phase1);
    auto f1 = static_cast<float*>(freq1);
    if (detector == 0) pll_variant_kernel<0><<<blocks, kRows, 0, s>>>(x, y, p0, f0, p1, f1, rows, n, a, b, coeffs);
    else pll_variant_kernel<1><<<blocks, kRows, 0, s>>>(x, y, p0, f0, p1, f1, rows, n, a, b, coeffs);
    return static_cast<int>(cudaGetLastError());
}
"""


# design 1 of this redesign (one warp a block, which moves one row of the
# next and the previous tile a step beside its steps), PLL detector, with switches:
# UNROLL (the full tile's step loop), NOSINCOS (s = 0, c = 1), NOATAN (err =
# m.y), NOSIDE (the rows of the next and previous tiles moved at the tile's
# end, not one a step); clock64 around row 0's run, into `cycles`
CURRENT = r"""
#include "common.cuh"
#include "pll_math.cuh"
#ifndef UNROLL
#define UNROLL 32
#endif
#define K10_STR(x) #x
#define K10_UNROLL(n) _Pragma(K10_STR(unroll n))
namespace {
constexpr int kRows = 32, kTile = 32, kRing = 3;
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(gmem));
}
__global__ void __launch_bounds__(kRows) pll_current_kernel(const float2* __restrict__ iq, float2* __restrict__ out,
        const float* __restrict__ phase0, const float* __restrict__ freq0, float* __restrict__ phase1,
        float* __restrict__ freq1, int rows, int n, float a, float b, K10Coeffs k, long long* cycles) {
    __shared__ float2 ring[kRing][kRows][kTile + 1];
    const int lane = threadIdx.x, row0 = blockIdx.x * kRows, row = row0 + lane;
    const bool live = row < rows;
    const int tiles = (n + kTile - 1) / kTile;
    float phase = live ? phase0[row] : 0.f, integ = live ? freq0[row] : 0.f;
    const float pi = 3.14159265358979323846f, two_pi = 6.28318530717958647692f;
    auto step = [&](float2 z) {
        float s = 0.f, c = 1.f;
#ifndef NOSINCOS
        k10_sincos<true>(-phase, k, s, c);
#endif
        const float2 m = make_float2(__fsub_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s)),
                                     __fadd_rn(__fmul_rn(z.x, s), __fmul_rn(z.y, c)));
#ifdef NOATAN
        const float err = m.y;
#else
        const float err = k10_atan_pos(m.y, __fadd_rn(fabsf(m.x), 1e-10f), k);
#endif
        integ = __fadd_rn(integ, __fmul_rn(b, err));
        const float corr = __fadd_rn(__fmul_rn(a, err), integ);
        const float p = __fadd_rn(phase, corr);
        phase = p > pi ? __fsub_rn(p, two_pi) : (p < -pi ? __fadd_rn(p, two_pi) : p);
        return m;
    };
    auto load_row = [&](int tile, int r) {
        const int t0 = tile * kTile;
        if (row0 + r < rows && lane < min(kTile, n - t0))
            cp_async8(&ring[tile % kRing][r][lane], iq + static_cast<long long>(row0 + r) * n + t0 + lane);
    };
    auto store_row = [&](int tile, int r) {
        const int t0 = tile * kTile;
        if (row0 + r < rows && lane < min(kTile, n - t0))
            out[static_cast<long long>(row0 + r) * n + t0 + lane] = ring[tile % kRing][r][lane];
    };
    const long long c0 = clock64();
    for (int r = 0; r < kRows; ++r) load_row(0, r);
    asm volatile("cp.async.commit_group;\n" ::);
    for (int tile = 0; tile < tiles; ++tile) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncwarp();
        float2* mine = ring[tile % kRing][lane];
        const bool prev = tile > 0, next = tile + 1 < tiles;
        if (n - tile * kTile >= kTile) {
        K10_UNROLL(UNROLL)
            for (int t = 0; t < kTile; ++t) {
                mine[t] = step(mine[t]);
#ifndef NOSIDE
                if (prev) store_row(tile - 1, t);
                if (next) load_row(tile + 1, t);
#endif
            }
#ifdef NOSIDE
            for (int r = 0; r < kRows; ++r) {
                if (prev) store_row(tile - 1, r);
                if (next) load_row(tile + 1, r);
            }
#endif
        } else {
            for (int r = 0; r < kRows; ++r) if (prev) store_row(tile - 1, r);
            for (int t = 0; t < n - tile * kTile; ++t) mine[t] = step(mine[t]);
        }
        asm volatile("cp.async.commit_group;\n" ::);
    }
    __syncwarp();
    for (int r = 0; r < kRows; ++r) store_row(tiles - 1, r);
    if (cycles && row == 0) cycles[0] = clock64() - c0;
    if (live) { phase1[row] = phase; freq1[row] = integ; }
}
// dependent chains of one operation, clock64 around them
template <int OP>
__global__ void probe_kernel(float* out, long long* cycles, int n, K10Coeffs k) {
    __shared__ int chase[64];
    for (int i = threadIdx.x; i < 64; i += 32) chase[i] = (i * 5 + 1) & 63;
    __syncwarp();
    float x = 0.5f + 1e-3f * threadIdx.x;
    int xi = threadIdx.x;
    const long long t0 = clock64();
#pragma unroll 8
    for (int i = 0; i < n; ++i) {
        if (OP == 0) x = fmaf(x, 0.99990f, 1e-4f);
        if (OP == 1) asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(x) : "f"(x));
        if (OP == 2) x = __fadd_rn(rintf(x), 0.25f);
        if (OP == 3) x = __int2float_rn(static_cast<int>(x)) + 0.5f;
        if (OP == 4) xi = chase[xi];
        if (OP == 5) { float s, c; k10_sincos<true>(x, k, s, c); x = __fadd_rn(s, 0.5f); }
        if (OP == 6) x = __fadd_rn(k10_atan_pos(x, 0.7f, k), 0.5f);
        if (OP == 7) x = x > 0.6f ? __fadd_rn(x, -0.2f) : __fadd_rn(x, 0.1f);
    }
    const long long t1 = clock64();
    out[threadIdx.x] = x + xi;
    if (threadIdx.x == 0) cycles[0] = t1 - t0;
}
}  // namespace
WAVECAP_EXPORT int k10_current(const void* iq, void* out, const void* phase0, const void* freq0, void* phase1,
                               void* freq1, int rows, int n, float a, float b, int detector, K10Coeffs coeffs,
                               void* cycles, void* stream) {
    pll_current_kernel<<<(rows + kRows - 1) / kRows, kRows, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<float2*>(out), static_cast<const float*>(phase0),
        static_cast<const float*>(freq0), static_cast<float*>(phase1), static_cast<float*>(freq1), rows, n, a, b,
        coeffs, static_cast<long long*>(cycles));
    return static_cast<int>(cudaGetLastError());
}
WAVECAP_EXPORT int k10_probe(int op, void* out, void* cycles, int n, K10Coeffs k, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* o = static_cast<float*>(out);
    long long* c = static_cast<long long*>(cycles);
    switch (op) {
        case 0: probe_kernel<0><<<1, 32, 0, s>>>(o, c, n, k); break;
        case 1: probe_kernel<1><<<1, 32, 0, s>>>(o, c, n, k); break;
        case 2: probe_kernel<2><<<1, 32, 0, s>>>(o, c, n, k); break;
        case 3: probe_kernel<3><<<1, 32, 0, s>>>(o, c, n, k); break;
        case 4: probe_kernel<4><<<1, 32, 0, s>>>(o, c, n, k); break;
        case 5: probe_kernel<5><<<1, 32, 0, s>>>(o, c, n, k); break;
        case 6: probe_kernel<6><<<1, 32, 0, s>>>(o, c, n, k); break;
        default: probe_kernel<7><<<1, 32, 0, s>>>(o, c, n, k); break;
    }
    return static_cast<int>(cudaGetLastError());
}
"""
PROBES = ("FFMA", "MUFU.RCP", "FRND + FADD", "F2I + I2F + FADD", "LDS (pointer chase)", "k10_sincos + FADD",
          "k10_atan_pos + FADD", "compare + select + FADD")
CURRENT_VARIANTS = {
    "design 1, unrolled 32": {},
    "design 1, unroll 1": {"UNROLL": 1},
    "design 1, unroll 4": {"UNROLL": 4},
    "design 1, s = 0, c = 1": {"NOSINCOS": 1},
    "design 1, err = Im": {"NOATAN": 1},
    "design 1, neither": {"NOSINCOS": 1, "NOATAN": 1},
    "design 1, side work at the tile's end": {"NOSIDE": 1},
    "design 1, side work at the tile's end, unroll 1": {"NOSIDE": 1, "UNROLL": 1},
}


# the warp-specialized design of kernels/csrc/pll.cu (PLL detector) with
# CW warps stepping CW x 32 rows and one warp moving their data, a block;
# each block's SM id into `smids`
PACKED = r"""
#include "common.cuh"
#include "pll_math.cuh"
namespace {
constexpr int kTile = 32, kRing = 3, kRows = 32 * CW;
__global__ void __launch_bounds__(kRows + 32) pll_packed_kernel(const float2* __restrict__ iq,
        float2* __restrict__ out, const float* __restrict__ phase0, const float* __restrict__ freq0,
        float* __restrict__ phase1, float* __restrict__ freq1, int rows, int n, float a, float b, K10Coeffs k,
        int* smids) {
    extern __shared__ float2 ring_raw[];  // [kRing][kRows][kTile + 1]
    auto ring = reinterpret_cast<float2 (*)[kRows][kTile + 1]>(ring_raw);
    const float pi = 3.14159265358979323846f, two_pi = 6.28318530717958647692f;
    const int lane = threadIdx.x & 31;
    const bool mover = threadIdx.x >= kRows;
    const int row0 = blockIdx.x * kRows, tiles = (n + kTile - 1) / kTile;
    if (threadIdx.x == 0) { int id; asm("mov.u32 %0, %%smid;" : "=r"(id)); smids[blockIdx.x] = id; }
    auto move = [&](int tile, bool in) {
        const int t0 = tile * kTile, len = min(kTile, n - t0);
        for (int r = 0; r < kRows && row0 + r < rows; ++r) {
            if (lane >= len) continue;
            const long long g = static_cast<long long>(row0 + r) * n + t0 + lane;
            float2* slot = &ring[tile % kRing][r][lane];
            if (in) {
                const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(slot));
                asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst), "l"(iq + g));
            } else {
                out[g] = *slot;
            }
        }
        if (in) asm volatile("cp.async.commit_group;\n" ::);
    };
    const int row = row0 + threadIdx.x;
    const bool live = !mover && row < rows;
    float phase = live ? phase0[row] : 0.f, integ = live ? freq0[row] : 0.f;
    auto step = [&](float2 z) {
        float s, c;
        k10_sincos<true>(-phase, k, s, c);
        const float2 m = make_float2(__fsub_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s)),
                                     __fadd_rn(__fmul_rn(z.x, s), __fmul_rn(z.y, c)));
        const float err = k10_atan_pos(m.y, __fadd_rn(fabsf(m.x), 1e-10f), k);
        integ = __fadd_rn(integ, __fmul_rn(b, err));
        const float corr = __fadd_rn(__fmul_rn(a, err), integ);
        const float p = __fadd_rn(phase, corr);
        phase = p > pi ? __fsub_rn(p, two_pi) : (p < -pi ? __fadd_rn(p, two_pi) : p);
        return m;
    };
    if (mover) { move(0, true); asm volatile("cp.async.wait_all;\n" ::: "memory"); }
    __syncthreads();
    for (int tile = 0; tile < tiles; ++tile) {
        if (mover) {
            if (tile > 0) move(tile - 1, false);
            if (tile + 1 < tiles) move(tile + 1, true);
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        } else {
            float2* mine = ring[tile % kRing][threadIdx.x];
            const int len = n - tile * kTile;
            if (len >= kTile) {
#pragma unroll
                for (int t = 0; t < kTile; ++t) mine[t] = step(mine[t]);
            } else {
                for (int t = 0; t < len; ++t) mine[t] = step(mine[t]);
            }
        }
        __syncthreads();
    }
    if (mover) move(tiles - 1, false);
    if (live) { phase1[row] = phase; freq1[row] = integ; }
}
}  // namespace
WAVECAP_EXPORT int k10_packed(const void* iq, void* out, const void* phase0, const void* freq0, void* phase1,
                              void* freq1, int rows, int n, float a, float b, int detector, K10Coeffs coeffs,
                              void* smids, void* stream) {
    const int smem = kRing * kRows * (kTile + 1) * 8;
    cudaFuncSetAttribute(pll_packed_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    pll_packed_kernel<<<(rows + kRows - 1) / kRows, kRows + 32, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(iq), static_cast<float2*>(out), static_cast<const float*>(phase0),
        static_cast<const float*>(freq0), static_cast<float*>(phase1), static_cast<float*>(freq1), rows, n, a, b,
        coeffs, static_cast<int*>(smids));
    return static_cast<int>(cudaGetLastError());
}
"""
PACKED_VARIANTS = {f"pll.cu's design, {cw} stepping warp(s) a block": {"CW": cw} for cw in (1, 2, 5)}

# name -> (macros, detectors timed)
VARIANTS = {
    "baseline": ({}, (0, 1)),
    "baseline + sincosf": ({"SINCOS": 1}, (0,)),
    "baseline + no loads": ({"NOLOADS": 1}, (0,)),
    "baseline + k10_atan_pos": ({"ATAN": 1}, (0,)),
    "baseline + k10_sincos": ({"SINCOS": 2}, (0, 1)),
    "baseline + k10_sincos + k10_atan_pos": ({"SINCOS": 2, "ATAN": 1}, (0,)),
    "baseline + k10_costas_wrap": ({"WRAP": 1}, (1,)),
    "baseline + k10_sincos + k10_costas_wrap": ({"SINCOS": 2, "WRAP": 1}, (1,)),
}


def sass_counts(sass: str, kernel: str) -> dict:
    """Counts in each instantiation of ``kernel`` in ``sass``, by opcode class."""
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)", block)
        heads = [o.split(".")[0] for o in ops]
        out[name[-40:]] = dict(
            instructions=len(ops), CALL=heads.count("CALL"), LDL=heads.count("LDL"),
            STL=heads.count("STL"), BRA=heads.count("BRA"), MUFU=heads.count("MUFU"),
            FFMA=heads.count("FFMA"), FMUL=heads.count("FMUL"), FADD=heads.count("FADD"),
        )
    return out


def main(argv=None) -> int:
    import argparse
    import ctypes

    import torch

    from wavecap_tpu_torch.kernels import build
    from wavecap_tpu_torch.ops import pll

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="where the SASS dumps go (default: kernels/build/k10_sass)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k10_variants: no CUDA device", file=sys.stderr)
        return 2
    out_dir = Path(args.out) if args.out else build.BUILD_DIR / "k10_sass"
    out_dir.mkdir(parents=True, exist_ok=True)
    build.build_all()
    vdir = build.BUILD_DIR / "k10_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    src = vdir / "variant.cu"
    src.write_text(TEMPLATE)
    cur = vdir / "current.cu"
    cur.write_text(CURRENT)
    nvcc = build._find_nvcc()
    procs = {}
    jobs = [(name, src, macros) for name, (macros, _) in VARIANTS.items()]
    jobs += [(name, cur, macros) for name, macros in CURRENT_VARIANTS.items()]
    packed = vdir / "packed.cu"
    packed.write_text(PACKED)
    jobs += [(name, packed, macros) for name, macros in PACKED_VARIANTS.items()]
    for i, (name, source, macros) in enumerate(jobs):
        lib = vdir / f"libvariant{i}.so"
        cmd = build.nvcc_command(source, lib, nvcc)
        cmd[1:1] = [f"-I{build.CSRC}"] + [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"k10_variants: {name} failed to build\n{text}", file=sys.stderr)
            return 1
        libs[name] = (lib, [ln.strip() for ln in text.splitlines() if "registers" in ln or "stack" in ln])
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    dumps = {"baseline": libs["baseline"][0], "current": build._library_path("pll")}
    counts = {}
    for tag, lib in dumps.items():
        sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
        (out_dir / f"{tag}.sass").write_text(sass)
        counts[tag] = sass_counts(sass, "pll_variant_kernel" if tag == "baseline" else "pll_kernel")

    clock = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                                 capture_output=True, text=True).stdout.split()[0]) * 1e6
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    n = 4920
    alpha, beta = pll.pll_coeffs(50.0, 25_000.0)
    coeffs = pll.k10_coeffs()

    def events(fn, reps=20):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    print(json.dumps(dict(card=card, max_sm_clock_hz=clock, sass_counts=counts)))
    # latency probes: one warp, dependent chains of 100,000 operations,
    # clock64 around them and CUDA events around the launch (the SM clock)
    probe = ctypes.CDLL(str(libs["design 1, unrolled 32"][0])).k10_probe
    probe.argtypes = (ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, build.K10Coeffs, ctypes.c_void_p)
    probe.restype = ctypes.c_int
    pout = torch.zeros(32, device=dev)
    pcyc = torch.zeros(1, dtype=torch.int64, device=dev)
    for op, what in enumerate(PROBES):
        n_ops = 100_000
        ms = events(lambda: probe(op, pout.data_ptr(), pcyc.data_ptr(), n_ops, coeffs,
                                  torch.cuda.current_stream().cuda_stream), reps=5)
        cyc = int(pcyc.item())
        print(json.dumps(dict(probe=what, cycles_per_op=cyc / n_ops, ns_per_op=ms * 1e6 / n_ops,
                              sm_clock_hz_measured=cyc / (ms * 1e-3), card=card)))
    for rows in (160, 100):
        z = torch.from_numpy((0.3 * np.exp(1j * rng.uniform(-np.pi, np.pi, (rows, n))))
                             .astype(np.complex64)).to(dev)
        st = pll.PllState(torch.from_numpy(rng.uniform(-3, 3, rows).astype(np.float32)).to(dev),
                          torch.zeros(rows, device=dev))
        out = torch.empty_like(z)
        p1 = torch.empty(rows, device=dev)
        f1 = torch.empty(rows, device=dev)
        results = []
        for name in VARIANTS:
            lib, ptxas = libs[name]
            fn = ctypes.CDLL(str(lib)).k10_variant
            fn.argtypes = build.KERNELS["K10_pll"][2]
            fn.restype = ctypes.c_int
            for det in VARIANTS[name][1]:
                def call(fn=fn, det=det):
                    status = fn(z.data_ptr(), out.data_ptr(), st.phase.data_ptr(), st.freq.data_ptr(),
                                p1.data_ptr(), f1.data_ptr(), rows, n, float(np.float32(alpha)),
                                float(np.float32(beta)), det, coeffs,
                                torch.cuda.current_stream().cuda_stream)
                    assert status == 0, status
                results.append((name, det, events(call), ptxas))
        cyc = torch.zeros(1, dtype=torch.int64, device=dev)
        for name, macros in CURRENT_VARIANTS.items():
            lib, ptxas = libs[name]
            fn = ctypes.CDLL(str(lib)).k10_current
            fn.argtypes = build.KERNELS["K10_pll"][2][:-1] + (ctypes.c_void_p, ctypes.c_void_p)
            fn.restype = ctypes.c_int

            def call(fn=fn):
                status = fn(z.data_ptr(), out.data_ptr(), st.phase.data_ptr(), st.freq.data_ptr(), p1.data_ptr(),
                            f1.data_ptr(), rows, n, float(np.float32(alpha)), float(np.float32(beta)), 0, coeffs,
                            cyc.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert status == 0, status
            ms = events(call)
            # the SM clock under this kernel, sampled by nvidia-smi over ~1 s of launches
            clocks = []
            for _ in range(4):
                for _ in range(200):
                    call()
                clocks.append(subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                                             capture_output=True, text=True).stdout.strip())
                torch.cuda.synchronize()
            results.append((name, 0, ms, dict(ptxas=ptxas, kernel_cycles_per_step=int(cyc.item()) / n,
                                               nvidia_smi_clocks_sm_mhz=clocks)))
        smids = torch.zeros(rows, dtype=torch.int32, device=dev)
        for name, macros in PACKED_VARIANTS.items():
            lib, ptxas = libs[name]
            fn = ctypes.CDLL(str(lib)).k10_packed
            fn.argtypes = build.KERNELS["K10_pll"][2][:-1] + (ctypes.c_void_p, ctypes.c_void_p)
            fn.restype = ctypes.c_int

            def call(fn=fn):
                status = fn(z.data_ptr(), out.data_ptr(), st.phase.data_ptr(), st.freq.data_ptr(), p1.data_ptr(),
                            f1.data_ptr(), rows, n, float(np.float32(alpha)), float(np.float32(beta)), 0, coeffs,
                            smids.data_ptr(), torch.cuda.current_stream().cuda_stream)
                assert status == 0, status
            ms = events(call)
            blocks = -(-rows // (32 * macros["CW"]))
            results.append((name, 0, ms, dict(ptxas=ptxas, block_sm_ids=smids[:blocks].tolist())))
        for det, fn in ((0, lambda: pll.carrier_recovery_pll(z, 25_000.0, st)),
                        (1, lambda: pll.costas_loop_qpsk(z, st, alpha, beta))):
            results.append(("current pll.cu", det, events(fn), None))
        for name, det, ms, ptxas in results:
            extra = ptxas if isinstance(ptxas, dict) else dict(ptxas=ptxas)
            print(json.dumps(dict(variant=name, detector=("PLL", "Costas")[det], rows=rows, samples=n, ms=ms,
                                  ns_per_step=ms * 1e6 / n, cycles_per_step=ms * 1e-3 * clock / n,
                                  card=card, **extra)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
