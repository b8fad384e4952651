#!/usr/bin/env python3
"""Where K14's and K7's time goes: the port's first designs of the echo
fit (``kernels/csrc/echo_fit.cu``) and the strided FIR
(``kernels/csrc/strided_fir.cu``) beside the current ones, with the
current ones' plans forced, and every design instrumented by stage, all
timed in one process on the card.

Run from the repository root on a machine with one NVIDIA card::

    python3 scripts/k7_k14_variants.py [--out FILE]

* ``OLD_K14`` and ``OLD_K7``, the first designs, as they were before
  their redesign: K14's acf one CTA a row (the row staged in shared
  memory, 29 lags one after another, two block sums each), its residuals
  one thread a candidate walking every row, its taps one thread a tap
  summing 512 double terms with a ``sincospi`` each; K7 one thread an
  output walking every tap, 128-output tiles.  Built as they were and with
  ``OLD_CLOCKS=1`` (clock64 at each stage's end in thread 0 of each CTA).
* the current kernels through their wrappers; built with ``K14_CLOCKS=1``
  / ``K7_CLOCKS=1`` (the same stamps); and the trials that did not win,
  each the current source with one change (``PATCHES``, applied to a copy
  in the build directory): K14 with its residual grid aimed at 132 and
  528 CTAs (against 264) and its candidates pruned exactly after 4, 8 and
  12 lags (against none); K7 with 4 and 16 outputs a thread (against 8)
  and a CTA an item (against persistent CTAs); and K7 with its plan's
  groups, phase sets and splits, or its direct variant, forced (the
  wrapper's ``k7_plan`` replaced for the call).

Every variant runs behind the port's wrappers (the launcher's function is
swapped), is held against the plain version at the thresholds of
``chip_smoke.py`` (K14: the candidate and the gate equal, taps rel L2 <=
1e-5, acf <= 1e-6, alias scores <= 1e-5; K7: rel L2 <= 1e-5, phases
bit-exact) and timed as device time from CUPTI (``chip_smoke.device_ms``)
at the paths' shapes: K14's fit at program B's (21, 7,500) and on one
60,000-sample row, its alias scores at (63, 7,500); K7's wide slots (2 x
48,000 outputs, 1,031 taps, stride 41, the NCO) whole and at a mesh
shard's 6,000 outputs, those of a 20 Msps capture (2 x 48,193 outputs,
2,085 taps, stride 83), the equaliser (21 rows, 41 complex taps), program
A's and program F's per-shard P25 filters (50 rows: the 63-tap low-pass
on complex rows, the 83-tap RRC on real rows) and the up == 1 resampler
(101 taps, stride 5).  A stage's time is the median over the CTAs of SM
cycles between its stamps.  One JSON line a case and variant, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# K14's first design, stamped: acf [0] start, [1] row staged, [2] lags summed,
# [3] finished; residuals [0], [1] staged, [2] rows done; epilogue [0],
# [1] gated, [2] W evaluated, [3] taps summed
OLD_K14 = r"""
#include "common.cuh"

namespace {
#ifndef OLD_CLOCKS
#define OLD_CLOCKS 0
#endif
#if OLD_CLOCKS
__device__ long long g_old_clocks[3][1024][4];  // K14: acf / residual / epilogue; K7: [0]
#define STAMP(which, k) do { if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < 1024) \
    g_old_clocks[which][blockIdx.y * gridDim.x + blockIdx.x][k] = clock64(); } while (0)
#else
#define STAMP(which, k) do {} while (0)
#endif

constexpr int kMaxLags = 32;  // n_tau + 1 = max_delay + 13 = 29 by default
constexpr int kNfft = 512;    // EQ_NFFT
constexpr int kThreads = 256;

__device__ __forceinline__ float sq_abs(float2 d) {
    const float m = hypotf(d.x, d.y);  // jnp.abs(.) ** 2
    return __fmul_rn(m, m);
}

__global__ void __launch_bounds__(kThreads)
acf_kernel(const float2* __restrict__ x, int n, int n_tau, const float2* __restrict__ acc,
           const bool* __restrict__ enable, float2* __restrict__ acf,
           unsigned long long* __restrict__ best, float ema, int fit) {
    extern __shared__ float2 xs[];
    __shared__ float scratch[32];
    __shared__ float2 lags[kMaxLags];
    const int r = blockIdx.x;
    const float2* row = x + static_cast<long long>(r) * n;
    STAMP(0, 0);
    for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = row[i];
    __syncthreads();
    STAMP(0, 1);
    for (int t = 0; t <= n_tau; ++t) {
        float re = 0.f, im = 0.f;
        for (int i = t + threadIdx.x; i < n; i += blockDim.x) {
            const float2 a = xs[i], b = xs[i - t];
            re += __fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
            im += __fsub_rn(__fmul_rn(a.y, b.x), __fmul_rn(a.x, b.y));
        }
        re = block_sum(re, scratch);
        im = block_sum(im, scratch);
        if (threadIdx.x == 0) {
            const float cnt = static_cast<float>(n - t);
            lags[t] = make_float2(__fdiv_rn(re, cnt), __fdiv_rn(im, cnt));
        }
    }
    STAMP(0, 2);
    if (threadIdx.x != 0) return;
    const float d = fmaxf(lags[0].x, 1e-9f);
    bool finite = true;
    for (int t = 0; t <= n_tau; ++t) {
        lags[t] = make_float2(__fdiv_rn(lags[t].x, d), __fdiv_rn(lags[t].y, d));
        finite = finite && isfinite(lags[t].x) && isfinite(lags[t].y);
    }
    const float2* a = acc ? acc + static_cast<long long>(r) * (n_tau + 1) : nullptr;
    float seen = 0.f;
    if (fit) {
        for (int t = 0; t <= n_tau; ++t) seen += hypotf(a[t].x, a[t].y);
    }
    const bool on = !fit || enable[r];
    for (int t = 0; t <= n_tau; ++t) {
        float2 v = finite ? lags[t] : make_float2(0.f, 0.f);
        if (fit && seen > 0.f) {
            v = make_float2(__fadd_rn(__fmul_rn(1.f - ema, a[t].x), __fmul_rn(ema, v.x)),
                            __fadd_rn(__fmul_rn(1.f - ema, a[t].y), __fmul_rn(ema, v.y)));
        }
        acf[static_cast<long long>(r) * (n_tau + 1) + t] = on ? v : make_float2(0.f, 0.f);
    }
    best[r] = ~0ull;
    STAMP(0, 3);
}

__global__ void __launch_bounds__(kThreads)
residual_kernel(const float2* __restrict__ acf, int rows, int lags,
                const float2* __restrict__ preds, int n_cand,
                unsigned long long* __restrict__ best) {
    extern __shared__ float2 as[];
    STAMP(1, 0);
    for (int i = threadIdx.x; i < rows * lags; i += blockDim.x) as[i] = acf[i];
    __syncthreads();
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = c < n_cand;
    float2 p[kMaxLags];
#pragma unroll
    for (int t = 0; t < kMaxLags; ++t) {
        p[t] = (valid && t < lags) ? preds[static_cast<long long>(c) * lags + t] : make_float2(0.f, 0.f);
    }
    STAMP(1, 1);
    for (int r = 0; r < rows; ++r) {
        const float2* a = as + r * lags;
        float s = 0.f;
#pragma unroll
        for (int t = 0; t < kMaxLags; ++t) {
            if (t < lags) s = __fadd_rn(s, sq_abs(make_float2(__fsub_rn(p[t].x, a[t].x),
                                                              __fsub_rn(p[t].y, a[t].y))));
        }
        unsigned long long key =
            valid ? (static_cast<unsigned long long>(__float_as_uint(s)) << 32) | static_cast<unsigned>(c)
                  : ~0ull;
        for (int o = 16; o > 0; o >>= 1) {
            const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
            key = other < key ? other : key;
        }
        if ((threadIdx.x & 31) == 0 && key != ~0ull) atomicMin(best + r, key);
    }
    STAMP(1, 2);
}

__global__ void __launch_bounds__(kNfft)
epilogue_kernel(const float2* __restrict__ acf, int lags, const float2* __restrict__ preds,
                const float* __restrict__ params, int n_cand,
                const unsigned long long* __restrict__ best, const bool* __restrict__ enable,
                float2* __restrict__ taps, bool* __restrict__ sig_out, int* __restrict__ j_out,
                float* __restrict__ score, int n_taps, float lam, float a_floor,
                float gate_ratio, int fit) {
    __shared__ float2 w[kNfft];
    __shared__ float echo[3];  // a, theta, d
    const int r = blockIdx.x;
    STAMP(2, 0);
    const unsigned long long b = best[r];
    int j = static_cast<int>(b & 0xffffffffull);
    const float rj = __uint_as_float(static_cast<unsigned>(b >> 32));
    if (j >= n_cand) j = 0;  // every residual was NaN: jnp.argmin gives 0
    if (!fit) {
        if (threadIdx.x == 0) score[r] = rj;
        return;
    }
    const bool on = enable[r];
    if (threadIdx.x == 0) {
        const float2* a = acf + static_cast<long long>(r) * lags;
        float r0 = 0.f;  // the no-echo candidate's residual
        for (int t = 0; t < lags; ++t) {
            r0 = __fadd_rn(r0, sq_abs(make_float2(__fsub_rn(preds[t].x, a[t].x),
                                                  __fsub_rn(preds[t].y, a[t].y))));
        }
        const float amp = params[3 * j + 2];
        const bool sig = (rj < __fmul_rn(gate_ratio, r0)) && (amp >= a_floor) && on;
        echo[0] = sig ? amp : 0.f;
        echo[1] = params[3 * j + 1];
        echo[2] = params[3 * j];
        sig_out[r] = sig;
        j_out[r] = j;
    }
    __syncthreads();
    STAMP(2, 1);
    const float amp = echo[0], theta = echo[1], d = echo[2];
    {
        const int k = threadIdx.x;
        // the reference's f32 grid 2 pi k / 512 (numpy float64, rounded)
        const float wk = static_cast<float>((6.283185307179586 * k) / 512.0);
        const float ph = -__fmul_rn(wk, d);
        const float er = cosf(ph), ei = sinf(ph);
        const float ar = __fmul_rn(amp, cosf(theta)), ai = __fmul_rn(amp, sinf(theta));
        const float hr = __fadd_rn(1.f, __fsub_rn(__fmul_rn(ar, er), __fmul_rn(ai, ei)));
        const float hi = __fadd_rn(__fmul_rn(ar, ei), __fmul_rn(ai, er));
        const float m = hypotf(hr, hi);
        const float den = __fadd_rn(__fmul_rn(m, m), lam);
        w[k] = make_float2(__fdiv_rn(hr, den), -__fdiv_rn(hi, den));
    }
    __syncthreads();
    STAMP(2, 2);
    const int t = threadIdx.x;
    if (t >= n_taps) return;
    const int c = n_taps / 2;
    float2 v = make_float2(t == c ? 1.f : 0.f, 0.f);
    if (on) {
        const int m = (((t - c) % kNfft) + kNfft) % kNfft;
        double sr = 0.0, si = 0.0;
        for (int k = 0; k < kNfft; ++k) {
            double sn, cs;
            sincospi(static_cast<double>((k * m) & (kNfft - 1)) / (kNfft / 2), &sn, &cs);
            sr += w[k].x * cs - w[k].y * sn;
            si += w[k].x * sn + w[k].y * cs;
        }
        v = make_float2(static_cast<float>(sr / kNfft), static_cast<float>(si / kNfft));
    }
    taps[static_cast<long long>(r) * n_taps + t] = v;
    STAMP(2, 3);
}

}  // namespace

#if OLD_CLOCKS
WAVECAP_EXPORT int old_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));
}
#endif

WAVECAP_EXPORT int k14_echo_fit(const void* x, int rows, int n, int n_tau, const void* preds,
                                const void* params, int n_cand, const void* acf_acc,
                                const void* enable, void* acf, void* best, void* score,
                                void* taps, void* sig, void* j, int n_taps, float lam,
                                float a_floor, float gate_ratio, float acf_ema, int fit,
                                void* stream) {
    if (n_tau + 1 > kMaxLags || n_taps > kNfft || (fit && (!acf_acc || !enable)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows <= 0) return 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int lags = n_tau + 1;
    const size_t smem_row = sizeof(float2) * static_cast<size_t>(n);
    cudaError_t err = cudaFuncSetAttribute(acf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem_row));
    if (err != cudaSuccess) return static_cast<int>(err);
    acf_kernel<<<rows, kThreads, smem_row, s>>>(
        static_cast<const float2*>(x), n, n_tau, static_cast<const float2*>(acf_acc),
        static_cast<const bool*>(enable), static_cast<float2*>(acf),
        static_cast<unsigned long long*>(best), acf_ema, fit);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t smem_acf = sizeof(float2) * static_cast<size_t>(rows) * lags;
    err = cudaFuncSetAttribute(residual_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_acf));
    if (err != cudaSuccess) return static_cast<int>(err);
    residual_kernel<<<(n_cand + kThreads - 1) / kThreads, kThreads, smem_acf, s>>>(
        static_cast<const float2*>(acf), rows, lags, static_cast<const float2*>(preds), n_cand,
        static_cast<unsigned long long*>(best));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    epilogue_kernel<<<rows, kNfft, 0, s>>>(
        static_cast<const float2*>(acf), lags, static_cast<const float2*>(preds),
        static_cast<const float*>(params), n_cand, static_cast<const unsigned long long*>(best),
        static_cast<const bool*>(enable), static_cast<float2*>(taps), static_cast<bool*>(sig),
        static_cast<int*>(j), static_cast<float*>(score), n_taps, lam, a_floor, gate_ratio, fit);
    return static_cast<int>(cudaGetLastError());
}
"""

# K7's first design, stamped: [0] start, [1] span staged, [2] output stored
OLD_K7 = r"""
#include "common.cuh"

namespace {
#ifndef OLD_CLOCKS
#define OLD_CLOCKS 0
#endif
#if OLD_CLOCKS
__device__ long long g_old_clocks[3][1024][4];  // K14: acf / residual / epilogue; K7: [0]
#define STAMP(which, k) do { if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < 1024) \
    g_old_clocks[which][blockIdx.y * gridDim.x + blockIdx.x][k] = clock64(); } while (0)
#else
#define STAMP(which, k) do {} while (0)
#endif

constexpr int kTile = 128;

__device__ __forceinline__ float load_x(const float* p, long long i, unsigned, unsigned, bool) {
    return p[i];
}

__device__ __forceinline__ float2 load_x(const float2* p, long long i, unsigned d, unsigned p0,
                                         bool mix) {
    const float2 v = p[i];
    if (!mix) return v;
    const float rad_per_count = static_cast<float>(6.283185307179586 / 4294967296.0);
    const unsigned acc = p0 + static_cast<unsigned>(i) * d;
    const float ph = __uint2float_rn(acc) * rad_per_count;
    const float c = cosf(ph), s = sinf(ph);
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

// the sums of one output: real taps keep one accumulator per component,
// complex taps the four real sums of the reference's complex convolution
template <typename V, typename H>
struct Acc;

template <>
struct Acc<float, float> {
    float s = 0.f;
    __device__ void mac(float h, float v) { s = fmaf(h, v, s); }
    __device__ float value() const { return s; }
};

template <>
struct Acc<float2, float> {
    float re = 0.f, im = 0.f;
    __device__ void mac(float h, float2 v) {
        re = fmaf(h, v.x, re);
        im = fmaf(h, v.y, im);
    }
    __device__ float2 value() const { return make_float2(re, im); }
};

template <>
struct Acc<float2, float2> {
    float rr = 0.f, ii = 0.f, ir = 0.f, ri = 0.f;
    __device__ void mac(float2 h, float2 v) {
        rr = fmaf(h.x, v.x, rr);
        ii = fmaf(h.y, v.y, ii);
        ir = fmaf(h.y, v.x, ir);
        ri = fmaf(h.x, v.y, ri);
    }
    __device__ float2 value() const { return make_float2(rr - ii, ir + ri); }
};

template <typename V, typename H>
__global__ void strided_fir_kernel(const V* __restrict__ x, int x_rows, const V* __restrict__ head,
                                   int head_len, const H* __restrict__ taps, int n_taps,
                                   int taps_stride, int stride, const unsigned* __restrict__ dphi,
                                   const unsigned* __restrict__ phase0, V* __restrict__ y,
                                   V* __restrict__ tail, unsigned* __restrict__ phase1, int n,
                                   int n_out, int n_tiles) {
    extern __shared__ float smem[];
    H* h = reinterpret_cast<H*>(smem);
    V* span = reinterpret_cast<V*>(smem + ((n_taps * (sizeof(H) / 4) + 3) & ~3));
    const int row = blockIdx.y;
    const V* xr = x + static_cast<long long>(x_rows == 1 ? 0 : row) * n;
    const V* hr = head ? head + static_cast<long long>(row) * head_len : nullptr;
    const bool mix = dphi != nullptr;
    const unsigned d = mix ? dphi[row] : 0u, p0 = mix ? phase0[row] : 0u;

    if (static_cast<int>(blockIdx.x) == n_tiles) {  // the tail and the next phase
        const long long total = static_cast<long long>(head_len) + n;
        // fewer samples than T - 1 (no output then): the tail holds them all
        const int t1 = static_cast<int>(min(static_cast<long long>(n_taps - 1), total));
        if (tail) {
            for (int i = threadIdx.x; i < t1; i += blockDim.x) {
                const long long j = total - t1 + i;
                tail[static_cast<long long>(row) * t1 + i] =
                    j < head_len ? hr[j] : load_x(xr, j - head_len, d, p0, mix);
            }
        }
        if (phase1 && threadIdx.x == 0) phase1[row] = p0 + static_cast<unsigned>(n) * d;
        return;
    }

    STAMP(0, 0);
    const H* hrow = taps + static_cast<long long>(row) * taps_stride;
    for (int k = threadIdx.x; k < n_taps; k += blockDim.x) h[k] = hrow[k];
    const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
    const int count = static_cast<int>(min(static_cast<long long>(kTile), n_out - m0));
    const long long j0 = m0 * stride;
    const int len = (count - 1) * stride + n_taps;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const long long j = j0 + i;
        span[i] = j < head_len ? hr[j] : load_x(xr, j - head_len, d, p0, mix);
    }
    __syncthreads();
    STAMP(0, 1);
    if (static_cast<int>(threadIdx.x) >= count) return;
    const V* w = span + threadIdx.x * stride + n_taps - 1;
    Acc<V, H> acc;
    for (int k = 0; k < n_taps; ++k) acc.mac(h[k], w[-k]);
    y[static_cast<long long>(row) * n_out + m0 + threadIdx.x] = acc.value();
    STAMP(0, 2);
}

template <typename V, typename H>
int launch_fir(const void* x, int x_rows, const void* head, int head_len, const void* taps,
               int n_taps, int taps_stride, int stride, const void* dphi, const void* phase0,
               void* y, void* tail, void* phase1, int rows, int n, int n_out,
               cudaStream_t stream) {
    const int n_tiles = (n_out + kTile - 1) / kTile;
    const size_t span = static_cast<size_t>(kTile - 1) * stride + n_taps;
    const size_t smem = sizeof(float) * ((n_taps * (sizeof(H) / 4) + 3) & ~3) + sizeof(V) * span;
    cudaError_t err = cudaFuncSetAttribute(strided_fir_kernel<V, H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int extra = (tail || phase1) ? 1 : 0;
    const dim3 grid(n_tiles + extra, rows);
    strided_fir_kernel<V, H><<<grid, kTile, smem, stream>>>(
        static_cast<const V*>(x), x_rows, static_cast<const V*>(head), head_len,
        static_cast<const H*>(taps), n_taps, taps_stride, stride,
        static_cast<const unsigned*>(dphi),
        static_cast<const unsigned*>(phase0), static_cast<V*>(y), static_cast<V*>(tail),
        static_cast<unsigned*>(phase1), n, n_out, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if OLD_CLOCKS
WAVECAP_EXPORT int old_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));
}
#endif

WAVECAP_EXPORT int k7_strided_fir(const void* x, int x_rows, const void* head, int head_len,
                                  const void* taps, int n_taps, int taps_stride, int taps_cplx,
                                  int stride, const void* dphi, const void* phase0, void* y,
                                  void* tail, void* phase1, int rows, int n, int n_out, int cplx,
                                  void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (taps_cplx) {
        if (!cplx) return static_cast<int>(cudaErrorInvalidValue);  // complex taps, complex rows
        return launch_fir<float2, float2>(x, x_rows, head, head_len, taps, n_taps, taps_stride,
                                          stride, dphi, phase0, y, tail, phase1, rows, n, n_out, s);
    }
    if (cplx) {
        return launch_fir<float2, float>(x, x_rows, head, head_len, taps, n_taps, taps_stride,
                                         stride, dphi, phase0, y, tail, phase1, rows, n, n_out, s);
    }
    if (dphi) return static_cast<int>(cudaErrorInvalidValue);  // the NCO mixes complex input
    return launch_fir<float, float>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride,
                                    nullptr, nullptr, y, tail, phase1, rows, n, n_out, s);
}
"""

# K14's exact pruning: a candidate whose first HEAD lags already exceed the
# whole residual of the tile's least such partial cannot be the least
# (the terms are >= 0 and summed in lag order; NaN never prunes).  Measured
# slower at 4, 8 and 12 lags: the barriers a row and the divergent warps
# cost more than the terms saved.
K14_PRUNED_PART = r"""
// lags [T0, T1) of a candidate's residual against an acf row a, added to s
template <int L, int T0, int T1>
__device__ __forceinline__ float residual_part(const float2 (&p)[L], const float2* a, float s) {
#pragma unroll
    for (int t = T0; t < T1; ++t) {
        s = __fadd_rn(s, sq_abs(make_float2(__fsub_rn(p[t].x, a[t].x), __fsub_rn(p[t].y, a[t].y))));
    }
    return s;
}

// a residual and its candidate as one key"""

K14_PRUNED_LOOP = r"""
    __shared__ unsigned long long lead[kResThreads / 32 + 1];  // the warps' least partials, the tile's
    __shared__ float bound;  // the whole residual of the tile's least partial
    constexpr int kHead = HEAD < L ? HEAD : L;
    for (int r = 0; r < nr; ++r) {
        const float2* a = as + r * L;
        unsigned long long key = ~0ull;
        const float s = residual_part<L, 0, kHead>(p, a, 0.f);
        unsigned long long k = warp_min(valid ? pack(s, tid) : ~0ull);
        if ((tid & 31) == 0) lead[tid >> 5] = k;
        __syncthreads();
        if (tid < 32) {
            k = warp_min(tid < kResThreads / 32 ? lead[tid] : ~0ull);
            if (tid == 0) lead[kResThreads / 32] = k;
        }
        __syncthreads();
        const unsigned long long lk = lead[kResThreads / 32];
        if (lk != ~0ull && tid == static_cast<int>(lk & 0xffffffffull)) {
            bound = residual_part<L, kHead, L>(p, a, s);
        }
        __syncthreads();
        if (valid && (lk == ~0ull || !(s > bound))) key = pack(residual_part<L, kHead, L>(p, a, s), c);
        key = warp_min(key);
        if ((tid & 31) == 0 && key != ~0ull) atomicMin(mins + r, key);
        __syncthreads();  // lead and bound are free for the next row
    }"""

K14_LOOP = """
    for (int r = 0; r < nr; ++r) {
        const unsigned long long key = warp_min(valid ? pack(residual<L>(p, as + r * L), c) : ~0ull);
        if ((tid & 31) == 0 && key != ~0ull) atomicMin(mins + r, key);
    }"""


def pruned(head: int) -> list:
    return [("\n// a residual and its candidate as one key", K14_PRUNED_PART),
            (K14_LOOP, K14_PRUNED_LOOP.replace("HEAD", str(head)))]


# the trials that lost: variant -> (source, [(text, its replacement)]); each
# text must occur once in the current source
PATCHES = {
    "K14 current, residuals aimed at 132 CTAs": (
        "echo_fit.cu", [("constexpr int kResTarget = 2 * 132;", "constexpr int kResTarget = 132;")]),
    "K14 current, residuals aimed at 528 CTAs": (
        "echo_fit.cu", [("constexpr int kResTarget = 2 * 132;", "constexpr int kResTarget = 528;")]),
    "K14 current, pruning after 4 lags": ("echo_fit.cu", pruned(4)),
    "K14 current, pruning after 8 lags": ("echo_fit.cu", pruned(8)),
    "K14 current, pruning after 12 lags": ("echo_fit.cu", pruned(12)),
    "K7 current, R = 4": ("strided_fir.cu", [("constexpr int kR = 8;", "constexpr int kR = 4;")]),
    "K7 current, R = 16": ("strided_fir.cu", [("constexpr int kR = 8;", "constexpr int kR = 16;")]),
    "K7 current, a CTA an item": (
        "strided_fir.cu", [("const long resident = static_cast<long>(per_sm > 1 ? per_sm : 1) * sms;",
                            "const long resident = all_items;")]),
}


def patched(csrc: Path, vdir: Path, name: str) -> Path:
    """The current source with one variant's changes, written beside the builds."""
    stem, changes = PATCHES[name]
    text = (csrc / stem).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old.strip()[:60]!r} does not occur once in {stem}")
        text = text.replace(old, new)
    out = vdir / f"{name.replace(' ', '_').replace(',', '').replace('=', '')}.cu"
    out.write_text(text)
    return out


K14_FUNCTIONS = ("acf_kernel", "residual_kernel", "epilogue_kernel")
K7_FUNCTIONS = ("strided_fir_kernel",)


def median_cycles(stamps: np.ndarray, spans: dict) -> dict:
    """Median SM cycles over the CTAs of each named span ``(start, end)``
    column pair; a span given as one column is a duration the kernel
    summed itself."""
    out = {}
    for name, cols in spans.items():
        v = stamps[:, cols] if isinstance(cols, int) else stamps[:, cols[1]] - stamps[:, cols[0]]
        out[name] = float(np.median(v)) if len(v) else None
    return out


def changed(before: np.ndarray, after: np.ndarray) -> np.ndarray:
    """The rows (CTAs) whose first stamp this run wrote anew."""
    return after[(after[:, 0] != before[:, 0]) & (after[:, 0] != 0)]


def build(vdir: Path, build_mod) -> dict:
    """Every variant's library, compiled in parallel: name -> (CDLL, ptxas lines)."""
    vdir.mkdir(parents=True, exist_ok=True)
    (vdir / "old_k14.cu").write_text(OLD_K14)
    (vdir / "old_k7.cu").write_text(OLD_K7)
    csrc = build_mod.CSRC
    jobs = {
        "K14 first design": (vdir / "old_k14.cu", {}),
        "K14 first design, instrumented": (vdir / "old_k14.cu", {"OLD_CLOCKS": 1}),
        "K14 current, instrumented": (csrc / "echo_fit.cu", {"K14_CLOCKS": 1}),
        "K7 first design": (vdir / "old_k7.cu", {}),
        "K7 first design, instrumented": (vdir / "old_k7.cu", {"OLD_CLOCKS": 1}),
        "K7 current, instrumented": (csrc / "strided_fir.cu", {"K7_CLOCKS": 1}),
    }
    jobs.update({name: (patched(csrc, vdir, name), {}) for name in PATCHES})
    nvcc = build_mod._find_nvcc()
    procs = {}
    for i, (name, (src, macros)) in enumerate(jobs.items()):
        lib = vdir / f"libvariant{i}.so"
        cmd = build_mod.nvcc_command(src, lib, nvcc)
        cmd[1:1] = [f"-I{csrc}"] + [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build\n{text}")
        libs[name] = (ctypes.CDLL(str(lib)), [ln.strip() for ln in text.splitlines() if "registers" in ln])
    return libs


def swap(build_mod, kernel: str, lib, symbol: str, drop: int = 0):
    """Point the launcher's ``kernel`` at ``symbol`` of ``lib``; ``drop``:
    the wrapper's last int arguments before the stream that the symbol
    does not take (the first K7's entry takes no plan)."""
    fn = getattr(lib, symbol)
    types = build_mod.KERNELS[kernel][2]
    fn.argtypes = tuple(types[:len(types) - 1 - drop]) + (types[-1],)
    fn.restype = ctypes.c_int
    lib.wavecap_error_string.argtypes = (ctypes.c_int,)
    lib.wavecap_error_string.restype = ctypes.c_char_p
    call = fn if not drop else (lambda *a: fn(*a[:-1 - drop], a[-1]))
    build_mod._FUNCTIONS[kernel] = (call, lib)


def k14_cases(cs, dev):
    import torch

    from wavecap_tpu_torch.capture.pipeline import p25_cfg_for
    from wavecap_tpu_torch.models.p25 import cqpsk

    cfgs = cs.p25_configs()
    cfg_b = p25_cfg_for(cfgs["B"])
    grid = cqpsk._cfg_grid(cfg_b, dev)
    rng = np.random.default_rng(cs.SEED + 7)
    rows, n_b = cfgs["B"].p25_capacity, 2 * cfgs["B"].block_size // cfgs["B"].channelizer().channel_count
    x = cs.cqpsk_rows(rng, rows, n_b, cfg_b.sample_rate, 4800.0, 0.2, cfo=np.zeros(rows))
    x[::2] += (0.8 * np.exp(2.98j)) * np.roll(x[::2], 4, axis=-1)
    xl = cs.cqpsk_rows(rng, 1, 60_000, cfg_b.sample_rate, 4800.0, 0.2, cfo=np.zeros(1))
    xl = xl + (0.8 * np.exp(2.98j)) * np.roll(xl, 4, axis=-1)
    x, xl = (torch.from_numpy(v.astype(np.complex64)).to(dev) for v in (x, xl))
    lags = grid.n_tau + 1
    acc = torch.zeros((rows, lags), dtype=torch.complex64, device=dev)
    acc[1::2] = 0.5
    enable = torch.from_numpy(np.arange(rows) != 5).to(dev)
    rot = torch.from_numpy(np.exp(2j * np.pi * 1200.0 * np.arange(n_b) / cfg_b.sample_rate)
                           .astype(np.complex64)).to(dev)
    x3 = torch.cat([x, x * rot, torch.flip(x, [0])])
    return [
        ("fit (21, 7500)", "fit", (x, acc, enable, grid)),
        ("alias scores (63, 7500)", "score", (x3, grid)),
        ("fit, one 60,000-sample row", "fit", (xl, torch.zeros((1, lags), dtype=torch.complex64, device=dev),
                                               torch.ones(1, dtype=torch.bool, device=dev), grid)),
    ]


def k14_run(cs, eqz, mode, args):
    if mode == "fit":
        x, acc, enable, grid = args
        return lambda: eqz.echo_fit(x, acc, enable, grid, 41, 0.01, 0.35, 0.6, 0.5), \
            lambda: eqz.echo_fit_plain(x, acc, enable, grid, 41, 0.01, 0.35, 0.6, 0.5)
    x, grid = args
    return lambda: eqz.echo_score(x, grid), lambda: eqz.echo_score_plain(x, grid)


def k14_agree(cs, mode, got, ref, enable=None) -> dict:
    if mode == "score":
        err = cs.rel_l2(cs.host(ref), cs.host(got))
        return dict(score_rel_l2=err, ok=err <= 1e-5)
    t_k, a_k, s_k, j_k = (cs.host(v) for v in got)
    t_p, a_p, s_p, j_p = (cs.host(v) for v in ref)
    on = cs.host(enable)
    res = dict(j_equal=bool(np.array_equal(j_k[on], j_p[on])), sig_equal=bool(np.array_equal(s_k, s_p)),
               taps_rel_l2=cs.rel_l2(t_p, t_k), acf_rel_l2=cs.rel_l2(a_p, a_k))
    res["ok"] = res["j_equal"] and res["sig_equal"] and res["taps_rel_l2"] <= 1e-5 and res["acf_rel_l2"] <= 1e-6
    return res


def k7_cases(cs, dev):
    import torch

    from wavecap_tpu_torch.models.p25 import c4fm
    from wavecap_tpu_torch.ops import fir
    from wavecap_tpu_torch.ops.nco import tuning_word

    rng = np.random.default_rng(cs.SEED + 8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def cnoise(*shape):
        return (0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)

    wide = fir.design_decimation_fir(41, 10_000_000.0)
    tw = t(wide)
    tw20 = t(fir.design_decimation_fir(83, 20_000_000.0))
    dphi20 = tuning_word(-t(np.array([700_000.0, -1_200_000.0], np.float32)), 20_000_000.0)
    dphi = tuning_word(-t(np.array([700_000.0, -1_200_000.0], np.float32)), 10_000_000.0)
    p0 = t(np.array([0xFFFF0000, 12345], np.uint32))
    lpf, rrc = (t(v) for v in (c4fm.design_baseband_lpf(50_000.0), c4fm.design_rrc(50_000.0)))
    r5 = t(fir.design_resample_poly_filter(1, 5))
    eq_taps = t((rng.standard_normal((21, 41)) + 1j * rng.standard_normal((21, 41))).astype(np.complex64) * 0.2)
    return [
        ("wide slots (2 x 1,968,000 + head -> 48,000)", (t(cnoise(1_968_000)), tw, 41, t(cnoise(2, 1030)), (dphi, p0))),
        ("a mesh shard's wide slots (2 x 247,030 -> 6,000)", (t(cnoise(247_030)), tw, 41, None, (dphi, p0))),
        ("wide slots at 20 Msps (2 x 4,000,000 + head -> 48,193)",
         (t(cnoise(4_000_000)), tw20, 83, t(cnoise(2, 2084)), (dphi20, p0))),
        ("equaliser (21, 7,540) c64, 41 complex taps a row", (t(cnoise(21, 7_540)), eq_taps, 1, None, None)),
        ("program A's low-pass (50, 12,562) c64, 63 taps", (t(cnoise(50, 12_562)), lpf, 1, None, None)),
        ("program F's per-shard low-pass (50, 1,562) c64, 63 taps", (t(cnoise(50, 1_562)), lpf, 1, None, None)),
        ("program F's per-shard RRC (50, 1,582) f32, 83 taps",
         (t((0.3 * rng.standard_normal((50, 1_582))).astype(np.float32)), rrc, 1, None, None)),
        ("up == 1: 1/5 (2, 48,000) f32 + head, 101 taps",
         (t(rng.standard_normal((2, 48_000)).astype(np.float32)), r5, 5,
          t(rng.standard_normal((2, 100)).astype(np.float32)), None)),
    ]


def forced_plans(fir, args) -> tuple:
    """The kernel's own plan, and plans to try beside it: groups, phase
    sets (stride > 1) and splits over a small grid, inside a block's
    threads and shared memory."""
    x, taps, stride, head, nco = args
    rows = fir._k7_rows(x, head, nco)
    rows = int(np.prod(rows)) if rows else 1
    total = x.shape[-1] + (0 if head is None else head.shape[-1])
    n_out = (total - taps.shape[-1]) // stride + 1
    shape = (taps.shape[-1], stride, rows, n_out, x.is_complex(), taps.is_complex())
    own = fir.k7_plan(*shape)
    q = -(-taps.shape[-1] // stride)
    if stride == 1:
        grid = [(g, 1, s, 0) for g in (8, 16, 32, 64) for s in (1, 2, 4, 8)]
    else:
        grid = [(g, ps, s, 0) for g in (4, 8, 12, 16, 24, 32) for ps in sorted({stride, 16, 8, 4})
                if ps <= stride for s in (1, 2)]
    grid.append((0, 0, 0, 1))  # the direct variant
    out = []
    for g, ps, s, direct in grid:
        plan = fir.k7_plan(*shape, forced=(g, ps, s, direct))
        same = plan.direct == own.direct and (own.direct or (g, ps, s) == (own.groups, own.phase_sets, own.splits))
        if not same and 32 <= plan.threads <= 512 and (s <= 1 or plan.threads % 32 == 0) \
                and plan.smem <= fir._K7_SMEM_MAX and (s <= 1 or q >= 2 * s * plan.r):
            out.append((g, ps, s, direct))
    return own, out


def main() -> int:
    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build as build_mod
    from wavecap_tpu_torch.models.p25 import equalizer as eqz
    from wavecap_tpu_torch.ops import fir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_k14_variants: no CUDA device", file=sys.stderr)
        return 2
    build_mod.build_all()
    libs = build(build_mod.BUILD_DIR / "k7_k14_variants", build_mod)
    card = cs.card_line()
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        line = json.dumps(dict(card=card, **obj), default=float)
        print(line, flush=True)
        lines.append(line)

    current14 = build_mod._function("K14_echo_fit")
    current7 = build_mod._function("K7_strided_fir")
    own_plan = fir.k7_plan
    acf_c = np.zeros((1024, 5), np.int64)
    res_c = np.zeros((1024, 4), np.int64)
    epi_c = np.zeros((256, 4), np.int64)
    old_c = np.zeros((3, 1024, 4), np.int64)  # the first K14's stamps
    old7_c = np.zeros((3, 1024, 4), np.int64)  # the first K7's

    # --- K14 ---
    for case, mode, cargs in k14_cases(cs, dev):
        kern, plain = k14_run(cs, eqz, mode, cargs)
        ref = plain()
        variants = [("K14 current", None)] + [(k, v) for k, v in libs.items() if k.startswith("K14")]
        for name, entry in variants:
            if entry is None:
                build_mod._FUNCTIONS["K14_echo_fit"] = current14
            else:
                swap(build_mod, "K14_echo_fit", entry[0], "k14_echo_fit")
            rec = dict(kernel="K14", case=case, variant=name, ptxas=entry[1] if entry else None)
            try:
                got = kern()
                torch.cuda.synchronize()
            except RuntimeError as e:  # the first design stages the row: refused past its shared memory
                emit(dict(rec, refused=str(e)))
                continue
            rec.update(k14_agree(cs, mode, got, ref, cargs[2] if mode == "fit" else None))
            rec["ms"] = cs.device_ms(kern, K14_FUNCTIONS)
            rec["ms_by_kernel"] = {k: cs.device_ms(kern, k) for k in K14_FUNCTIONS}
            if name.endswith("instrumented"):
                lib = entry[0]
                if "first" in name:
                    read = lib.old_clocks
                    read.argtypes = (ctypes.c_void_p,)
                    before = old_c.copy()
                    kern()
                    torch.cuda.synchronize()
                    assert read(old_c.ctypes.data) == 0
                    rec["median_cycles"] = dict(
                        acf=median_cycles(changed(before[0], old_c[0]), {"stage row": (0, 1), "29 lags": (1, 2),
                                                                          "finish": (2, 3)}),
                        residuals=median_cycles(changed(before[1], old_c[1]), {"stage": (0, 1), "rows": (1, 2)}))
                    if mode == "fit":  # score mode's epilogue only copies the minimum
                        rec["median_cycles"]["epilogue"] = median_cycles(
                            changed(before[2], old_c[2]), {"gate": (0, 1), "W": (1, 2), "taps": (2, 3)})
                else:
                    read = lib.k14_clocks
                    read.argtypes = (ctypes.c_void_p,) * 3
                    b_acf, b_res, b_epi = acf_c.copy(), res_c.copy(), epi_c.copy()
                    kern()
                    torch.cuda.synchronize()
                    assert read(acf_c.ctypes.data, res_c.ctypes.data, epi_c.ctypes.data) == 0
                    a = changed(b_acf, acf_c)
                    red = a[:, 3] - a[:, 0] - a[:, 1] - a[:, 2]
                    fin = a[:, 4] - a[:, 3]
                    rec["median_cycles"] = dict(
                        acf=dict(median_cycles(a, {"stage chunks": 1, "products": 2}),
                                 reduce_and_cluster=float(np.median(red)),
                                 finish_rank0=float(np.median(fin[fin > 0])) if (fin > 0).any() else None),
                        residuals=median_cycles(changed(b_res, res_c), {"stage": (0, 1), "rows": (1, 2),
                                                                        "atomics": (2, 3)}))
                    if mode == "fit":
                        rec["median_cycles"]["epilogue"] = median_cycles(
                            changed(b_epi, epi_c), {"gate and table": (0, 1), "W": (1, 2), "taps": (2, 3)})
            emit(rec)
        build_mod._FUNCTIONS["K14_echo_fit"] = current14

    # --- K7 ---
    k7_c = np.zeros((1024, 6), np.int64)
    for case, cargs in k7_cases(cs, dev):
        def kern(a=cargs):
            return fir.strided_fir(*a)

        ref = fir.strided_fir_plain(*cargs)
        own, forced = forced_plans(fir, cargs)
        variants = [("K7 current", None, None)] + [(k, v, None) for k, v in libs.items() if k.startswith("K7")]
        variants += [("K7 current, forced direct variant" if dv else
                      f"K7 current, forced groups {g}, phase sets {ps}, splits {sp}", None, (g, ps, sp, dv))
                     for g, ps, sp, dv in forced]
        for name, entry, plan in variants:
            build_mod._FUNCTIONS["K7_strided_fir"] = current7
            fir.k7_plan = own_plan
            if plan is not None:
                fir.k7_plan = lambda *a, plan=plan: own_plan(*a, forced=plan)
            elif entry is not None:
                swap(build_mod, "K7_strided_fir", entry[0], "k7_strided_fir", drop=4 if "first" in name else 0)
            rec = dict(kernel="K7", case=case, variant=name, plan=own._asdict() if name == "K7 current" else None,
                       ptxas=entry[1] if entry else None)
            try:
                got = kern()
                torch.cuda.synchronize()
            except RuntimeError as e:
                emit(dict(rec, refused=str(e)))
                continue
            err = cs.rel_l2(cs.host(ref[0]), cs.host(got[0]))
            same_phase = ref[2] is None or torch.equal(ref[2], got[2])
            rec.update(rel_l2=err, phases_equal=bool(same_phase), ok=err <= 1e-5 and same_phase,
                       ms=cs.device_ms(kern, K7_FUNCTIONS))
            if name.endswith("instrumented"):
                lib = entry[0]
                first = "first" in name
                read = lib.old_clocks if first else lib.k7_clocks
                read.argtypes = (ctypes.c_void_p,)
                buf = old7_c if first else k7_c
                before = buf.copy()
                kern()
                torch.cuda.synchronize()
                assert read(buf.ctypes.data) == 0
                if first:
                    rec["median_cycles"] = median_cycles(changed(before[0], buf[0]), {"stage span": (0, 1),
                                                                                      "taps and store": (1, 2)})
                else:
                    rows_c = changed(before, buf)
                    if not len(rows_c):  # the direct variant carries no stamps
                        emit(rec)
                        continue
                    items = np.maximum(rows_c[:, 5], 1)[:, None]
                    per_item = np.concatenate([rows_c[:, :1], rows_c[:, 1:4] / items], 1)
                    rec["median_cycles"] = dict(
                        median_cycles(per_item, {"stage span, an item": 1, "taps, an item": 2,
                                                 "add partials and store, an item": 3}),
                        cta_lifetime=float(np.median(rows_c[:, 4] - rows_c[:, 0])),
                        cta_lifetime_max=float(np.max(rows_c[:, 4] - rows_c[:, 0])),
                        items_a_cta=float(np.median(rows_c[:, 5])))
                    shape = np.zeros(2, np.int32)
                    lib.k7_launch_shape(shape.ctypes.data_as(ctypes.c_void_p))
                    rec.update(ctas_an_sm=int(shape[0]), ctas=int(shape[1]), ctas_stamped=len(rows_c))
            emit(rec)
        build_mod._FUNCTIONS["K7_strided_fir"] = current7
        fir.k7_plan = own_plan
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
