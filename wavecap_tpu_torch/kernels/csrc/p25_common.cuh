// Shared pieces of the P25 timing kernels (p25_timing.cu: K12, K13;
// p25_scan.cu: K12s, K13s): the constants, the f32 arithmetic in the
// reference's order (__f*_rn, so nvcc does not contract a*b + c into an
// FMA the plain version does not have), and the per-block epilogues that
// turn a row's symbols into soft symbols and dibits.
#pragma once

#include "common.cuh"

namespace p25 {

constexpr int kTail = 64;  // INTERP_TAIL
constexpr float kQuarterPi = static_cast<float>(0.7853981633974483);

struct Consts {
    float sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock;
};

__device__ __forceinline__ float clip(float x, float lo, float hi) { return fminf(fmaxf(x, lo), hi); }

__device__ __forceinline__ float lerp(float a, float b, float fr) {
    return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, fr)), __fmul_rn(b, fr));
}
__device__ __forceinline__ float2 lerp(float2 a, float2 b, float fr) {
    return make_float2(lerp(a.x, b.x, fr), lerp(a.y, b.y, fr));
}
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float2 sub(float2 a, float2 b) {
    return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

// one term of the Gardner discriminant: (y0 - y1) ym, or Re(conj(ym) (y0 - y1))
__device__ __forceinline__ float gardner_term(float d, float ym) { return __fmul_rn(d, ym); }
__device__ __forceinline__ float gardner_term(float2 d, float2 ym) {
    return __fadd_rn(__fmul_rn(ym.x, d.x), __fmul_rn(ym.y, d.y));
}

__device__ __forceinline__ unsigned char to_dibit(float s) {
    const bool outer = fabsf(s) >= 2.f;
    return s >= 0.f ? (outer ? 1 : 0) : (outer ? 3 : 2);
}

// the next block's position: the carry window's shift, recentred by a
// whole symbol when the clock walks it out
__device__ __forceinline__ float recenter(float pos_end, int len, const Consts& c) {
    float p = __fsub_rn(pos_end, static_cast<float>(len - kTail));
    if (p < 4.f) p = __fadd_rn(p, c.sps);
    if (p > c.recenter_hi) p = __fsub_rn(p, c.sps);
    return p;
}

// C4FM: the blockwise amplitude normalization and the slow gain EMA over
// the raw symbols sym[0..n_sym) (in shared memory, published); every
// thread calls it and gets the new gain; soft and dibits of the row out.
__device__ __forceinline__ float c4fm_gain(const float* sym, int n_sym, float gain_in, float* srow,
                                           unsigned char* drow, float* scratch) {
    const int tid = threadIdx.x, bs = blockDim.x;
    float acc = 0.f;
    for (int m = tid; m < n_sym; m += bs) acc += fabsf(sym[m]);
    acc = block_sum(acc, scratch);
    const float scale = __fdiv_rn(2.f, fmaxf(__fdiv_rn(acc, static_cast<float>(n_sym)), 0.05f));
    float gain = gain_in < 0.01f ? scale : __fadd_rn(__fmul_rn(0.95f, gain_in), __fmul_rn(0.05f, scale));
    gain = clip(gain, 0.05f, 40.f);
    for (int m = tid; m < n_sym; m += bs) {
        const float v = __fmul_rn(sym[m], gain);
        srow[m] = v;
        drow[m] = to_dibit(v);
    }
    return gain;
}

// CQPSK: differential detection z = y[m] conj(y[m-1]) (y[-1] = prev),
// atan2, the round-half-even pi/4 quantizer and the bias tracker; every
// thread calls it and gets the new bias; dph holds n_sym floats of
// shared memory; soft and dibits of the row out.
__device__ __forceinline__ float cqpsk_detect(const float2* sym, float* dph, int n_sym, float2 prev,
                                              float bias_in, float* srow, unsigned char* drow,
                                              float* scratch) {
    const int tid = threadIdx.x, bs = blockDim.x;
    float acc = 0.f;
    for (int m = tid; m < n_sym; m += bs) {
        const float2 s = sym[m];
        const float2 p = m > 0 ? sym[m - 1] : prev;
        const float zr = __fadd_rn(__fmul_rn(s.x, p.x), __fmul_rn(s.y, p.y));
        const float zi = __fsub_rn(__fmul_rn(s.y, p.x), __fmul_rn(s.x, p.y));
        const float d = atan2f(zi, zr);
        dph[m] = d;
        const float q = clip(rintf(__fdiv_rn(__fsub_rn(d, bias_in), kQuarterPi)), -3.f, 3.f);
        acc += __fsub_rn(__fsub_rn(d, bias_in), __fmul_rn(q, kQuarterPi));
    }
    acc = block_sum(acc, scratch);  // its barriers also publish dph
    const float bias = __fadd_rn(bias_in, __fmul_rn(0.02f, __fdiv_rn(acc, static_cast<float>(n_sym))));
    for (int m = tid; m < n_sym; m += bs) {
        const float v = __fdiv_rn(__fsub_rn(dph[m], bias), kQuarterPi);
        srow[m] = v;
        drow[m] = to_dibit(v);
    }
    return bias;
}

}  // namespace p25
