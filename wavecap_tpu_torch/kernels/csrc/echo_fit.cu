// K14: the simulcast echo fit of the P25 equalizer.
//
// Replaces wavecap_tpu/models/p25/equalizer.py:fit_and_invert (the block
// acf, its EMA and guards, the candidate match, the gate and the MMSE
// inverse), :block_acf, and the scoring inside :resolve_cfo_alias.  Three
// kernels on the stream, one C entry:
//
//  1. acf, one CTA per row: r[t] = mean(x[t:] conj(x[:n-t])) for t <= n_tau,
//     r /= max(Re r[0], 1e-9), zeroed if not finite; in fit mode the EMA
//     with the carried acf (where it is not all zero) and the enable guard.
//  2. residuals, a grid over candidate tiles: every row's acf is staged in
//     shared memory, each thread holds one candidate's prediction in
//     registers and scores sum_t |p[t] - acf[t]|^2 against every row.  The
//     first minimum across blocks comes from atomicMin on a packed u64
//     (float bits << 32 | index): residuals are >= 0, so their bits order as
//     integers, and on a tie the lower index wins, as jnp.argmin's.
//  3. epilogue, one CTA per row: the gate (resid[j] < 0.6 resid[0],
//     a >= 0.35, enable), then W[k] = conj(H)/(|H|^2 + lambda) on the 512
//     FFT points and the taps as the direct inverse DFT at the n_taps
//     needed indices, (1/512) sum_k W[k] e^{+2 pi i k m / 512}, summed in
//     double, in place of a whole 512-point inverse FFT.  Score mode writes
//     the least residual instead.
//
// Bound on the H100: bytes and operations are both small.  Program B's
// fit reads 21 x 7,500 complex rows (1.3 MB) and the 12,289 x 29 complex
// prediction table (2.85 MB) once, ~1.2 us at 3.35 TB/s; the residuals are
// 21 x 12,289 x 29 x ~7 flops (52 MFLOP) and the acf 21 x 29 x 7,500 x 8
// (37 MFLOP), ~1.3 us at 67 TFLOP/s.  Design: the row, and then every
// row's acf, live in shared memory so the table is read once per launch;
// the dependent steps are separate kernels on one stream, not a grid-wide
// barrier.
#include "common.cuh"

namespace {

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
    for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = row[i];
    __syncthreads();
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
}

__global__ void __launch_bounds__(kThreads)
residual_kernel(const float2* __restrict__ acf, int rows, int lags,
                const float2* __restrict__ preds, int n_cand,
                unsigned long long* __restrict__ best) {
    extern __shared__ float2 as[];
    for (int i = threadIdx.x; i < rows * lags; i += blockDim.x) as[i] = acf[i];
    __syncthreads();
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    const bool valid = c < n_cand;
    float2 p[kMaxLags];
#pragma unroll
    for (int t = 0; t < kMaxLags; ++t) {
        p[t] = (valid && t < lags) ? preds[static_cast<long long>(c) * lags + t] : make_float2(0.f, 0.f);
    }
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
}

}  // namespace

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
