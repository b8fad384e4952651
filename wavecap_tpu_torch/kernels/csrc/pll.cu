// K10: per-sample phase-locked loops, one thread per row.
//
// Replaces wavecap_tpu/ops/pll.py:carrier_recovery_pll (detector 0) and
// ops/pll.py:costas_loop_qpsk (detector 1), the lax.scan steps of
// pll.py:54-64 and :84-93.  Per sample, with f32 state (phase, integ):
//
//   mixed = z * (cos(-phase), sin(-phase))
//   err   = atan2(Im mixed, |Re mixed| + 1e-10)                   (PLL)
//         = clip(sign(Re) Im - sign(Im) Re, -1, 1)                (Costas)
//   integ = integ + b err;  corr = a err + integ
//   phase = phase + corr, wrapped once each way at +-pi           (PLL)
//         = mod(phase + corr + pi, 2 pi) - pi, divisor's sign     (Costas)
//
// and the output is mixed.  The loop arithmetic is rounded as the
// reference's (no multiply-add contraction), so the kernel and its plain
// version part only by the libraries' cosf/sinf/atan2f.
//
// Bound on the H100: the serial chain.  At 160 rows x 4,920 samples it
// moves 12.6 MB (~3.8 us at 3.35 TB/s), but each row is one chain of
// 4,920 steps, each a cosf, a sinf and an atan2f in sequence (some
// hundred cycles), and only ceil(rows / 32) warps run.  Design: one
// thread per row, the state in registers; the row's samples are loaded
// and stored through a 32 x 32 shared-memory tile so that a warp's global
// accesses are coalesced.
#include "common.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kSamples = 32;

__device__ __forceinline__ float sign_of(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

template <int DETECTOR>
__global__ void pll_kernel(const float2* __restrict__ iq, float2* __restrict__ out,
                           const float* __restrict__ phase0, const float* __restrict__ freq0,
                           float* __restrict__ phase1, float* __restrict__ freq1, int rows, int n,
                           float a, float b) {
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
        for (int r = 0; r < kRows; ++r) {
            if (row0 + r < rows && lane < len)
                tile[r][lane] = iq[static_cast<long long>(row0 + r) * n + t0 + lane];
        }
        __syncwarp();
        if (live) {
            for (int t = 0; t < len; ++t) {
                const float2 z = tile[lane][t];
                const float c = cosf(-phase), s = sinf(-phase);
                const float2 m = make_float2(__fsub_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s)),
                                             __fadd_rn(__fmul_rn(z.x, s), __fmul_rn(z.y, c)));
                float err;
                if (DETECTOR == 0) {
                    err = atan2f(m.y, __fadd_rn(fabsf(m.x), 1e-10f));
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
                    float r = fmodf(__fadd_rn(__fadd_rn(phase, corr), pi), two_pi);
                    if (r != 0.f && r < 0.f) r = __fadd_rn(r, two_pi);
                    phase = __fsub_rn(r, pi);
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

WAVECAP_EXPORT int k10_pll(const void* iq, void* out, const void* phase0, const void* freq0,
                           void* phase1, void* freq1, int rows, int n, float a, float b,
                           int detector, void* stream) {
    if (rows <= 0) return 0;
    const int blocks = (rows + kRows - 1) / kRows;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* x = static_cast<const float2*>(iq);
    float2* y = static_cast<float2*>(out);
    const float* p0 = static_cast<const float*>(phase0);
    const float* f0 = static_cast<const float*>(freq0);
    float* p1 = static_cast<float*>(phase1);
    float* f1 = static_cast<float*>(freq1);
    if (detector == 0) {
        pll_kernel<0><<<blocks, kRows, 0, s>>>(x, y, p0, f0, p1, f1, rows, n, a, b);
    } else if (detector == 1) {
        pll_kernel<1><<<blocks, kRows, 0, s>>>(x, y, p0, f0, p1, f1, rows, n, a, b);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
