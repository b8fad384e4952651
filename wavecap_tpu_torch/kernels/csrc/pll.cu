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
// and the output is mixed.  The mix and the loop are rounded as the
// reference's (no multiply-add contraction); sin, cos and atan are this
// kernel's own (pll_math.cuh, coefficients from ops/pll.py).
//
// Bound on the H100: the serial chain.  At 160 rows x 4,920 samples it
// moves 12.6 MB (~3.8 us at 3.35 TB/s), but each row is one dependent
// chain of 4,920 steps and nothing exact splits it.  A single warp issues
// at most one instruction a cycle, so the step is bound both by its
// dependent path and by its instruction count.  Design: one thread a row,
// the state in registers, blocks of two warps for 32 rows (160 rows: 5
// blocks on 5 SMs).  Warp 0 runs the steps; its dependent path is kept
// short: sin and cos from one Cody-Waite reduction (the quadrant by a
// shifted add, not rintf) and two short polynomials (sincosf only behind
// a branch for |phase| > 2 pi, which a wrapped phase never takes), the
// detector as the atan of a positive abscissa (a reciprocal with one
// Newton step, a polynomial by Estrin's scheme; no quadrant or NaN
// logic), the wraps as selects.  The library's sincosf and Costas' fmodf
// stay behind branches in a rolled loop that a tile takes only if some
// row's phase or integrator could leave the range where they are never
// needed (a state handed over unwrapped); the unrolled loop of every
// other tile has no branch.
// Warp 1 moves the data, so warp 0 issues nothing else: the rows go
// through a ring of three 32 x 32 sample tiles in shared memory, and
// while warp 0 steps through tile k, warp 1 stores tile k - 1's outputs
// and brings tile k + 1 in with cp.async; the two meet at one barrier a
// tile.  A tile row is padded to 33 samples, so warp 0's column reads and
// writes (one sample of each of its 32 rows) are free of bank conflicts;
// warp 1's accesses are 8 bytes a lane, 256 bytes a row.
#include <type_traits>

#include "common.cuh"
#include "pll_math.cuh"

namespace {

constexpr int kRows = 32;
constexpr int kTile = 32;
constexpr int kRing = 3;

__device__ __forceinline__ float sign_of(float v) { return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f); }

template <int DETECTOR>
__global__ void __launch_bounds__(2 * kRows) pll_kernel(const float2* __restrict__ iq, float2* __restrict__ out,
                                                        const float* __restrict__ phase0,
                                                        const float* __restrict__ freq0,
                                                        float* __restrict__ phase1, float* __restrict__ freq1,
                                                        int rows, int n, float a, float b, K10Coeffs k) {
    __shared__ float2 ring[kRing][kRows][kTile + 1];
    const float pi = 3.14159265358979323846f;
    const float two_pi = 6.28318530717958647692f;
    const int lane = threadIdx.x & 31;
    const bool mover = threadIdx.x >= kRows;
    const int row0 = blockIdx.x * kRows;
    const int tiles = (n + kTile - 1) / kTile;

    // warp 1: row r of `tile` in or out of its ring slot, one sample a lane
    auto move = [&](int tile, bool in) {
        const int t0 = tile * kTile;
        const int len = min(kTile, n - t0);
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

    // warp 0: the loop's state, one row a lane
    const int row = row0 + lane;
    const bool live = !mover && row < rows;
    float phase = live ? phase0[row] : 0.f;
    float integ = live ? freq0[row] : 0.f;
    // CHECKED: the library's sincosf and fmodf behind branches; without,
    // selects only, for a tile whose phase cannot leave [-pi, pi] (below)
    auto step = [&](float2 z, auto checked) {
        constexpr bool kChecked = decltype(checked)::value;
        float s, c;
        k10_sincos<kChecked>(-phase, k, s, c);
        const float2 m = make_float2(__fsub_rn(__fmul_rn(z.x, c), __fmul_rn(z.y, s)),
                                     __fadd_rn(__fmul_rn(z.x, s), __fmul_rn(z.y, c)));
        float err;
        if (DETECTOR == 0) {
            err = k10_atan_pos(m.y, __fadd_rn(fabsf(m.x), 1e-10f), k);
        } else {
            err = __fsub_rn(__fmul_rn(sign_of(m.x), m.y), __fmul_rn(sign_of(m.y), m.x));
            err = fminf(fmaxf(err, -1.f), 1.f);
        }
        integ = __fadd_rn(integ, __fmul_rn(b, err));
        const float corr = __fadd_rn(__fmul_rn(a, err), integ);
        if (DETECTOR == 0) {
            phase = k10_pll_wrap(__fadd_rn(phase, corr), pi, two_pi);
        } else {
            phase = k10_costas_wrap<kChecked>(__fadd_rn(__fadd_rn(phase, corr), pi), pi, two_pi);
        }
        return m;
    };
    // |err| <= pi/2 (PLL) or 1 (Costas), so over a tile |corr| <= 1.6 (|a| +
    // 33 |b|) + |integ| at its start.  With that below 3 < pi and |phase| <=
    // pi, each wrap keeps |phase| <= pi and Costas' v = phase + corr + pi in
    // (-2pi, 4pi): no step of the tile can take a library path.
    const float drift = 1.6f * (fabsf(a) + 33.f * fabsf(b));

    if (mover) {
        move(0, true);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
    __syncthreads();
    for (int tile = 0; tile < tiles; ++tile) {
        if (mover) {
            if (tile > 0) move(tile - 1, false);
            if (tile + 1 < tiles) move(tile + 1, true);
            asm volatile("cp.async.wait_all;\n" ::: "memory");
        } else {
            float2* mine = ring[tile % kRing][lane];
            const int len = n - tile * kTile;
            const bool bounded = fabsf(phase) <= pi && __fadd_rn(fabsf(integ), drift) <= 3.f;
            if (len >= kTile && __all_sync(0xffffffffu, bounded || !live)) {
#pragma unroll
                for (int t = 0; t < kTile; ++t) mine[t] = step(mine[t], std::false_type{});
            } else {
#pragma unroll 1
                for (int t = 0; t < min(len, kTile); ++t) mine[t] = step(mine[t], std::true_type{});
            }
        }
        __syncthreads();
    }
    if (mover) move(tiles - 1, false);
    if (live) {
        phase1[row] = phase;
        freq1[row] = integ;
    }
}

}  // namespace

WAVECAP_EXPORT int k10_pll(const void* iq, void* out, const void* phase0, const void* freq0,
                           void* phase1, void* freq1, int rows, int n, float a, float b,
                           int detector, K10Coeffs coeffs, void* stream) {
    if (rows <= 0 || n <= 0) return 0;
    const int blocks = (rows + kRows - 1) / kRows;  // 2 warps each
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* x = static_cast<const float2*>(iq);
    float2* y = static_cast<float2*>(out);
    const float* p0 = static_cast<const float*>(phase0);
    const float* f0 = static_cast<const float*>(freq0);
    float* p1 = static_cast<float*>(phase1);
    float* f1 = static_cast<float*>(freq1);
    if (detector == 0) {
        pll_kernel<0><<<blocks, 2 * kRows, 0, s>>>(x, y, p0, f0, p1, f1, rows, n, a, b, coeffs);
    } else if (detector == 1) {
        pll_kernel<1><<<blocks, 2 * kRows, 0, s>>>(x, y, p0, f0, p1, f1, rows, n, a, b, coeffs);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
