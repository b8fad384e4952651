// K12 and K13 (timing): the P25 block timing recovery, a cluster of CTAs a row.
//
// Replaces wavecap_tpu/models/p25/c4fm.py:_demod_block_timing (K12, real
// rows, C4FM) and the block branch of models/p25/cqpsk.py:cqpsk_demodulate
// with its differential detection (cqpsk.py:375-469; K13, complex rows).
// Per row, over buf = interp_tail (64) ++ filt (n) and the carried
// scalars, in the reference's order:
//
//   dc0     = dc 0.9 + mean(filt) 0.1                    (C4FM; CQPSK: 0)
//   u       = (filt - dc0)^2   |  |filt|^2
//   A1, A2  = sum of u exp(-2 pi i idx / sps) over the two block halves
//   lock    = |A1 + A2| / max(sum |u|, 1e-9)
//   slope   = clip(angle(A2 conj A1) / 2 pi sps (sps / (n/2)), +-0.005)
//   delta_om= mod(-angle(A1 + A2) / 2 pi sps - mod(pos - 64, sps) + sps/2, sps) - sps/2
//   two Newton steps on the block-mean Gardner discriminant g(off), from
//   d0 = delta_om where |delta_om| > 0.75; the dead-air gate lock > 0.005
//   (CQPSK 0.002); the PI update of integrator and freq; the gather of
//   every symbol along base + delta + slope (m - n_sym/2); then C4FM: the
//   gain EMA, soft and dibits; CQPSK: z = y[m] conj(y[m-1]), atan2, the
//   round-half-even pi/4 quantizer and the bias tracker, soft and dibits;
//   and the next pos, recentred by a whole symbol.
//
// jnp.mod's floor semantics, jnp.where's select of both computed sides,
// the clip to [0, len - 2] before each gather and prev = raw[-1] are
// copied; positions, phases and the scalar chain use __f*_rn so nvcc does
// not contract them into FMAs the plain version does not have.
//
// Bound on the H100: neither bytes nor operations.  Program A (50 rows x
// 12,564 f32 in, 50 x 1,200 soft + dibits out) moves ~2.8 MB (~0.8 us at
// 3.35 TB/s); the ~50 MFLOP of the O&M line and the gathers take ~1 us at
// 67 TFLOP/s.  What bounds it is the chain of dependent row-wide sums (dc,
// the O&M line, g0 and g1, g2, the gain or the bias) and, with one SM a
// row, the O&M line's IEEE division, cosf and sinf a sample (47 % of the
// first design's CTA at program A, scripts/k4_k12_variants.py).
//
// Design (plan: models/p25/c4fm.py:k12_plan):
//
// * a row's CTAs form a thread-block cluster (4 a row; 8 where the launch
//   has few rows); CTA `rank` takes the symbols [rank mseg, (rank + 1)
//   mseg) and, for the row passes (dc, the O&M line), the samples from the
//   floor of its first symbol's position to the next CTA's (the first
//   from 64, the last to the row's end): every sample once, inside the
//   CTA's window;
// * a CTA stages only the window its passes and gathers can read: its
//   samples and, for its symbols and the one before them (CQPSK's
//   detection), pos + m freq + off with |off| <= sps/2 + 0.5 (d0 + 0.5),
//   the mid sample a half symbol back, and the ramp's |slope (m -
//   n_sym/2)| <= 0.005 n_sym / 2, each clipped to [0, len - 2] as the
//   gathers clip, plus 2 samples of margin; by 16-byte cp.async, landing
//   while the CTA sets up its barriers.  A window past the plan's room
//   (``cap`` samples; 0: the row did not fit) reads the row from global
//   memory (L2) instead: rows of any length run;
// * the O&M line's per-sample weights, cos and sin of -2 pi i / sps, come
//   from a table (c4fm.py:_om_table) that torch computes once per shape on
//   the card exactly as the plain version computes them: a sample costs
//   two loads and three multiplies, not a division, a cosf and a sinf;
// * every step's sums are one multi-value reduction: warp shuffles, the
//   warps' partials in shared memory, then one st.async a (sum, CTA) into
//   every CTA of the cluster, counted by that CTA's mbarrier of the step;
//   each CTA waits for its own mbarrier and adds the sums in rank order,
//   so every CTA runs the same scalar chain on the same values, with no
//   cluster-wide barrier a step;
// * CQPSK's detection needs y[m - 1] across a CTA's first symbol: the CTA
//   gathers it again, bit-equal; for m = 0 it is the carried prev_sym;
// * the raw symbols (C4FM) or phase steps (CQPSK) wait in the soft row
//   until the gain or the bias is known; each thread rescales its own.
#include <cooperative_groups.h>

#include "p25_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace p25;

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kSteps = 5;    // dc, O&M, (g0, g1), g2, gain or bias
constexpr int kMaxVals = 5;  // the O&M line's sums
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kMargin = 2.f;  // samples past a window's computed bounds

// Build switch for scripts/k4_k12_variants.py: K12_CLOCKS, clock64 in
// thread 0 of the first CTAs at [0] start, [1] state read and window
// bounds known, [2] window staged, [3] dc, [4] the O&M line, [5] g0 and
// g1, [6] g2, [7] gain or bias, [8] end; k12_clocks reads them.
#ifndef K12_CLOCKS
#define K12_CLOCKS 0
#endif
#if K12_CLOCKS
__device__ long long g_k12_clocks[4096][10];
#define STAMP(k)                                                              \
    do {                                                                      \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_k12_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// jnp.mod / torch.remainder: the remainder takes the divisor's sign
__device__ __forceinline__ float floor_mod(float x, float y) {
    float r = fmodf(x, y);
    if (r != 0.f && ((r < 0.f) != (y < 0.f))) r = __fadd_rn(r, y);
    return r;
}

// the interpolated row at p, clipped to [0, hi] as the reference does
template <typename V>
__device__ __forceinline__ V sample_at(const V* buf, float p, float hi) {
    p = clip(p, 0.f, hi);
    const float f = floorf(p);
    const int i0 = static_cast<int>(f);
    return lerp(buf[i0], buf[i0 + 1], __fsub_rn(p, f));
}

__device__ __forceinline__ float power(float v) { return __fmul_rn(v, v); }
__device__ __forceinline__ float power(float2 v) {
    const float m = hypotf(v.x, v.y);  // jnp.abs(y) ** 2
    return __fmul_rn(m, m);
}

// The sums of one step over the row: each thread's K values -> the CTA's
// (warps in order) -> every CTA of the cluster (ranks in order).  Thread
// (k, d) of the first K x nct adds the warps' k-th sums and sends the total
// to CTA d (itself too) with st.async, which counts the bytes on that
// CTA's mbarrier of the step; a CTA waits on its own mbarrier until all of
// the cluster's sums are in, then adds them in rank order.  No cluster-wide
// barrier a step: a CTA waits only for the data it needs.  Every thread of
// every CTA calls sum().
struct Reducer {
    float (*warps)[kMaxVals];                 // [kMaxWarps][kMaxVals], shared
    float (*parts)[kMaxCluster][kMaxVals];    // [kSteps][kMaxCluster][kMaxVals], shared
    uint64_t* bars;                           // [kSteps] mbarriers, shared
    int nct, rank;
    bool started;  // the cluster's start barrier has been waited on

    // thread 0: step s's mbarrier expects nct x vals[s] sums (steps of no
    // sums are never waited on); then the cluster learns that they exist
    // before any CTA sends
    __device__ __forceinline__ void init(const int (&vals)[kSteps]) {
        if (threadIdx.x == 0) {
            for (int s = 0; s < kSteps; ++s) {
                if (!vals[s]) continue;
                const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bars + s));
                asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(b) : "memory");
                uint64_t state;
                asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
                             : "=l"(state)
                             : "r"(b), "r"(nct * vals[s] * 4)
                             : "memory");
            }
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        if (nct > 1) {
            cluster_arrive_release();  // waited on before the first send
        } else {
            __syncthreads();
            started = true;
        }
    }

    template <int K>
    __device__ __forceinline__ void sum(float (&v)[K], int step) {
        static_assert(K <= kMaxVals, "a step's sums fit its slot");
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
        for (int k = 0; k < K; ++k)
            for (int o = 16; o > 0; o >>= 1) v[k] += __shfl_xor_sync(0xffffffffu, v[k], o);
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < K; ++k) warps[warp][k] = v[k];
        }
        __syncthreads();
        if (!started) {
            cluster_wait();  // every CTA of the cluster has started and set its mbarriers
            started = true;
        }
        const int tid = threadIdx.x;
        if (tid < K * nct) {  // thread (k, d) sends this CTA's k-th sum to CTA d
            const int k = tid / nct, d = tid - k * nct;
            const int n_warps = blockDim.x >> 5;
            float wv[kMaxWarps];  // loaded together, added in warp order (+0 past the CTA's warps)
#pragma unroll
            for (int w = 0; w < kMaxWarps; ++w) wv[w] = w < n_warps ? warps[w][k] : 0.f;
            float s = 0.f;
#pragma unroll
            for (int w = 0; w < kMaxWarps; ++w) s += wv[w];
            unsigned dst, bar;
            const unsigned mine = static_cast<unsigned>(__cvta_generic_to_shared(&parts[step][rank][k]));
            const unsigned my_bar = static_cast<unsigned>(__cvta_generic_to_shared(bars + step));
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(dst) : "r"(mine), "r"(d));
            asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(bar) : "r"(my_bar), "r"(d));
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n"
                         ::"r"(dst), "f"(s), "r"(bar)
                         : "memory");
        }
        const unsigned b = static_cast<unsigned>(__cvta_generic_to_shared(bars + step));
        unsigned done = 0;
        while (!done) {
            asm volatile(
                "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                " selp.u32 %0, 1, 0, p;\n}\n"
                : "=r"(done)
                : "r"(b)
                : "memory");
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float pv[kMaxCluster];  // loaded together, added in rank order
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r) pv[r] = r < nct ? parts[step][r][k] : 0.f;
            float s = 0.f;
#pragma unroll
            for (int r = 0; r < kMaxCluster; ++r) s += pv[r];
            v[k] = s;
        }
    }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(gmem));
}

// Start the copies of samples [w_lo, w_hi) of a row (``nc`` floats a
// sample) into shared memory, 16 bytes at a time where both sides allow;
// returns the window's first sample.  The caller waits (cp.async.wait_all
// and a barrier) before reading it.
__device__ __forceinline__ const float* stage(float* smem, const float* row, int w_lo, int w_hi,
                                              int nc) {
    const float* g = row + static_cast<long>(w_lo) * nc;
    const int nw = (w_hi - w_lo) * nc;
    const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);  // g's float in its 16 bytes
    float* s = smem + sh;  // s and g share their alignment
    const int head = min((4 - sh) & 3, nw);
    const int n4 = (nw - head) >> 2;
    const int tid = threadIdx.x, bs = blockDim.x;
    for (int k = tid; k < head; k += bs) s[k] = g[k];
    for (int k = tid; k < n4; k += bs) cp_async16(s + head + 4 * k, g + head + 4 * k);
    for (int k = head + 4 * n4 + tid; k < nw; k += bs) s[k] = g[k];
    asm volatile("cp.async.commit_group;\n" ::);
    return s;
}

template <typename V, bool kCqpsk>
__global__ void __launch_bounds__(kMaxThreads)
timing_kernel(const V* __restrict__ rows_in, const float* __restrict__ st,
              const float2* __restrict__ om_tab, float* __restrict__ soft,
              unsigned char* __restrict__ dibits, float* __restrict__ out, int rows, int len,
              int n_sym, int mseg, int cap, Consts c) {
    extern __shared__ float4 smem4[];
    __shared__ float warps[kMaxWarps][kMaxVals];
    __shared__ float parts[kSteps][kMaxCluster][kMaxVals];
    __shared__ uint64_t bars[kSteps];
    STAMP(0);
    cg::cluster_group cluster = cg::this_cluster();
    const int nct = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    Reducer red{warps, parts, bars, nct, rank, false};
    const int r = blockIdx.x / nct;
    const int tid = threadIdx.x, bs = blockDim.x;
    const V* row = rows_in + static_cast<long long>(r) * len;

    const float pos = st[r], freq_in = st[rows + r], integ_in = st[2 * rows + r];
    const float s3 = st[3 * rows + r], s4 = st[4 * rows + r], s5 = st[5 * rows + r];
    const int n = len - kTail;
    const float hi = static_cast<float>(len - 2);
    float freq = freq_in < 1.f ? c.sps : freq_in;
    if (!kCqpsk) freq = clip(freq, c.fmin, c.fmax);
    auto base = [&](int m) { return __fadd_rn(pos, __fmul_rn(static_cast<float>(m), freq)); };
    const float pos_mod = floor_mod(__fsub_rn(pos, static_cast<float>(kTail)), c.sps);

    // this CTA's symbols, samples and window
    const int m0 = rank * mseg, m1 = min(n_sym, m0 + mseg);
    auto bound = [&](int m) {  // the row passes' cut before symbol m
        return static_cast<int>(fminf(fmaxf(floorf(base(m)), static_cast<float>(kTail)),
                                      static_cast<float>(len)));
    };
    const int b_lo = rank == 0 ? kTail : bound(m0);
    const int b_hi = rank == nct - 1 ? len : bound(m1);
    const float extra = __fadd_rn(__fadd_rn(c.half, 0.5f + kMargin), 0.0025f * static_cast<float>(n_sym));
    // (from symbol m0 - 1: CQPSK's detection gathers it again)
    const int g_lo = static_cast<int>(floorf(clip(__fsub_rn(base(max(m0 - 1, 0)), extra), 0.f, hi)));
    const int g_hi = static_cast<int>(floorf(clip(__fadd_rn(base(min(m1, n_sym - 1)), extra), 0.f, hi))) + 2;
    const int w_lo = min(b_lo, g_lo), w_hi = max(b_hi, g_hi);
    STAMP(1);
    const V* src = row;  // indexed by the row's sample
    const bool staged = w_hi - w_lo <= cap;
    if (staged) {
        const float* s = stage(reinterpret_cast<float*>(smem4), reinterpret_cast<const float*>(row),
                               w_lo, w_hi, sizeof(V) / sizeof(float));
        src = reinterpret_cast<const V*>(s) - w_lo;
    }
    constexpr int kVals[kSteps] = {kCqpsk ? 0 : 1, 5, 4, 2, 1};  // each step's sums
    red.init(kVals);  // while the window's copies land
    if (staged) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();
    }
    STAMP(2);

    // --- dc (C4FM)
    float dc0 = 0.f;
    if constexpr (!kCqpsk) {
        float v[1] = {0.f};
        for (int i = b_lo + tid; i < b_hi; i += bs) v[0] += src[i];
        red.sum<1>(v, 0);
        dc0 = __fadd_rn(__fmul_rn(s4, 0.9f), __fmul_rn(__fdiv_rn(v[0], static_cast<float>(n)), 0.1f));
    }
    STAMP(3);

    // --- the O&M line at the symbol rate over the two block halves
    const int half_n = n / 2;
    float om[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // a1r, a1i, a2r, a2i, den
    constexpr int kBatch = 4;  // a thread's samples whose loads go out together
    for (int i0 = b_lo + tid; i0 < b_hi; i0 += kBatch * bs) {
        V x[kBatch];
        float2 w[kBatch];  // (cos, sin) of -2 pi idx / sps
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int i = i0 + q * bs;
            if (i < b_hi) {
                x[q] = src[i];
                w[q] = __ldg(om_tab + (i - kTail));
            }
        }
#pragma unroll
        for (int q = 0; q < kBatch; ++q) {
            const int i = i0 + q * bs;
            if (i < b_hi) {
                float u;
                if constexpr (kCqpsk) {
                    u = power(x[q]);
                } else {
                    u = power(__fsub_rn(x[q], dc0));
                }
                const float ur = __fmul_rn(u, w[q].x), ui = __fmul_rn(u, w[q].y);
                if (i - kTail < half_n) {
                    om[0] += ur;
                    om[1] += ui;
                } else {
                    om[2] += ur;
                    om[3] += ui;
                }
                om[4] += fabsf(u);
            }
        }
    }
    red.sum<5>(om, 1);
    STAMP(4);
    const float a1r = om[0], a1i = om[1], a2r = om[2], a2i = om[3], den = om[4];
    const float sr = __fadd_rn(a1r, a2r), si = __fadd_rn(a1i, a2i);
    const float lock = __fdiv_rn(hypotf(sr, si), fmaxf(den, 1e-9f));
    // angle(A2 conj(A1))
    const float dre = __fadd_rn(__fmul_rn(a2r, a1r), __fmul_rn(a2i, a1i));
    const float dim = __fsub_rn(__fmul_rn(a2i, a1r), __fmul_rn(a2r, a1i));
    float slope = __fmul_rn(__fmul_rn(__fdiv_rn(atan2f(dim, dre), kTwoPi), c.sps),
                            __fdiv_rn(c.sps, static_cast<float>(max(half_n, 1))));
    slope = clip(slope, -0.005f, 0.005f);
    const float tau_om = __fmul_rn(__fdiv_rn(-atan2f(si, sr), kTwoPi), c.sps);
    const float delta_om =
        __fsub_rn(floor_mod(__fadd_rn(__fsub_rn(tau_om, pos_mod), c.half), c.sps), c.half);

    // --- phase: the block-averaged Gardner discriminant, two Newton steps
    const float half_freq = __fmul_rn(freq, 0.5f);
    auto at = [&](int m, float off) { return __fadd_rn(base(m), off); };
    auto sample = [&](float p) {
        V y = sample_at(src, p, hi);
        if constexpr (!kCqpsk) y = __fsub_rn(y, dc0);
        return y;
    };
    // this thread's terms of g(off): the numerator and the power
    auto terms = [&](float off, float& num, float& pw) {
        for (int m = m0 + tid; m < m1; m += bs) {
            const V y = sample(at(m, off));
            pw += power(y);
            if (m + 1 < n_sym) {
                const float pn = at(m + 1, off);
                num += gardner_term(sub(y, sample(pn)), sample(__fsub_rn(pn, half_freq)));
            }
        }
    };
    auto gardner = [&](float num, float pw) {
        const float g = __fdiv_rn(num, static_cast<float>(n_sym - 1));
        return __fdiv_rn(g, fmaxf(__fdiv_rn(pw, static_cast<float>(n_sym)), 1e-6f));
    };
    const float d0 = fabsf(delta_om) > 0.75f ? delta_om : 0.f;
    const float d1 = __fadd_rn(d0, 0.5f);
    float g01[4] = {0.f, 0.f, 0.f, 0.f};
    terms(d0, g01[0], g01[1]);
    terms(d1, g01[2], g01[3]);
    red.sum<4>(g01, 2);
    STAMP(5);
    const float g0 = gardner(g01[0], g01[1]), g1 = gardner(g01[2], g01[3]);
    const float k = __fdiv_rn(__fsub_rn(g1, g0), 0.5f);
    const bool ok = fabsf(k) > 1e-3f;
    float delta = clip(ok ? __fsub_rn(d0, __fdiv_rn(g0, k)) : d0, -c.half, c.half);
    float g2v[2] = {0.f, 0.f};
    terms(delta, g2v[0], g2v[1]);
    red.sum<2>(g2v, 3);
    STAMP(6);
    const float g2 = gardner(g2v[0], g2v[1]);
    delta = clip(ok ? __fsub_rn(delta, __fdiv_rn(g2, k)) : delta, -c.half, c.half);

    // dead-air gate: no spectral line -> freeze timing
    if (!(lock > c.lock)) {
        delta = 0.f;
        slope = 0.f;
    }
    const float integ = clip(
        __fadd_rn(__fadd_rn(integ_in, __fmul_rn(0.5f, slope)),
                  __fmul_rn(0.05f, __fdiv_rn(delta, static_cast<float>(max(n_sym, 1))))),
        c.integ_lo, c.integ_hi);
    const float freq_next = clip(__fadd_rn(c.sps, integ), c.fmin, c.fmax);

    // --- every symbol along the corrected ramp, then the gain or the bias
    const float mid = 0.5f * static_cast<float>(n_sym);
    auto symbol = [&](int m) {
        const float ramp =
            __fadd_rn(delta, __fmul_rn(slope, __fsub_rn(static_cast<float>(m), mid)));
        return sample(__fadd_rn(at(m, 0.f), ramp));
    };
    float* srow = soft + static_cast<long long>(r) * n_sym;
    unsigned char* drow = dibits + static_cast<long long>(r) * n_sym;
    const float pos_next = recenter(
        __fadd_rn(__fadd_rn(pos, delta), __fmul_rn(static_cast<float>(n_sym), freq_next)), len, c);
    float acc[1] = {0.f};
    if constexpr (!kCqpsk) {
        for (int m = m0 + tid; m < m1; m += bs) {
            const float y = symbol(m);
            srow[m] = y;  // the raw symbol until the gain is known
            acc[0] += fabsf(y);
            if (m == n_sym - 1) out[5 * rows + r] = y;
        }
        red.sum<1>(acc, 4);
        STAMP(7);
        const float scale = __fdiv_rn(2.f, fmaxf(__fdiv_rn(acc[0], static_cast<float>(n_sym)), 0.05f));
        float gain = s3 < 0.01f ? scale : __fadd_rn(__fmul_rn(0.95f, s3), __fmul_rn(0.05f, scale));
        gain = clip(gain, 0.05f, 40.f);
        for (int m = m0 + tid; m < m1; m += bs) {
            const float v = __fmul_rn(srow[m], gain);
            srow[m] = v;
            drow[m] = to_dibit(v);
        }
        if (rank == nct - 1 && tid == 0) {
            const float v[5] = {pos_next, freq_next, integ, gain, dc0};
            for (int q = 0; q < 5; ++q) out[q * rows + r] = v[q];
        }
    } else {
        const float2 prev = make_float2(s4, s5);
        for (int m = m0 + tid; m < m1; m += bs) {
            const float2 s = symbol(m);
            const float2 p = m > 0 ? symbol(m - 1) : prev;
            const float zr = __fadd_rn(__fmul_rn(s.x, p.x), __fmul_rn(s.y, p.y));
            const float zi = __fsub_rn(__fmul_rn(s.y, p.x), __fmul_rn(s.x, p.y));
            const float d = atan2f(zi, zr);
            srow[m] = d;  // the phase step until the bias is known
            const float q = clip(rintf(__fdiv_rn(__fsub_rn(d, s3), kQuarterPi)), -3.f, 3.f);
            acc[0] += __fsub_rn(__fsub_rn(d, s3), __fmul_rn(q, kQuarterPi));
            if (m == n_sym - 1) {
                out[4 * rows + r] = s.x;
                out[5 * rows + r] = s.y;
            }
        }
        red.sum<1>(acc, 4);
        STAMP(7);
        const float bias = __fadd_rn(s3, __fmul_rn(0.02f, __fdiv_rn(acc[0], static_cast<float>(n_sym))));
        for (int m = m0 + tid; m < m1; m += bs) {
            const float v = __fdiv_rn(__fsub_rn(srow[m], bias), kQuarterPi);
            srow[m] = v;
            drow[m] = to_dibit(v);
        }
        if (rank == nct - 1 && tid == 0) {
            const float v[4] = {pos_next, freq_next, integ, bias};
            for (int q = 0; q < 4; ++q) out[q * rows + r] = v[q];
        }
    }
    STAMP(8);
}

template <typename V, bool kCqpsk>
int launch_timing(const void* buf, const void* st, const void* om_tab, void* soft, void* dibits,
                  void* out, int rows, int len, int n_sym, Consts c, int mseg, int cluster,
                  int threads, int cap, void* stream) {
    if (rows <= 0) return 0;
    if (len < 2 || n_sym < 2 || mseg < 1 || cluster < 1 || cluster > kMaxCluster ||
        threads < 32 || threads > kMaxThreads || threads % 32 || cap < 0 ||
        static_cast<long>(mseg) * (cluster - 1) >= n_sym ||
        static_cast<long>(mseg) * cluster < n_sym)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = cap ? sizeof(V) * static_cast<size_t>(cap) + 16 : 0;
    cudaError_t err = cudaFuncSetAttribute(timing_kernel<V, kCqpsk>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * static_cast<unsigned>(cluster));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, timing_kernel<V, kCqpsk>, static_cast<const V*>(buf),
                             static_cast<const float*>(st), static_cast<const float2*>(om_tab),
                             static_cast<float*>(soft),
                             static_cast<unsigned char*>(dibits), static_cast<float*>(out), rows,
                             len, n_sym, mseg, cap, c);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if K12_CLOCKS
WAVECAP_EXPORT int k12_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_k12_clocks, sizeof(g_k12_clocks)));
}
#endif

// The plan (models/p25/c4fm.py:k12_plan) comes in as it is: ``mseg``
// symbols a CTA, ``cluster`` CTAs a row, ``threads`` a CTA (a multiple of
// 32), ``cap`` samples of window a CTA (0: no window is staged).  What the
// kernel cannot take is refused here, before a launch.
WAVECAP_EXPORT int k12_c4fm_timing(const void* buf, const void* st, const void* om_tab, void* soft,
                                   void* dibits,
                                   void* out, int rows, int len, int n_sym, float sps,
                                   float fmin, float fmax, float integ_lo, float integ_hi,
                                   float half, float recenter_hi, float lock, int mseg,
                                   int cluster, int threads, int cap, void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_timing<float, false>(buf, st, om_tab, soft, dibits, out, rows, len, n_sym, c, mseg,
                                       cluster, threads, cap, stream);
}

WAVECAP_EXPORT int k13_cqpsk_timing(const void* buf, const void* st, const void* om_tab, void* soft,
                                    void* dibits,
                                    void* out, int rows, int len, int n_sym, float sps,
                                    float fmin, float fmax, float integ_lo, float integ_hi,
                                    float half, float recenter_hi, float lock, int mseg,
                                    int cluster, int threads, int cap, void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_timing<float2, true>(buf, st, om_tab, soft, dibits, out, rows, len, n_sym, c, mseg,
                                       cluster, threads, cap, stream);
}
