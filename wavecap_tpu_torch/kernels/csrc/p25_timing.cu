// K12 and K13 (timing): the P25 block timing recovery, one CTA per slot.
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
// 3.35 TB/s); the ~50 MFLOP of cosf/sinf and gathers take ~1 us at
// 67 TFLOP/s.  What bounds it is the chain of ten dependent block-wide
// reductions per row (dc, the O&M line, three Gardner evaluations, the
// gain or the bias), each a pass over the row or the symbols and two
// barriers, with one CTA per row: 21-50 CTAs on 132 SMs.  Design: the row
// (50 KB real, 60 KB complex) and the symbols live in shared memory, so
// every pass after the first reads on-chip; each reduction's scalar
// result is broadcast to every thread, which then computes the next step
// redundantly instead of waiting on a single thread.
#include "p25_common.cuh"

namespace {

using namespace p25;

constexpr int kThreads = 512;
constexpr float kNegTwoPi = static_cast<float>(-6.283185307179586);
constexpr float kTwoPi = static_cast<float>(6.283185307179586);

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

template <typename V, bool kCqpsk>
__global__ void __launch_bounds__(kThreads)
timing_kernel(const V* __restrict__ rows_in, const float* __restrict__ st, float* __restrict__ soft,
              unsigned char* __restrict__ dibits, float* __restrict__ out, int rows, int len,
              int n_sym, Consts c) {
    extern __shared__ float smem[];
    __shared__ float scratch[32];
    V* buf = reinterpret_cast<V*>(smem);
    V* sym = buf + len;
    float* dph = reinterpret_cast<float*>(sym + n_sym);  // CQPSK's phase steps
    const int r = blockIdx.x;
    const int tid = threadIdx.x, bs = blockDim.x;
    const V* src = rows_in + static_cast<long long>(r) * len;
    for (int i = tid; i < len; i += bs) buf[i] = src[i];
    __syncthreads();

    const float pos = st[r], freq_in = st[rows + r], integ_in = st[2 * rows + r];
    const float s3 = st[3 * rows + r], s4 = st[4 * rows + r], s5 = st[5 * rows + r];
    const int n = len - kTail;
    const float hi = static_cast<float>(len - 2);
    float freq = freq_in < 1.f ? c.sps : freq_in;
    if (!kCqpsk) freq = clip(freq, c.fmin, c.fmax);

    // --- dc (C4FM)
    float dc0 = 0.f;
    if constexpr (!kCqpsk) {
        float s = 0.f;
        for (int i = tid; i < n; i += bs) s += buf[kTail + i];
        s = block_sum(s, scratch);
        dc0 = __fadd_rn(__fmul_rn(s4, 0.9f), __fmul_rn(__fdiv_rn(s, static_cast<float>(n)), 0.1f));
    }

    // --- the O&M line at the symbol rate over the two block halves
    const int half_n = n / 2;
    float a1r = 0.f, a1i = 0.f, a2r = 0.f, a2i = 0.f, den = 0.f;
    for (int i = tid; i < n; i += bs) {
        float u;
        if constexpr (kCqpsk) {
            u = power(buf[kTail + i]);
        } else {
            u = power(__fsub_rn(buf[kTail + i], dc0));
        }
        const float ang = __fdiv_rn(__fmul_rn(kNegTwoPi, static_cast<float>(i)), c.sps);
        const float ur = __fmul_rn(u, cosf(ang)), ui = __fmul_rn(u, sinf(ang));
        if (i < half_n) {
            a1r += ur;
            a1i += ui;
        } else {
            a2r += ur;
            a2i += ui;
        }
        den += fabsf(u);
    }
    a1r = block_sum(a1r, scratch);
    a1i = block_sum(a1i, scratch);
    a2r = block_sum(a2r, scratch);
    a2i = block_sum(a2i, scratch);
    den = block_sum(den, scratch);
    const float sr = __fadd_rn(a1r, a2r), si = __fadd_rn(a1i, a2i);
    const float lock = __fdiv_rn(hypotf(sr, si), fmaxf(den, 1e-9f));
    // angle(A2 conj(A1))
    const float dre = __fadd_rn(__fmul_rn(a2r, a1r), __fmul_rn(a2i, a1i));
    const float dim = __fsub_rn(__fmul_rn(a2i, a1r), __fmul_rn(a2r, a1i));
    float slope = __fmul_rn(__fmul_rn(__fdiv_rn(atan2f(dim, dre), kTwoPi), c.sps),
                            __fdiv_rn(c.sps, static_cast<float>(max(half_n, 1))));
    slope = clip(slope, -0.005f, 0.005f);
    const float tau_om = __fmul_rn(__fdiv_rn(-atan2f(si, sr), kTwoPi), c.sps);
    const float pos_mod = floor_mod(__fsub_rn(pos, static_cast<float>(kTail)), c.sps);
    const float delta_om =
        __fsub_rn(floor_mod(__fadd_rn(__fsub_rn(tau_om, pos_mod), c.half), c.sps), c.half);

    // --- phase: the block-averaged Gardner discriminant, two Newton steps
    const float half_freq = __fmul_rn(freq, 0.5f);
    auto at = [&](int m, float off) {
        return __fadd_rn(__fadd_rn(pos, __fmul_rn(static_cast<float>(m), freq)), off);
    };
    auto sample = [&](float p) {
        V y = sample_at(buf, p, hi);
        if constexpr (!kCqpsk) y = __fsub_rn(y, dc0);
        return y;
    };
    auto gardner = [&](float off) {
        float num = 0.f, pw = 0.f;
        for (int m = tid; m < n_sym; m += bs) {
            const V y = sample(at(m, off));
            pw += power(y);
            if (m + 1 < n_sym) {
                const float pn = at(m + 1, off);
                num += gardner_term(sub(y, sample(pn)), sample(__fsub_rn(pn, half_freq)));
            }
        }
        num = block_sum(num, scratch);
        pw = block_sum(pw, scratch);
        const float g = __fdiv_rn(num, static_cast<float>(n_sym - 1));
        return __fdiv_rn(g, fmaxf(__fdiv_rn(pw, static_cast<float>(n_sym)), 1e-6f));
    };
    const float d0 = fabsf(delta_om) > 0.75f ? delta_om : 0.f;
    const float g0 = gardner(d0);
    const float g1 = gardner(__fadd_rn(d0, 0.5f));
    const float k = __fdiv_rn(__fsub_rn(g1, g0), 0.5f);
    const bool ok = fabsf(k) > 1e-3f;
    float delta = clip(ok ? __fsub_rn(d0, __fdiv_rn(g0, k)) : d0, -c.half, c.half);
    const float g2 = gardner(delta);
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

    // --- every symbol along the corrected ramp
    const float mid = 0.5f * static_cast<float>(n_sym);
    for (int m = tid; m < n_sym; m += bs) {
        const float ramp =
            __fadd_rn(delta, __fmul_rn(slope, __fsub_rn(static_cast<float>(m), mid)));
        sym[m] = sample(__fadd_rn(at(m, 0.f), ramp));
    }
    __syncthreads();

    const float pos_next = recenter(
        __fadd_rn(__fadd_rn(pos, delta), __fmul_rn(static_cast<float>(n_sym), freq_next)), len, c);
    float* srow = soft + static_cast<long long>(r) * n_sym;
    unsigned char* drow = dibits + static_cast<long long>(r) * n_sym;
    float vals[6];
    if constexpr (!kCqpsk) {
        const float gain = c4fm_gain(sym, n_sym, s3, srow, drow, scratch);
        const float v[6] = {pos_next, freq_next, integ, gain, dc0, sym[n_sym - 1]};
        for (int q = 0; q < 6; ++q) vals[q] = v[q];
    } else {
        const float bias = cqpsk_detect(sym, dph, n_sym, make_float2(s4, s5), s3, srow, drow, scratch);
        const float2 last = sym[n_sym - 1];
        const float v[6] = {pos_next, freq_next, integ, bias, last.x, last.y};
        for (int q = 0; q < 6; ++q) vals[q] = v[q];
    }
    if (tid == 0) {
        for (int q = 0; q < 6; ++q) out[q * rows + r] = vals[q];
    }
}

template <typename V, bool kCqpsk>
int launch_timing(const void* buf, const void* st, void* soft, void* dibits, void* out, int rows,
                  int len, int n_sym, Consts c, void* stream) {
    if (rows <= 0) return 0;
    const size_t smem = sizeof(V) * (static_cast<size_t>(len) + n_sym) +
                        (kCqpsk ? sizeof(float) * static_cast<size_t>(n_sym) : 0);
    cudaError_t err = cudaFuncSetAttribute(timing_kernel<V, kCqpsk>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    timing_kernel<V, kCqpsk><<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(buf), static_cast<const float*>(st), static_cast<float*>(soft),
        static_cast<unsigned char*>(dibits), static_cast<float*>(out), rows, len, n_sym, c);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WAVECAP_EXPORT int k12_c4fm_timing(const void* buf, const void* st, void* soft, void* dibits,
                                   void* out, int rows, int len, int n_sym, float sps,
                                   float fmin, float fmax, float integ_lo, float integ_hi,
                                   float half, float recenter_hi, float lock, void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_timing<float, false>(buf, st, soft, dibits, out, rows, len, n_sym, c, stream);
}

WAVECAP_EXPORT int k13_cqpsk_timing(const void* buf, const void* st, void* soft, void* dibits,
                                    void* out, int rows, int len, int n_sym, float sps,
                                    float fmin, float fmax, float integ_lo, float integ_hi,
                                    float half, float recenter_hi, float lock, void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_timing<float2, true>(buf, st, soft, dibits, out, rows, len, n_sym, c, stream);
}
