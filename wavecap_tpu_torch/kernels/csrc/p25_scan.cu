// K12s and K13s: the P25 per-symbol Gardner timing scans, one CTA per slot.
//
// Replaces the scan branch of wavecap_tpu/models/p25/c4fm.py:c4fm_demodulate
// (the step at c4fm.py:281-290, its lax.scan at :294, then the gain EMA
// and recentring at :299-320; K12s, real rows) and of
// models/p25/cqpsk.py:cqpsk_demodulate (the loop gains and `step` at
// cqpsk.py:346-373, the scan at :453-457, then the differential detector
// and bias tracker at :459-470 shared with the block branch; K13s,
// complex rows).  Per row, over buf = interp_tail (64) ++ filt (n) and the
// carried (pos, freq, integrator, gain or bias, dc or -, prev):
//
//   C4FM:  dc0 = dc 0.9 + mean(filt) 0.1 and amp = 2 / max(gain, 0.05)
//          (2 on the first block); per symbol
//            y   = interp(pos) - dc0,  ym = interp(pos - freq / 2) - dc0
//            err = clip((prev - y) ym / amp^2, +-2)
//   CQPSK: freq0 = sps on the first block; per symbol
//            y   = interp(pos),        ym = interp(pos - freq / 2)
//            err = clip(Re(conj(ym) (prev - y)), +-2)
//   both:  integ = clip(integ + beta err, fmin - sps, fmax - sps)
//          freq  = clip(sps + integ, fmin, fmax)
//          pos   = pos + freq + alpha err,  prev = y
//
// then C4FM's block gain EMA, or CQPSK's detector, soft symbols and
// dibits, and the next position recentred by a whole symbol.  C4FM's
// dc0 comes in from torch (its mean(filt) in the plain version's
// summation order: every symbol reads it, and an ulp would walk the loop
// apart); the mean |raw| of the gain and the detector's bias are fused.
// interp(p) copies jax.lax.dynamic_slice(buf, (i0,), (2,)): the start is
// clamped to [0, len - 2] while the fraction uses the unclamped floor.
// Every step of the loop is __f*_rn, so nvcc does not contract it into
// FMAs the plain version does not have: each symbol's error moves the
// next position, and one ulp would walk.
//
// Bound on the H100: the serial chain.  Program A's bank (50 rows x 12,564
// f32 in, 1,200 symbols) moves ~2.8 MB (~0.8 us at 3.35 TB/s) and does
// ~60 flops a symbol; but each symbol's two reads depend on the position
// the previous one moved: ~130 SM cycles a symbol (floor, clamp, address,
// two shared-memory loads, the lerps, the IEEE division and four clips),
// ~0.08 ms at 1,200 symbols and 1.98 GHz whatever the row count.  Design:
// one CTA a row, its threads stage the row in shared memory (50 KB real,
// 61 KB complex; rows past the limit are read from global memory) and take
// the block epilogue (mean|raw| and the gain, or the detector); one thread
// walks the symbols.  50 rows fill 50 of 132 SMs: the rows run side by
// side, the chain of one is the time.
#include "p25_common.cuh"

namespace {

using namespace p25;

constexpr int kThreads = 256;

template <typename V>
__device__ __forceinline__ V interp(const V* buf, float pos, int last) {
    const float f = floorf(pos);
    const float fr = __fsub_rn(pos, f);
    const int i0 = static_cast<int>(clip(f, 0.f, static_cast<float>(last)));
    return lerp(buf[i0], buf[i0 + 1], fr);
}

__device__ __forceinline__ float c4fm_error(float y, float ym, float prev, float den) {
    return clip(__fdiv_rn(__fmul_rn(__fsub_rn(prev, y), ym), den), -2.f, 2.f);
}

__device__ __forceinline__ float cqpsk_error(float2 y, float2 ym, float2 prev) {
    const float2 d = sub(prev, y);
    return clip(__fadd_rn(__fmul_rn(ym.x, d.x), __fmul_rn(ym.y, d.y)), -2.f, 2.f);
}

template <typename V, bool kCqpsk>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const V* __restrict__ rows_in, const float* __restrict__ st,
            const float* __restrict__ dc_in, float* __restrict__ soft,
            unsigned char* __restrict__ dibits, float* __restrict__ out, int rows, int len,
            int n_sym, int staged, Consts c, float alpha, float beta) {
    extern __shared__ float smem[];
    __shared__ float scratch[32];
    __shared__ float carry[3];
    V* row = reinterpret_cast<V*>(smem);
    V* sym = row + (staged ? len : 0);
    float* dph = reinterpret_cast<float*>(sym + n_sym);  // CQPSK's phase steps
    const int r = blockIdx.x;
    const int tid = threadIdx.x, bs = blockDim.x;
    const V* src = rows_in + static_cast<long long>(r) * len;
    const V* buf = src;
    if (staged) {
        for (int i = tid; i < len; i += bs) row[i] = src[i];
        buf = row;
    }
    float pos = st[r], freq = st[rows + r], integ = st[2 * rows + r];
    const float s3 = st[3 * rows + r], s4 = st[4 * rows + r], s5 = st[5 * rows + r];
    const int last = len - 2;
    const float dc0 = kCqpsk ? 0.f : dc_in[r];
    if (kCqpsk && freq < 1.f) freq = c.sps;
    __syncthreads();  // publishes the staged row

    if (tid == 0) {
        if constexpr (!kCqpsk) {
            const float amp = s3 < 0.01f ? 2.f : __fdiv_rn(2.f, fmaxf(s3, 0.05f));
            const float den = __fmul_rn(amp, amp);
            float prev = s5;
            for (int m = 0; m < n_sym; ++m) {
                const float y = __fsub_rn(interp(buf, pos, last), dc0);
                const float ym = __fsub_rn(interp(buf, __fsub_rn(pos, __fmul_rn(freq, 0.5f)), last), dc0);
                const float err = c4fm_error(y, ym, prev, den);
                integ = clip(__fadd_rn(integ, __fmul_rn(beta, err)), c.integ_lo, c.integ_hi);
                freq = clip(__fadd_rn(c.sps, integ), c.fmin, c.fmax);
                pos = __fadd_rn(__fadd_rn(pos, freq), __fmul_rn(alpha, err));
                prev = y;
                sym[m] = y;
            }
        } else {
            float2 prev = make_float2(s4, s5);
            for (int m = 0; m < n_sym; ++m) {
                const float2 y = interp(buf, pos, last);
                const float2 ym = interp(buf, __fsub_rn(pos, __fmul_rn(freq, 0.5f)), last);
                const float err = cqpsk_error(y, ym, prev);
                integ = clip(__fadd_rn(integ, __fmul_rn(beta, err)), c.integ_lo, c.integ_hi);
                freq = clip(__fadd_rn(c.sps, integ), c.fmin, c.fmax);
                pos = __fadd_rn(__fadd_rn(pos, freq), __fmul_rn(alpha, err));
                prev = y;
                sym[m] = y;
            }
        }
        carry[0] = pos;
        carry[1] = freq;
        carry[2] = integ;
    }
    __syncthreads();

    float* srow = soft + static_cast<long long>(r) * n_sym;
    unsigned char* drow = dibits + static_cast<long long>(r) * n_sym;
    const float pos_next = recenter(carry[0], len, c);
    float vals[6];
    if constexpr (!kCqpsk) {
        const float gain = c4fm_gain(sym, n_sym, s3, srow, drow, scratch);
        const float v[6] = {pos_next, carry[1], carry[2], gain, dc0, sym[n_sym - 1]};
        for (int q = 0; q < 6; ++q) vals[q] = v[q];
    } else {
        const float bias = cqpsk_detect(sym, dph, n_sym, make_float2(s4, s5), s3, srow, drow, scratch);
        const float2 y_last = sym[n_sym - 1];
        const float v[6] = {pos_next, carry[1], carry[2], bias, y_last.x, y_last.y};
        for (int q = 0; q < 6; ++q) vals[q] = v[q];
    }
    if (tid == 0) {
        for (int q = 0; q < 6; ++q) out[q * rows + r] = vals[q];
    }
}

template <typename V, bool kCqpsk>
int launch_scan(const void* buf, const void* st, const void* dc, void* soft, void* dibits, void* out,
                int rows, int len, int n_sym, int staged, Consts c, float alpha, float beta,
                void* stream) {
    if (rows <= 0) return 0;
    const size_t smem = sizeof(V) * ((staged ? static_cast<size_t>(len) : 0) + n_sym) +
                        (kCqpsk ? sizeof(float) * static_cast<size_t>(n_sym) : 0);
    cudaError_t err = cudaFuncSetAttribute(scan_kernel<V, kCqpsk>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_kernel<V, kCqpsk><<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const V*>(buf), static_cast<const float*>(st), static_cast<const float*>(dc),
        static_cast<float*>(soft), static_cast<unsigned char*>(dibits), static_cast<float*>(out), rows,
        len, n_sym, staged, c, alpha, beta);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WAVECAP_EXPORT int k12s_c4fm_scan(const void* buf, const void* st, const void* dc, void* soft,
                                  void* dibits, void* out, int rows, int len, int n_sym, int staged,
                                  float sps,
                                  float fmin, float fmax, float integ_lo, float integ_hi, float half,
                                  float recenter_hi, float lock, float alpha, float beta,
                                  void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_scan<float, false>(buf, st, dc, soft, dibits, out, rows, len, n_sym, staged, c,
                                     alpha, beta, stream);
}

WAVECAP_EXPORT int k13s_cqpsk_scan(const void* buf, const void* st, const void* dc, void* soft,
                                   void* dibits, void* out, int rows, int len, int n_sym, int staged,
                                   float sps,
                                   float fmin, float fmax, float integ_lo, float integ_hi,
                                   float half, float recenter_hi, float lock, float alpha,
                                   float beta, void* stream) {
    const Consts c{sps, fmin, fmax, integ_lo, integ_hi, half, recenter_hi, lock};
    return launch_scan<float2, true>(buf, st, dc, soft, dibits, out, rows, len, n_sym, staged, c,
                                     alpha, beta, stream);
}
