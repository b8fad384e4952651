// K3: the per-slot front end of the channel bank.
//
// Replaces the per_slot function of
// wavecap_tpu/models/channel_bank.py:bank_demod_step up to the demod's
// audio filter: the gather of the slot's channelizer row,
// wavecap_tpu/ops/nco.py:freq_shift (exact uint32 NCO), ops/clip.py:rssi_dbfs
// and ops/demod.py:quadrature_demod (mode 1: fast_atan2; mode 0: atan2f).
// Mode 2 writes the shifted rows themselves (complex) and skips the
// discriminator: the AM, SSB and SAM banks detect from them.
// Per slot s, over its row x of S samples:
//
//   acc[n]   = phase0 + n * dphi                   (uint32, wraps mod 2^32)
//   y[n]     = x[n] * (cos, sin)(float(acc[n]) * 2 pi / 2^32)
//   rssi     = 10 log10(max(mean |y|^2, 1e-20))
//   fm[n]    = atan2(Im(y[n] y*[n-1]), Re(...)) * fs / (2 pi dev),  y[-1] = prev
//   phase1   = phase0 + S * dphi,  last = y[S-1]   (modes 0 and 1)
//   rows[n]  = y[n]                               (mode 2)
//
// The tuning word dphi is computed per slot on the host side in torch
// (the reference's hi/lo f32 split), so accumulators match bit for bit.
//
// Bound on the H100: bytes.  At 800 slots x 4,920 samples it reads 31.5 MB
// of channel rows and writes 15.7 MB of discriminator output (~14 us at
// 3.35 TB/s); the arithmetic (~32 flops a sample with cosf and sinf counted
// once each) is a few microseconds.  Mode 2 writes 31.5 MB instead.
// Design: one block per slot; the mixed row is kept in shared memory
// (39 KB) so the discriminator reads its neighbour there, and the power is
// a block reduction.
#include "common.cuh"

namespace {

__device__ __forceinline__ float fast_atan2(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const float a = lo / fmaxf(hi, 1e-30f);
    const float s = a * a;
    float r = ((-0.0464964749f * s + 0.15931422f) * s - 0.327622764f) * s * a + a;
    if (ay > ax) r = static_cast<float>(3.141592653589793 / 2) - r;
    if (x < 0.f) r = static_cast<float>(3.141592653589793) - r;
    return y < 0.f ? -r : r;
}

__global__ void slot_frontend_kernel(const float2* __restrict__ chans,
                                     const int* __restrict__ index,
                                     const unsigned* __restrict__ dphi,
                                     const unsigned* __restrict__ phase0,
                                     const float2* __restrict__ prev, float* __restrict__ fm,
                                     float* __restrict__ rssi, unsigned* __restrict__ phase1,
                                     float2* __restrict__ last, int m, int s_len, float scale,
                                     int mode) {
    extern __shared__ float2 y[];
    __shared__ float scratch[32];
    const int slot = blockIdx.x;
    // out-of-range bins clamp, as the reference's gather does
    const int row = min(max(index[slot], 0), m - 1);
    const float2* x = chans + static_cast<long>(row) * s_len;
    const unsigned d = dphi[slot], p0 = phase0[slot];
    const float rad_per_count = static_cast<float>(6.283185307179586 / 4294967296.0);

    float power = 0.f;
    for (int n = threadIdx.x; n < s_len; n += blockDim.x) {
        const unsigned acc = p0 + static_cast<unsigned>(n) * d;
        const float ph = __uint2float_rn(acc) * rad_per_count;
        const float c = cosf(ph), s = sinf(ph);
        const float2 v = x[n];
        const float2 w = make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
        if (mode == 2) {
            reinterpret_cast<float2*>(fm)[static_cast<long>(slot) * s_len + n] = w;
        } else {
            y[n] = w;
        }
        power += w.x * w.x + w.y * w.y;
    }
    power = block_sum(power, scratch);  // its barrier also publishes y
    if (mode == 2) {
        if (threadIdx.x == 0) {
            rssi[slot] = 10.f * log10f(fmaxf(power / static_cast<float>(s_len), 1e-20f));
            phase1[slot] = p0 + static_cast<unsigned>(s_len) * d;
        }
        return;
    }

    float* out = fm + static_cast<long>(slot) * s_len;
    const float2 before = prev[slot];
    for (int n = threadIdx.x; n < s_len; n += blockDim.x) {
        const float2 a = y[n];
        const float2 b = n > 0 ? y[n - 1] : before;
        const float re = a.x * b.x + a.y * b.y;
        const float im = a.y * b.x - a.x * b.y;
        out[n] = (mode == 1 ? fast_atan2(im, re) : atan2f(im, re)) * scale;
    }
    if (threadIdx.x == 0) {
        rssi[slot] = 10.f * log10f(fmaxf(power / static_cast<float>(s_len), 1e-20f));
        phase1[slot] = p0 + static_cast<unsigned>(s_len) * d;
        last[slot] = s_len > 0 ? y[s_len - 1] : before;
    }
}

}  // namespace

WAVECAP_EXPORT int k3_slot_frontend(const void* chans, const void* index, const void* dphi,
                                    const void* phase0, const void* prev, void* fm,
                                    void* rssi, void* phase1, void* last, int n_slots, int m,
                                    int s_len, float scale, int mode, void* stream) {
    if (mode < 0 || mode > 2) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = mode == 2 ? 0 : sizeof(float2) * static_cast<size_t>(s_len);
    cudaError_t err = cudaFuncSetAttribute(
        slot_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    slot_frontend_kernel<<<n_slots, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(chans), static_cast<const int*>(index),
        static_cast<const unsigned*>(dphi), static_cast<const unsigned*>(phase0),
        static_cast<const float2*>(prev), static_cast<float*>(fm), static_cast<float*>(rssi),
        static_cast<unsigned*>(phase1), static_cast<float2*>(last), m, s_len, scale, mode);
    return static_cast<int>(cudaGetLastError());
}
