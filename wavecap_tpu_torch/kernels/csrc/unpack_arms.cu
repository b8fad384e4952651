// K1: packed-word unpack fused with the channelizer's polyphase arms.
//
// Replaces wavecap_tpu/capture/pipeline.py:_to_complex (its three word
// branches: int32 words of i16 pairs scaled 1/32768; int16 words of i8
// pairs and int8 words of i4 nibble pairs, each times the block's f32
// scale, which the kernel reads from device memory) fused with the
// parity_stack inner function of wavecap_tpu/ops/channelizer.py:channelize.  With x_ext = [history || x]
// (history = the last M*T samples of the stream), it writes both parity
// stacks of the NMDPFB:
//
//   u[p, r, c] = sum_{k<T} arms_rev[k, c] * x_ext[off_p + (r + T-1-k)*M + c],
//   off_0 = 1, off_1 = 1 + M/2,
//
// summed in the reference's tap order, and (for word input) the unpacked
// complex block, which the spectrum, the whole-block RSSI and the next
// history read.  Complex input (a caller that already holds complex64
// samples) takes the same kernel without the unpack and without x_out.
//
// Bound on the H100: bytes.  At the slice's shapes (N = 1,968,000 words,
// M = 800, T = 9) it reads 7.9 MB of words and writes 31.5 MB of arms and
// 15.7 MB of samples, against ~0.14 GFLOP.  Design: one thread per
// (parity, channel column), walking a run of rows, so a warp reads and
// writes consecutive columns (coalesced); the T-fold reuse of each sample
// across rows is served from L1/L2, not from device memory.
#include "common.cuh"

namespace {

struct WordSource {
    const int32_t* w;
    __device__ __forceinline__ float2 operator()(long i) const {
        const int32_t v = w[i];
        // low half sign-extended by masking, high half by arithmetic shift
        const float re = static_cast<float>(((v & 0xFFFF) ^ 0x8000) - 0x8000);
        const float im = static_cast<float>(v >> 16);
        return make_float2(re * (1.0f / 32768.0f), im * (1.0f / 32768.0f));
    }
};

// adaptive i8: low byte I, high byte Q (little-endian), times the scale
struct I8Source {
    const int16_t* w;
    const float* scale;
    __device__ __forceinline__ float2 operator()(long i) const {
        const int v = w[i];
        const float s = *scale;
        const float re = static_cast<float>(((v & 0xFF) ^ 0x80) - 0x80);
        const float im = static_cast<float>(v >> 8);
        return make_float2(re * s, im * s);
    }
};

// adaptive i4: low nibble I, high nibble Q, times the scale
struct I4Source {
    const int8_t* w;
    const float* scale;
    __device__ __forceinline__ float2 operator()(long i) const {
        const int v = w[i];
        const float s = *scale;
        const float re = static_cast<float>(((v & 0xF) ^ 0x8) - 0x8);
        const float im = static_cast<float>(v >> 4);
        return make_float2(re * s, im * s);
    }
};

struct ComplexSource {
    const float2* x;
    __device__ __forceinline__ float2 operator()(long i) const { return x[i]; }
};

template <class Source>
__global__ void unpack_arms_kernel(Source src, const float2* __restrict__ hist,
                                   const float* __restrict__ arms_rev,
                                   float2* __restrict__ u, float2* __restrict__ x_out,
                                   int m, int t, int r_steps, int rows_per_block) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= m) return;
    const int p = blockIdx.z;
    const long h = static_cast<long>(m) * t;
    const long off = 1 + (p ? m / 2 : 0);
    const int r0 = blockIdx.y * rows_per_block;
    const int r1 = min(r0 + rows_per_block, r_steps);
    for (int r = r0; r < r1; ++r) {
        float2 acc = make_float2(0.f, 0.f);
        for (int k = 0; k < t; ++k) {
            const long i = off + static_cast<long>(r + t - 1 - k) * m + c;
            const float2 s = i < h ? hist[i] : src(i - h);
            const float a = arms_rev[k * m + c];
            acc.x += s.x * a;
            acc.y += s.y * a;
        }
        u[(static_cast<long>(p) * r_steps + r) * m + c] = acc;
        if (x_out != nullptr && p == 0) {
            const long j = static_cast<long>(r) * m + c;
            x_out[j] = src(j);
        }
    }
}

// Threads per block along the channel axis: a multiple of 32 that tiles
// ceil(m/32) warps evenly where it can (160 for m = 800), at most 256.
int column_threads(int m) {
    const int warps = (m + 31) / 32;
    for (int d = 8; d > 1; --d)
        if (warps % d == 0) return 32 * d;
    return 32 * (warps < 8 ? warps : 8);
}

}  // namespace

template <class Source>
void launch_arms(Source src, const void* hist, const void* arms_rev, void* u, void* x_out, int m,
                 int t, int r_steps, cudaStream_t s) {
    const int rows_per_block = 8;
    const int threads = column_threads(m);
    const dim3 grid((m + threads - 1) / threads, (r_steps + rows_per_block - 1) / rows_per_block, 2);
    unpack_arms_kernel<<<grid, threads, 0, s>>>(
        src, static_cast<const float2*>(hist), static_cast<const float*>(arms_rev),
        static_cast<float2*>(u), static_cast<float2*>(x_out), m, t, r_steps, rows_per_block);
}

// kind: 0 complex64 samples (no x_out), 1 int32 i16-pair words, 2 int16
// i8-pair words, 3 int8 i4-nibble words (2 and 3 read ``scale``)
WAVECAP_EXPORT int k1_unpack_arms(const void* src, int kind, const void* scale, const void* hist,
                                  const void* arms_rev, void* u, void* x_out, int m, int t,
                                  int r_steps, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sc = static_cast<const float*>(scale);
    switch (kind) {
        case 0:
            launch_arms(ComplexSource{static_cast<const float2*>(src)}, hist, arms_rev, u, nullptr,
                        m, t, r_steps, s);
            break;
        case 1:
            launch_arms(WordSource{static_cast<const int32_t*>(src)}, hist, arms_rev, u, x_out, m,
                        t, r_steps, s);
            break;
        case 2:
            launch_arms(I8Source{static_cast<const int16_t*>(src), sc}, hist, arms_rev, u, x_out, m,
                        t, r_steps, s);
            break;
        case 3:
            launch_arms(I4Source{static_cast<const int8_t*>(src), sc}, hist, arms_rev, u, x_out, m,
                        t, r_steps, s);
            break;
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
