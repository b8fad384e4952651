// K2: the channelizer's cross-arm DFT with its epilogue.
//
// Replaces wavecap_tpu/ops/planar.py:planar_factored_dft (and, with
// m1 = 1, planar_matmul_dft) together with the tail of
// wavecap_tpu/ops/channelizer.py:channelize.  For every output step of
// both parity stacks u[p, r, :] (M = m1*m2 arms) it computes
//
//   stage 1   A[c1, k2] = sum_k1 x[k1*m2 + k2] * W1[k1, c1]     (m1-point DFT)
//   twiddle   B[c1, k2] = A[c1, k2] * TW[c1, k2]
//   stage 2   Y[c1 + m1*c2] = sum_k2 B[c1, k2] * W2[k2, c2]      (m2-point DFT)
//   epilogue  y[c] = Y[c] * e^{-2 pi i c / M}, times (-1)^c on odd steps,
//
// and writes out[c, 2r + p]: the two stacks interleaved and transposed to
// (M, S).  The tables are the reference's f32 tables (cos and sin planes,
// built in float64 on the host), so both sides multiply by the same
// numbers; the arithmetic is f32 on the CUDA cores, with the real and
// imaginary products of each stage summed apart and combined after, as
// the reference's planar matmuls do.
//
// Bound on the H100: operations.  At M = 800 = 25 x 32 and 4,920 steps it
// does ~1.84 GFLOP (27 us at 67 TFLOP/s f32) on 63 MB of traffic (19 us at
// 3.35 TB/s).  Design: a block takes 4 step pairs (8 rows), stages them in
// shared memory, and runs both stages there; the stage-2 buffer is padded
// so that a half-warp (2 channels x 8 rows) hits 16 distinct bank pairs,
// and the store walks the 8 consecutive output columns of a channel
// fastest, so the transpose to (M, S) is written in 64-byte runs.  Tensor
// cores (3xTF32 or wgmma) are later work.
#include "common.cuh"

namespace {

// Row stride (in float2) of the stage-2 buffer: rows of m2+1 per c1, and
// a tile-row stride that is 2 mod 16, so 8 tile rows x 2 neighbouring c1
// fall in 16 distinct float2 bank slots.
__host__ __device__ inline int b_stride(int m1, int m2) {
    const int base = m1 * (m2 + 1);
    return base + ((2 - base % 16) + 16) % 16;
}

__global__ void arm_dft_kernel(const float2* __restrict__ u, const float* __restrict__ tables,
                               float2* __restrict__ out, int m1, int m2, int r_steps,
                               int row_pairs) {
    extern __shared__ float2 smem[];
    const int m = m1 * m2;
    const int n_rows = 2 * row_pairs;
    const int bs = b_stride(m1, m2);
    float2* xs = smem;               // n_rows x m
    float2* bb = smem + n_rows * m;  // n_rows x bs
    const float* c1m = tables;
    const float* s1m = c1m + m1 * m1;
    const float* c2m = s1m + m1 * m1;
    const float* s2m = c2m + m2 * m2;
    const float* twc = s2m + m2 * m2;
    const float* tws = twc + m1 * m2;
    const float2* chan_tw = reinterpret_cast<const float2*>(tws + m1 * m2);

    const int r0 = blockIdx.x * row_pairs;
    const int s_total = 2 * r_steps;

    // tile row j is output column 2*r0 + j: parity j & 1, step r0 + j/2
    for (int i = threadIdx.x; i < n_rows * m; i += blockDim.x) {
        const int j = i / m, k = i - j * m;
        const int r = r0 + (j >> 1);
        xs[i] = r < r_steps ? u[(static_cast<long>(j & 1) * r_steps + r) * m + k]
                            : make_float2(0.f, 0.f);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n_rows * m; i += blockDim.x) {
        const int j = i / m, rem = i - j * m;
        const int c1 = rem / m2, k2 = rem - c1 * m2;
        const float2* x = xs + j * m + k2;
        float rc = 0.f, is = 0.f, rs = 0.f, ic = 0.f;
        for (int k1 = 0; k1 < m1; ++k1) {
            const float2 v = x[k1 * m2];
            const float c = c1m[k1 * m1 + c1], s = s1m[k1 * m1 + c1];
            rc += v.x * c;
            is += v.y * s;
            rs += v.x * s;
            ic += v.y * c;
        }
        const float ar = rc - is, ai = rs + ic;
        const float wc = twc[c1 * m2 + k2], ws = tws[c1 * m2 + k2];
        bb[j * bs + c1 * (m2 + 1) + k2] = make_float2(ar * wc - ai * ws, ar * ws + ai * wc);
    }
    __syncthreads();

    for (int i = threadIdx.x; i < n_rows * m; i += blockDim.x) {
        const int c = i / n_rows, j = i - c * n_rows;
        const int s = 2 * r0 + j;
        if (s >= s_total) continue;
        const int c2 = c / m1, c1 = c - c2 * m1;
        const float2* b = bb + j * bs + c1 * (m2 + 1);
        float rc = 0.f, is = 0.f, rs = 0.f, ic = 0.f;
        for (int k2 = 0; k2 < m2; ++k2) {
            const float2 v = b[k2];
            const float cc = c2m[k2 * m2 + c2], ss = s2m[k2 * m2 + c2];
            rc += v.x * cc;
            is += v.y * ss;
            rs += v.x * ss;
            ic += v.y * cc;
        }
        const float yr = rc - is, yi = rs + ic;
        const float2 w = chan_tw[c];
        float zr = yr * w.x - yi * w.y, zi = yr * w.y + yi * w.x;
        if ((j & 1) && (c & 1)) {
            zr = -zr;
            zi = -zi;
        }
        out[static_cast<long>(c) * s_total + s] = make_float2(zr, zi);
    }
}

}  // namespace

WAVECAP_EXPORT int k2_arm_dft(const void* u, const void* tables, void* out, int m1, int m2,
                              int r_steps, int row_pairs, void* stream) {
    const int m = m1 * m2;
    const size_t smem = sizeof(float2) * 2 * row_pairs * (m + b_stride(m1, m2));
    cudaError_t err = cudaFuncSetAttribute(
        arm_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (r_steps + row_pairs - 1) / row_pairs;
    arm_dft_kernel<<<blocks, 256, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(u), static_cast<const float*>(tables),
        static_cast<float2*>(out), m1, m2, r_steps, row_pairs);
    return static_cast<int>(cudaGetLastError());
}
