// K13 (line search): the 4th-power CFO line search of CQPSK, one CTA per slot.
//
// Replaces the search half of wavecap_tpu/models/p25/cqpsk.py:
// _estimate_cfo_residual (cqpsk.py:187-201); the FFT of x^4 before it stays
// on cuFFT (torch.fft), as the reference leaves it to XLA's FFT.  Per row,
// over X = |FFT(x^4)| of `size` bins:
//
//   M[j]  = X[(j - k4 + off) mod size] + X[(j - k4 - off) mod size],  j < 2 k4 + 1
//   j*    = the first argmax of M
//   resid = (j* - k4) df_step  if M[j*] > 8 mean(X) and M[j*] > 1.5 M[k4], else 0
//
// The two lines of pi/4-DQPSK's x^4 sit at 4 CFO +- Rs/2 (off bins from
// the centre); their joint search is unambiguous for |CFO| < Rs/4.
//
// Bound on the H100: bytes, and far below a launch.  Program B reads 21 x
// 8,192 f32 (0.7 MB, ~0.2 us at 3.35 TB/s) and compares 21 x 1,449 pairs.
// Design: one CTA per row; the mean is a block sum, the argmax a block
// reduction of (value, index) that keeps the lower index on a tie, as
// jnp.argmax does.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap(int i, int size) { return ((i % size) + size) % size; }

// the better of two (value, index) candidates: larger value, then lower index
__device__ __forceinline__ void keep_max(float& v, int& i, float v2, int i2) {
    if (v2 > v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
    }
}

__global__ void __launch_bounds__(kThreads)
cfo_lines_kernel(const float* __restrict__ spec, int size, int k4, int off, float df_step,
                 float* __restrict__ resid, int* __restrict__ jout) {
    __shared__ float scratch[32];
    __shared__ float best_v[32];
    __shared__ int best_i[32];
    const int r = blockIdx.x;
    const float* x = spec + static_cast<long long>(r) * size;
    float s = 0.f;
    for (int i = threadIdx.x; i < size; i += blockDim.x) s += x[i];
    const float mean = __fdiv_rn(block_sum(s, scratch), static_cast<float>(size));

    float v = -INFINITY;
    int idx = 0x7fffffff;
    for (int j = threadIdx.x; j < 2 * k4 + 1; j += blockDim.x) {
        const int k = j - k4;
        keep_max(v, idx, __fadd_rn(x[wrap(k + off, size)], x[wrap(k - off, size)]), j);
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
        keep_max(v, idx, v2, i2);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        best_v[warp] = v;
        best_i[warp] = idx;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) keep_max(v, idx, best_v[w], best_i[w]);
        const float centre = __fadd_rn(x[wrap(off, size)], x[wrap(-off, size)]);
        const bool sig = (v > __fmul_rn(8.f, mean)) && (v > __fmul_rn(1.5f, centre));
        resid[r] = sig ? __fmul_rn(static_cast<float>(idx - k4), df_step) : 0.f;
        jout[r] = idx;
    }
}

}  // namespace

WAVECAP_EXPORT int k13_cfo_lines(const void* spec, int rows, int size, int k4, int off,
                                 float df_step, void* resid, void* j, void* stream) {
    if (rows <= 0) return 0;
    cfo_lines_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(spec), size, k4, off, df_step, static_cast<float*>(resid),
        static_cast<int*>(j));
    return static_cast<int>(cudaGetLastError());
}
