// K5: the rational polyphase resampler.
//
// Replaces wavecap_tpu/ops/fir.py:resample_poly_stream (the causal
// streaming branch with its tail carry) and ops/fir.py:resample_poly (the
// centered one-shot branch for up > 1).  Per row, over the virtual input
// v = head ++ x ++ zeros, where head is the carried tail (streaming) or
// L = ph_len - 1 zeros (one-shot):
//
//   a      = off + m * down                          (int64)
//   p_m    = a mod up,   q_m = a div up + L
//   y[m]   = sum_{k < ph_len} phases[p_m, k] * v[q_m - k]
//
// with phases[p, k] = h[p + k up] (scipy resample_poly's Kaiser FIR).
// off = 0 is the streaming branch; off = (len(h) - 1) / 2 the one-shot.
// The index arithmetic is int64: at the wide slots' 24000/121951, m * down
// reaches ~1.15e9 plus a 1.2e6 offset.
//
// Bound on the H100: bytes.  At 800 rows x 4,920 -> 9,447 samples (48/25,
// 21 taps per phase) it reads 15.7 MB and writes 30.2 MB (~14 us at
// 3.35 TB/s); 0.32 GFLOP of multiply-adds is ~5 us at 67 TFLOP/s.  Design:
// one block per (output tile of 256, row); the tile's input span (~155
// samples at 48/25, ~1,400 at the wide ratio) is staged in shared memory
// with coalesced loads, and each thread computes one output from it,
// reading its phase row from the f32 table in global memory (L1/L2: 4 KB
// at 48/25, 9.8 MB at the wide ratio).
#include "common.cuh"

namespace {

constexpr int kTile = 256;

__global__ void resample_poly_kernel(const float* __restrict__ x, const float* __restrict__ head,
                                     const float* __restrict__ phases, float* __restrict__ y,
                                     int n, int lead, int up, int down, int ph_len,
                                     long long off, int n_out) {
    extern __shared__ float span[];
    const int row = blockIdx.y;
    const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
    const long long m_last = min(m0 + kTile, static_cast<long long>(n_out)) - 1;
    const long long q0 = (off + m0 * down) / up + lead;
    const long long q1 = (off + m_last * down) / up + lead;
    const long long j0 = q0 - (ph_len - 1);
    const int len = static_cast<int>(q1 - j0 + 1);
    const float* xr = x + static_cast<long long>(row) * n;
    const float* hr = head ? head + static_cast<long long>(row) * lead : nullptr;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const long long j = j0 + i;
        float v = 0.f;
        if (j >= 0 && j < lead) {
            v = hr ? hr[j] : 0.f;
        } else if (j >= lead && j - lead < n) {
            v = xr[j - lead];
        }
        span[i] = v;
    }
    __syncthreads();
    const long long m = m0 + threadIdx.x;
    if (m > m_last) return;
    const long long a = off + m * down;
    const int p = static_cast<int>(a % up);
    const int local = static_cast<int>(a / up + lead - j0);
    const float* h = phases + static_cast<long long>(p) * ph_len;
    float acc = 0.f;
    for (int k = 0; k < ph_len; ++k) acc = fmaf(h[k], span[local - k], acc);
    y[static_cast<long long>(row) * n_out + m] = acc;
}

}  // namespace

WAVECAP_EXPORT int k5_resample_poly(const void* x, const void* head, const void* phases, void* y,
                                    int rows, int n, int lead, int up, int down, int ph_len,
                                    long long off, int n_out, void* stream) {
    const long long span = (static_cast<long long>(kTile - 1) * down) / up + ph_len + 2;
    const size_t smem = sizeof(float) * static_cast<size_t>(span);
    cudaError_t err = cudaFuncSetAttribute(resample_poly_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n_out + kTile - 1) / kTile, rows);
    resample_poly_kernel<<<grid, kTile, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(head),
        static_cast<const float*>(phases), static_cast<float*>(y), n, lead, up, down, ph_len, off,
        n_out);
    return static_cast<int>(cudaGetLastError());
}
