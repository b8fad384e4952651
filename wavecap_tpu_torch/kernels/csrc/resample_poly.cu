// K5: the rational polyphase resampler.
//
// Replaces wavecap_tpu/ops/fir.py:resample_poly_stream (the causal
// streaming branch with its tail carry) and ops/fir.py:resample_poly (the
// centered one-shot branch for up > 1).  Per row, over the virtual input
// v = head ++ x ++ zeros, where head is the carried tail (streaming) or
// L = ph_len - 1 zeros (one-shot):
//
//   a      = off + m * down
//   p_m    = a mod up,   q_m = a div up + L
//   y[m]   = sum_{k < ph_len} phases[p_m, k] * v[q_m - k]
//
// with phases[p, k] = h[p + k up] (scipy resample_poly's Kaiser FIR).
// off = 0 is the streaming branch; off = (len(h) - 1) / 2 the one-shot.
//
// Bound on the H100: bytes.  At 800 rows x 4,920 -> 9,447 samples (48/25,
// 21 taps per phase) it reads 15.7 MB and writes 30.2 MB (~14 us at
// 3.35 TB/s); 0.32 GFLOP of multiply-adds is ~5 us at 67 TFLOP/s.
//
// Design (ops/fir.py:k5_plan chooses the variant and its sizes):
// * table variant, where the phase table fits in shared memory (every
//   ratio of the analog banks): one block a tile of `threads` x 8
//   consecutive outputs of one row (1,920 at 48/25 and 24/25).  The block
//   stages the table transposed, [ph_len][up] (4 KB at 48/25), and its
//   input span (~1,020 samples) with coalesced loads.  `threads` is a
//   multiple of up and thread t owns phase class t mod up: its 8 outputs lie
//   up apart, share one phase and so one set of taps, and sit down input
//   samples apart in the span.  A warp's 32 lanes hold 32 consecutive
//   outputs, whose distinct phases fall at most 2 to a bank.  The block's
//   base a0 = off + m0 down, p0 = a0 mod up, a0 div up is int64 once a
//   block; within it the offsets p0 + i down are int32 (k5_plan keeps them
//   below 2^31), one 32-bit divide a thread.  Its shared-memory loads
//   (21 + 21/8 an output at 48/25) are what bound it.
// * row variant, for a table too large for shared memory (the wide slots'
//   24000/121951: 102 taps, 9.8 MB): one thread an output, 256 a block,
//   the block's input span (~1,400 samples) staged in shared memory, each
//   thread reading its phase row from the table in device memory two taps
//   a load (the row is contiguous, so L1 serves most of it).  One warp an
//   output, whose lanes read the row coalesced, was slower at the wide
//   slots' 2 rows x 9,447 outputs (PERF.md, K5).
#include "common.cuh"

namespace {

constexpr int kPer = 8;        // outputs a thread, table variant
constexpr int kRowTile = 256;  // outputs (threads) a block, row variant

__device__ __forceinline__ float v_at(const float* xr, const float* hr, long long j, int lead, int n) {
    if (j >= 0 && j < lead) return hr ? hr[j] : 0.f;
    if (j >= lead && j - lead < n) return xr[j - lead];
    return 0.f;
}

__global__ void resample_poly_kernel(const float* __restrict__ x, const float* __restrict__ head,
                                     const float* __restrict__ table_t, float* __restrict__ y, int n,
                                     int lead, int up, int down, int ph_len, long long off, int n_out,
                                     int span_len) {
    extern __shared__ float smem[];
    float* tab = smem;                 // [ph_len][up]
    float* span = smem + ph_len * up;  // span_len staged inputs
    const int row = blockIdx.y;
    const int tile = blockDim.x * kPer;
    const long long m0 = static_cast<long long>(blockIdx.x) * tile;
    const long long a0 = off + m0 * down;
    const int p0 = static_cast<int>(a0 % up);
    const long long j0 = a0 / up;  // the span's first index into v
    const float* xr = x + static_cast<long long>(row) * n;
    const float* hr = head ? head + static_cast<long long>(row) * lead : nullptr;
    for (int i = threadIdx.x; i < ph_len * up; i += blockDim.x) tab[i] = table_t[i];
    for (int i = threadIdx.x; i < span_len; i += blockDim.x) span[i] = v_at(xr, hr, j0 + i, lead, n);
    __syncthreads();

    const int t = threadIdx.x;
    const int i0 = (t / up) * up * kPer + t % up;  // this thread's first output in the tile
    const int v = p0 + i0 * down;
    const int p = v % up;
    const int s0 = lead + v / up;  // span index of tap 0 of that output
    float acc[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) acc[r] = 0.f;
    for (int k = 0; k < ph_len; ++k) {
        const float c = tab[k * up + p];
        const float* sk = span + s0 - k;
#pragma unroll
        for (int r = 0; r < kPer; ++r) acc[r] = fmaf(c, sk[r * down], acc[r]);
    }
    float* yr = y + static_cast<long long>(row) * n_out;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
        const long long m = m0 + i0 + r * up;
        if (m < n_out) yr[m] = acc[r];
    }
}

__global__ void resample_poly_row_kernel(const float* __restrict__ x, const float* __restrict__ head,
                                         const float* __restrict__ phases, float* __restrict__ y, int n,
                                         int lead, int up, int down, int ph_len, long long off, int n_out,
                                         int span_len) {
    extern __shared__ float span[];
    const int row = blockIdx.y;
    const long long m0 = static_cast<long long>(blockIdx.x) * blockDim.x;
    const long long a0 = off + m0 * down;
    const int p0 = static_cast<int>(a0 % up);
    const long long j0 = a0 / up;  // the span's first index into v
    const float* xr = x + static_cast<long long>(row) * n;
    const float* hr = head ? head + static_cast<long long>(row) * lead : nullptr;
    for (int i = threadIdx.x; i < span_len; i += blockDim.x) span[i] = v_at(xr, hr, j0 + i, lead, n);
    __syncthreads();
    if (m0 + threadIdx.x >= n_out) return;
    const int v = p0 + static_cast<int>(threadIdx.x) * down;
    const float* h = phases + static_cast<long long>(v % up) * ph_len;
    const float* sk = span + lead + v / up;  // tap 0's sample
    float acc = 0.f;
    if ((ph_len & 1) == 0) {  // the row is 8-byte aligned: two taps a load
        const float2* h2 = reinterpret_cast<const float2*>(h);
#pragma unroll 4
        for (int k = 0; k < ph_len / 2; ++k) {
            const float2 c = __ldg(h2 + k);
            acc = fmaf(c.x, sk[-2 * k], acc);
            acc = fmaf(c.y, sk[-2 * k - 1], acc);
        }
    } else {
#pragma unroll 4
        for (int k = 0; k < ph_len; ++k) acc = fmaf(__ldg(h + k), sk[-k], acc);
    }
    y[static_cast<long long>(row) * n_out + m0 + threadIdx.x] = acc;
}

}  // namespace

// variant 0: the table variant with `threads` threads a block (a multiple
// of up) and `span_len` staged inputs; `table` is the transposed table
// [ph_len][up].  Variant 1: the row variant with `span_len` staged inputs;
// `table` is [up][ph_len].
WAVECAP_EXPORT int k5_resample_poly(const void* x, const void* head, const void* table, void* y,
                                    int rows, int n, int lead, int up, int down, int ph_len,
                                    long long off, int n_out, int variant, int threads, int span_len,
                                    void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* xf = static_cast<const float*>(x);
    const float* hf = static_cast<const float*>(head);
    const float* tf = static_cast<const float*>(table);
    float* yf = static_cast<float*>(y);
    if (variant == 0) {
        const size_t smem = sizeof(float) * (static_cast<size_t>(ph_len) * up + span_len);
        if (smem > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                resample_poly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        const int tile = threads * kPer;
        const dim3 grid((n_out + tile - 1) / tile, rows);
        resample_poly_kernel<<<grid, threads, smem, s>>>(xf, hf, tf, yf, n, lead, up, down, ph_len, off,
                                                         n_out, span_len);
    } else if (variant == 1) {
        const size_t smem = sizeof(float) * static_cast<size_t>(span_len);
        if (smem > 48 * 1024) {
            const cudaError_t err = cudaFuncSetAttribute(
                resample_poly_row_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
            if (err != cudaSuccess) return static_cast<int>(err);
        }
        const dim3 grid((n_out + kRowTile - 1) / kRowTile, rows);
        resample_poly_row_kernel<<<grid, kRowTile, smem, s>>>(xf, hf, tf, yf, n, lead, up, down, ph_len, off,
                                                              n_out, span_len);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
