// K11b: the spectral noise reduction's arithmetic around cuFFT.
//
// Replaces wavecap_tpu/ops/noise.py:spectral_noise_reduction except its
// rFFT and irFFT, which the reference takes from XLA's library FFT and
// the port from cuFFT (torch.fft).  Per row x of n samples, F frames of
// N = fft_size at hop H, win = np.hanning(N) as f32:
//
//   k11b_nr_frames:       frames[f, j] = x[f H + j] * win[j]
//   (torch.fft.rfft)      X[f, b]
//   k11b_nr_gain:         floor[b] = lo (1 - h) + hi h, the ranks floor(q), ceil(q) of
//                         |X[., b]| (q = f32(0.1) * (F - 1), jnp.percentile's linear method)
//                         g = max(max(0, 1 - (floor k / max(|X|, 1e-10))^2), 0.1)
//                         X[f, b] *= g                                  (in place)
//   (torch.fft.irfft)     c[f, j]
//   k11b_nr_overlap_add:  y[i] = (sum over the frames covering i, in frame order from 0,
//                         of c[f, i - f H] * win[i - f H]) / max(wsum[i], 1e-6),
//                         y[i] = x[i] past the last frame
//
// |X| is hypotf; every product and sum is rounded as written (no FMA
// contraction), as the reference's f32 operations are.
//
// Bound on the H100: bytes.  At 160 rows x 9,447 samples (17 frames) the
// function must read 6.0 MB and write 6.0 MB; the frames and spectra it
// passes between launches are ~11 MB each way, L2-resident.
//
// Design (the gain's plan is ops/noise.py:k11b_plan):
// * frames and overlap-add: a 2-D grid, row x (frame or 1,024-sample
//   tile) in blockIdx, so no thread divides a flat index; a thread moves 4
//   consecutive samples with 16-byte accesses wherever a row's alignment
//   allows (the frames, spectra, window and wsum always; x and y on the
//   rows whose offset is a multiple of 4), and the overlap-add one
//   division a thread for its frames' range;
// * gain, F <= 32 (the register variant, F padded to a bucket FB): one
//   thread a (row, bin) loads its column's F values, coalesced across
//   bins, takes F hypotfs into registers, keeps the KB least magnitudes in
//   order by compare-exchange (KB = ceil(0.1 (FB - 1)) + 1 covers rank
//   ceil(q)), and rewrites its column, each value read again from L2
//   (holding the values too costs registers, and a second wave: slower);
// * gain, F > 32 (the staged variant): a block stages a tile of bins'
//   magnitudes (F x tile) in shared memory, each warp ranks a column by
//   counting with its lanes over the frames (equal magnitudes take
//   consecutive ranks in frame order), and the block rewrites the tile.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;     // frames, overlap-add, the staged gain
constexpr int kGainThreads = 128;  // the register gain
constexpr int kSmemMax = 232448;

__device__ __forceinline__ float gain_of(float num, float m) {
    const float r = __fdiv_rn(num, fmaxf(m, 1e-10f));
    const float g = fmaxf(__fsub_rn(1.0f, __fmul_rn(r, r)), 0.0f);
    return fmaxf(g, 0.1f);
}

// the percentile's two ranks and weights
struct Ranks {
    int lo, hi;
    float lw, hw;
};

__device__ __forceinline__ Ranks ranks_of(float pos, int n_frames) {
    const float lo_pos = floorf(pos), hi_pos = ceilf(pos);
    Ranks r;
    r.hw = __fsub_rn(pos, lo_pos);
    r.lw = __fsub_rn(1.0f, r.hw);
    r.lo = min(max(static_cast<int>(lo_pos), 0), n_frames - 1);
    r.hi = min(max(static_cast<int>(hi_pos), 0), n_frames - 1);
    return r;
}

__device__ __forceinline__ float4 load4(const float* p, bool aligned) {
    if (aligned) return *reinterpret_cast<const float4*>(p);
    return make_float4(p[0], p[1], p[2], p[3]);
}

__device__ __forceinline__ void store4(float* p, float4 v, bool aligned) {
    if (aligned) {
        *reinterpret_cast<float4*>(p) = v;
    } else {
        p[0] = v.x;
        p[1] = v.y;
        p[2] = v.z;
        p[3] = v.w;
    }
}

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// grid (rows, F): block (row, f) writes frame f of the row
__global__ void nr_frames_kernel(const float* __restrict__ x, const float* __restrict__ win,
                                 float* __restrict__ frames, int n, int n_frames, int fft_size, int hop,
                                 int vec) {
    const long row = blockIdx.x;
    const int f = blockIdx.y;
    const float* src = x + row * n + static_cast<long>(f) * hop;
    float* dst = frames + (row * n_frames + f) * static_cast<long>(fft_size);
    if (vec) {
        const bool al = aligned16(src);
        for (int j = 4 * threadIdx.x; j < fft_size; j += 4 * blockDim.x) {
            const float4 a = load4(src + j, al);
            const float4 w = *reinterpret_cast<const float4*>(win + j);
            *reinterpret_cast<float4*>(dst + j) =
                make_float4(__fmul_rn(a.x, w.x), __fmul_rn(a.y, w.y), __fmul_rn(a.z, w.z), __fmul_rn(a.w, w.w));
        }
    } else {
        for (int j = threadIdx.x; j < fft_size; j += blockDim.x) dst[j] = __fmul_rn(src[j], win[j]);
    }
}

// F <= FB: one thread a (row, bin).  The magnitudes stay in registers from
// the load to the gain; the values are read again (from L2) for the write,
// which keeps the registers (~90 at FB = 24) low enough for one wave of
// 160 x 513 threads.
template <int FB>
__global__ void __launch_bounds__(kGainThreads)
nr_gain_kernel(float2* __restrict__ spec, int rows, int n_frames, int bins, float pos, float k) {
    constexpr int KB = (FB - 1 + 9) / 10 + 1;  // ranks 0 .. ceil(0.1 (FB - 1))
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= rows * bins) return;
    const int row = t / bins;
    const int b = t - row * bins;
    float2* col = spec + static_cast<long>(row) * n_frames * bins + b;  // frame f at col[f * bins]
    float m[FB];
    float least[KB];  // the KB least magnitudes, ascending (+inf pads)
#pragma unroll
    for (int j = 0; j < KB; ++j) least[j] = __int_as_float(0x7f800000);
#pragma unroll
    for (int f = 0; f < FB; ++f) {
        if (f < n_frames) {
            const float2 v = col[static_cast<long>(f) * bins];
            m[f] = hypotf(v.x, v.y);
        } else {
            m[f] = __int_as_float(0x7f800000);
        }
        float c = m[f];
#pragma unroll
        for (int j = 0; j < KB; ++j) {
            const float a = fminf(least[j], c);
            c = fmaxf(least[j], c);
            least[j] = a;
        }
    }
    const Ranks r = ranks_of(pos, n_frames);
    float v_lo = 0.0f, v_hi = 0.0f;
#pragma unroll
    for (int j = 0; j < KB; ++j) {
        if (j == r.lo) v_lo = least[j];
        if (j == r.hi) v_hi = least[j];
    }
    const float num = __fmul_rn(__fadd_rn(__fmul_rn(v_lo, r.lw), __fmul_rn(v_hi, r.hw)), k);
#pragma unroll
    for (int f = 0; f < FB; ++f) {
        if (f < n_frames) {
            const float g = gain_of(num, m[f]);
            const float2 v = col[static_cast<long>(f) * bins];
            col[static_cast<long>(f) * bins] = make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
        }
    }
}

// any F: grid (rows, ceil(bins / tile)); shared m[f * tile + c], then num[tile]
__global__ void nr_gain_kernel_staged(float2* __restrict__ spec, int n_frames, int bins, int tile, float pos,
                                      float k) {
    extern __shared__ float sm[];
    float* num = sm + static_cast<long>(n_frames) * tile;
    const long row = blockIdx.x;
    const int b0 = blockIdx.y * tile;
    const int nb = min(tile, bins - b0);
    float2* base = spec + row * n_frames * static_cast<long>(bins) + b0;
    const int total = n_frames * tile;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int f = e / tile, c = e - f * tile;
        if (c < nb) {
            const float2 v = base[static_cast<long>(f) * bins + c];
            sm[e] = hypotf(v.x, v.y);
        }
    }
    __syncthreads();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
    const Ranks r = ranks_of(pos, n_frames);
    for (int c = warp; c < nb; c += n_warps) {
        // element f's rank: #{g: m_g < m_f} + #{g < f: m_g == m_f}
        float v_lo = 0.0f, v_hi = 0.0f;
        bool has_lo = false, has_hi = false;
        for (int f = lane; f < n_frames; f += 32) {
            const float mf = sm[f * tile + c];
            int rank = 0;
            for (int g = 0; g < n_frames; ++g) {
                const float mg = sm[g * tile + c];
                rank += (mg < mf || (mg == mf && g < f)) ? 1 : 0;
            }
            if (rank == r.lo) { v_lo = mf; has_lo = true; }
            if (rank == r.hi) { v_hi = mf; has_hi = true; }
        }
        const unsigned who_lo = __ballot_sync(0xffffffffu, has_lo);
        const unsigned who_hi = __ballot_sync(0xffffffffu, has_hi);
        v_lo = who_lo ? __shfl_sync(0xffffffffu, v_lo, __ffs(who_lo) - 1) : 0.0f;
        v_hi = who_hi ? __shfl_sync(0xffffffffu, v_hi, __ffs(who_hi) - 1) : 0.0f;
        if (lane == 0) num[c] = __fmul_rn(__fadd_rn(__fmul_rn(v_lo, r.lw), __fmul_rn(v_hi, r.hw)), k);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int f = e / tile, c = e - f * tile;
        if (c < nb) {
            float2* p = base + static_cast<long>(f) * bins + c;
            const float2 v = *p;
            const float g = gain_of(num[c], sm[e]);
            *p = make_float2(__fmul_rn(v.x, g), __fmul_rn(v.y, g));
        }
    }
}

__device__ __forceinline__ float ola_one(const float* __restrict__ c, const float* __restrict__ win,
                                         const float* __restrict__ wsum, int i, int n_frames, int fft_size,
                                         int hop) {
    const int f0 = i >= fft_size ? (i - fft_size) / hop + 1 : 0;
    const int f1 = min(i / hop, n_frames - 1);
    float acc = 0.0f;
    for (int f = f0; f <= f1; ++f) {
        const int j = i - f * hop;
        acc = __fadd_rn(acc, __fmul_rn(c[static_cast<long>(f) * fft_size + j], win[j]));
    }
    return __fdiv_rn(acc, fmaxf(wsum[i], 1e-6f));
}

// grid (rows, ceil(n / (4 threads))): a thread 4 consecutive outputs.
// With vec (H and N multiples of 4) the 4 share one range of frames.
__global__ void nr_overlap_add_kernel(const float* __restrict__ clean, const float* __restrict__ x,
                                      const float* __restrict__ win, const float* __restrict__ wsum,
                                      float* __restrict__ y, int n, int n_frames, int fft_size, int hop,
                                      int out_len, int vec) {
    const long row = blockIdx.x;
    const int i = 4 * (blockIdx.y * blockDim.x + threadIdx.x);
    if (i >= n) return;
    const float* c = clean + row * n_frames * static_cast<long>(fft_size);
    const float* xr = x + row * n;
    float* yr = y + row * n;
    if (!vec || i + 4 > n) {
        for (int e = i; e < min(i + 4, n); ++e)
            yr[e] = e >= out_len ? xr[e] : ola_one(c, win, wsum, e, n_frames, fft_size, hop);
        return;
    }
    const bool al = aligned16(yr + i);
    if (i >= out_len) {  // past the last frame (out_len is a multiple of 4)
        store4(yr + i, load4(xr + i, al), al);
        return;
    }
    const int f0 = i >= fft_size ? (i - fft_size) / hop + 1 : 0;
    const int f1 = min(i / hop, n_frames - 1);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int f = f0; f <= f1; ++f) {
        const int j = i - f * hop;
        const float4 v = *reinterpret_cast<const float4*>(c + static_cast<long>(f) * fft_size + j);
        const float4 w = *reinterpret_cast<const float4*>(win + j);
        acc.x = __fadd_rn(acc.x, __fmul_rn(v.x, w.x));
        acc.y = __fadd_rn(acc.y, __fmul_rn(v.y, w.y));
        acc.z = __fadd_rn(acc.z, __fmul_rn(v.z, w.z));
        acc.w = __fadd_rn(acc.w, __fmul_rn(v.w, w.w));
    }
    const float4 s = *reinterpret_cast<const float4*>(wsum + i);
    store4(yr + i,
           make_float4(__fdiv_rn(acc.x, fmaxf(s.x, 1e-6f)), __fdiv_rn(acc.y, fmaxf(s.y, 1e-6f)),
                       __fdiv_rn(acc.z, fmaxf(s.z, 1e-6f)), __fdiv_rn(acc.w, fmaxf(s.w, 1e-6f))),
           al);
}

template <int FB>
int launch_gain(float2* spec, int rows, int n_frames, int bins, float pos, float k, cudaStream_t stream) {
    const long total = static_cast<long>(rows) * bins;
    const unsigned grid = static_cast<unsigned>((total + kGainThreads - 1) / kGainThreads);
    nr_gain_kernel<FB><<<grid, kGainThreads, 0, stream>>>(spec, rows, n_frames, bins, pos, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WAVECAP_EXPORT int k11b_nr_frames(const void* x, const void* win, void* frames, int rows, int n,
                                  int n_frames, int fft_size, int hop, void* stream) {
    const int vec = (fft_size % 4 == 0) ? 1 : 0;
    nr_frames_kernel<<<dim3(rows, n_frames), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(win), static_cast<float*>(frames), n,
        n_frames, fft_size, hop, vec);
    return static_cast<int>(cudaGetLastError());
}

// bucket: the register variant's FB (8, 16, 24 or 32), or 0 for the staged
// variant with `tile` bins a block and `smem_bytes` of shared memory
// (ops/noise.py:k11b_plan)
WAVECAP_EXPORT int k11b_nr_gain(void* spec, int rows, int n_frames, int bins, float pos, float k, int bucket,
                                int tile, int smem_bytes, void* stream) {
    auto* sp = static_cast<float2*>(spec);
    auto* s = static_cast<cudaStream_t>(stream);
    const int hi = static_cast<int>(ceilf(pos));
    if (static_cast<long>(rows) * bins >= (1L << 31)) return static_cast<int>(cudaErrorInvalidValue);
    if (bucket != 0) {
        // the bucket must hold the frames, and its KB least values rank ceil(q)
        if (n_frames > bucket || hi >= (bucket - 1 + 9) / 10 + 1) return static_cast<int>(cudaErrorInvalidValue);
        switch (bucket) {
            case 8: return launch_gain<8>(sp, rows, n_frames, bins, pos, k, s);
            case 16: return launch_gain<16>(sp, rows, n_frames, bins, pos, k, s);
            case 24: return launch_gain<24>(sp, rows, n_frames, bins, pos, k, s);
            case 32: return launch_gain<32>(sp, rows, n_frames, bins, pos, k, s);
            default: return static_cast<int>(cudaErrorInvalidValue);
        }
    }
    if (tile < 1 || tile > 32 || smem_bytes < 4L * (static_cast<long>(n_frames) * tile + tile) ||
        smem_bytes > kSmemMax)
        return static_cast<int>(cudaErrorInvalidValue);
    if (smem_bytes > 48 * 1024) {
        const cudaError_t e =
            cudaFuncSetAttribute(nr_gain_kernel_staged, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid(rows, (bins + tile - 1) / tile);
    nr_gain_kernel_staged<<<grid, kThreads, smem_bytes, s>>>(sp, n_frames, bins, tile, pos, k);
    return static_cast<int>(cudaGetLastError());
}

WAVECAP_EXPORT int k11b_nr_overlap_add(const void* clean, const void* x, const void* win,
                                       const void* wsum, void* y, int rows, int n, int n_frames,
                                       int fft_size, int hop, int out_len, void* stream) {
    const int vec = (fft_size % 4 == 0 && hop % 4 == 0) ? 1 : 0;
    const int per_block = 4 * kThreads;
    const dim3 grid(rows, (n + per_block - 1) / per_block);
    nr_overlap_add_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(clean), static_cast<const float*>(x), static_cast<const float*>(win),
        static_cast<const float*>(wsum), static_cast<float*>(y), n, n_frames, fft_size, hop, out_len, vec);
    return static_cast<int>(cudaGetLastError());
}
