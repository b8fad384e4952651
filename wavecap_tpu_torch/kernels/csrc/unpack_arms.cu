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
// 15.7 MB of samples, against ~0.14 GFLOP.
//
// Design: read x_ext as a grid X[j][q] = x_ext[1 + j*M + q] of M "position
// columns".  Both stacks read only their own position column:
//
//   u[0, r, q]        = sum_k arms_rev[k, q]  * X[r + T-1-k][q]
//   u[1, r, q - M/2]  = sum_k arms_rev[k, .]  * X[r + T-1-k][q]   (q >= M/2)
//   u[1, r, q + M/2]  = sum_k arms_rev[k, .]  * X[r + T-k][q]     (q <  M/2)
//
// so one thread owns a position column q over a tile of R rows
// (ops/channelizer.py:k1_plan): it loads the R + T samples of its window
// once (the history-or-block choice made there, once a sample), unpacks
// each once, keeps them and its 2T arm taps in registers, and writes both
// parities' R outputs from them; it also writes the samples of its tile's
// own rows to x_out (each block sample exactly once over the grid).  A
// tile's T - 1 (or T) halo rows are the only samples read twice.  Threads
// run over (tile, column) pairs with the column fastest, so a warp reads
// and writes consecutive addresses and no CTA idles at any M.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Build switch for scripts/k1_k3_variants.py: K1_CLOCKS, clock64 in thread
// 0 of the first CTAs at [0] start, [1] arm taps loaded, [2] window loaded
// (and x_out written), [3] outputs written; k1_clocks reads them.
#ifndef K1_CLOCKS
#define K1_CLOCKS 0
#endif
#if K1_CLOCKS
__device__ long long g_k1_clocks[4096][4];
#define STAMP(k)                                                             \
    do {                                                                     \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_k1_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

// A source reads a raw word (``load``) and unpacks it (``convert``) apart,
// so a thread can start all its window's loads before it unpacks any.
struct WordSource {
    using Raw = int32_t;
    static constexpr bool kSamples = false;
    const int32_t* w;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ Raw load(long i) const { return w[i]; }
    __device__ __forceinline__ float2 convert(Raw v) const {
        // low half sign-extended by masking, high half by arithmetic shift
        const float re = static_cast<float>(((v & 0xFFFF) ^ 0x8000) - 0x8000);
        const float im = static_cast<float>(v >> 16);
        return make_float2(re * (1.0f / 32768.0f), im * (1.0f / 32768.0f));
    }
};

// adaptive i8: low byte I, high byte Q (little-endian), times the scale
struct I8Source {
    using Raw = int16_t;
    static constexpr bool kSamples = false;
    const int16_t* w;
    const float* scale;
    float s;
    __device__ __forceinline__ void prepare() { s = *scale; }
    __device__ __forceinline__ Raw load(long i) const { return w[i]; }
    __device__ __forceinline__ float2 convert(Raw raw) const {
        const int v = raw;
        const float re = static_cast<float>(((v & 0xFF) ^ 0x80) - 0x80);
        const float im = static_cast<float>(v >> 8);
        return make_float2(re * s, im * s);
    }
};

// adaptive i4: low nibble I, high nibble Q, times the scale
struct I4Source {
    using Raw = int8_t;
    static constexpr bool kSamples = false;
    const int8_t* w;
    const float* scale;
    float s;
    __device__ __forceinline__ void prepare() { s = *scale; }
    __device__ __forceinline__ Raw load(long i) const { return w[i]; }
    __device__ __forceinline__ float2 convert(Raw raw) const {
        const int v = raw;
        const float re = static_cast<float>(((v & 0xF) ^ 0x8) - 0x8);
        const float im = static_cast<float>(v >> 4);
        return make_float2(re * s, im * s);
    }
};

// complex samples: history and block are the same type, so the choice is
// of the pointer and each window sample one load
struct ComplexSource {
    using Raw = float2;
    static constexpr bool kSamples = true;
    const float2* x;
    __device__ __forceinline__ void prepare() {}
    __device__ __forceinline__ Raw load(long i) const { return x[i]; }
    __device__ __forceinline__ float2 convert(Raw v) const { return v; }
};

// Thread g's place: position column q of the tile of rows from r0, its
// parity-1 output column c1, and whether parity 1 reads one row later
// (q < M/2).
struct Place {
    int q, c1, r0;
    bool low, last_tile;
    __device__ __forceinline__ Place(int g, int m, int r_steps, int rows) {
        q = g % m;
        r0 = g / m * rows;
        const int h = m / 2;
        low = q < h;
        c1 = low ? q + (m - h) : q - h;
        last_tile = r0 + rows >= r_steps;
    }
};

// T taps known at compile time: the window and the taps in registers
template <class Source, int T, int R>
__global__ void __launch_bounds__(kThreads)
unpack_arms_kernel(Source src, const float2* __restrict__ hist, const float* __restrict__ arms_rev,
                   float2* __restrict__ u, float2* __restrict__ x_out, int m, int r_steps,
                   long items) {
    STAMP(0);
    const long g = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= items) return;
    src.prepare();
    const Place p(static_cast<int>(g), m, r_steps, R);
    const long h_len = static_cast<long>(m) * T;
    const long len = h_len + static_cast<long>(r_steps) * m;
    float a0[T], a1[T];
#pragma unroll
    for (int k = 0; k < T; ++k) {
        a0[k] = arms_rev[k * m + p.q];
        a1[k] = arms_rev[k * m + p.c1];
    }
    STAMP(1);
    // X rows r0 .. r0 + R + T - 1; the last only for q < M/2 (parity 1's
    // shift) and, in the last tile, for the block's closing samples
    const long i0 = 1 + static_cast<long>(p.r0) * m + p.q;  // X[r0][q]
    // every load in flight (predicated, no branch) before any sample is used
    float2 w[R + T];
    if constexpr (Source::kSamples) {
#pragma unroll
        for (int j = 0; j < R + T; ++j) {
            const long i = i0 + static_cast<long>(j) * m;
            const bool need = (j < R + T - 1 || p.low || p.last_tile) && i < len;
            w[j] = need ? *(i < h_len ? hist + i : src.x + (i - h_len)) : make_float2(0.f, 0.f);
        }
    } else {
        typename Source::Raw raw[R + T];
        float2 hv[R + T];
#pragma unroll
        for (int j = 0; j < R + T; ++j) {
            const long i = i0 + static_cast<long>(j) * m;
            const bool need = (j < R + T - 1 || p.low || p.last_tile) && i < len;
            raw[j] = need && i >= h_len ? src.load(i - h_len) : typename Source::Raw{};
            hv[j] = need && i < h_len ? hist[i] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < R + T; ++j)
            w[j] = i0 + static_cast<long>(j) * m < h_len ? hv[j] : src.convert(raw[j]);
    }
    // this tile's own rows of the block, X rows r0 + T-1 .. r0 + R + T-2
    // (and the closing row in the last tile): each sample written once
    if (x_out != nullptr) {
#pragma unroll
        for (int j = T - 1; j < R + T; ++j) {
            const long i = i0 + static_cast<long>(j) * m;
            if (i >= h_len && i < len && (j < R + T - 1 || p.last_tile)) x_out[i - h_len] = w[j];
        }
    }
    STAMP(2);
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
        const int r = p.r0 + rr;
        if (r >= r_steps) break;
        float2 e = make_float2(0.f, 0.f), o = make_float2(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < T; ++k) {
            const float2 s0 = w[rr + T - 1 - k];
            const float2 s1 = p.low ? w[rr + T - k] : s0;
            e.x = fmaf(s0.x, a0[k], e.x);
            e.y = fmaf(s0.y, a0[k], e.y);
            o.x = fmaf(s1.x, a1[k], o.x);
            o.y = fmaf(s1.y, a1[k], o.y);
        }
        u[static_cast<long>(r) * m + p.q] = e;
        u[(static_cast<long>(r_steps) + r) * m + p.c1] = o;
    }
    STAMP(3);
}

// any T: the same places and order, the window read through L1 as it is used
template <class Source, int R>
__global__ void __launch_bounds__(kThreads)
unpack_arms_any_t_kernel(Source src, const float2* __restrict__ hist,
                         const float* __restrict__ arms_rev, float2* __restrict__ u,
                         float2* __restrict__ x_out, int m, int t, int r_steps, long items) {
    const long g = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (g >= items) return;
    src.prepare();
    const Place p(static_cast<int>(g), m, r_steps, R);
    const long h_len = static_cast<long>(m) * t;
    const long len = h_len + static_cast<long>(r_steps) * m;
    auto at = [&](int j) {
        const long i = 1 + static_cast<long>(p.r0 + j) * m + p.q;
        return i < h_len ? hist[i] : src.convert(src.load(i - h_len));
    };
    if (x_out != nullptr) {
        for (int j = t - 1; j < R + t - 1 + (p.last_tile ? 1 : 0); ++j) {
            const long i = 1 + static_cast<long>(p.r0 + j) * m + p.q;
            if (i >= h_len && i < len) x_out[i - h_len] = src.convert(src.load(i - h_len));
        }
    }
    for (int rr = 0; rr < R && p.r0 + rr < r_steps; ++rr) {
        const int r = p.r0 + rr;
        float2 e = make_float2(0.f, 0.f), o = make_float2(0.f, 0.f);
        for (int k = 0; k < t; ++k) {
            const float2 s0 = at(rr + t - 1 - k);
            const float2 s1 = p.low ? at(rr + t - k) : s0;
            const float b0 = arms_rev[k * m + p.q], b1 = arms_rev[k * m + p.c1];
            e.x = fmaf(s0.x, b0, e.x);
            e.y = fmaf(s0.y, b0, e.y);
            o.x = fmaf(s1.x, b1, o.x);
            o.y = fmaf(s1.y, b1, o.y);
        }
        u[static_cast<long>(r) * m + p.q] = e;
        u[(static_cast<long>(r_steps) + r) * m + p.c1] = o;
    }
}

template <class Source, int R>
void launch_rows(Source src, const float2* hist, const float* arms, float2* u, float2* x_out,
                 int m, int t, int r_steps, cudaStream_t s) {
    const long items = static_cast<long>(m) * ((r_steps + R - 1) / R);
    const unsigned grid = static_cast<unsigned>((items + kThreads - 1) / kThreads);
    if (t == 9)
        unpack_arms_kernel<Source, 9, R><<<grid, kThreads, 0, s>>>(src, hist, arms, u, x_out, m,
                                                                    r_steps, items);
    else
        unpack_arms_any_t_kernel<Source, R><<<grid, kThreads, 0, s>>>(src, hist, arms, u, x_out,
                                                                      m, t, r_steps, items);
}

template <class Source>
int launch_arms(Source src, const void* hist, const void* arms_rev, void* u, void* x_out, int m,
                int t, int r_steps, int rows, cudaStream_t s) {
    const float2* h = static_cast<const float2*>(hist);
    const float* a = static_cast<const float*>(arms_rev);
    float2* uu = static_cast<float2*>(u);
    float2* xo = static_cast<float2*>(x_out);
    switch (rows) {
        case 2: launch_rows<Source, 2>(src, h, a, uu, xo, m, t, r_steps, s); break;
        case 4: launch_rows<Source, 4>(src, h, a, uu, xo, m, t, r_steps, s); break;
        case 8: launch_rows<Source, 8>(src, h, a, uu, xo, m, t, r_steps, s); break;
        case 16: launch_rows<Source, 16>(src, h, a, uu, xo, m, t, r_steps, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if K1_CLOCKS
WAVECAP_EXPORT int k1_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_k1_clocks, sizeof(g_k1_clocks)));
}
#endif

// kind: 0 complex64 samples (no x_out), 1 int32 i16-pair words, 2 int16
// i8-pair words, 3 int8 i4-nibble words (2 and 3 read ``scale``).  The
// plan (ops/channelizer.py:k1_plan) gives ``rows`` a tile (2, 4, 8 or 16)
// and ``threads`` a CTA, which must be the kernel's 256.
WAVECAP_EXPORT int k1_unpack_arms(const void* src, int kind, const void* scale, const void* hist,
                                  const void* arms_rev, void* u, void* x_out, int m, int t,
                                  int r_steps, int rows, int threads, void* stream) {
    if (m < 2 || t < 1 || r_steps < 1 || threads != kThreads)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* sc = static_cast<const float*>(scale);
    switch (kind) {
        case 0:
            return launch_arms(ComplexSource{static_cast<const float2*>(src)}, hist, arms_rev, u,
                               nullptr, m, t, r_steps, rows, s);
        case 1:
            return launch_arms(WordSource{static_cast<const int32_t*>(src)}, hist, arms_rev, u,
                               x_out, m, t, r_steps, rows, s);
        case 2:
            return launch_arms(I8Source{static_cast<const int16_t*>(src), sc, 0.f}, hist, arms_rev,
                               u, x_out, m, t, r_steps, rows, s);
        case 3:
            return launch_arms(I4Source{static_cast<const int8_t*>(src), sc, 0.f}, hist, arms_rev,
                               u, x_out, m, t, r_steps, rows, s);
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
}
