// K7: the strided (decimating) valid FIR, with an optional carried head
// and an optional exact NCO mix of the input.
//
// Replaces wavecap_tpu/ops/fir.py:_conv_valid_direct (real or complex
// taps, any stride) and ops/fir.py:fir_decimate, and with the NCO the wide
// slots' ops/nco.py:freq_shift + fir_decimate of capture/pipeline.py:_wide_step
// (pipeline.py:415-416) and CQPSK's carrier de-rotation + RRC
// (models/p25/cqpsk.py:259-265); without it, also resample_poly_stream's
// up == 1 branch, the P25 filters and the simulcast equaliser's per-slot
// complex FIR (models/p25/cqpsk.py:338, c4fm.py:246, under vmap).  Per row
// r, over v = head[r] ++ mix_r(x), with h = taps (shared) or taps[r]:
//
//   mix_r(x)[i] = x[i] * (cos, sin)(float(phase0[r] + i * dphi[r]) * 2 pi / 2^32)
//   y[r, m]     = sum_{k < T} h[k] * v[m * stride + T - 1 - k],  m < n_out
//   tail[r]     = the last min(T - 1, |v|) samples of v,   phase1[r] = phase0[r] + n * dphi[r]
//
// with the uint32 accumulator of K3 (wraps mod 2^32).  x is complex or
// real; one row of x may feed every output row (the wide slots share the
// block).  Complex taps (complex x only) keep the reference's four real
// sums, Re = sum hr vr - sum hi vi and Im = sum hi vr + sum hr vi.
//
// Bound on the H100: operations for the wide slots.  Two slots read the
// 1,968,000-sample complex block (15.7 MB each, 31.5 MB in all) and write
// 2 x 48,000 outputs (~9.4 us at 3.35 TB/s); 2 x 48,000 x 1,031 complex
// multiply-adds are 0.40 GFLOP (~5.9 us at 67 TFLOP/s), and the NCO's
// cosf/sinf of every input sample of both slots as many instructions again.
// The equaliser's 21 rows x 7,500 samples x 41 complex taps read and write
// 2.5 MB (~0.8 us) and do 50 MFLOP (~0.8 us).
//
// Design (the launch plan -- groups, phase sets, splits or the direct
// variant -- is ops/fir.py:k7_plan, which the CPU tests emulate; the entry
// takes it as arguments and derives the rest of the layout from it):
// * work items of (row, tile of G x R outputs), R = 8, walked by
//   persistent CTAs (as many as the card holds at once); an item's input
//   span ((G R - 1) x stride + T samples) is copied into shared memory
//   with cp.async while the CTA computes the item before it, then mixed by
//   the NCO once a sample into (re, im) planes with one float of padding
//   every 32; the row's taps beside it;
// * over the polyphase decomposition -- with stride D, output m takes
//   h[p + q D] v[(m - q) D + T - 1 - p] for the phase p < D -- a thread
//   owns R consecutive outputs and a set of phases (every PS-th), and of
//   each phase a run of its taps q; it slides a window of R samples
//   u_p(i) = v[i D + T - 1 - p] in registers (one shared load a tap, no
//   moves: the window's slots rotate with the tap index, unrolled by R,
//   whole runs of R taps without a guard so the loads hoist) and does R
//   multiply-adds (2R, 4R for complex) a sample and a tap.  Stride 1 is
//   the same loop with one phase: a sliding register window;
// * where rows x tiles leave the card idle (a mesh shard's launch, the P25
//   filters) the taps are split S ways across slices of a warp, whose sums
//   meet by shuffles; the PS partial sums of an output meet in shared
//   memory, set by set;
// * the tail and the next phase: one item a row after the tiles;
// * a small launch (at most 400,000 outputs of at most 128 taps: the
//   equaliser, the P25 filters of a mesh shard, resample_poly_stream's up
//   == 1) takes the direct variant below instead, one output a thread:
//   there the pipeline's fixed costs outweigh its savings.  So does a
//   launch whose span no pipelined tile can hold twice in shared memory.
// scripts/k7_k14_variants.py holds the trials: the NCO mix is ~40 % of
// the wide slots' instructions, the taps ~55 %.
#include "common.cuh"

namespace {

constexpr int kR = 8;                  // outputs a thread (ops/fir.py:_K7_R)
constexpr int kDirectTile = 128;        // the direct variant's outputs (threads) a CTA
constexpr int kMaxThreads = 512;       // threads a CTA, at most (D x G x S)
constexpr int kSmemMax = 232448;       // the H100's 227 KB a block

// Build switch for scripts/k7_k14_variants.py: K7_CLOCKS, in thread 0 of
// each of the first 1,024 CTAs clock64 at entry and exit, the cycles of
// each stage (stage, taps, sums) summed over its items, and its items
// (k7_clocks reads them back, k7_launch_shape the last launch's CTAs an SM
// and CTAs).
#ifndef K7_CLOCKS
#define K7_CLOCKS 0
#endif
#if K7_CLOCKS
__device__ long long g_clocks[1024][6];  // entry, stage, taps, sums (summed over items), exit, items
int g_launch[2];  // the last launch's resident CTAs an SM and CTAs
#define STAMP(k)                                                                  \
    do {                                                                          \
        const long long t_ = clock64();                                           \
        if (threadIdx.x == 0 && blockIdx.x < 1024) {                              \
            if ((k) == 0) g_clocks[blockIdx.x][5] += 1;                           \
            else g_clocks[blockIdx.x][k] += t_ - stamp_last;                      \
        }                                                                         \
        stamp_last = t_;                                                          \
    } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

struct Plan {
    int g, ps, s;  // groups of kR outputs an item; phase sets; ways the taps are split
    bool direct;   // the direct variant (an output a thread) in its place
};

// a thread's lane order: phase set fastest where the sets are many (their
// samples lie side by side), else group fastest (the taps a broadcast)
__host__ __device__ inline bool group_fast(const Plan& p) { return p.ps < 16; }

// float index of sample i in a plane: one float of padding every 32
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }
__host__ __device__ constexpr long plane_len(long n) { return n + (n >> 5) + 1; }

__device__ __forceinline__ float mix_at(float v, long long, unsigned, unsigned, bool) { return v; }

__device__ __forceinline__ float2 mix_at(float2 v, long long i, unsigned d, unsigned p0, bool mix) {
    if (!mix) return v;
    const float rad_per_count = static_cast<float>(6.283185307179586 / 4294967296.0);
    const unsigned acc = p0 + static_cast<unsigned>(i) * d;
    const float ph = __uint2float_rn(acc) * rad_per_count;
    float s, c;
    sincosf(ph, &s, &c);
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

// v[j] of v = head ++ mix(x)
template <typename V>
__device__ __forceinline__ V sample_at(const V* hr, int head_len, const V* xr, long long j, unsigned d,
                                       unsigned p0, bool mix) {
    return j < head_len ? hr[j] : mix_at(xr[j - head_len], j - head_len, d, p0, mix);
}

// a value's (re, im) planes in shared memory; a real value has one
template <typename V>
struct Planes;

template <>
struct Planes<float> {
    float* re;
    __device__ Planes(float* base, long) : re(base) {}
    __device__ void put(int i, float v) { re[i] = v; }
    __device__ float get(int i) const { return re[i]; }
};

template <>
struct Planes<float2> {
    float *re, *im;
    __device__ Planes(float* base, long len) : re(base), im(base + len) {}
    __device__ void put(int i, float2 v) {
        re[i] = v.x;
        im[i] = v.y;
    }
    __device__ float2 get(int i) const { return make_float2(re[i], im[i]); }
};

// the sums of one output: real taps keep one accumulator per component,
// complex taps the four real sums of the reference's complex convolution
template <typename V, typename H>
struct Acc;

template <>
struct Acc<float, float> {
    float s = 0.f;
    __device__ void mac(float h, float v) { s = fmaf(h, v, s); }
    __device__ float value() const { return s; }
};

template <>
struct Acc<float2, float> {
    float re = 0.f, im = 0.f;
    __device__ void mac(float h, float2 v) {
        re = fmaf(h, v.x, re);
        im = fmaf(h, v.y, im);
    }
    __device__ float2 value() const { return make_float2(re, im); }
};

template <>
struct Acc<float2, float2> {
    float rr = 0.f, ii = 0.f, ir = 0.f, ri = 0.f;
    __device__ void mac(float2 h, float2 v) {
        rr = fmaf(h.x, v.x, rr);
        ii = fmaf(h.y, v.y, ii);
        ir = fmaf(h.y, v.x, ir);
        ri = fmaf(h.x, v.y, ri);
    }
    __device__ float2 value() const { return make_float2(rr - ii, ir + ri); }
};

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }

__device__ __forceinline__ float shfl_xor(float v, int o) { return __shfl_xor_sync(0xffffffffu, v, o); }
__device__ __forceinline__ float2 shfl_xor(float2 v, int o) {
    return make_float2(__shfl_xor_sync(0xffffffffu, v.x, o), __shfl_xor_sync(0xffffffffu, v.y, o));
}

// an asynchronous copy of one sample from device to shared memory
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copy_async(float2* dst, const float2* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void copies_issued() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copies_landed() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// One CTA walks the work items blockIdx.x, + gridDim.x, ...: the (row,
// tile) items row by row, then one tail item a row (the tail and the next
// phase).  An item's raw span is copied into shared memory asynchronously
// while the CTA computes the item before it.
template <typename V, typename H>
__global__ void __launch_bounds__(kMaxThreads)
strided_fir_kernel(const V* __restrict__ x, int x_rows, const V* __restrict__ head, int head_len,
                   const H* __restrict__ taps, int n_taps, int taps_stride, int stride,
                   const unsigned* __restrict__ dphi, const unsigned* __restrict__ phase0,
                   V* __restrict__ y, V* __restrict__ tail, unsigned* __restrict__ phase1, int rows, int n,
                   int n_out, int n_tiles, int groups, int phase_sets, int splits, int q_split,
                   int taps_floats, int plane, int raw_off) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
#if K7_CLOCKS
    long long stamp_last = clock64();
    if (tid == 0 && blockIdx.x < 1024) {
        for (int k = 1; k < 6; ++k) g_clocks[blockIdx.x][k] = 0;
        g_clocks[blockIdx.x][0] = stamp_last;
    }
#endif
    const bool mix = dphi != nullptr;
    const int tile = groups * kR;
    const int items = rows * n_tiles;
    const int all_items = items + ((tail || phase1) ? rows : 0);
    Planes<H> hs(smem, n_taps);
    Planes<V> vs(smem + taps_floats, plane);
    V* raw = reinterpret_cast<V*>(smem + raw_off);

    // the item's span: v[m0 stride + i], i < len, from the head or from x
    auto issue = [&](int it) {
        const int row = it / n_tiles;
        const V* xr = x + static_cast<long long>(x_rows == 1 ? 0 : row) * n;
        const V* hr = head ? head + static_cast<long long>(row) * head_len : nullptr;
        const long long m0 = static_cast<long long>(it % n_tiles) * tile;
        const int count = static_cast<int>(min(static_cast<long long>(tile), n_out - m0));
        const int len = (count - 1) * stride + n_taps;
        for (int i = tid; i < len; i += blockDim.x) {
            const long long j = m0 * stride + i;
            copy_async(raw + i, j < head_len ? hr + j : xr + (j - head_len));
        }
        copies_issued();
    };

    // this thread: split s (a warp's lanes in S slices of 32 / S, so a
    // split's sums meet by shuffles), then group g and phase set ps (the
    // phases p = ps, ps + PS, ... < stride) in the plan's order; outputs
    // g R .. g R + R - 1 of a tile; of each of its phases the taps q in
    // [q0, q0 + q_split)
    const int slice = 32 / splits;
    const int s = (tid & 31) / slice;
    const int rest = (tid >> 5) * slice + (tid & 31) % slice;
    const bool gfast = group_fast(Plan{groups, phase_sets, splits, false});
    const int g = gfast ? rest % groups : (rest / phase_sets) % groups;
    const int ps = gfast ? rest / groups : rest % phase_sets;
    const int q0 = s * q_split;
    int staged_row = -1;

    int it = blockIdx.x;
    if (it < items) issue(it);
    for (; it < all_items; it += gridDim.x) {
        if (it >= items) {  // the tail and the next phase of a row
            const int row = it - items;
            const V* xr = x + static_cast<long long>(x_rows == 1 ? 0 : row) * n;
            const V* hr = head ? head + static_cast<long long>(row) * head_len : nullptr;
            const unsigned d = mix ? dphi[row] : 0u, p0 = mix ? phase0[row] : 0u;
            const long long total = static_cast<long long>(head_len) + n;
            // fewer samples than T - 1 (no output then): the tail holds them all
            const int t1 = static_cast<int>(min(static_cast<long long>(n_taps - 1), total));
            if (tail) {
                for (int i = tid; i < t1; i += blockDim.x) {
                    tail[static_cast<long long>(row) * t1 + i] =
                        sample_at(hr, head_len, xr, total - t1 + i, d, p0, mix);
                }
            }
            if (phase1 && tid == 0) phase1[row] = p0 + static_cast<unsigned>(n) * d;
            continue;
        }
        STAMP(0);
        const int row = it / n_tiles;
        const unsigned d = mix ? dphi[row] : 0u, p0 = mix ? phase0[row] : 0u;
        const long long m0 = static_cast<long long>(it % n_tiles) * tile;
        const int count = static_cast<int>(min(static_cast<long long>(tile), n_out - m0));
        const int len = (count - 1) * stride + n_taps;
        if (staged_row < 0 || (taps_stride != 0 && row != staged_row)) {  // the row's taps
            const H* hrow = taps + static_cast<long long>(row) * taps_stride;
            for (int k = tid; k < n_taps; k += blockDim.x) hs.put(k, hrow[k]);
            staged_row = row;
        }
        // this thread's copies have landed: mix them into the planes
        copies_landed();
        for (int i = tid; i < len; i += blockDim.x) {
            const long long j = m0 * stride + i - head_len;
            vs.put(pad(i), j < 0 ? raw[i] : mix_at(raw[i], j, d, p0, mix));
        }
        __syncthreads();  // the planes and taps are whole; raw is free
        if (it + static_cast<int>(gridDim.x) < items) issue(it + gridDim.x);
        STAMP(1);

        Acc<V, H> acc[kR];
        for (int p = ps; p < stride; p += phase_sets) {
            const int q1 = min(q0 + q_split, (n_taps - p + stride - 1) / stride);
            if (q0 >= q1) continue;
            // window slot (i mod R) holds u_p(i) = span[i stride + T - 1 - p];
            // q0 is a multiple of R, so the slots rotate with the tap index
            // and every index below is static.  A step loads the next step's
            // sample (clamped at the span's start past the phase's last tap,
            // where it is not used)
            int at = (g * kR - q0) * stride + n_taps - 1 - p;  // u_p(g R - q), q = q0
            V w[kR];
#pragma unroll
            for (int r = 0; r < kR; ++r) w[r] = vs.get(pad(at + r * stride));
            int k = p + q0 * stride;  // the tap h[p + q stride]
            int qc = q0;
            for (; qc + kR <= q1; qc += kR) {  // whole runs of R taps: no guard, loads hoisted
#pragma unroll
                for (int sub = 0; sub < kR; ++sub) {
                    const H h = hs.get(k);
#pragma unroll
                    for (int r = 0; r < kR; ++r) acc[r].mac(h, w[(r - sub + kR) % kR]);
                    at -= stride;
                    k += stride;
                    w[(kR - 1 - sub) % kR] = vs.get(pad(max(at, 0)));
                }
            }
#pragma unroll
            for (int sub = 0; sub < kR - 1; ++sub) {  // the rest, fewer than R taps
                if (qc + sub < q1) {
                    const H h = hs.get(k);
#pragma unroll
                    for (int r = 0; r < kR; ++r) acc[r].mac(h, w[(r - sub + kR) % kR]);
                    at -= stride;
                    k += stride;
                    w[(kR - 1 - sub) % kR] = vs.get(pad(max(at, 0)));
                }
            }
        }
        STAMP(2);
        // a split's sums by shuffles (lanes s, s ^ 1, ...), then the phase
        // sets' in shared memory, set by set
        V v[kR];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
            v[r] = acc[r].value();
            for (int o = slice; o < 32; o <<= 1) v[r] = add(v[r], shfl_xor(v[r], o));
        }
        V* yr = y + static_cast<long long>(row) * n_out + m0;
        if (phase_sets == 1) {
            if (s == 0) {
#pragma unroll
                for (int r = 0; r < kR; ++r) {
                    if (g * kR + r < count) yr[g * kR + r] = v[r];
                }
            }
            __syncthreads();  // every thread is done with the planes and taps
        } else {
            __syncthreads();  // every thread is done with the planes
            const int ld = tile + 1;
            Planes<V> red(smem + taps_floats, static_cast<long>(phase_sets) * ld);
            if (s == 0) {
#pragma unroll
                for (int r = 0; r < kR; ++r) red.put(ps * ld + g * kR + r, v[r]);
            }
            __syncthreads();
            for (int o = tid; o < count; o += blockDim.x) {
                V sum = red.get(o);
                for (int k2 = 1; k2 < phase_sets; ++k2) sum = add(sum, red.get(k2 * ld + o));
                yr[o] = sum;
            }
            __syncthreads();  // the sums are read: the planes are free
        }
        STAMP(3);
    }
#if K7_CLOCKS
    if (tid == 0 && blockIdx.x < 1024) g_clocks[blockIdx.x][4] = clock64();
#endif
}

// shared memory of a plan, in floats: the taps' planes; the span's planes
// or, where phase sets add their sums, their planes if larger; the raw span
template <typename V, typename H>
long smem_floats(int n_taps, int stride, Plan p, int* taps_floats, long* plane, long* raw_off) {
    const int tf = ((n_taps * static_cast<int>(sizeof(H) / 4)) + 3) & ~3;
    const int tile = p.g * kR;
    const long span = static_cast<long>(tile - 1) * stride + n_taps;
    const long planes = sizeof(V) / 4;
    long body = planes * plane_len(span);
    if (p.ps > 1 && planes * p.ps * (tile + 1) > body) body = planes * p.ps * (tile + 1);
    *taps_floats = tf;
    *plane = plane_len(span);
    *raw_off = (tf + body + 3) & ~3L;
    return *raw_off + planes * span;
}

template <typename V, typename H>
int launch_fir(const void* x, int x_rows, const void* head, int head_len, const void* taps,
               int n_taps, int taps_stride, int stride, const void* dphi, const void* phase0,
               void* y, void* tail, void* phase1, int rows, int n, int n_out, Plan p,
               cudaStream_t stream) {
    const int q = (n_taps + stride - 1) / stride;
    const long threads = static_cast<long>(p.ps) * p.g * p.s;
    // splits are lanes of whole warps (their sums meet by shuffles)
    if (p.g < 1 || p.s < 1 || p.s > 32 || (p.s & (p.s - 1)) || p.ps < 1 || p.ps > stride ||
        threads > kMaxThreads || threads < 32 || (p.s > 1 && threads % 32))
        return static_cast<int>(cudaErrorInvalidValue);
    // each split a multiple of R taps, so the window's slots start in place
    const int q_split = ((q + p.s - 1) / p.s + kR - 1) / kR * kR;
    int taps_floats;
    long plane, raw_off;
    const long floats = smem_floats<V, H>(n_taps, stride, p, &taps_floats, &plane, &raw_off);
    if (floats * 4 > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = static_cast<size_t>(floats) * 4;
    auto kernel = strided_fir_kernel<V, H>;
    // all of the SM's 228 KB as shared memory, so two wide CTAs fit an SM
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tile = p.g * kR;
    const int n_tiles = (n_out + tile - 1) / tile;
    const long all_items = static_cast<long>(rows) * n_tiles + ((tail || phase1) ? rows : 0);
    if (all_items == 0) return 0;
    // persistent CTAs: as many as the card holds at once, at most one an item
    int per_sm = 0, sms = 0, dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, static_cast<int>(threads), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long resident = static_cast<long>(per_sm > 1 ? per_sm : 1) * sms;
    const long ctas = all_items < resident ? all_items : resident;
#if K7_CLOCKS
    g_launch[0] = per_sm;
    g_launch[1] = static_cast<int>(ctas);
#endif
    kernel<<<static_cast<unsigned>(ctas), static_cast<unsigned>(threads), smem, stream>>>(
        static_cast<const V*>(x), x_rows, static_cast<const V*>(head), head_len,
        static_cast<const H*>(taps), n_taps, taps_stride, stride,
        static_cast<const unsigned*>(dphi),
        static_cast<const unsigned*>(phase0), static_cast<V*>(y), static_cast<V*>(tail),
        static_cast<unsigned*>(phase1), rows, n, n_out, n_tiles, p.g, p.ps, p.s, q_split, taps_floats,
        static_cast<int>(plane), static_cast<int>(raw_off));
    return static_cast<int>(cudaGetLastError());
}

// The direct variant, for small launches of short filters: a CTA a tile
// of 128 outputs of a row, its span (127 x stride + T samples, mixed once)
// and the row's taps staged in shared memory, a thread an output summing
// its taps in order; an extra CTA a row writes the tail and the next phase.
// Its short items beat the pipeline's fixed costs there
// (scripts/k7_k14_variants.py).
template <typename V, typename H>
__global__ void __launch_bounds__(kDirectTile)
direct_strided_fir_kernel(const V* __restrict__ x, int x_rows, const V* __restrict__ head, int head_len,
                  const H* __restrict__ taps, int n_taps, int taps_stride, int stride,
                  const unsigned* __restrict__ dphi, const unsigned* __restrict__ phase0,
                  V* __restrict__ y, V* __restrict__ tail, unsigned* __restrict__ phase1, int n, int n_out,
                  int n_tiles) {
    extern __shared__ __align__(16) float smem[];
    H* h = reinterpret_cast<H*>(smem);
    V* span = reinterpret_cast<V*>(smem + ((n_taps * (sizeof(H) / 4) + 3) & ~3));
    const int row = blockIdx.y;
    const V* xr = x + static_cast<long long>(x_rows == 1 ? 0 : row) * n;
    const V* hr = head ? head + static_cast<long long>(row) * head_len : nullptr;
    const bool mix = dphi != nullptr;
    const unsigned d = mix ? dphi[row] : 0u, p0 = mix ? phase0[row] : 0u;
    if (static_cast<int>(blockIdx.x) == n_tiles) {  // the tail and the next phase
        const long long total = static_cast<long long>(head_len) + n;
        const int t1 = static_cast<int>(min(static_cast<long long>(n_taps - 1), total));
        if (tail) {
            for (int i = threadIdx.x; i < t1; i += blockDim.x)
                tail[static_cast<long long>(row) * t1 + i] = sample_at(hr, head_len, xr, total - t1 + i, d, p0, mix);
        }
        if (phase1 && threadIdx.x == 0) phase1[row] = p0 + static_cast<unsigned>(n) * d;
        return;
    }
    const H* hrow = taps + static_cast<long long>(row) * taps_stride;
    for (int k = threadIdx.x; k < n_taps; k += blockDim.x) h[k] = hrow[k];
    const long long m0 = static_cast<long long>(blockIdx.x) * kDirectTile;
    const int count = static_cast<int>(min(static_cast<long long>(kDirectTile), n_out - m0));
    const int len = (count - 1) * stride + n_taps;
    for (int i = threadIdx.x; i < len; i += blockDim.x)
        span[i] = sample_at(hr, head_len, xr, m0 * stride + i, d, p0, mix);
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= count) return;
    const V* w = span + threadIdx.x * stride + n_taps - 1;
    Acc<V, H> acc;
    for (int k = 0; k < n_taps; ++k) acc.mac(h[k], w[-k]);
    y[static_cast<long long>(row) * n_out + m0 + threadIdx.x] = acc.value();
}

template <typename V, typename H>
int launch_direct(const void* x, int x_rows, const void* head, int head_len, const void* taps, int n_taps,
                  int taps_stride, int stride, const void* dphi, const void* phase0, void* y, void* tail,
                  void* phase1, int rows, int n, int n_out, cudaStream_t stream) {
    const int n_tiles = (n_out + kDirectTile - 1) / kDirectTile;
    const size_t span = static_cast<size_t>(kDirectTile - 1) * stride + n_taps;
    const size_t smem = sizeof(float) * ((n_taps * (sizeof(H) / 4) + 3) & ~3) + sizeof(V) * span;
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(direct_strided_fir_kernel<V, H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int extra = (tail || phase1) ? 1 : 0;
    if (n_tiles + extra == 0 || rows <= 0) return 0;
    direct_strided_fir_kernel<V, H><<<dim3(n_tiles + extra, rows), kDirectTile, smem, stream>>>(
        static_cast<const V*>(x), x_rows, static_cast<const V*>(head), head_len, static_cast<const H*>(taps),
        n_taps, taps_stride, stride, static_cast<const unsigned*>(dphi), static_cast<const unsigned*>(phase0),
        static_cast<V*>(y), static_cast<V*>(tail), static_cast<unsigned*>(phase1), n, n_out, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

template <typename V, typename H>
int launch_variant(const void* x, int x_rows, const void* head, int head_len, const void* taps, int n_taps,
             int taps_stride, int stride, const void* dphi, const void* phase0, void* y, void* tail,
             void* phase1, int rows, int n, int n_out, Plan p, cudaStream_t s) {
    if (p.direct)
        return launch_direct<V, H>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride, dphi, phase0,
                                   y, tail, phase1, rows, n, n_out, s);
    return launch_fir<V, H>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride, dphi, phase0, y,
                            tail, phase1, rows, n, n_out, p, s);
}

int dispatch(const void* x, int x_rows, const void* head, int head_len, const void* taps, int n_taps,
             int taps_stride, int taps_cplx, int stride, const void* dphi, const void* phase0, void* y,
             void* tail, void* phase1, int rows, int n, int n_out, int cplx, Plan p, cudaStream_t s) {
    if (n_taps < 1 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (taps_cplx) {
        if (!cplx) return static_cast<int>(cudaErrorInvalidValue);  // complex taps, complex rows
        return launch_variant<float2, float2>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride, dphi,
                                        phase0, y, tail, phase1, rows, n, n_out, p, s);
    }
    if (cplx) {
        return launch_variant<float2, float>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride, dphi,
                                       phase0, y, tail, phase1, rows, n, n_out, p, s);
    }
    if (dphi) return static_cast<int>(cudaErrorInvalidValue);  // the NCO mixes complex input
    return launch_variant<float, float>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride, nullptr,
                                  nullptr, y, tail, phase1, rows, n, n_out, p, s);
}

}  // namespace

#if K7_CLOCKS
WAVECAP_EXPORT int k7_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks)));
}
WAVECAP_EXPORT int k7_launch_shape(int* host) {
    host[0] = g_launch[0];
    host[1] = g_launch[1];
    return 0;
}
#endif

// K7 by the plan ops/fir.py:k7_plan chose: groups of R outputs an item,
// phase sets, the taps' splits, or (direct != 0) the direct variant.  A
// plan past a block's threads or shared memory is refused.
WAVECAP_EXPORT int k7_strided_fir(const void* x, int x_rows, const void* head, int head_len,
                                  const void* taps, int n_taps, int taps_stride, int taps_cplx,
                                  int stride, const void* dphi, const void* phase0, void* y,
                                  void* tail, void* phase1, int rows, int n, int n_out, int cplx,
                                  int groups, int phase_sets, int splits, int direct, void* stream) {
    return dispatch(x, x_rows, head, head_len, taps, n_taps, taps_stride, taps_cplx, stride, dphi,
                    phase0, y, tail, phase1, rows, n, n_out, cplx, Plan{groups, phase_sets, splits, direct != 0},
                    static_cast<cudaStream_t>(stream));
}
