// K11a: the impulse noise blanker, one thread-block cluster a row.
//
// Replaces wavecap_tpu/ops/noise.py:noise_blanker.  Per row x of n
// samples (float32, or complex64 with |x| = hypotf(re, im)):
//
//   median = (a[(n-1)/2] + a[n/2]) * 0.5     a = sort(|x|)  (jnp.median's midpoint)
//   thr    = median * factor                 factor = f32(10^(threshold_db/20)), host-rounded
//   blank  = any(|x[j]| > thr, |j - i| <= w) (reduce_window max, SAME, padded with 0)
//   out[i] = blank && !(median < 1e-10) ? 0 : x[i]
//
// Bound on the H100: bytes.  The rows are read from HBM once and written
// once: at 160 rows x 4,920 complex samples 6.3 MB each way, ~3.8 us at
// 3.35 TB/s.  What a CTA does between the load and the store (passes,
// barriers) takes longer than that: the design cuts the passes and their
// reads, and keeps a row's CTAs to one wave of the card.
//
// Design (the launch plan is ops/noise.py:k11a_plan):
// * a row is split over a cluster of `ctas` CTAs (1 for the narrow rows,
//   8 for the wide IF's 48,000 samples), each CTA a 32-aligned slice;
// * each sample's |x| is computed once: a slice of one chunk (ITEMS x 512
//   samples) keeps it in registers (a real row keeps x itself, |x| being
//   its bits without the sign), a longer one in shared memory as uint32
//   bits (|x| >= 0, so the bits order as the floats do);
// * the median is an exact radix select over digits of (11, 11, 10) bits
//   from the top: three passes, each counting the elements that share the
//   prefix found so far into a shared histogram with plain atomics (a warp
//   aggregation by __match_any_sync measured slower, scripts/k11a_variants.py),
//   then every warp finds the bucket itself from the warps' totals and one
//   warp's run of bins (no second barrier).  A cluster sums its CTAs'
//   histograms through distributed shared memory, so every CTA finds the
//   same digit.  The last pass also finds rank n/2: the bucket of rank k+1
//   when it lies in the last prefix's range, else the least magnitude
//   above that range, kept by the same pass;
// * the mask: each warp ballots |x| > thr over 32 consecutive samples into
//   one word; a thread dilates a word by +-w (w < 32: the word pairs q-1:q
//   and q:q+1 spread by doubling; else funnel shifts over the neighbouring
//   words), reading a neighbour CTA's words through distributed shared
//   memory; each output is one bit test and one coalesced 8- or 4-byte
//   store;
// * the staged kernels are compiled for 2 CTAs an SM (64 registers), so
//   160 rows take one wave of 132 SMs;
// * a slice too long for shared memory (`staged` = 0; rows past ~350,000
//   samples) recomputes |x| from global memory (L2) in every pass and keeps
//   its mask words in a global scratch row.
#include <cooperative_groups.h>

#include <climits>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxPer = 4;        // histogram bins a thread sums (bins / threads)
constexpr int kSmemMax = 232448;  // the H100's 227 KB a block, static and dynamic
// Build switches for scripts/k11a_variants.py: K11A_MINB, the CTAs an SM
// the staged kernels are compiled for (2 caps them at 64 registers, so 160
// rows take one wave of 132 SMs), and K11A_CLOCKS, clock64 at the end of
// each phase in thread 0 of each of the first 256 CTAs (k11a_clocks reads
// them back).
#ifndef K11A_MINB
#define K11A_MINB 2
#endif
#ifndef K11A_CLOCKS
#define K11A_CLOCKS 0
#endif
#if K11A_CLOCKS
__device__ long long g_clocks[256][17];
#define STAMP(k) do { if (threadIdx.x == 0 && blockIdx.x < 256) g_clocks[blockIdx.x][k] = clock64(); } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

__device__ __forceinline__ unsigned warp_min(unsigned v) {
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

// c[0 .. per) += p[0 .. per), in one 16- or 8-byte load (per is 1, 2 or 4;
// a run starts at a multiple of per, so the loads are aligned)
__device__ __forceinline__ void add_run(const unsigned* p, int per, unsigned (&c)[kMaxPer]) {
    if (per == 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        c[0] += q.x;
        c[1] += q.y;
        c[2] += q.z;
        c[3] += q.w;
    } else if (per == 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(p);
        c[0] += q.x;
        c[1] += q.y;
    } else {
        c[0] += p[0];
    }
}

template <bool CPLX>
struct Row {
    using T = typename std::conditional<CPLX, float2, float>::type;
    __device__ __forceinline__ static unsigned bits(T v) {
        if constexpr (CPLX) return __float_as_uint(hypotf(v.x, v.y));
        else return __float_as_uint(fabsf(v));
    }
    __device__ __forceinline__ static T zero() {
        if constexpr (CPLX) return make_float2(0.f, 0.f);
        else return 0.f;
    }
};

// Shared memory (dynamic): hist[2][1 << max digit] (passes alternate, so a
// CTA clears the next pass's histogram while its cluster may still read
// this one's), tot[1 << max digit] (a cluster's sums), then, when staged,
// words[slice / 32], dwords[slice / 32] (the dilated words) and
// mags[slice] (for a slice of more than one chunk).  A long slice keeps
// its words and dwords in the scratch row wbuf[row] = [words | dwords].
// Every loop over a slice takes chunks of ITEMS x threads samples and
// issues a chunk's loads before it uses them.
template <bool CPLX, bool STAGED, int ITEMS>
__global__ void __launch_bounds__(kMaxThreads, STAGED ? K11A_MINB : 1)
noise_blanker_kernel(const float* __restrict__ x, float* __restrict__ out, unsigned* __restrict__ wbuf,
                     int n, int slice, int d0, int d1, int d2, float factor, int width) {
    using T = typename Row<CPLX>::T;
    extern __shared__ __align__(16) unsigned smem[];
    __shared__ unsigned s_warp[32];
    __shared__ unsigned s_min[32];

    cg::cluster_group cluster = cg::this_cluster();
    const int nct = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int threads = blockDim.x, n_warps = threads >> 5;
    const long row = blockIdx.x / nct;
    const int start = rank * slice;
    const int len = max(0, min(slice, n - start));
    const int n_words = (n + 31) >> 5;
    const int wpc = slice >> 5;  // words a CTA
    const T* xr = reinterpret_cast<const T*>(x) + row * n + start;
    T* yr = reinterpret_cast<T*>(out) + row * n + start;
    auto csync = [&]() {
        if (nct > 1) cluster.sync();
        else __syncthreads();
    };
    STAMP(0);

    const int bins = 1 << max(d0, max(d1, d2));
    unsigned* hist = smem;  // two buffers of bins
    unsigned* tot = hist + 2 * bins;
    unsigned* words = STAGED ? tot + (nct > 1 ? bins : 0) : wbuf + row * 2 * n_words;  // word q of the row at [q]
    unsigned* dwords = STAGED ? words + wpc : words + n_words;             // this CTA's at [q - rank wpc]
    unsigned* mags = dwords + wpc;
    unsigned* my_words = STAGED ? words : words + rank * wpc;
    unsigned* my_dwords = STAGED ? dwords : dwords + rank * wpc;
    const int chunk = ITEMS * threads;
    const bool single = STAGED && len <= chunk;

    // a chunk's magnitude bits: from registers, shared memory or the row.
    // A one-chunk slice keeps a word a sample in registers: |x|'s bits
    // (complex rows; x is read again for the store) or x's own (real rows,
    // |x| being its bits without the sign)
    unsigned kept[ITEMS];
    auto chunk_bits = [&](int c0, unsigned (&u)[ITEMS]) {
        if (single) {
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) u[j] = CPLX ? kept[j] : kept[j] & 0x7FFFFFFFu;
        } else if (STAGED) {
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const int i = c0 + j * threads + tid;
                u[j] = i < len ? mags[i] : 0u;
            }
        } else {
            T v[ITEMS];
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const int i = c0 + j * threads + tid;
                if (i < len) v[j] = xr[i];
            }
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) u[j] = c0 + j * threads + tid < len ? Row<CPLX>::bits(v[j]) : 0u;
        }
    };

    for (int b = tid; b < (1 << d0); b += threads) hist[b] = 0;
    __syncthreads();
    // no barrier after the staging: a thread counts only the samples it staged
    if (STAGED) {
        for (int c0 = 0; c0 < len; c0 += chunk) {
            T v[ITEMS];
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const int i = c0 + j * threads + tid;
                if (i < len) v[j] = xr[i];
            }
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const int i = c0 + j * threads + tid;
                const unsigned u = i < len ? Row<CPLX>::bits(v[j]) : 0u;
                if (single) {
                    if constexpr (CPLX) kept[j] = u;
                    else kept[j] = i < len ? __float_as_uint(v[j]) : 0u;
                } else if (i < len) {
                    mags[i] = u;
                }
            }
        }
    }
    STAMP(1);

    // the radix select of rank lo = (n-1)/2; rank hi = n/2 from the last pass
    const unsigned lo = static_cast<unsigned>(n - 1) / 2u, hi = static_cast<unsigned>(n) / 2u;
    unsigned prefix = 0, pmask = 0, k = lo, a_hi = 0;
    int shift = 32;
    for (int p = 0; p < 3; ++p) {
        const int width_p = p == 0 ? d0 : (p == 1 ? d1 : d2);
        shift -= width_p;
        const int nb = 1 << width_p;
        const unsigned dmask = static_cast<unsigned>(nb - 1);
        const bool last = p == 2;
        unsigned* h = hist + (p & 1) * bins;
        // elements above the last prefix's range: u > prefix | low bits
        const unsigned top = prefix | ~pmask;
        unsigned above = 0xFFFFFFFFu;
        for (int c0 = 0; c0 < len; c0 += chunk) {
            unsigned u[ITEMS];
            chunk_bits(c0, u);
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const bool live = c0 + j * threads + tid < len;
                if (live && (u[j] & pmask) == prefix) atomicAdd(&h[(u[j] >> shift) & dmask], 1u);
                if (last && live && u[j] > top) above = min(above, u[j]);
            }
        }
        if (last) {
            above = warp_min(above);
            if (lane == 0) s_min[warp] = above;
        }
        STAMP(2 + 4 * p);
        csync();  // every CTA's histogram (and minimum) is whole
        STAMP(3 + 4 * p);
        // this thread's run of `per` bins (a cluster sums its CTAs' into
        // tot), and each warp's total
        const int per = nb / threads;
        unsigned c[kMaxPer] = {};
        if (nct == 1) {
            add_run(h + tid * per, per, c);
        } else {
#pragma unroll
            for (int r = 0; r < 8; ++r)
                if (r < nct) add_run(cluster.map_shared_rank(h, r) + tid * per, per, c);
#pragma unroll
            for (int j = 0; j < kMaxPer; ++j)
                if (j < per) tot[tid * per + j] = c[j];
        }
        const unsigned* cnt = nct == 1 ? h : tot;
        unsigned local = 0;
#pragma unroll
        for (int j = 0; j < kMaxPer; ++j) local += c[j];
        const unsigned wsum = __reduce_add_sync(0xffffffffu, local);
        if (lane == 0) s_warp[warp] = wsum;
        // the next pass's histogram is no CTA's any more: clear it now
        if (!last)
            for (int b = tid; b < (1 << (p == 0 ? d1 : d2)); b += threads) hist[((p + 1) & 1) * bins + b] = 0;
        __syncthreads();  // the warps' totals and the cluster's sums are whole
        STAMP(4 + 4 * p);
        // every warp finds the buckets itself: the warp segment holding rank
        // r by the warps' totals, then the bin by the segment's runs
        const unsigned wt = lane < n_warps ? s_warp[lane] : 0u;
        unsigned winc = wt;
        for (int o = 1; o < 32; o <<= 1) {
            const unsigned v = __shfl_up_sync(0xffffffffu, winc, o);
            if (lane >= o) winc += v;
        }
        // rank r's bucket and the count below it (-1: r is past the counts)
        auto locate = [&](unsigned r, unsigned* below) -> int {
            const unsigned in_seg = __ballot_sync(0xffffffffu, lane < n_warps && r < winc);
            if (in_seg == 0) return -1;
            const int seg = __ffs(in_seg) - 1;
            const unsigned base = __shfl_sync(0xffffffffu, winc - wt, seg);
            unsigned cc[kMaxPer] = {};
            add_run(cnt + (seg * 32 + lane) * per, per, cc);
            unsigned lsum = 0;
#pragma unroll
            for (int j = 0; j < kMaxPer; ++j) lsum += cc[j];
            unsigned linc = lsum;
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned v = __shfl_up_sync(0xffffffffu, linc, o);
                if (lane >= o) linc += v;
            }
            const int owner = __ffs(__ballot_sync(0xffffffffu, r < base + linc)) - 1;
            unsigned cum = base + linc - lsum;
            int bj = per - 1;
            bool found = false;
#pragma unroll
            for (int j = 0; j < kMaxPer; ++j) {
                if (j < per && !found) {
                    if (r < cum + cc[j]) {
                        bj = j;
                        found = true;
                    } else {
                        cum += cc[j];
                    }
                }
            }
            *below = __shfl_sync(0xffffffffu, cum, owner);
            return __shfl_sync(0xffffffffu, (seg * 32 + lane) * per + bj, owner);
        };
        unsigned below = 0;
        const unsigned b = static_cast<unsigned>(locate(k, &below));
        if (last) {
            unsigned ignored;
            const int b_hi = hi != lo ? locate(k + 1, &ignored) : static_cast<int>(b);
            if (b_hi >= 0) {
                a_hi = prefix | static_cast<unsigned>(b_hi);
            } else {  // rank hi is the least magnitude above the prefix's range
                unsigned m = 0xFFFFFFFFu;
                for (int e = lane; e < nct * n_warps; e += 32)
                    m = min(m, nct > 1 ? cluster.map_shared_rank(s_min, e / n_warps)[e % n_warps] : s_min[e]);
                a_hi = warp_min(m);
            }
        }
        k -= below;
        prefix |= b << shift;
        pmask |= dmask << shift;
        STAMP(5 + 4 * p);
    }
    const float median = __fmul_rn(__fadd_rn(__uint_as_float(prefix), __uint_as_float(a_hi)), 0.5f);
    const float thr = __fmul_rn(median, factor);
    const bool degenerate = median < 1e-10f;

    // the mask, a bit a sample: words of 32 consecutive samples (a warp's
    // lanes hold 32 consecutive samples at each j)
    if (!degenerate) {
        for (int c0 = 0; c0 < len; c0 += chunk) {
            unsigned u[ITEMS];
            chunk_bits(c0, u);
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const int i = c0 + j * threads + tid;
                const unsigned word = __ballot_sync(0xffffffffu, i < len && __uint_as_float(u[j]) > thr);
                if (lane == 0 && i < len) my_words[i >> 5] = word;
            }
        }
        if (!STAGED) __threadfence();
    }
    csync();  // every CTA's words are whole
    STAMP(14);

    // the dilation: a thread a word q of this slice, the OR over d in
    // [-w, w] of the 32 bits from sample 32 q + d (a funnel shift of words
    // floor(s / 32) and floor(s / 32) + 1, 0 outside the row)
    auto word_at = [&](int q) -> unsigned {
        if (q < 0 || q >= n_words) return 0u;
        if (!STAGED) return words[q];
        const int local = q - rank * wpc;
        if (local >= 0 && local < wpc) return words[local];
        const int r = q / wpc;
        return cluster.map_shared_rank(words, r)[q - r * wpc];
    };
    if (!degenerate) {
        for (int t = tid; t < (len + 31) >> 5; t += threads) {
            const int q = rank * wpc + t;
            unsigned acc = 0;
            if (width < 32) {
                // words q-1:q spread right (to later samples) and q:q+1 spread
                // left by 0..w, doubling the covered shifts each step
                const unsigned prev = word_at(q - 1), mid = word_at(q), next = word_at(q + 1);
                unsigned long long r = (static_cast<unsigned long long>(mid) << 32) | prev;
                unsigned long long l = (static_cast<unsigned long long>(next) << 32) | mid;
                for (int cover = 1; cover <= width;) {
                    const int step = min(cover, width + 1 - cover);
                    r |= r << step;
                    l |= l >> step;
                    cover += step;
                }
                acc = static_cast<unsigned>(r >> 32) | static_cast<unsigned>(l);
            } else {
                unsigned a = 0, b2 = 0;
                int held = INT_MIN;  // no pair held yet (qq may be -1)
                for (int d = -width; d <= width; ++d) {
                    const int s = (q << 5) + d;
                    const int qq = s >> 5;
                    if (qq != held) {
                        a = word_at(qq);
                        b2 = word_at(qq + 1);
                        held = qq;
                    }
                    acc |= __funnelshift_r(a, b2, static_cast<unsigned>(s & 31));
                }
            }
            my_dwords[t] = acc;
        }
    }
    csync();  // the dilated words are whole, and no CTA reads another's words any more
    STAMP(15);

    for (int c0 = 0; c0 < len; c0 += chunk) {
        T v[ITEMS];
        bool reused = false;
        if constexpr (!CPLX) {
            if (single) {
#pragma unroll
                for (int j = 0; j < ITEMS; ++j) v[j] = __uint_as_float(kept[j]);
                reused = true;
            }
        }
        if (!reused) {
#pragma unroll
            for (int j = 0; j < ITEMS; ++j) {
                const int i = c0 + j * threads + tid;
                if (i < len) v[j] = xr[i];
            }
        }
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
            const int i = c0 + j * threads + tid;
            if (i < len) {
                const bool blank = !degenerate && ((my_dwords[i >> 5] >> (i & 31)) & 1u);
                yr[i] = blank ? Row<CPLX>::zero() : v[j];
            }
        }
    }
    STAMP(16);
}

template <typename K>
cudaError_t opt_in(K kernel) {
    cudaFuncAttributes a;
    cudaError_t e = cudaFuncGetAttributes(&a, kernel);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSmemMax - static_cast<int>(a.sharedSizeBytes));
}

template <bool CPLX, bool STAGED, int ITEMS>
int launch_blanker(const float* x, float* out, unsigned* wbuf, int rows, int n, int ctas, int threads,
                   int slice, int d0, int d1, int d2, int smem_bytes, float factor, int width,
                   cudaStream_t stream) {
    auto kernel = noise_blanker_kernel<CPLX, STAGED, ITEMS>;
    // the opt-in is per device: set it at every launch
    cudaError_t e = opt_in(kernel);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = static_cast<size_t>(smem_bytes);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, kernel, x, out, wbuf, n, slice, d0, d1, d2, factor, width);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan's fields (ops/noise.py:k11a_plan) come in as they are; what the
// kernel cannot take is refused here, before a launch.
#if K11A_CLOCKS
WAVECAP_EXPORT int k11a_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_clocks, sizeof(g_clocks)));
}
#endif

WAVECAP_EXPORT int k11a_noise_blanker(const void* x, void* out, void* wbuf, int rows, int n, int cplx,
                                      float factor, int width, int ctas, int threads, int items, int slice,
                                      int staged, int d0, int d1, int d2, int smem_bytes, void* stream) {
    const int widest = d0 > d1 ? (d0 > d2 ? d0 : d2) : (d1 > d2 ? d1 : d2);
    const long need = 4L * ((ctas > 1 ? 3L : 2L) * (1L << (widest > 12 ? 12 : widest)) +
                            (staged ? 2L * (slice / 32) + slice : 0));
    if (d0 + d1 + d2 != 32 || d0 < 1 || d1 < 1 || d2 < 1 || widest > 12 || ctas < 1 || ctas > 8 ||
        threads < 32 || threads > kMaxThreads || threads % 32 || (1 << d0) % threads || (1 << d1) % threads ||
        (1 << d2) % threads || (1 << widest) > kMaxPer * threads || slice % 32 ||
        !(items == 12 || (items == 10 && staged)) || static_cast<long>(ctas) * slice < n ||
        (!staged && wbuf == nullptr) || width < 0 || smem_bytes < need || smem_bytes > kSmemMax)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto* xf = static_cast<const float*>(x);
    auto* yf = static_cast<float*>(out);
    auto* wb = static_cast<unsigned*>(wbuf);
    auto* s = static_cast<cudaStream_t>(stream);
#define K11A_LAUNCH(C, S, I) \
    launch_blanker<C, S, I>(xf, yf, wb, rows, n, ctas, threads, slice, d0, d1, d2, smem_bytes, factor, width, s)
    if (cplx) {
        if (!staged) return K11A_LAUNCH(true, false, 12);
        return items == 10 ? K11A_LAUNCH(true, true, 10) : K11A_LAUNCH(true, true, 12);
    }
    if (!staged) return K11A_LAUNCH(false, false, 12);
    return items == 10 ? K11A_LAUNCH(false, true, 10) : K11A_LAUNCH(false, true, 12);
#undef K11A_LAUNCH
}
