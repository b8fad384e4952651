// K14: the simulcast echo fit of the P25 equalizer.
//
// Replaces wavecap_tpu/models/p25/equalizer.py:fit_and_invert (the block
// acf, its EMA and guards, the candidate match, the gate and the MMSE
// inverse), :block_acf, and the scoring inside :resolve_cfo_alias.  Three
// kernels on the stream, one C entry:
//
//  1. acf, a cluster of CTAs a row: r[t] = mean(x[t:] conj(x[:n-t])) for
//     t <= n_tau, r /= max(Re r[0], 1e-9), zeroed if not finite; in fit
//     mode the EMA with the carried acf (where it is not all zero) and the
//     enable guard, in the reference's order.
//  2. residuals on a 2-D grid (candidate tile x row group): each thread
//     holds one candidate's predictions in registers and scores
//     sum_t |p[t] - acf[t]|^2 (hypotf, squared, summed in lag order)
//     against every row of its group, whose acf is in shared memory.  The
//     first minimum comes from atomicMin on a packed u64 (float bits << 32
//     | index): residuals are >= 0, so their bits order as integers, and
//     on a tie the lower index wins, as jnp.argmin's.
//  3. epilogue, one CTA a row: the gate (resid[j] < 0.6 resid[0], a >=
//     0.35, enable), then W[k] = conj(H)/(|H|^2 + lambda) on the 512 FFT
//     points and the taps as the direct inverse DFT at the n_taps needed
//     indices, (1/512) sum_k W[k] e^{+2 pi i k m / 512}, summed in double
//     from a 512-entry table of e^{i pi j / 256} (the twiddle depends only
//     on k m mod 512).  Score mode writes the least residual instead.
//
// Bound on the H100: operations.  Program B's fit reads 21 x 7,500
// complex rows (1.3 MB) and the 12,289 x 29 complex prediction table
// (2.85 MB) once, ~1.2 us at 3.35 TB/s; the acf is 21 x 7,500 x 29 x 8
// (37 MFLOP) and the residuals 21 x 12,289 x 29 hypotf terms (~150 M
// thread instructions, ~4.5 us at the card's issue rate).  Design:
//
// * acf in one pass: a thread takes 8 consecutive samples and keeps all
//   lags' sums in registers (2 x 29 accumulators), its samples and their
//   28-sample lookback read once from a staged chunk (1,024 samples and
//   its lookback a CTA pass, laid out with 2 float2 of padding every 8 so
//   the 16-byte reads are free of bank conflicts); one reduction of the
//   58 sums a CTA, then the cluster's CTAs (up to 8 a row, so 21 rows
//   fill the card) add theirs through distributed shared memory in rank
//   order.  The row streams through in chunks: no length limit.
// * residuals: tiles of 256 candidates, their predictions staged through
//   shared memory with coalesced loads; row groups sized so that about two
//   CTAs an SM run at 21 or 63 rows.  Each CTA reduces its minima in
//   shared memory before one global atomicMin a row.
// * epilogue: the twiddle table is built once a CTA (one sincospi a
//   thread); a lane holds its 16 values of W in registers, and a warp sums
//   the taps c - m' and c + m' together (their twiddles are conjugate: one
//   table read a term), 16 terms a lane and a double shuffle reduction.
//   The no-echo candidate's residual for the gate: a lag a lane, summed in
//   lag order by shuffles.
//
// The launch plan of the acf (CTAs a row, samples a thread and a pass) is
// mirrored by models/p25/equalizer.py:k14_plan, which the CPU tests
// emulate.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLags = 32;  // n_tau + 1 = max_delay + 13 = 29 by default
constexpr int kNfft = 512;    // EQ_NFFT
constexpr int kAcfThreads = 128;
constexpr int kPer = 8;                        // samples a thread a pass
constexpr int kChunk = kAcfThreads * kPer;     // samples a CTA a pass
constexpr int kLook = 32;                      // staged lookback (>= lags - 1, a multiple of 8)
constexpr int kMaxCtas = 8;                    // CTAs (one cluster) a row
constexpr int kResThreads = 256;               // candidates a residual tile
constexpr int kResTarget = 2 * 132;            // residual CTAs to aim for: two an SM
constexpr int kMaxGroupRows = 512;             // rows of a residual group, at most

// Build switch for scripts/k7_k14_variants.py: K14_CLOCKS, clock64 at the
// end of each stage in thread 0 of the first CTAs of each kernel (the
// acf's stage and compute summed over its passes); k14_clocks reads them.
#ifndef K14_CLOCKS
#define K14_CLOCKS 0
#endif
#if K14_CLOCKS
__device__ long long g_acf_clocks[1024][5];
__device__ long long g_res_clocks[1024][4];
__device__ long long g_epi_clocks[256][4];
#define STAMP(buf, cap, k)                                                                  \
    do {                                                                                    \
        const unsigned b_ = blockIdx.y * gridDim.x + blockIdx.x;                            \
        if (threadIdx.x == 0 && b_ < (cap)) buf[b_][k] = clock64();                         \
    } while (0)
#else
#define STAMP(buf, cap, k) do {} while (0)
#endif

__device__ __forceinline__ float sq_abs(float2 d) {
    const float m = hypotf(d.x, d.y);  // jnp.abs(.) ** 2
    return __fmul_rn(m, m);
}

// the staged chunk's float2 index of sample j: 2 float2 of padding every 8
__device__ __forceinline__ int pad_idx(int j) { return j + (j >> 3) * 2; }

constexpr int kStaged = (kLook + kChunk) + ((kLook + kChunk) >> 3) * 2;

// one lane's residual of a candidate's predictions p against an acf row a,
// summed in lag order
template <int L>
__device__ __forceinline__ float residual(const float2 (&p)[L], const float2* a) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
        s = __fadd_rn(s, sq_abs(make_float2(__fsub_rn(p[t].x, a[t].x), __fsub_rn(p[t].y, a[t].y))));
    }
    return s;
}

// a residual and its candidate as one key: residuals are >= 0, so their
// bits order as integers; on a tie the lower index is less
__device__ __forceinline__ unsigned long long pack(float s, int c) {
    return (static_cast<unsigned long long>(__float_as_uint(s)) << 32) | static_cast<unsigned>(c);
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long key) {
    for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, o);
        key = other < key ? other : key;
    }
    return key;
}

template <int L>
__global__ void __launch_bounds__(kAcfThreads)
acf_kernel(const float2* __restrict__ x, int n, int lags, const float2* __restrict__ acc,
           const bool* __restrict__ enable, float2* __restrict__ acf,
           unsigned long long* __restrict__ best, float ema, int fit) {
    // LB: the lookback a thread reads, even so its reads pair into 16 bytes
    constexpr int LB = L & 1 ? L - 1 : L;
    static_assert(LB <= kLook && L <= kMaxLags, "lookback");
    __shared__ __align__(16) float2 xs[kStaged];
    __shared__ float red[kAcfThreads][2 * L + 1];
    __shared__ float part[2 * L];
    cg::cluster_group cluster = cg::this_cluster();
    const int nct = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int row = blockIdx.x / nct;
    const int tid = threadIdx.x;
    const float2* xr = x + static_cast<long long>(row) * n;
    STAMP(g_acf_clocks, 1024, 0);
#if K14_CLOCKS
    long long t_stage = 0, t_mac = 0;
#endif

    float re[L], im[L];
#pragma unroll
    for (int t = 0; t < L; ++t) re[t] = im[t] = 0.f;
    const int n_chunks = (n + kChunk - 1) / kChunk;
    for (int c = rank; c < n_chunks; c += nct) {
#if K14_CLOCKS
        const long long c0 = clock64();
#endif
        const long long base = static_cast<long long>(c) * kChunk - kLook;
        __syncthreads();  // the last pass's reads are done
        for (int j = tid; j < kLook + kChunk; j += kAcfThreads) {
            const long long g = base + j;
            xs[pad_idx(j)] = (g >= 0 && g < n) ? xr[g] : make_float2(0.f, 0.f);
        }
        __syncthreads();
#if K14_CLOCKS
        const long long c1 = clock64();
#endif
        // this thread's samples i0..i0+7 and their lookback: X[LB + s] is i0 + s
        float2 xv[LB + kPer];
        const int j0 = tid * kPer + kLook - LB;
#pragma unroll
        for (int k = 0; k < (LB + kPer) / 2; ++k) {
            const float4 v = *reinterpret_cast<const float4*>(xs + pad_idx(j0 + 2 * k));
            xv[2 * k] = make_float2(v.x, v.y);
            xv[2 * k + 1] = make_float2(v.z, v.w);
        }
#pragma unroll
        for (int s = 0; s < kPer; ++s) {
            const float2 a = xv[LB + s];
#pragma unroll
            for (int t = 0; t < L; ++t) {
                const float2 b = xv[LB + s - t];  // a conj(b)
                re[t] = fmaf(a.x, b.x, re[t]);
                re[t] = fmaf(a.y, b.y, re[t]);
                im[t] = fmaf(a.y, b.x, im[t]);
                im[t] = fmaf(-a.x, b.y, im[t]);
            }
        }
#if K14_CLOCKS
        const long long c2 = clock64();
        t_stage += c1 - c0;
        t_mac += c2 - c1;
#endif
    }
#if K14_CLOCKS
    if (tid == 0 && blockIdx.x < 1024) {
        g_acf_clocks[blockIdx.x][1] = t_stage;
        g_acf_clocks[blockIdx.x][2] = t_mac;
    }
#endif

    // the CTA's sums: each of the 2L values summed over the threads in 4 chains
#pragma unroll
    for (int t = 0; t < L; ++t) {
        red[tid][t] = re[t];
        red[tid][L + t] = im[t];
    }
    __syncthreads();
    if (tid < 2 * L) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
        for (int k = 0; k < kAcfThreads; k += 4) {
            s0 += red[k][tid];
            s1 += red[k + 1][tid];
            s2 += red[k + 2][tid];
            s3 += red[k + 3][tid];
        }
        part[tid] = (s0 + s1) + (s2 + s3);
    }
    if (nct > 1) cluster.sync();  // every CTA's sums are whole
    else __syncthreads();
    STAMP(g_acf_clocks, 1024, 3);
    float tot = 0.f;
    if (rank == 0 && tid < 2 * L) {
        for (int r = 0; r < nct; ++r) tot += nct > 1 ? cluster.map_shared_rank(part, r)[tid] : part[tid];
    }
    if (nct > 1) cluster.sync();  // no CTA leaves while rank 0 reads its sums
    if (rank != 0) return;
    __syncthreads();
    if (tid < 2 * L) red[0][tid] = tot;  // red[0] is free again
    __syncthreads();
    if (tid >= 32) return;

    // the finish, one lane a lag, in the reference's order
    const int lane = tid;
    const bool mine = lane < lags;
    float2 lag = make_float2(0.f, 0.f);
    if (mine) {
        const float cnt = static_cast<float>(max(n - lane, 0));  // an empty lag is NaN, as a mean
        lag = make_float2(__fdiv_rn(red[0][lane], cnt), __fdiv_rn(red[0][L + lane], cnt));
    }
    const float d = fmaxf(__shfl_sync(0xffffffffu, lag.x, 0), 1e-9f);
    lag = make_float2(__fdiv_rn(lag.x, d), __fdiv_rn(lag.y, d));
    const bool finite = __all_sync(0xffffffffu, !mine || (isfinite(lag.x) && isfinite(lag.y)));
    // the carried acf, a lag a lane; its magnitudes summed in lag order
    const float2 av = fit && mine ? acc[static_cast<long long>(row) * lags + lane] : make_float2(0.f, 0.f);
    const float mag = hypotf(av.x, av.y);
    float seen = 0.f;
    for (int t = 0; t < lags; ++t) seen += __shfl_sync(0xffffffffu, mag, t);
    const bool on = !fit || enable[row];
    if (mine) {
        float2 v = finite ? lag : make_float2(0.f, 0.f);
        if (fit && seen > 0.f) {
            v = make_float2(__fadd_rn(__fmul_rn(1.f - ema, av.x), __fmul_rn(ema, v.x)),
                            __fadd_rn(__fmul_rn(1.f - ema, av.y), __fmul_rn(ema, v.y)));
        }
        acf[static_cast<long long>(row) * lags + lane] = on ? v : make_float2(0.f, 0.f);
    }
    if (lane == 0) best[row] = ~0ull;
    STAMP(g_acf_clocks, 1024, 4);
}

template <int L>
__global__ void __launch_bounds__(kResThreads)
residual_kernel(const float2* __restrict__ acf, int rows, int lags, int group_rows,
                const float2* __restrict__ preds, int n_cand,
                unsigned long long* __restrict__ best) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    // the tile's predictions, then the group's acf rows (both L a row, zero
    // past lags: a zero term adds +0), then the group's minima
    float2* ps = reinterpret_cast<float2*>(smem_raw);
    float2* as = ps + kResThreads * L;
    unsigned long long* mins = reinterpret_cast<unsigned long long*>(as + group_rows * L);
    const int tid = threadIdx.x;
    const int c0 = blockIdx.x * kResThreads;
    const int r0 = blockIdx.y * group_rows;
    const int nr = min(group_rows, rows - r0);
    STAMP(g_res_clocks, 1024, 0);
    {
        // the tile's rows of the table are contiguous: coalesced 8-byte loads
        const int count = min(kResThreads, n_cand - c0) * lags;
        const float2* src = preds + static_cast<long long>(c0) * lags;
        if (lags == L) {
            for (int i = tid; i < count; i += kResThreads) ps[i] = src[i];
        } else {
            for (int i = tid; i < kResThreads * L; i += kResThreads) ps[i] = make_float2(0.f, 0.f);
            __syncthreads();
            for (int i = tid; i < count; i += kResThreads) ps[(i / lags) * L + i % lags] = src[i];
        }
        const float2* arow = acf + static_cast<long long>(r0) * lags;
        for (int i = tid; i < nr * L; i += kResThreads) {
            const int t = i % L;
            as[i] = t < lags ? arow[(i / L) * lags + t] : make_float2(0.f, 0.f);
        }
        for (int i = tid; i < nr; i += kResThreads) mins[i] = ~0ull;
    }
    __syncthreads();
    const int c = c0 + tid;
    const bool valid = c < n_cand;
    float2 p[L];
#pragma unroll
    for (int t = 0; t < L; ++t) p[t] = valid ? ps[tid * L + t] : make_float2(0.f, 0.f);
    STAMP(g_res_clocks, 1024, 1);
    for (int r = 0; r < nr; ++r) {
        const unsigned long long key = warp_min(valid ? pack(residual<L>(p, as + r * L), c) : ~0ull);
        if ((tid & 31) == 0 && key != ~0ull) atomicMin(mins + r, key);
    }
    __syncthreads();
    STAMP(g_res_clocks, 1024, 2);
    for (int r = tid; r < nr; r += kResThreads) {
        if (mins[r] != ~0ull) atomicMin(best + r0 + r, mins[r]);
    }
    STAMP(g_res_clocks, 1024, 3);
}

__global__ void __launch_bounds__(kNfft)
epilogue_kernel(const float2* __restrict__ acf, int lags, const float2* __restrict__ preds,
                const float* __restrict__ params, int n_cand,
                const unsigned long long* __restrict__ best, const bool* __restrict__ enable,
                float2* __restrict__ taps, bool* __restrict__ sig_out, int* __restrict__ j_out,
                float* __restrict__ score, int n_taps, float lam, float a_floor,
                float gate_ratio, int fit) {
    __shared__ double2 w[kNfft];   // W in f32, held as double for the sums
    __shared__ double2 tw[kNfft];  // (cos, sin)(pi j / 256)
    __shared__ float echo[3];      // a, theta, d
    const int r = blockIdx.x;
    const int tid = threadIdx.x;
    STAMP(g_epi_clocks, 256, 0);
    const unsigned long long b = best[r];
    int j = static_cast<int>(b & 0xffffffffull);
    const float rj = __uint_as_float(static_cast<unsigned>(b >> 32));
    if (j >= n_cand) j = 0;  // every residual was NaN: jnp.argmin gives 0
    if (!fit) {
        if (tid == 0) score[r] = rj;
        return;
    }
    const bool on = enable[r];
    if (tid < 32) {
        // the no-echo candidate's residual: its terms a lane, summed in lag
        // order as residual() sums them
        const float2* a = acf + static_cast<long long>(r) * lags;
        float term = 0.f;
        if (tid < lags) {
            term = sq_abs(make_float2(__fsub_rn(preds[tid].x, a[tid].x), __fsub_rn(preds[tid].y, a[tid].y)));
        }
        float r0 = 0.f;
        for (int t = 0; t < lags; ++t) r0 = __fadd_rn(r0, __shfl_sync(0xffffffffu, term, t));
        if (tid == 0) {
            const float amp = params[3 * j + 2];
            const bool sig = (rj < __fmul_rn(gate_ratio, r0)) && (amp >= a_floor) && on;
            echo[0] = sig ? amp : 0.f;
            echo[1] = params[3 * j + 1];
            echo[2] = params[3 * j];
            sig_out[r] = sig;
            j_out[r] = j;
        }
    }
    {
        double sn, cs;
        sincospi(static_cast<double>(tid) / (kNfft / 2), &sn, &cs);
        tw[tid] = make_double2(cs, sn);
    }
    __syncthreads();
    STAMP(g_epi_clocks, 256, 1);
    const float amp = echo[0], theta = echo[1], d = echo[2];
    {
        const int k = tid;
        // the reference's f32 grid 2 pi k / 512 (numpy float64, rounded)
        const float wk = static_cast<float>((6.283185307179586 * k) / 512.0);
        const float ph = -__fmul_rn(wk, d);
        const float er = cosf(ph), ei = sinf(ph);
        const float ar = __fmul_rn(amp, cosf(theta)), ai = __fmul_rn(amp, sinf(theta));
        const float hr = __fadd_rn(1.f, __fsub_rn(__fmul_rn(ar, er), __fmul_rn(ai, ei)));
        const float hi = __fadd_rn(__fmul_rn(ar, ei), __fmul_rn(ai, er));
        const float m = hypotf(hr, hi);
        const float den = __fadd_rn(__fmul_rn(m, m), lam);
        w[k] = make_double2(__fdiv_rn(hr, den), -__fdiv_rn(hi, den));  // f32 values, held as double
    }
    __syncthreads();
    STAMP(g_epi_clocks, 256, 2);
    const int warp = tid >> 5, lane = tid & 31;
    const int c = n_taps / 2;
    // this lane's W[k], k = lane + 32 i, in registers; work item 0 is the
    // centre tap (m = 0), item m' the taps c -+ m' (m = -+m' mod 512), whose
    // twiddles are conjugate: one table read serves both
    double2 wl[kNfft / 32];
#pragma unroll
    for (int i = 0; i < kNfft / 32; ++i) wl[i] = w[lane + 32 * i];
    for (int item = warp; item <= c; item += kNfft / 32) {
        double ac = 0.0, bs = 0.0, as = 0.0, bc = 0.0;  // sums of Re W cos, Im W sin, Re W sin, Im W cos
        if (on) {
#pragma unroll
            for (int i = 0; i < kNfft / 32; ++i) {
                const int k = lane + 32 * i;
                const double2 e = tw[(k * item) & (kNfft - 1)];
                ac += wl[i].x * e.x;
                bs += wl[i].y * e.y;
                as += wl[i].x * e.y;
                bc += wl[i].y * e.x;
            }
            for (int o = 16; o > 0; o >>= 1) {
                ac += __shfl_xor_sync(0xffffffffu, ac, o);
                bs += __shfl_xor_sync(0xffffffffu, bs, o);
                as += __shfl_xor_sync(0xffffffffu, as, o);
                bc += __shfl_xor_sync(0xffffffffu, bc, o);
            }
        }
        if (lane != 0) continue;
        float2* out = taps + static_cast<long long>(r) * n_taps;
        const float id = item == 0 ? 1.f : 0.f;  // identity taps when the row is disabled
        // tap c - item: m = -item, e^{-i ...}: W conj(e); tap c + item: m = +item: W e
        out[c - item] = on ? make_float2(static_cast<float>((ac + bs) / kNfft), static_cast<float>((bc - as) / kNfft))
                           : make_float2(id, 0.f);
        if (item > 0 && c + item < n_taps) {
            out[c + item] = on ? make_float2(static_cast<float>((ac - bs) / kNfft),
                                             static_cast<float>((as + bc) / kNfft))
                               : make_float2(0.f, 0.f);
        }
    }
    STAMP(g_epi_clocks, 256, 3);
}

// the acf's CTAs a row (models/p25/equalizer.py:k14_plan)
int acf_ctas(int n) {
    const int chunks = (n + kChunk - 1) / kChunk;
    return chunks < 1 ? 1 : (chunks > kMaxCtas ? kMaxCtas : chunks);
}

template <int L>
int launch_fit(const float2* x, int rows, int n, int lags, const float2* preds, const float* params, int n_cand,
               const float2* acc, const bool* enable, float2* acf, unsigned long long* best,
               float* score, float2* taps, bool* sig, int* j, int n_taps, float lam, float a_floor,
               float gate_ratio, float ema, int fit, cudaStream_t s) {
    const int ctas = acf_ctas(n);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(kAcfThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(ctas);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t err = cudaLaunchKernelEx(&cfg, acf_kernel<L>, x, n, lags, acc, enable, acf, best, ema, fit);
    if (err == cudaSuccess) err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);

    // row groups: about two residual CTAs an SM, at most kMaxGroupRows rows a group
    const int tiles = (n_cand + kResThreads - 1) / kResThreads;
    int groups = (kResTarget + tiles - 1) / tiles;
    groups = groups > rows ? rows : groups;
    const int min_groups = (rows + kMaxGroupRows - 1) / kMaxGroupRows;
    groups = groups < min_groups ? min_groups : groups;
    const int group_rows = (rows + groups - 1) / groups;
    groups = (rows + group_rows - 1) / group_rows;
    const size_t smem = sizeof(float2) * (static_cast<size_t>(kResThreads) * L + static_cast<size_t>(group_rows) * L) +
                        sizeof(unsigned long long) * group_rows;
    err = cudaFuncSetAttribute(residual_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(residual_kernel<L>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return static_cast<int>(err);
    residual_kernel<L><<<dim3(tiles, groups), kResThreads, smem, s>>>(acf, rows, lags, group_rows, preds,
                                                                       n_cand, best);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    // score mode only copies each row's least residual: one warp a row
    epilogue_kernel<<<rows, fit ? kNfft : 32, 0, s>>>(
        acf, lags, preds, params, n_cand, best, enable, taps, sig, j, score, n_taps, lam, a_floor,
        gate_ratio, fit);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

#if K14_CLOCKS
WAVECAP_EXPORT int k14_clocks(void* acf_host, void* res_host, void* epi_host) {
    cudaError_t e = cudaMemcpyFromSymbol(acf_host, g_acf_clocks, sizeof(g_acf_clocks));
    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(res_host, g_res_clocks, sizeof(g_res_clocks));
    if (e == cudaSuccess) e = cudaMemcpyFromSymbol(epi_host, g_epi_clocks, sizeof(g_epi_clocks));
    return static_cast<int>(e);
}
#endif

WAVECAP_EXPORT int k14_echo_fit(const void* x, int rows, int n, int n_tau, const void* preds,
                                const void* params, int n_cand, const void* acf_acc,
                                const void* enable, void* acf, void* best, void* score,
                                void* taps, void* sig, void* j, int n_taps, float lam,
                                float a_floor, float gate_ratio, float acf_ema, int fit,
                                void* stream) {
    if (n_tau + 1 > kMaxLags || n_tau < 0 || n < 0 || n_cand < 1 || n_taps > kNfft ||
        (fit && (!acf_acc || !enable)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows <= 0) return 0;
    const auto s = static_cast<cudaStream_t>(stream);
#define K14_LAUNCH(L)                                                                               \
    launch_fit<L>(static_cast<const float2*>(x), rows, n, n_tau + 1, static_cast<const float2*>(preds),        \
                  static_cast<const float*>(params), n_cand, static_cast<const float2*>(acf_acc),  \
                  static_cast<const bool*>(enable), static_cast<float2*>(acf),                     \
                  static_cast<unsigned long long*>(best), static_cast<float*>(score),              \
                  static_cast<float2*>(taps), static_cast<bool*>(sig), static_cast<int*>(j), n_taps, \
                  lam, a_floor, gate_ratio, acf_ema, fit, s)
    // the default grid's 29 lags take their own instance; any other count up to 32
    if (n_tau + 1 == 29) return K14_LAUNCH(29);
    switch (n_tau + 1) {
        case 1: case 2: case 3: case 4: case 5: case 6: case 7: case 8:
            return K14_LAUNCH(8);
        case 9: case 10: case 11: case 12: case 13: case 14: case 15: case 16:
            return K14_LAUNCH(16);
        default:
            return K14_LAUNCH(32);
    }
#undef K14_LAUNCH
}
