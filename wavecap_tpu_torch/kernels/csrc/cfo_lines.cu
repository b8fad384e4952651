// K13's CFO estimate: the 4th-power spectrum and its line search, two
// kernels around cuFFT.
//
// Replaces wavecap_tpu/models/p25/cqpsk.py:_estimate_cfo_residual
// (cqpsk.py:170-201), where XLA fuses x^4, pads it, runs its FFT and
// searches |X|.  The FFT stays on cuFFT (torch.fft), as the reference leaves
// it to XLA's FFT; the rest is two kernels:
//
//   K13_cfo_power  buf = x^4 of the normalized rows (R, n) c64, zero-padded
//                  to (R, size): one pass for two products and the pad
//   (cuFFT)        X = FFT(buf), (R, size) c64
//   K13_cfo_lines  per row, over |X| (hypotf, as torch.abs on the card):
//     M[j]  = |X|[(j - k4 + off) mod size] + |X|[(j - k4 - off) mod size],  j < 2 k4 + 1
//     j*    = the first argmax of M
//     resid = (j* - k4) df_step  if M[j*] > 8 mean|X| and M[j*] > 1.5 M[k4], else 0
//
// The two lines of pi/4-DQPSK's x^4 sit at 4 CFO +- Rs/2 (off bins from the
// centre); their joint search is unambiguous for |CFO| < Rs/4.
//
// Bound on the H100: bytes, and both kernels lie far below a launch's own
// time.  Program B (21 rows, n 7,500, size 8,192, 1,449 candidates): the
// power pass reads 1.26 MB and writes 1.38 MB (0.79 us at 3.35 TB/s), the
// search reads 1.38 MB (0.41 us).  So the design is about latency:
//
// * K13_cfo_power: a thread two samples, one 16-byte load and one 16-byte
//   store; rows x chunks of 512 bins (336 CTAs at B).  x^4 = (x x)(x x) in
//   the order of torch's complex product on the card (cmul), so cuFFT gets
//   the bits the plain version gives it.
// * K13_cfo_lines: a row over a cluster of 8 CTAs (168 CTAs at B, 16 for
//   C's two control rows).  Every CTA issues its loads at once (its first
//   candidates' two bins, then its slice of the row for the mean, 16-byte
//   loads, kUnroll a thread in flight), sums |X| over the slice and takes
//   the argmax of its share of the candidates (a warp's by two REDUX on
//   the value's bits, then warp 0's; the lower index on a tie and NaN above
//   every number, as torch.argmax and jnp.argmax).  The candidates come
//   split where a bin wraps into at most three contiguous ranges, each with
//   its two bin offsets (models/p25/cqpsk.py:cfo_lines_plan), so no % is on
//   the path.  Ranks 1.. send their partial sum and (value, index) into
//   rank 0's shared memory by one st.async each, counted on rank 0's
//   mbarrier, and leave; rank 0 adds them in rank order and applies the
//   significance test.  Measured (scripts/k13_cfo_variants.py): ~1.0 us of
//   it is the launch of an empty kernel, the slice's sum ~1,700 SM cycles
//   (hypotf the most: |x| + |y| in its place saves ~0.4 us); the first
//   plan's exchange (remote stores and a released cluster barrier) took
//   ~2,000 cycles in rank 0, this one ~950.
#include <cooperative_groups.h>
#include <stdint.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPowerThreads = 256;  // K13_cfo_power: two samples a thread, 512 bins a CTA
constexpr int kThreads = 256;       // K13_cfo_lines: a CTA's threads
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // CTAs a row, at most: the portable cluster size
constexpr int kUnroll = 4;      // the mean's 16-byte loads in flight a thread

// torch's complex product on the card: c10::complex's (a c - b d, a d + b c)
// as nvcc contracts it, the first product of each fused; written out so
// that squaring a value is not re-associated
__device__ __forceinline__ float2 cmul(float2 x, float2 y) {
    return make_float2(__fmaf_rn(x.x, y.x, -__fmul_rn(x.y, y.y)),
                       __fmaf_rn(x.x, y.y, __fmul_rn(x.y, y.x)));
}

__device__ __forceinline__ float2 pow4(float2 x) {
    const float2 p = cmul(x, x);
    return cmul(p, p);
}

// VEC: n is even and the rows lie on 16-byte boundaries
template <bool VEC>
__global__ void __launch_bounds__(kPowerThreads)
cfo_power_kernel(const float2* __restrict__ filt, int n, int size, float2* __restrict__ buf) {
    const int i = 2 * (blockIdx.x * kPowerThreads + threadIdx.x);
    if (i >= size) return;
    const long long r = blockIdx.y;
    const float2* x = filt + r * n;
    float2 a = make_float2(0.f, 0.f), b = a;
    if (VEC) {
        if (i < n) {
            const float4 v = *reinterpret_cast<const float4*>(x + i);
            a = pow4(make_float2(v.x, v.y));
            b = pow4(make_float2(v.z, v.w));
        }
    } else {
        if (i < n) a = pow4(x[i]);
        if (i + 1 < n) b = pow4(x[i + 1]);
    }
    *reinterpret_cast<float4*>(buf + r * size + i) = make_float4(a.x, a.y, b.x, b.y);
}

// the candidates' wrap split: ranges [0, b1), [b1, b2), [b2, 2 k4 + 1); in
// range q, candidate j reads bins j + dp[q] and j + dm[q]
struct Split {
    int b1, b2;
    int dp0, dm0, dp1, dm1, dp2, dm2;
};

__device__ __forceinline__ int2 bins_of(const Split& sp, int j) {
    const bool one = j >= sp.b1, two = j >= sp.b2;
    return make_int2(j + (two ? sp.dp2 : one ? sp.dp1 : sp.dp0), j + (two ? sp.dm2 : one ? sp.dm1 : sp.dm0));
}

__device__ __forceinline__ float mag(float2 z) { return hypotf(z.x, z.y); }

// A candidate's M is a sum of two magnitudes: +0 or more, +inf, or the
// canonical NaN (0x7fffffff).  So its bits order as unsigned integers as
// torch.argmax and jnp.argmax order the values, NaN above every number;
// the argmax is the largest bits, then the lowest index among them.
__device__ __forceinline__ void keep_max(unsigned& v, unsigned& i, unsigned v2, unsigned i2) {
    if (v2 > v || (v2 == v && i2 < i)) {
        v = v2;
        i = i2;
    }
}

// a warp's (bits, index) argmax in every lane, and the sum of its first
// LANES lanes' s
template <int LANES>
__device__ __forceinline__ void warp_merge(float& s, unsigned& v, unsigned& i) {
    for (int o = LANES / 2; o > 0; o >>= 1) s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, o));
    const unsigned top = __reduce_max_sync(0xffffffffu, v);
    i = __reduce_min_sync(0xffffffffu, v == top ? i : 0xffffffffu);
    v = top;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// a row a cluster; rank c sums bins [c size / nct, (c + 1) size / nct) and
// searches candidates [c per, min((c + 1) per, ncand)).  Ranks 1.. send
// (sum, bits, index) to rank 0 by one st.async each, counted in bytes on
// rank 0's mbarrier; rank 0 adds them in rank order.
__global__ void __launch_bounds__(kThreads)
cfo_lines_kernel(const float2* __restrict__ spec, int size, int ncand, int k4, int per, Split sp,
                 int c_plus, int c_minus, float df_step, float* __restrict__ resid,
                 int* __restrict__ jout) {
    __shared__ float w_sum[kWarps];
    __shared__ unsigned w_val[kWarps], w_idx[kWarps];
    __shared__ __align__(16) uint4 parts[kMaxCluster];  // rank 0: the CTAs' (sum, bits, index, -)
    __shared__ __align__(8) uint64_t bar;                // rank 0: counts the parts' bytes
    cg::cluster_group cluster = cg::this_cluster();
    const int nct = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const unsigned bar_at = static_cast<unsigned>(__cvta_generic_to_shared(&bar));
    if (nct > 1) {
        if (rank == 0 && threadIdx.x == 0) {  // rank 0's mbarrier exists before any CTA sends
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_at) : "memory");
            uint64_t state;
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
                         : "=l"(state)
                         : "r"(bar_at), "r"((nct - 1) * 16)
                         : "memory");
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        cluster_arrive_relaxed();
    }
    const float2* x = spec + static_cast<long long>(blockIdx.x / nct) * size;

    // first the loads: this thread's first candidate's two bins, the
    // centre's (rank 0, thread 0), then the mean's slice
    const int j_end = min((rank + 1) * per, ncand);
    int j = rank * per + static_cast<int>(threadIdx.x);
    float2 zp = make_float2(0.f, 0.f), zm = zp, cp = zp, cm = zp;
    if (j < j_end) {
        const int2 b = bins_of(sp, j);
        zp = x[b.x];
        zm = x[b.y];
    }
    if (rank == 0 && threadIdx.x == 0) {
        cp = x[c_plus];
        cm = x[c_minus];
    }
    const int nq = size / (2 * nct);  // 16-byte loads of the slice
    const float4* q = reinterpret_cast<const float4*>(x) + rank * nq;
    float s = 0.f;
    for (int base = 0; base < nq; base += kThreads * kUnroll) {
        float4 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
            const int k = base + u * kThreads + static_cast<int>(threadIdx.x);
            v[u] = k < nq ? q[k] : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
            if (base + u * kThreads + static_cast<int>(threadIdx.x) < nq)  // the same in a warp at the paths' shapes
                s = __fadd_rn(s, __fadd_rn(hypotf(v[u].x, v[u].y), hypotf(v[u].z, v[u].w)));
    }

    // the candidates, each thread's in rising j: a larger value only replaces
    unsigned best = 0u, bi = 0xffffffffu;
    while (j < j_end) {
        const unsigned m = __float_as_uint(__fadd_rn(mag(zp), mag(zm)));
        if (m > best || bi == 0xffffffffu) {
            best = m;
            bi = static_cast<unsigned>(j);
        }
        j += kThreads;
        if (j < j_end) {
            const int2 b = bins_of(sp, j);
            zp = x[b.x];
            zm = x[b.y];
        }
    }

    warp_merge<32>(s, best, bi);
    const int lane = static_cast<int>(threadIdx.x & 31), warp = static_cast<int>(threadIdx.x >> 5);
    if (lane == 0) {
        w_sum[warp] = s;
        w_val[warp] = best;
        w_idx[warp] = bi;
    }
    __syncthreads();
    if (warp != 0) return;
    s = lane < kWarps ? w_sum[lane] : 0.f;
    best = lane < kWarps ? w_val[lane] : 0u;
    bi = lane < kWarps ? w_idx[lane] : 0xffffffffu;
    warp_merge<kWarps>(s, best, bi);
    if (nct > 1 && rank != 0) {
        cluster_wait();  // every CTA of the cluster has started: rank 0's mbarrier is there
        if (lane == 0) {
            const unsigned mine = static_cast<unsigned>(__cvta_generic_to_shared(&parts[rank]));
            unsigned dst, dst_bar;
            asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(dst) : "r"(mine));
            asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(dst_bar) : "r"(bar_at));
            asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
                         ::"r"(dst), "r"(__float_as_uint(s)), "r"(best), "r"(bi), "r"(0u), "r"(dst_bar)
                         : "memory");
        }
        return;
    }
    if (lane == 0) {
        const float centre = __fadd_rn(mag(cp), mag(cm));
        if (nct > 1) {
            unsigned done = 0;
            while (!done) {
                asm volatile(
                    "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                    " selp.u32 %0, 1, 0, p;\n}\n"
                    : "=r"(done)
                    : "r"(bar_at)
                    : "memory");
            }
        }
        uint4 pc[kMaxCluster];  // loaded together, merged in rank order
#pragma unroll
        for (int c = 1; c < kMaxCluster; ++c) pc[c] = c < nct ? parts[c] : make_uint4(0u, 0u, 0xffffffffu, 0u);
        float tot = s;
#pragma unroll
        for (int c = 1; c < kMaxCluster; ++c) {
            if (c < nct) tot = __fadd_rn(tot, __uint_as_float(pc[c].x));
            keep_max(best, bi, pc[c].y, pc[c].z);
        }
        const float v = __uint_as_float(best);
        const float mean = __fdiv_rn(tot, static_cast<float>(size));
        const bool sig = (v > __fmul_rn(8.f, mean)) && (v > __fmul_rn(1.5f, centre));
        const int r = static_cast<int>(blockIdx.x) / nct;
        const int i = static_cast<int>(bi);
        resid[r] = sig ? __fmul_rn(static_cast<float>(i - k4), df_step) : 0.f;
        jout[r] = i;
    }
}

bool range_ok(int start, int end, int d, int size) {
    return start >= end || (start + d >= 0 && end - 1 + d < size);
}

}  // namespace

// x^4 of ``rows`` rows of ``n`` c64 into ``rows`` rows of ``size`` c64,
// zeros from n on
WAVECAP_EXPORT int k13_cfo_power(const void* filt, int rows, int n, int size, void* buf, void* stream) {
    if (rows < 0 || rows > 65535 || n < 0 || size < 2 || size % 2 || n > size ||
        reinterpret_cast<uintptr_t>(buf) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    const dim3 grid(static_cast<unsigned>((size / 2 + kPowerThreads - 1) / kPowerThreads),
                    static_cast<unsigned>(rows));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* f = static_cast<const float2*>(filt);
    float2* b = static_cast<float2*>(buf);
    if (n % 2 == 0 && reinterpret_cast<uintptr_t>(filt) % 16 == 0)
        cfo_power_kernel<true><<<grid, kPowerThreads, 0, s>>>(f, n, size, b);
    else
        cfo_power_kernel<false><<<grid, kPowerThreads, 0, s>>>(f, n, size, b);
    return static_cast<int>(cudaGetLastError());
}

// The plan (models/p25/cqpsk.py:cfo_lines_plan) comes in as it is:
// ``cluster`` CTAs a row, ``per`` candidates a CTA, the wrap split and the
// centre's two bins.  What the kernel cannot take is refused here, before a
// launch.
WAVECAP_EXPORT int k13_cfo_lines(const void* spec, int rows, int size, int k4, int cluster, int per,
                                 int b1, int b2, int dp0, int dm0, int dp1, int dm1, int dp2, int dm2,
                                 int c_plus, int c_minus, float df_step, void* resid, void* j,
                                 void* stream) {
    const int ncand = 2 * k4 + 1;
    if (rows < 0 || k4 < 0 || ncand > size || cluster < 1 || cluster > kMaxCluster ||
        size % (2 * cluster) || per < 1 || static_cast<long long>(per) * cluster < ncand ||
        b1 < 0 || b1 > b2 || b2 > ncand || c_plus < 0 || c_plus >= size || c_minus < 0 ||
        c_minus >= size || !range_ok(0, b1, dp0, size) || !range_ok(0, b1, dm0, size) ||
        !range_ok(b1, b2, dp1, size) || !range_ok(b1, b2, dm1, size) ||
        !range_ok(b2, ncand, dp2, size) || !range_ok(b2, ncand, dm2, size) ||
        reinterpret_cast<uintptr_t>(spec) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (rows == 0) return 0;
    const Split sp{b1, b2, dp0, dm0, dp1, dm1, dp2, dm2};
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(rows) * static_cast<unsigned>(cluster));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        cudaLaunchKernelEx(&cfg, cfo_lines_kernel, static_cast<const float2*>(spec), size, ncand, k4,
                           per, sp, c_plus, c_minus, df_step, static_cast<float*>(resid),
                           static_cast<int*>(j));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
