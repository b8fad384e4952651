// K3: the per-slot front end of the channel bank.
//
// Replaces the per_slot function of
// wavecap_tpu/models/channel_bank.py:bank_demod_step up to the demod's
// audio filter: the gather of the slot's channelizer row,
// wavecap_tpu/ops/nco.py:freq_shift (exact uint32 NCO), ops/clip.py:rssi_dbfs
// and ops/demod.py:quadrature_demod (mode 1: fast_atan2; mode 0: atan2f).
// Mode 2 writes the shifted rows themselves (complex) and skips the
// discriminator: the AM, SSB and SAM banks detect from them.
// Per slot s, over its row x of S samples:
//
//   acc[n]   = phase0 + n * dphi                   (uint32, wraps mod 2^32)
//   y[n]     = x[n] * (cos, sin)(float(acc[n]) * 2 pi / 2^32)
//   rssi     = 10 log10(max(mean |y|^2, 1e-20))
//   fm[n]    = atan2(Im(y[n] y*[n-1]), Re(...)) * fs / (2 pi dev),  y[-1] = prev
//   phase1   = phase0 + S * dphi,  last = y[S-1]   (modes 0 and 1)
//   rows[n]  = y[n]                               (mode 2)
//
// The tuning word dphi is computed per slot on the host side in torch
// (the reference's hi/lo f32 split), so accumulators match bit for bit.
//
// Bound on the H100: bytes.  At 800 slots x 4,920 samples it reads 31.5 MB
// of channel rows and writes 15.7 MB of discriminator output (~14 us at
// 3.35 TB/s); mode 2 writes the 31.5 MB of shifted rows instead.  The
// arithmetic (~33 operations a sample with cosf and sinf counted once
// each) is a few microseconds.
//
// Design: nothing in the function is serial but the power sum.  The NCO
// phase is closed-form, and the discriminator of sample n needs only
// y[n-1], which any thread can recompute bit for bit.  So:
//
// * a row is cut into segments (ops: models/channel_bank.py:k3_plan), one
//   CTA each, and a row's segments form a thread-block cluster of at most
//   8 CTAs; a segment longer than a CTA's pass (threads x 4 samples) loops;
// * a thread mixes 4 consecutive samples in registers (16-byte loads and
//   stores where the row length is a multiple of 4), nothing is staged;
// * y[n-1] comes from the previous lane by a shuffle; a warp's first lane
//   recomputes it from the row and the closed-form phase with the same
//   arithmetic (the row's first sample takes prev);
// * the power: each thread's sum, a block sum, then each CTA stores its sum
//   into the row's last CTA through distributed shared memory and leaves;
//   the last CTA adds them in rank order (deterministic) and writes rssi
//   and phase1.  A split cluster barrier (arrive at the start, wait before
//   the store; arrive after it, only the last CTA waits) keeps the other
//   CTAs from waiting on the last one's read;
// * sincosf: on the H100 its shifted rows are bit-equal to those of the
//   kernel's first design (whose cosf and sinf the compiler paired), where
//   separate cosf and sinf here are not.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kV = 4;             // consecutive samples a thread a pass
constexpr int kMaxThreads = 512;  // threads a CTA
constexpr int kMaxCluster = 8;    // CTAs (one cluster) a row

// Build switch for scripts/k1_k3_variants.py: K3_CLOCKS, clock64 in thread
// 0 of the first CTAs at [0] start, [1] samples done, [2] CTA's power
// summed, [3] end (the last CTA of a row: after the cluster's sum);
// k3_clocks reads them.
#ifndef K3_CLOCKS
#define K3_CLOCKS 0
#endif
#if K3_CLOCKS
__device__ long long g_k3_clocks[4096][4];
#define STAMP(k)                                                             \
    do {                                                                     \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_k3_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
#else
#define STAMP(k) do {} while (0)
#endif

__device__ __forceinline__ float fast_atan2(float y, float x) {
    const float ax = fabsf(x), ay = fabsf(y);
    const float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
    const float a = lo / fmaxf(hi, 1e-30f);
    const float s = a * a;
    float r = ((-0.0464964749f * s + 0.15931422f) * s - 0.327622764f) * s * a + a;
    if (ay > ax) r = static_cast<float>(3.141592653589793 / 2) - r;
    if (x < 0.f) r = static_cast<float>(3.141592653589793) - r;
    return y < 0.f ? -r : r;
}

// sample v at NCO count acc, shifted: the one place the mix is computed, so
// a recomputed neighbour is bit-equal to the sample its lane holds
__device__ __forceinline__ float2 mix(float2 v, unsigned acc) {
    const float rad_per_count = static_cast<float>(6.283185307179586 / 4294967296.0);
    const float ph = __uint2float_rn(acc) * rad_per_count;
    float c, s;
    sincosf(ph, &s, &c);
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

// the cluster's split barrier: every thread of every CTA arrives; a wait
// returns once every thread that has not exited has arrived
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <int MODE>
__device__ __forceinline__ float discriminate(float2 a, float2 b, float scale) {
    const float re = a.x * b.x + a.y * b.y;
    const float im = a.y * b.x - a.x * b.y;
    return (MODE == 1 ? fast_atan2(im, re) : atan2f(im, re)) * scale;
}

// VEC: the row length is a multiple of 4 and the rows lie on 16-byte
// boundaries, so a thread's 4 samples are all in or all out of its segment
template <int MODE, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
slot_frontend_kernel(const float2* __restrict__ chans, const int* __restrict__ index,
                     const unsigned* __restrict__ dphi, const unsigned* __restrict__ phase0,
                     const float2* __restrict__ prev, void* __restrict__ out,
                     float* __restrict__ rssi, unsigned* __restrict__ phase1,
                     float2* __restrict__ last, int m, int s_len, int seg, float scale) {
    __shared__ float scratch[32];
    __shared__ float parts[kMaxCluster];  // the cluster's CTAs' power, in the last CTA
    STAMP(0);
    cg::cluster_group cluster = cg::this_cluster();
    const int nct = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    if (nct > 1) cluster_arrive_relaxed();  // this CTA has started
    const int slot = blockIdx.x / nct;
    // out-of-range bins clamp, as the reference's gather does
    const int row = min(max(index[slot], 0), m - 1);
    const float2* x = chans + static_cast<long>(row) * s_len;
    const unsigned d = dphi[slot], p0 = phase0[slot];
    const int lo = rank * seg, hi = min(s_len, lo + seg);
    const int lane = threadIdx.x & 31;
    const long row_out = static_cast<long>(slot) * s_len;

    float power = 0.f;
    // every thread of the CTA takes the same number of passes (the shuffle)
    for (int base = lo; base < hi; base += blockDim.x * kV) {
        const int n0 = base + threadIdx.x * kV;
        float2 v[kV];
        if (VEC) {
            if (n0 < hi) {
                const float4 a = *reinterpret_cast<const float4*>(x + n0);
                const float4 b = *reinterpret_cast<const float4*>(x + n0 + 2);
                v[0] = make_float2(a.x, a.y);
                v[1] = make_float2(a.z, a.w);
                v[2] = make_float2(b.x, b.y);
                v[3] = make_float2(b.z, b.w);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kV; ++j)
                if (n0 + j < hi) v[j] = x[n0 + j];
        }
        float2 y[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) {
            const bool in = VEC ? n0 < hi : n0 + j < hi;
            y[j] = in ? mix(v[j], p0 + static_cast<unsigned>(n0 + j) * d) : make_float2(0.f, 0.f);
            if (in) power += y[j].x * y[j].x + y[j].y * y[j].y;
        }
        if (MODE == 2) {
            float2* rows = static_cast<float2*>(out) + row_out;
            if (VEC) {
                if (n0 < hi) {
                    *reinterpret_cast<float4*>(rows + n0) = make_float4(y[0].x, y[0].y, y[1].x, y[1].y);
                    *reinterpret_cast<float4*>(rows + n0 + 2) = make_float4(y[2].x, y[2].y, y[3].x, y[3].y);
                }
            } else {
#pragma unroll
                for (int j = 0; j < kV; ++j)
                    if (n0 + j < hi) rows[n0 + j] = y[j];
            }
            continue;
        }
        // y[n0 - 1]: the previous lane's last sample, or recomputed
        float2 left;
        left.x = __shfl_up_sync(0xffffffffu, y[kV - 1].x, 1);
        left.y = __shfl_up_sync(0xffffffffu, y[kV - 1].y, 1);
        if (lane == 0 && n0 < hi) {
            left = n0 == 0 ? prev[slot] : mix(x[n0 - 1], p0 + static_cast<unsigned>(n0 - 1) * d);
        }
        float f[kV];
#pragma unroll
        for (int j = 0; j < kV; ++j) f[j] = discriminate<MODE>(y[j], j ? y[j - 1] : left, scale);
        float* fm = static_cast<float*>(out) + row_out;
        if (VEC) {
            if (n0 < hi) *reinterpret_cast<float4*>(fm + n0) = make_float4(f[0], f[1], f[2], f[3]);
        } else {
#pragma unroll
            for (int j = 0; j < kV; ++j)
                if (n0 + j < hi) fm[n0 + j] = f[j];
        }
        const int e = s_len - 1 - n0;  // the row's last sample, if this thread holds it
        if (n0 < hi) {
#pragma unroll
            for (int j = 0; j < kV; ++j)
                if (j == e) last[slot] = y[j];
        }
    }
    STAMP(1);
    power = block_sum(power, scratch);
    STAMP(2);
    if (nct > 1) {
        cluster_wait();  // every CTA of the cluster has started: its shared memory is there
        if (threadIdx.x == 0) *cluster.map_shared_rank(&parts[rank], nct - 1) = power;
        cluster_arrive_release();
        if (rank != nct - 1) {  // the last CTA reads the sums; the others are done
            STAMP(3);
            return;
        }
        cluster_wait();
    } else if (threadIdx.x == 0) {
        parts[0] = power;
    }
    if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int r = 0; r < nct; ++r) tot += parts[r];
        rssi[slot] = 10.f * log10f(fmaxf(tot / static_cast<float>(s_len), 1e-20f));
        phase1[slot] = p0 + static_cast<unsigned>(s_len) * d;
    }
    STAMP(3);
}

template <int MODE, bool VEC>
cudaError_t launch_frontend(const float2* chans, const int* index, const unsigned* dphi,
                            const unsigned* phase0, const float2* prev, void* out, float* rssi,
                            unsigned* phase1, float2* last, int n_slots, int m, int s_len,
                            int seg, int cluster, int threads, float scale, cudaStream_t stream) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(n_slots) * static_cast<unsigned>(cluster));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, slot_frontend_kernel<MODE, VEC>, chans, index, dphi, phase0,
                              prev, out, rssi, phase1, last, m, s_len, seg, scale);
}

template <int MODE>
cudaError_t launch_mode(bool vec, const float2* chans, const int* index, const unsigned* dphi,
                        const unsigned* phase0, const float2* prev, void* out, float* rssi,
                        unsigned* phase1, float2* last, int n_slots, int m, int s_len, int seg,
                        int cluster, int threads, float scale, cudaStream_t stream) {
    return vec ? launch_frontend<MODE, true>(chans, index, dphi, phase0, prev, out, rssi, phase1,
                                             last, n_slots, m, s_len, seg, cluster, threads, scale,
                                             stream)
               : launch_frontend<MODE, false>(chans, index, dphi, phase0, prev, out, rssi, phase1,
                                              last, n_slots, m, s_len, seg, cluster, threads, scale,
                                              stream);
}

}  // namespace

#if K3_CLOCKS
WAVECAP_EXPORT int k3_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_k3_clocks, sizeof(g_k3_clocks)));
}
#endif

// The plan (models/channel_bank.py:k3_plan) comes in as it is: ``seg``
// samples a CTA (a multiple of 128), ``cluster`` CTAs a row (the row's
// segments), ``threads`` a CTA (a multiple of 32).  What the kernel cannot
// take is refused here, before a launch.
WAVECAP_EXPORT int k3_slot_frontend(const void* chans, const void* index, const void* dphi,
                                    const void* phase0, const void* prev, void* out,
                                    void* rssi, void* phase1, void* last, int n_slots, int m,
                                    int s_len, float scale, int mode, int seg, int cluster,
                                    int threads, void* stream) {
    if (mode < 0 || mode > 2 || n_slots < 1 || m < 1 || s_len < 1 || seg < 1 || seg % 128 ||
        cluster < 1 || cluster > kMaxCluster || threads < 32 || threads > kMaxThreads ||
        threads % 32 || static_cast<long>(seg) * (cluster - 1) >= s_len ||
        static_cast<long>(seg) * cluster < s_len)
        return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = s_len % kV == 0 && reinterpret_cast<uintptr_t>(chans) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float2* c = static_cast<const float2*>(chans);
    const int* ix = static_cast<const int*>(index);
    const unsigned* dp = static_cast<const unsigned*>(dphi);
    const unsigned* p0 = static_cast<const unsigned*>(phase0);
    const float2* pv = static_cast<const float2*>(prev);
    float* rs = static_cast<float*>(rssi);
    unsigned* p1 = static_cast<unsigned*>(phase1);
    float2* ls = static_cast<float2*>(last);
    cudaError_t err;
    switch (mode) {
        case 0:
            err = launch_mode<0>(vec, c, ix, dp, p0, pv, out, rs, p1, ls, n_slots, m, s_len, seg,
                                 cluster, threads, scale, s);
            break;
        case 1:
            err = launch_mode<1>(vec, c, ix, dp, p0, pv, out, rs, p1, ls, n_slots, m, s_len, seg,
                                 cluster, threads, scale, s);
            break;
        default:
            err = launch_mode<2>(vec, c, ix, dp, p0, pv, out, rs, p1, ls, n_slots, m, s_len, seg,
                                 cluster, threads, scale, s);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
