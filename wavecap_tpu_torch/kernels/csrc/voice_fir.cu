// K4: the voice-band FIR with the bank's audio epilogue.
//
// Replaces wavecap_tpu/ops/fir.py:fir_filter / conv_valid (the TPU form is
// the banded matmul _conv_valid_matmul; off the TPU the reference takes
// _conv_valid_direct) together with ops/clip.py:rms_normalize, soft_clip
// and squelch_gate, and the active mask of
// wavecap_tpu/models/channel_bank.py:bank_demod_step.  Per slot s, with
// xin = [tail || fm] (the overlap-save carry, T-1 samples):
//
//   y[n]    = sum_k h[k] * xin[n + T-1 - k]             (valid convolution)
//   g       = rms > min_rms ? target / max(rms, min_rms) : 1,  rms = sqrt(mean y^2)
//   audio   = tanh((y * g) * 1.5) * clip_gain            (0 when the squelch is
//             shut, rssi < threshold, or the slot is inactive)
//   rssi'   = active ? rssi : -200,   tail' = last T-1 samples of xin.
//
// Bound on the H100: operations.  At 800 slots x 4,920 samples and 127 taps
// it does ~1.0 GFLOP (15 us at 67 TFLOP/s f32) on 32 MB of traffic
// (10 us at 3.35 TB/s).
//
// Design (plan: models/channel_bank.py:k4_plan):
//
// * the launch holds as many CTAs as the card runs at once (three of 320
//   threads an SM at the slice), in thread-block clusters of at most 8;
// * where a CTA can form a whole row in one pass and there are rows for
//   every CTA (the slice), each CTA first takes ``whole`` rows alone (CTA
//   b: rows b, b + gridDim, ...); the rows left over, fewer than the CTAs,
//   are each cut into segments over a cluster, so a few CTAs filter half a
//   row, not a whole one, while the others idle (at the slice: 396 CTAs
//   take 2 rows each, and the last 8 rows go a half row a CTA to 8
//   clusters of 2);
// * otherwise every row is cut into segments, one CTA each, a row's
//   segments one cluster, and each cluster walks rows gridDim / cluster
//   apart;
// * a CTA stages a pass of its segment's inputs, threads x 16 outputs and
//   the 126-sample halo (from hp_z at the row's start), in shared memory
//   with one float of padding every 16 (a warp's loads at one offset then
//   fall on 32 banks), by cp.async: the next row's pass is in flight while
//   this one is filtered.  Nothing else of a row is staged, so rows of any
//   length run;
// * register blocking: a thread forms 16 consecutive outputs; the 16
//   inputs they need at one tap sit in a ring of registers, and each tap
//   shifts one new input in, so an FMA costs 1/16 of a shared load; the
//   taps come as broadcast 16-byte loads;
// * the energy: each thread's sum, a block sum, then every CTA stores its
//   sum into every CTA of its cluster (DSMEM) and each adds them in rank
//   order, so every CTA forms the same gain;
// * with one pass a segment (rows up to 8 x 384 x 16 = 49,152 samples) the
//   outputs stay in registers until the gain is known; past that a pass
//   writes its outputs unscaled and the thread rescales its own outputs
//   after the cluster's sum.
//
// * a row's scaled outputs go to an out buffer in shared memory and leave
//   by one bulk store (cp.async.bulk) while the next row is filtered, so
//   the CTAs of an SM, which run in step, do not all wait on their stores.
//
// The banded product on the tensor cores in 3xTF32 (the counterpart of the
// reference's _conv_valid_matmul) lost to the register ring at the slice;
// scripts/k4_k12_variants.py keeps it as a variant.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kTaps = 127;          // the voice-band FIR's length (models/analog.py)
constexpr int kHalo = kTaps - 1;    // the overlap-save carry
constexpr int kR = 16;              // consecutive outputs a thread a pass
// threads a CTA, and CTAs an SM at that size: 56 registers a thread, so
// three CTAs of 320 threads (10 warps) fit each of an SM's four register
// files (a CTA's warps take them in turn: 9 warps of 56 x 32 in the first)
constexpr int kMaxThreads = 384;
constexpr int kMinCtas = 3;
constexpr int kMaxCluster = 8;      // CTAs (one cluster) a row

// Build switch for scripts/k4_k12_variants.py: K4_CLOCKS, thread 0 of the
// first CTAs sums the clock64 cycles of each stage over its rows: [1]
// waiting for a row's staged inputs, [2] filtering, [3] the cluster's
// energy, [4] the soft clip and stores, [0] the CTA in all, [5] its rows,
// and [6] [7] the global timer (ns) at its start and end; k4_clocks reads
// them.
#ifndef K4_CLOCKS
#define K4_CLOCKS 0
#endif
#if K4_CLOCKS
__device__ long long g_k4_clocks[4096][8];
__device__ __forceinline__ long long global_ns() {
    long long t;
    asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t));
    return t;
}
#define CLOCKS_START()                                                       \
    long long t_last = clock64(), t_first = t_last, t_sum[8] = {0, 0, 0, 0, 0, 0, global_ns(), 0}
#define STAMP(k)                                                             \
    do {                                                                     \
        const long long t_now = clock64();                                   \
        t_sum[k] += t_now - t_last;                                          \
        t_last = t_now;                                                      \
    } while (0)
#define CLOCKS_END(rows)                                                     \
    do {                                                                     \
        t_sum[0] = clock64() - t_first;                                      \
        t_sum[5] = rows;                                                     \
        t_sum[7] = global_ns();                                              \
        if (threadIdx.x == 0 && blockIdx.x < 4096)                          \
            for (int q = 0; q < 8; ++q) g_k4_clocks[blockIdx.x][q] = t_sum[q]; \
    } while (0)
#else
#define CLOCKS_START() do {} while (0)
#define STAMP(k) do {} while (0)
#define CLOCKS_END(rows) do {} while (0)
#endif

// the padded shared index of local input e
__device__ __forceinline__ int padded(int e) { return e + (e >> 4); }

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One tap chunk: taps kc .. kc + STEPS - 1 (kc a multiple of 16) on the
// ring.  ring[q mod 16] holds v(q) = xin[e0 + 126 + q]; output j takes
// h[k] v(j - k); after tap k the ring takes v(-(k+1)), loaded a tap ahead
// (``next``) so its shared-memory latency hides behind a tap's 16 FMAs.
// v(-(k+1)) sits at padded offset 17 (tid - kc/16) + off(r) from xs,
// off(r) = (125 - r) + ((125 - r) >> 4), r = k - kc: compile-time once r
// is, and the formula runs on into the next chunk (r = 16 is its r = 0).
template <int STEPS, bool LAST>
__device__ __forceinline__ void tap_chunk(float (&acc)[kR], float (&ring)[kR], float& next,
                                          const float* xb, const float4* h4) {
    float4 t;  // taps r .. r + 3, a broadcast load every fourth tap
#pragma unroll
    for (int r = 0; r < STEPS; ++r) {
        if (r % 4 == 0) t = h4[r / 4];
        const float hk = r % 4 == 0 ? t.x : r % 4 == 1 ? t.y : r % 4 == 2 ? t.z : t.w;
#pragma unroll
        for (int j = 0; j < kR; ++j) acc[j] = fmaf(hk, ring[(j - r + kR) % kR], acc[j]);
        if (!LAST || r + 1 < STEPS) ring[kR - 1 - r] = next;                         // v(-(k+1))
        if (!LAST || r + 2 < STEPS) next = xb[(124 - r) + ((124 - r) >> 4)];        // v(-(k+2))
    }
}

// The thread's 16 outputs from the staged pass: e0 = 16 tid
__device__ __forceinline__ void fir16(float (&acc)[kR], const float* xs, const float4* h4) {
    const int tid = threadIdx.x;
    float ring[kR];
    const float* x0 = xs + 17 * tid;  // padded(16 tid + c) = 17 tid + c + (c >> 4)
#pragma unroll
    for (int j = 0; j < kR; ++j) {
        ring[j] = x0[(kHalo + j) + ((kHalo + j) >> 4)];
        acc[j] = 0.f;
    }
    float next = x0[125 + (125 >> 4)];  // v(-1)
    constexpr int kFull = kTaps / kR;  // 7 chunks of 16 taps, then 15
#pragma unroll 1
    for (int m = 0; m < kFull; ++m)
        tap_chunk<kR, false>(acc, ring, next, xs + 17 * (tid - m), h4 + 4 * m);
    tap_chunk<kTaps - kFull * kR, true>(acc, ring, next, xs + 17 * (tid - kFull), h4 + 4 * kFull);
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem, int bytes) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void copies_issued() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copies_landed() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// Start the copies of one pass: xin[t0 .. t0 + n_out + 125] (xin = tail ++
// row) to xs in the padded layout, zeros past them up to the threads'
// last ring read (cp.async's zero fill)
__device__ __forceinline__ void stage_pass(float* xs, const float* row, const float* carry, int t0,
                                           int n_out) {
    const int n_in = n_out + kHalo;
    const int n_fill = ((n_out + kR - 1) / kR) * kR + kHalo + 2;
    for (int e = threadIdx.x; e < n_fill; e += blockDim.x) {
        const int i = t0 + e;  // index into xin = tail ++ row
        const float* src = i < kHalo ? carry + i : row + (i - kHalo);
        cp_async4(xs + padded(e), e < n_in ? src : row, e < n_in ? 4 : 0);
    }
    copies_issued();
}


// ops/clip.py:soft_clip of the normalized sample: tanh(x) = 1 - 2 / (e^2x +
// 1), the exponential and the division on the special-function unit
// (__expf, __fdividef: ~1e-7 from tanhf, whose branches and polynomials
// cost three times the instructions in the epilogue)
__device__ __forceinline__ float soft_clip(float y, float clip_gain) {
    const float e = __expf(2.f * (y * 1.5f));
    return (1.f - __fdividef(2.f, e + 1.f)) * clip_gain;
}

__device__ __forceinline__ void bulk_fence() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_store(float* gmem, const float* smem, int bytes) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 ::"l"(gmem), "r"(s), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::);
}
// the issuing thread: its bulk stores have read their shared memory / are done
__device__ __forceinline__ void bulk_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
__device__ __forceinline__ void bulk_done() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// KEEP: one pass a segment, the outputs stay in registers, and the next
// row's pass is fetched while this one is filtered
template <bool KEEP>
__global__ void __launch_bounds__(kMaxThreads, kMinCtas)
voice_fir_kernel(const float* __restrict__ fm, const float* __restrict__ tail,
                 const float* __restrict__ taps, const float* __restrict__ rssi,
                 const float* __restrict__ squelch, const uint8_t* __restrict__ active,
                 float* __restrict__ audio, float* __restrict__ rssi_out,
                 float* __restrict__ tail_out, int n_slots, int s_len, int seg, int whole, int buf_floats,
                 float target_rms, float min_rms, float clip_gain) {
    extern __shared__ __align__(16) float xs[];  // KEEP: two pass buffers of buf_floats and the out buffer, else one
    __shared__ float4 h4[(kTaps + 3) / 4];
    __shared__ float scratch[32];
    __shared__ float parts[2][kMaxCluster];  // every CTA's energy, in rank order; a slot a row's parity
    CLOCKS_START();
    cg::cluster_group cluster = cg::this_cluster();
    const int nct = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    if (nct > 1) cluster_arrive_relaxed();  // this CTA has started
    const int tid = threadIdx.x, bs = blockDim.x;
    const int first = blockIdx.x / nct, stride = gridDim.x / nct;  // this cluster's cut rows
    // item it: a whole row of this CTA's (it < whole), then this cluster's
    // cut rows, this CTA's segment of each
    const int seg_lo = rank * seg, seg_hi = min(s_len, seg_lo + seg);
    auto is_cut = [&](int it) { return it >= whole; };
    auto item_slot = [&](int it) {
        return it < whole ? static_cast<int>(blockIdx.x) + it * static_cast<int>(gridDim.x)
                          : whole * static_cast<int>(gridDim.x) + first + (it - whole) * stride;
    };
    for (int i = tid; i < (kTaps + 3) / 4 * 4; i += bs)
        reinterpret_cast<float*>(h4)[i] = i < kTaps ? taps[i] : 0.f;
    const int tile = bs * kR;
    const int e0 = tid * kR;
    float* ob = xs + 2 * buf_floats;  // KEEP: a row's scaled outputs on their way out
    // bulk stores need 16-byte rows: the segments start on 64 bytes (seg % 16 == 0)
    const bool bulk = s_len % 4 == 0 && (reinterpret_cast<uintptr_t>(audio) & 15) == 0;
    if (KEEP && item_slot(0) < n_slots) {
        const int s0 = item_slot(0);
        stage_pass(xs, fm + static_cast<long>(s0) * s_len, tail + static_cast<long>(s0) * kHalo,
                   is_cut(0) ? seg_lo : 0, is_cut(0) ? seg_hi - seg_lo : s_len);
    }
    bool waited = false;  // on the cluster's start barrier
    int it = 0;
    for (int slot = item_slot(0); slot < n_slots; slot = item_slot(++it)) {
        const bool cut = is_cut(it);  // a segment of a row cut over the cluster, else a whole row
        const int lo = cut ? seg_lo : 0, hi = cut ? seg_hi : s_len;
        const float* row = fm + static_cast<long>(slot) * s_len;
        const float* carry = tail + static_cast<long>(slot) * kHalo;
        float* out = audio + static_cast<long>(slot) * s_len;
        float acc[kR];
        float energy = 0.f;
        const bool on = active[slot] != 0;  // loaded before the filtering, used after
        const bool open = on && rssi[slot] >= squelch[slot];
        const float* xb = xs + (it & 1) * buf_floats;  // KEEP: this row's staged pass
        if (KEEP) {
            copies_landed();
            __syncthreads();  // this row's pass is staged; the other buffer is free
            STAMP(1);
            const int next = item_slot(it + 1);
            const bool next_cut = is_cut(it + 1);
            if (next < n_slots)
                stage_pass(xs + ((it + 1) & 1) * buf_floats, fm + static_cast<long>(next) * s_len,
                           tail + static_cast<long>(next) * kHalo, next_cut ? seg_lo : 0,
                           next_cut ? seg_hi - seg_lo : s_len);
            if (e0 < hi - lo) {
                fir16(acc, xb, h4);
#pragma unroll
                for (int j = 0; j < kR; ++j)
                    if (e0 + j < hi - lo) energy = fmaf(acc[j], acc[j], energy);
            }
            if (tid == 0) bulk_read();  // the previous row's store has left the out buffer
        } else {
            for (int t0 = lo; t0 < hi; t0 += tile) {
                const int n_out = min(tile, hi - t0);
                __syncthreads();  // the previous pass is done with xs
                stage_pass(xs, row, carry, t0, n_out);
                copies_landed();
                __syncthreads();
                STAMP(1);
                if (e0 < n_out) {
                    fir16(acc, xs, h4);
#pragma unroll
                    for (int j = 0; j < kR; ++j) {
                        if (e0 + j < n_out) {
                            energy = fmaf(acc[j], acc[j], energy);
                            out[t0 + e0 + j] = acc[j];
                        }
                    }
                }
            }
        }
        STAMP(2);
        float total = block_sum(energy, scratch);
        if (cut && nct > 1) {
            if (!waited) {
                cluster_wait();  // every CTA of the cluster has started: its shared memory is there
                waited = true;
            }
            if (tid < nct) *cluster.map_shared_rank(&parts[it & 1][rank], tid) = total;
            cluster_arrive_release();
            cluster_wait();
            total = 0.f;
            for (int r = 0; r < nct; ++r) total += parts[it & 1][r];
        }
        STAMP(3);

        const float rms = sqrtf(total / static_cast<float>(s_len));
        const float gain = rms > min_rms ? target_rms / fmaxf(rms, min_rms) : 1.f;
        if (KEEP) {
            // the segment's outputs into the out buffer, then one bulk store
            // (16-byte rows) that the next row's filtering overlaps
            const int n = hi - lo;
            if (e0 < n) {
                float v[kR];
#pragma unroll
                for (int j = 0; j < kR; ++j) v[j] = open ? soft_clip(acc[j] * gain, clip_gain) : 0.f;
#pragma unroll
                for (int a = 0; a < kR / 4; ++a)
                    reinterpret_cast<float4*>(ob + e0)[a] = make_float4(v[4 * a], v[4 * a + 1], v[4 * a + 2], v[4 * a + 3]);
            }
            bulk_fence();
            __syncthreads();
            const int n4 = bulk ? n & ~3 : 0;
            if (tid == 0 && n4) bulk_store(out + lo, ob, 4 * n4);
            for (int i = n4 + tid; i < n; i += bs) out[lo + i] = ob[i];
        } else {
            // the thread's own unscaled outputs, pass by pass
            for (int t0 = lo; t0 < hi; t0 += tile) {
#pragma unroll
                for (int j = 0; j < kR; ++j) {
                    const int n = t0 + e0 + j;
                    if (n < hi) out[n] = open ? soft_clip(out[n] * gain, clip_gain) : 0.f;
                }
            }
        }
        if (!cut || rank == nct - 1) {  // tail' = xin[S .. S + 125]: the staged pass's last inputs, or from the inputs
            float* carry_out = tail_out + static_cast<long>(slot) * kHalo;
            for (int i = tid; i < kHalo; i += bs) {
                const int k = s_len + i;
                carry_out[i] = KEEP ? xb[padded(hi - lo + i)] : k < kHalo ? carry[k] : row[k - kHalo];
            }
        }
        if ((!cut || rank == 0) && tid == 0) rssi_out[slot] = on ? rssi[slot] : -200.f;
        STAMP(4);
    }
    if (nct > 1 && !waited) cluster_wait();  // a cluster with no row still completes its start barrier
    if (KEEP && tid == 0) bulk_done();
    CLOCKS_END(it);
}

// the shared floats of one pass's buffer: threads x 16 outputs and the halo, padded
inline int pass_floats(int threads) {
    const int span = threads * kR + kHalo + 2;
    return span + span / 16 + 1;
}

template <bool KEEP>
cudaError_t launch_fir(const float* fm, const float* tail, const float* taps, const float* rssi,
                       const float* squelch, const uint8_t* active, float* audio, float* rssi_out,
                       float* tail_out, int n_slots, int s_len, int seg, int cluster, int threads,
                       int ctas, int whole, float target_rms, float min_rms, float clip_gain,
                       cudaStream_t stream) {
    const int buf = (pass_floats(threads) + 3) / 4 * 4;  // buffers on 16-byte boundaries
    // KEEP: two pass buffers and the out buffer (threads x 16 floats)
    const size_t smem = sizeof(float) * static_cast<size_t>(KEEP ? 2 * buf + threads * kR : buf);
    cudaError_t err = cudaFuncSetAttribute(voice_fir_kernel<KEEP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    // all shared memory, no L1 share: three CTAs of 320 threads (65 KB each)
    // an SM, the count k4_plan launches
    err = cudaFuncSetAttribute(voice_fir_kernel<KEEP>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(ctas));
    cfg.blockDim = dim3(static_cast<unsigned>(threads));
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(cluster);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, voice_fir_kernel<KEEP>, fm, tail, taps, rssi, squelch, active,
                              audio, rssi_out, tail_out, n_slots, s_len, seg, whole, buf, target_rms,
                              min_rms, clip_gain);
}

}  // namespace

#if K4_CLOCKS
WAVECAP_EXPORT int k4_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_k4_clocks, sizeof(g_k4_clocks)));
}
#endif

// The plan (models/channel_bank.py:k4_plan) comes in as it is: ``seg``
// outputs a CTA (a multiple of 16), ``cluster`` CTAs a cut row,
// ``threads`` a CTA (a multiple of 32), ``passes`` passes of threads x 16
// outputs a segment, ``ctas`` CTAs in all (whole clusters; each cluster
// takes cut rows ctas / cluster apart), ``whole`` rows each CTA takes
// alone first (one pass a row; rows b, b + ctas, ...).  What the kernel
// cannot take is refused here, before a launch.
WAVECAP_EXPORT int k4_voice_fir(const void* fm, const void* tail, const void* taps,
                                const void* rssi, const void* squelch, const void* active,
                                void* audio, void* rssi_out, void* tail_out, int n_slots,
                                int s_len, int n_taps, float target_rms, float min_rms,
                                float clip_gain, int seg, int cluster, int threads, int passes,
                                int ctas, int whole, void* stream) {
    if (n_taps != kTaps || n_slots < 1 || s_len < 1 || seg < 1 || seg % kR || cluster < 1 ||
        cluster > kMaxCluster || threads < 32 || threads > kMaxThreads || threads % 32 ||
        passes < 1 || static_cast<long>(seg) * (cluster - 1) >= s_len ||
        static_cast<long>(seg) * cluster < s_len ||
        static_cast<long>(passes) * threads * kR < seg ||
        static_cast<long>(passes - 1) * threads * kR >= seg || ctas < cluster || ctas % cluster ||
        whole < 0 || (whole == 0 && ctas / cluster > n_slots) ||
        (whole > 0 && (passes != 1 || static_cast<long>(threads) * kR < s_len ||
                       static_cast<long>(whole) * ctas > n_slots)))
        return static_cast<int>(cudaErrorInvalidValue);
    const float* f = static_cast<const float*>(fm);
    const float* t = static_cast<const float*>(tail);
    const float* h = static_cast<const float*>(taps);
    const float* rs = static_cast<const float*>(rssi);
    const float* sq = static_cast<const float*>(squelch);
    const uint8_t* on = static_cast<const uint8_t*>(active);
    float* a = static_cast<float*>(audio);
    float* ro = static_cast<float*>(rssi_out);
    float* to = static_cast<float*>(tail_out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        passes == 1 ? launch_fir<true>(f, t, h, rs, sq, on, a, ro, to, n_slots, s_len, seg, cluster,
                                       threads, ctas, whole, target_rms, min_rms, clip_gain, s)
                    : launch_fir<false>(f, t, h, rs, sq, on, a, ro, to, n_slots, s_len, seg,
                                        cluster, threads, ctas, 0, target_rms, min_rms, clip_gain, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
}
