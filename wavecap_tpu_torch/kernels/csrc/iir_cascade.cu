// K9: IIR recurrences with carried state: biquad cascades, one-poles and
// the AGC's two-stage envelope, as a chunked scan.
//
// Replaces wavecap_tpu/ops/iir.py:_biquad_scan / sos_filter (mode 0),
// ops/iir.py:onepole_filter and deemphasis (mode 1) and
// ops/agc.py:envelope (mode 2), which the reference evaluates as
// associative scans of affine maps.  Per sample, in registers:
//
//   mode 0, per section (scipy sosfilt's DF2T, coef = b0 b1 b2 a1 a2 each):
//     y = b0 x + z1;  z1 = b1 x - a1 y + z2;  z2 = b2 x - a2 y
//   mode 1 (coef = b0 a):          y = b0 x + a y
//   mode 2 (coef = ca 1-ca cr 1-cr):
//     ea = ca |x| + (1-ca) ea;  er = cr ea + (1-cr) er;  y = max(ea, er)
//
// Each mode is linear in its state s (D = 2 x sections, 1 or 2 floats):
// s[n] = A s[n-1] + B u[n]; |x| and the max act per sample only.  The
// state is (rows, sections, 2) for mode 0, (rows,) for mode 1 and
// (rows, 2) = (attack, release) for mode 2, in the reference's layout;
// the final state is written to z1.
//
// Bound on the H100: at 160 rows x 9,447 samples a pass reads and writes
// 12 MB (3.6 us at 3.35 TB/s); walked in order, each row is one chain of
// 9,447 x sections dependent multiply-adds (~0.06 ms for 3 sections).
// Design: one block of 256 threads a row.  The row is staged in shared
// memory in segments of up to 12,288 samples (cp.async, coalesced), cut
// into 256 chunks of an odd length L (thread k reads smem[k L + t], in
// distinct banks).  Pass 1: every thread runs its chunk from a zero state
// (thread 0 from the segment's start state) and keeps its end state.
// Pass 2: a Kogge-Stone scan over the threads joins them, with the
// powers P_j = A^(L 2^j) that the host builds in float64 (ops/iir.py:
// k9_scan_matrices): E_k += P_j E_(k-2^j).  Pass 3: every thread reruns
// its chunk from its true start state E_(k-1) with the same fmaf order,
// writing y in place; the segment goes out coalesced, and the last
// chunk's state carries to the next segment.  The chain is ~2 L x
// sections multiply-adds a thread and the scan log2(256) = 8 matvecs.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // chunks a segment: ops/iir.py K9_THREADS
constexpr int kMaxSections = 8;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int NS, int MODE>
struct Recurrence {
    static constexpr int D = MODE == 0 ? 2 * NS : (MODE == 1 ? 1 : 2);
    float c[MODE == 0 ? NS : 1][5];
    float k0, k1, k2, k3;

    __device__ void load(const float* coef) {
        if (MODE == 0) {
#pragma unroll
            for (int i = 0; i < NS; ++i)
#pragma unroll
                for (int j = 0; j < 5; ++j) c[i][j] = coef[i * 5 + j];
        } else {
            k0 = coef[0];
            k1 = coef[1];
            k2 = MODE == 2 ? coef[2] : 0.f;
            k3 = MODE == 2 ? coef[3] : 0.f;
        }
    }

    // one sample: advances s, returns y
    __device__ __forceinline__ float step(float (&s)[D], float v) const {
        if (MODE == 0) {
#pragma unroll
            for (int i = 0; i < NS; ++i) {
                const float out = fmaf(c[i][0], v, s[2 * i]);
                s[2 * i] = fmaf(-c[i][3], out, fmaf(c[i][1], v, s[2 * i + 1]));
                s[2 * i + 1] = fmaf(-c[i][4], out, c[i][2] * v);
                v = out;
            }
            return v;
        } else if (MODE == 1) {
            s[0] = fmaf(k1, s[0], k0 * v);
            return s[0];
        } else {
            s[0] = fmaf(k1, s[0], k0 * fabsf(v));
            s[1] = fmaf(k3, s[1], k2 * s[0]);
            return fmaxf(s[0], s[1]);
        }
    }
};

template <int NS, int MODE>
__global__ void __launch_bounds__(kThreads)
iir_scan_kernel(const float* __restrict__ x, float* __restrict__ y, const float* __restrict__ coef,
                const float* __restrict__ z0, float* __restrict__ z1,
                const float* __restrict__ pmats, int n, int chunk, int seg_len, int levels) {
    using R = Recurrence<NS, MODE>;
    constexpr int D = R::D;
    extern __shared__ float smem[];
    const int seg_pad = (seg_len + 3) & ~3;
    float* buf = smem;                   // seg_len samples of the row
    float* ev = buf + seg_pad;           // D x kThreads chunk states, component-major
    float* pm = ev + D * kThreads;       // levels x D x D
    float* carry = pm + levels * D * D;  // D: the segment's start state

    const int tid = threadIdx.x;
    const long long row = blockIdx.x;
    R f;
    f.load(coef);
    for (int i = tid; i < levels * D * D; i += kThreads) pm[i] = pmats[i];
    if (tid < D) carry[tid] = z0[row * D + tid];
    const float* xr = x + row * n;
    float* yr = y + row * n;

    for (int seg0 = 0; seg0 < n; seg0 += seg_len) {
        const int len = min(seg_len, n - seg0);
        for (int i = tid; i < len; i += kThreads) cp_async4(buf + i, xr + seg0 + i);
        cp_async_wait_all();
        __syncthreads();  // the segment and carry are visible

        const int chunks = (len + chunk - 1) / chunk;
        const int start = tid * chunk;
        const int clen = max(0, min(chunk, len - start));
        float s[D];

        // pass 1: every chunk from zero, the first from the carry
#pragma unroll
        for (int d = 0; d < D; ++d) s[d] = tid == 0 ? carry[d] : 0.f;
        for (int t = 0; t < clen; ++t) f.step(s, buf[start + t]);

        // pass 2: inclusive scan of the end states, E_k += A^(L 2^j) E_(k - 2^j)
        for (int j = 0; (1 << j) < chunks; ++j) {
            const int off = 1 << j;
#pragma unroll
            for (int d = 0; d < D; ++d) ev[d * kThreads + tid] = s[d];
            __syncthreads();
            if (tid >= off && tid < chunks) {
                float prev[D];
#pragma unroll
                for (int d = 0; d < D; ++d) prev[d] = ev[d * kThreads + tid - off];
                const float* p = pm + j * D * D;
#pragma unroll
                for (int r = 0; r < D; ++r) {
                    float acc = s[r];
#pragma unroll
                    for (int q = 0; q < D; ++q) acc = fmaf(p[r * D + q], prev[q], acc);
                    s[r] = acc;
                }
            }
            __syncthreads();
        }
#pragma unroll
        for (int d = 0; d < D; ++d) ev[d * kThreads + tid] = s[d];
        __syncthreads();

        // pass 3: every chunk from its true start state, y in place
#pragma unroll
        for (int d = 0; d < D; ++d) s[d] = tid == 0 ? carry[d] : ev[d * kThreads + tid - 1];
        for (int t = 0; t < clen; ++t) buf[start + t] = f.step(s, buf[start + t]);
        __syncthreads();  // every thread has read the carry and written its chunk
        if (tid == chunks - 1) {
#pragma unroll
            for (int d = 0; d < D; ++d) carry[d] = s[d];
        }
        for (int i = tid; i < len; i += kThreads) yr[seg0 + i] = buf[i];
        __syncthreads();  // buf is free and the carry visible
    }
    if (tid < D) z1[row * D + tid] = carry[tid];
}

template <int NS, int MODE>
int launch_iir(const float* x, float* y, const float* coef, const float* z0, float* z1,
               const float* pmats, int rows, int n, int chunk, int seg_len, int levels,
               cudaStream_t stream) {
    constexpr int D = Recurrence<NS, MODE>::D;
    const size_t smem =
        sizeof(float) * (((seg_len + 3) & ~3) + D * kThreads + levels * D * D + D);
    cudaError_t err = cudaFuncSetAttribute(iir_scan_kernel<NS, MODE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    iir_scan_kernel<NS, MODE><<<rows, kThreads, smem, stream>>>(x, y, coef, z0, z1, pmats, n,
                                                                chunk, seg_len, levels);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WAVECAP_EXPORT int k9_iir_cascade(const void* x, void* y, const void* coef, const void* z0,
                                  void* z1, const void* pmats, int rows, int n, int n_sections,
                                  int mode, int chunk, int seg_len, int levels, void* stream) {
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    const float* c = static_cast<const float*>(coef);
    const float* zi = static_cast<const float*>(z0);
    float* zo = static_cast<float*>(z1);
    const float* p = static_cast<const float*>(pmats);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rows <= 0 || n <= 0) return 0;
    if (chunk <= 0 || seg_len <= 0 || (seg_len + chunk - 1) / chunk > kThreads ||
        (1 << levels) < (seg_len + chunk - 1) / chunk)
        return static_cast<int>(cudaErrorInvalidValue);
#define K9_ARGS xi, yo, c, zi, zo, p, rows, n, chunk, seg_len, levels, s
    if (mode == 1) return launch_iir<1, 1>(K9_ARGS);
    if (mode == 2) return launch_iir<1, 2>(K9_ARGS);
    if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (n_sections) {
        case 1: return launch_iir<1, 0>(K9_ARGS);
        case 2: return launch_iir<2, 0>(K9_ARGS);
        case 3: return launch_iir<3, 0>(K9_ARGS);
        case 4: return launch_iir<4, 0>(K9_ARGS);
        case 5: return launch_iir<5, 0>(K9_ARGS);
        case 6: return launch_iir<6, 0>(K9_ARGS);
        case 7: return launch_iir<7, 0>(K9_ARGS);
        case kMaxSections: return launch_iir<kMaxSections, 0>(K9_ARGS);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef K9_ARGS
}
