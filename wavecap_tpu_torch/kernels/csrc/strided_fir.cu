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
// Bound on the H100: bytes for the wide slots.  Two slots read the
// 1,968,000-sample complex block (15.7 MB each, 31.5 MB in all) and write
// 2 x 48,000 outputs (~9.4 us at 3.35 TB/s); 2 x 48,000 x 1,031 complex
// multiply-adds are 0.40 GFLOP (~5.9 us at 67 TFLOP/s).  The equaliser's
// 21 rows x 7,500 samples x 41 complex taps read and write 2.5 MB (~0.8 us)
// and do 50 MFLOP (~0.8 us).  Design: one block per (tile of 128 outputs,
// row).  The tile's input span ((128 - 1) x stride + T samples, 50 KB at
// stride 41 and 1,031 taps) and the row's taps are staged in shared
// memory, the NCO mixed in on the load, so each input sample's cosf/sinf
// is computed once per tile, not once per tap.  Each thread then computes
// one output.  An extra block per row writes the tail and the next phase.
#include "common.cuh"

namespace {

constexpr int kTile = 128;

__device__ __forceinline__ float load_x(const float* p, long long i, unsigned, unsigned, bool) {
    return p[i];
}

__device__ __forceinline__ float2 load_x(const float2* p, long long i, unsigned d, unsigned p0,
                                         bool mix) {
    const float2 v = p[i];
    if (!mix) return v;
    const float rad_per_count = static_cast<float>(6.283185307179586 / 4294967296.0);
    const unsigned acc = p0 + static_cast<unsigned>(i) * d;
    const float ph = __uint2float_rn(acc) * rad_per_count;
    const float c = cosf(ph), s = sinf(ph);
    return make_float2(v.x * c - v.y * s, v.x * s + v.y * c);
}

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

template <typename V, typename H>
__global__ void strided_fir_kernel(const V* __restrict__ x, int x_rows, const V* __restrict__ head,
                                   int head_len, const H* __restrict__ taps, int n_taps,
                                   int taps_stride, int stride, const unsigned* __restrict__ dphi,
                                   const unsigned* __restrict__ phase0, V* __restrict__ y,
                                   V* __restrict__ tail, unsigned* __restrict__ phase1, int n,
                                   int n_out, int n_tiles) {
    extern __shared__ float smem[];
    H* h = reinterpret_cast<H*>(smem);
    V* span = reinterpret_cast<V*>(smem + ((n_taps * (sizeof(H) / 4) + 3) & ~3));
    const int row = blockIdx.y;
    const V* xr = x + static_cast<long long>(x_rows == 1 ? 0 : row) * n;
    const V* hr = head ? head + static_cast<long long>(row) * head_len : nullptr;
    const bool mix = dphi != nullptr;
    const unsigned d = mix ? dphi[row] : 0u, p0 = mix ? phase0[row] : 0u;

    if (static_cast<int>(blockIdx.x) == n_tiles) {  // the tail and the next phase
        const long long total = static_cast<long long>(head_len) + n;
        // fewer samples than T - 1 (no output then): the tail holds them all
        const int t1 = static_cast<int>(min(static_cast<long long>(n_taps - 1), total));
        if (tail) {
            for (int i = threadIdx.x; i < t1; i += blockDim.x) {
                const long long j = total - t1 + i;
                tail[static_cast<long long>(row) * t1 + i] =
                    j < head_len ? hr[j] : load_x(xr, j - head_len, d, p0, mix);
            }
        }
        if (phase1 && threadIdx.x == 0) phase1[row] = p0 + static_cast<unsigned>(n) * d;
        return;
    }

    const H* hrow = taps + static_cast<long long>(row) * taps_stride;
    for (int k = threadIdx.x; k < n_taps; k += blockDim.x) h[k] = hrow[k];
    const long long m0 = static_cast<long long>(blockIdx.x) * kTile;
    const int count = static_cast<int>(min(static_cast<long long>(kTile), n_out - m0));
    const long long j0 = m0 * stride;
    const int len = (count - 1) * stride + n_taps;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
        const long long j = j0 + i;
        span[i] = j < head_len ? hr[j] : load_x(xr, j - head_len, d, p0, mix);
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) >= count) return;
    const V* w = span + threadIdx.x * stride + n_taps - 1;
    Acc<V, H> acc;
    for (int k = 0; k < n_taps; ++k) acc.mac(h[k], w[-k]);
    y[static_cast<long long>(row) * n_out + m0 + threadIdx.x] = acc.value();
}

template <typename V, typename H>
int launch_fir(const void* x, int x_rows, const void* head, int head_len, const void* taps,
               int n_taps, int taps_stride, int stride, const void* dphi, const void* phase0,
               void* y, void* tail, void* phase1, int rows, int n, int n_out,
               cudaStream_t stream) {
    const int n_tiles = (n_out + kTile - 1) / kTile;
    const size_t span = static_cast<size_t>(kTile - 1) * stride + n_taps;
    const size_t smem = sizeof(float) * ((n_taps * (sizeof(H) / 4) + 3) & ~3) + sizeof(V) * span;
    cudaError_t err = cudaFuncSetAttribute(strided_fir_kernel<V, H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int extra = (tail || phase1) ? 1 : 0;
    const dim3 grid(n_tiles + extra, rows);
    strided_fir_kernel<V, H><<<grid, kTile, smem, stream>>>(
        static_cast<const V*>(x), x_rows, static_cast<const V*>(head), head_len,
        static_cast<const H*>(taps), n_taps, taps_stride, stride,
        static_cast<const unsigned*>(dphi),
        static_cast<const unsigned*>(phase0), static_cast<V*>(y), static_cast<V*>(tail),
        static_cast<unsigned*>(phase1), n, n_out, n_tiles);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WAVECAP_EXPORT int k7_strided_fir(const void* x, int x_rows, const void* head, int head_len,
                                  const void* taps, int n_taps, int taps_stride, int taps_cplx,
                                  int stride, const void* dphi, const void* phase0, void* y,
                                  void* tail, void* phase1, int rows, int n, int n_out, int cplx,
                                  void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (taps_cplx) {
        if (!cplx) return static_cast<int>(cudaErrorInvalidValue);  // complex taps, complex rows
        return launch_fir<float2, float2>(x, x_rows, head, head_len, taps, n_taps, taps_stride,
                                          stride, dphi, phase0, y, tail, phase1, rows, n, n_out, s);
    }
    if (cplx) {
        return launch_fir<float2, float>(x, x_rows, head, head_len, taps, n_taps, taps_stride,
                                         stride, dphi, phase0, y, tail, phase1, rows, n, n_out, s);
    }
    if (dphi) return static_cast<int>(cudaErrorInvalidValue);  // the NCO mixes complex input
    return launch_fir<float, float>(x, x_rows, head, head_len, taps, n_taps, taps_stride, stride,
                                    nullptr, nullptr, y, tail, phase1, rows, n, n_out, s);
}
