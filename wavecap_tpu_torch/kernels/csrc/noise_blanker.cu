// K11a: the impulse noise blanker, one row per CTA.
//
// Replaces wavecap_tpu/ops/noise.py:noise_blanker.  Per row x of n
// samples (float32, or complex64 with |x| = hypotf(re, im)):
//
//   median = (a[(n-1)/2] + a[n/2]) * 0.5     a = sort(|x|)  (jnp.median's midpoint)
//   thr    = median * factor                 factor = f32(10^(threshold_db/20)), host-rounded
//   blank  = any(|x[j]| > thr, |j - i| <= w) (reduce_window max, SAME, padded with 0)
//   out[i] = blank && !(median < 1e-10) ? 0 : x[i]
//
// The median is an exact radix select, not a sort: |x| >= 0, so its float
// bits order as uint32.  Four 8-bit passes, each a 256-bin histogram in
// shared memory over the elements that share the prefix found so far,
// find the element of rank (n-1)/2; the element of rank n/2 is the same
// value when enough elements equal it, else the least element above it
// (one more pass, a block min).  The row is read from global memory on
// every pass: the wide rows (48,000 complex) do not fit shared memory with
// room to spare, and a row is L2-resident between passes.
//
// Bound on the H100: bytes.  At 160 rows x 4,920 complex samples it must
// read 6.3 MB and write 6.3 MB (~3.8 us at 3.35 TB/s).  The select reads
// the row 5-6 times from L2 and the blank pass reads 2w+1 magnitudes per
// sample from L1; one CTA per row gives 160 CTAs on 132 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;

struct RowMag {
    const float* x;
    int cplx;
    __device__ __forceinline__ float operator()(int i) const {
        if (cplx) return hypotf(x[2 * i], x[2 * i + 1]);
        return fabsf(x[i]);
    }
};

// Rank k's bucket of one pass: the 256 counts are scanned by warp 0
// (8 buckets a lane).  Returns the bucket in *bucket and, in *below, the
// number of counted elements in the lower buckets.
__device__ void find_bucket(const unsigned* hist, unsigned k, int* bucket, unsigned* below) {
    const int lane = threadIdx.x & 31;
    unsigned local = 0;
    for (int b = 0; b < 8; ++b) local += hist[lane * 8 + b];
    unsigned incl = local;
    for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    const unsigned excl = incl - local;
    const unsigned hit = __ballot_sync(0xffffffffu, excl <= k && k < incl);
    const int owner = __ffs(hit) - 1;
    if (lane == owner) {
        unsigned cum = excl;
        int b = lane * 8;
        while (cum + hist[b] <= k) cum += hist[b++];
        *bucket = b;
        *below = cum;
    }
}

__global__ void noise_blanker_kernel(const float* __restrict__ x, float* __restrict__ out,
                                     int n, int cplx, float factor, int width) {
    __shared__ unsigned hist[256];
    __shared__ int s_bucket;
    __shared__ unsigned s_below;
    __shared__ unsigned s_min[32];
    const int stride = cplx ? 2 : 1;
    const long row = blockIdx.x;
    const float* xr = x + row * n * stride;
    float* yr = out + row * n * stride;
    const RowMag mag{xr, cplx};

    // rank lo = (n-1)/2 by four 8-bit passes over the magnitude bits
    const unsigned lo = static_cast<unsigned>(n - 1) / 2u, hi = static_cast<unsigned>(n) / 2u;
    unsigned prefix = 0, mask = 0, k = lo, less = 0, equal = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
        for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
        __syncthreads();
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const unsigned u = __float_as_uint(mag(i));
            if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFFu], 1u);
        }
        __syncthreads();
        if (threadIdx.x < 32) find_bucket(hist, k, &s_bucket, &s_below);
        __syncthreads();
        const int b = s_bucket;
        k -= s_below;
        less += s_below;
        if (shift == 0) equal = hist[b];
        prefix |= static_cast<unsigned>(b) << shift;
        mask |= 0xFFu << shift;
        __syncthreads();  // hist is cleared by the next pass
    }
    const float a_lo = __uint_as_float(prefix);
    float a_hi = a_lo;
    if (hi != lo && less + equal <= hi) {
        // rank hi is the least magnitude above a_lo
        unsigned best = 0xFFFFFFFFu;
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const unsigned u = __float_as_uint(mag(i));
            if (u > prefix && u < best) best = u;
        }
        for (int o = 16; o > 0; o >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, o));
        if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = best;
        __syncthreads();
        best = 0xFFFFFFFFu;
        for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) best = min(best, s_min[w]);
        a_hi = __uint_as_float(best);
    }
    const float median = __fmul_rn(__fadd_rn(a_lo, a_hi), 0.5f);
    const float thr = __fmul_rn(median, factor);
    const bool degenerate = median < 1e-10f;

    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        bool blank = false;
        if (!degenerate) {
            const int j0 = max(i - width, 0), j1 = min(i + width, n - 1);
            for (int j = j0; j <= j1 && !blank; ++j) blank = mag(j) > thr;
        }
        if (cplx) {
            const float2 v = blank ? make_float2(0.f, 0.f)
                                   : reinterpret_cast<const float2*>(xr)[i];
            reinterpret_cast<float2*>(yr)[i] = v;
        } else {
            yr[i] = blank ? 0.f : xr[i];
        }
    }
}

}  // namespace

WAVECAP_EXPORT int k11a_noise_blanker(const void* x, void* out, int rows, int n, int cplx,
                                      float factor, int width, void* stream) {
    noise_blanker_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, cplx, factor, width);
    return static_cast<int>(cudaGetLastError());
}
