// K11b: the spectral noise reduction's arithmetic around cuFFT.
//
// Replaces wavecap_tpu/ops/noise.py:spectral_noise_reduction except its
// rFFT and irFFT, which the reference takes from XLA's library FFT and
// the port from cuFFT (torch.fft).  Per row x of n samples, F frames of
// N = fft_size at hop H, win = np.hanning(N) as f32:
//
//   k11b_nr_frames:       frames[f, j] = x[f H + j] * win[j]
//   (torch.fft.rfft)      X[f, b]
//   k11b_nr_gain:         floor[b] = lo (1 - h) + hi h, the ranks floor(q), ceil(q) of
//                         |X[., b]| (q = f32(0.1) * (F - 1), jnp.percentile's linear method)
//                         g = max(max(0, 1 - (floor k / max(|X|, 1e-10))^2), 0.1)
//                         X[f, b] *= g                                  (in place)
//   (torch.fft.irfft)     c[f, j]
//   k11b_nr_overlap_add:  y[i] = (sum over the frames covering i, in frame order from 0,
//                         of c[f, i - f H] * win[i - f H]) / max(wsum[i], 1e-6),
//                         y[i] = x[i] past the last frame
//
// |X| is hypotf; every product and sum is rounded as written (no FMA
// contraction), as the reference's f32 operations are.
//
// Bound on the H100: bytes.  At 160 rows x 9,447 samples (17 frames) the
// function must read 6.0 MB and write 6.0 MB; the frames and spectra it
// passes between launches are ~11 MB each way, L2-resident.  The gain is
// one thread per (row, bin), 160 x 513 threads: each ranks its F = 17
// magnitudes by counting (F^2 compares from L1, no array, any F) to pick
// the percentile's two ranks.  The overlap-add is one thread per output
// sample and needs no atomics.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void nr_frames_kernel(const float* __restrict__ x, const float* __restrict__ win,
                                 float* __restrict__ frames, int n, int n_frames, int fft_size,
                                 int hop, long total) {
    const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int j = static_cast<int>(t % fft_size);
    const long fr = t / fft_size;  // row * n_frames + frame
    const int f = static_cast<int>(fr % n_frames);
    const long row = fr / n_frames;
    frames[t] = __fmul_rn(x[row * n + static_cast<long>(f) * hop + j], win[j]);
}

__global__ void nr_gain_kernel(float2* __restrict__ spec, int n_frames, int bins, float pos,
                               float k, long total) {
    const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int b = static_cast<int>(t % bins);
    const long row = t / bins;
    float2* col = spec + row * n_frames * bins + b;  // frame f at col[f * bins]
    const float lo_pos = floorf(pos), hi_pos = ceilf(pos);
    const float hw = __fsub_rn(pos, lo_pos);
    const float lw = __fsub_rn(1.0f, hw);
    const int lo = min(max(static_cast<int>(lo_pos), 0), n_frames - 1);
    const int hi = min(max(static_cast<int>(hi_pos), 0), n_frames - 1);
    // the sorted column's ranks lo and hi: element f has rank #{g: m_g < m_f}
    // + #{g < f: m_g == m_f}, so equal magnitudes take consecutive ranks
    float v_lo = 0.0f, v_hi = 0.0f;
    for (int f = 0; f < n_frames; ++f) {
        const float2 a = col[static_cast<long>(f) * bins];
        const float mf = hypotf(a.x, a.y);
        int rank = 0;
        for (int g = 0; g < n_frames; ++g) {
            const float2 c = col[static_cast<long>(g) * bins];
            const float mg = hypotf(c.x, c.y);
            rank += (mg < mf || (mg == mf && g < f)) ? 1 : 0;
        }
        if (rank == lo) v_lo = mf;
        if (rank == hi) v_hi = mf;
    }
    const float floor_b = __fadd_rn(__fmul_rn(v_lo, lw), __fmul_rn(v_hi, hw));
    const float num = __fmul_rn(floor_b, k);
    for (int f = 0; f < n_frames; ++f) {
        float2 v = col[static_cast<long>(f) * bins];
        const float m = hypotf(v.x, v.y);
        const float r = __fdiv_rn(num, fmaxf(m, 1e-10f));
        float g = fmaxf(__fsub_rn(1.0f, __fmul_rn(r, r)), 0.0f);
        g = fmaxf(g, 0.1f);
        v.x = __fmul_rn(v.x, g);
        v.y = __fmul_rn(v.y, g);
        col[static_cast<long>(f) * bins] = v;
    }
}

__global__ void nr_overlap_add_kernel(const float* __restrict__ clean, const float* __restrict__ x,
                                      const float* __restrict__ win, const float* __restrict__ wsum,
                                      float* __restrict__ y, int n, int n_frames, int fft_size,
                                      int hop, int out_len, long total) {
    const long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= total) return;
    const int i = static_cast<int>(t % n);
    const long row = t / n;
    if (i >= out_len) {
        y[t] = x[t];
        return;
    }
    // frames f with f H <= i < f H + N, in frame order
    const int f0 = i >= fft_size ? (i - fft_size) / hop + 1 : 0;
    const int f1 = min(i / hop, n_frames - 1);
    const float* c = clean + row * n_frames * static_cast<long>(fft_size);
    float acc = 0.0f;
    for (int f = f0; f <= f1; ++f) {
        const int j = i - f * hop;
        acc = __fadd_rn(acc, __fmul_rn(c[static_cast<long>(f) * fft_size + j], win[j]));
    }
    y[t] = __fdiv_rn(acc, fmaxf(wsum[i], 1e-6f));
}

unsigned grid_for(long total) { return static_cast<unsigned>((total + kThreads - 1) / kThreads); }

}  // namespace

WAVECAP_EXPORT int k11b_nr_frames(const void* x, const void* win, void* frames, int rows, int n,
                                  int n_frames, int fft_size, int hop, void* stream) {
    const long total = static_cast<long>(rows) * n_frames * fft_size;
    nr_frames_kernel<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(win), static_cast<float*>(frames),
        n, n_frames, fft_size, hop, total);
    return static_cast<int>(cudaGetLastError());
}

WAVECAP_EXPORT int k11b_nr_gain(void* spec, int rows, int n_frames, int bins, float pos, float k,
                                void* stream) {
    const long total = static_cast<long>(rows) * bins;
    nr_gain_kernel<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<float2*>(spec), n_frames, bins, pos, k, total);
    return static_cast<int>(cudaGetLastError());
}

WAVECAP_EXPORT int k11b_nr_overlap_add(const void* clean, const void* x, const void* win,
                                       const void* wsum, void* y, int rows, int n, int n_frames,
                                       int fft_size, int hop, int out_len, void* stream) {
    const long total = static_cast<long>(rows) * n;
    nr_overlap_add_kernel<<<grid_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(clean), static_cast<const float*>(x),
        static_cast<const float*>(win), static_cast<const float*>(wsum), static_cast<float*>(y), n,
        n_frames, fft_size, hop, out_len, total);
    return static_cast<int>(cudaGetLastError());
}
