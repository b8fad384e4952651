// K9: IIR recurrences with carried state: biquad cascades, one-poles and
// the AGC's two-stage envelope.
//
// Replaces wavecap_tpu/ops/iir.py:_biquad_scan / sos_filter (mode 0),
// ops/iir.py:onepole_filter and deemphasis (mode 1) and
// ops/agc.py:envelope (mode 2), which the reference evaluates as
// associative scans of affine maps.  Here each row is walked in order:
//
//   mode 0, per section (scipy sosfilt's DF2T, coef = b0 b1 b2 a1 a2 each):
//     y = b0 x + z1;  z1 = b1 x - a1 y + z2;  z2 = b2 x - a2 y
//   mode 1 (coef = b0 a):          y = b0 x + a y
//   mode 2 (coef = ca 1-ca cr 1-cr):
//     ea = ca |x| + (1-ca) ea;  er = cr ea + (1-cr) er;  y = max(ea, er)
//
// The state is (rows, sections, 2) for mode 0, (rows,) for mode 1 and
// (rows, 2) = (attack, release) for mode 2, in the reference's layout;
// the final state is written to z1.
//
// Bound on the H100: the serial dependency chain, not bytes.  At 160 rows
// x 9,447 samples a pass reads and writes 12 MB (~3.6 us at 3.35 TB/s),
// but each row is one chain of 9,447 x sections dependent multiply-adds
// (at ~4 cycles each, ~0.06 ms for 3 sections at 1.98 GHz), and only
// ceil(rows / 32) warps run.  Design: one thread per row, the sections'
// states and coefficients in registers; the row is loaded and stored
// through a 32 x 32 shared-memory tile so that a warp's global accesses
// are 128-byte rows.  A chunked parallel scan across samples is later
// work.
#include "common.cuh"

namespace {

constexpr int kRows = 32;  // rows per block, one per thread of the warp
constexpr int kSamples = 32;  // samples per tile
constexpr int kMaxSections = 8;

template <int NS, int MODE>
__global__ void iir_cascade_kernel(const float* __restrict__ x, float* __restrict__ y,
                                   const float* __restrict__ coef, const float* __restrict__ z0,
                                   float* __restrict__ z1, int rows, int n) {
    __shared__ float tile[kRows][kSamples + 1];
    const int lane = threadIdx.x;
    const int row0 = blockIdx.x * kRows;
    const int row = row0 + lane;
    const bool live = row < rows;

    float c[NS][5];
    float s1[NS], s2[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
#pragma unroll
        for (int j = 0; j < 5; ++j) c[i][j] = (MODE == 0) ? coef[i * 5 + j] : 0.f;
        s1[i] = s2[i] = 0.f;
    }
    float k0 = 0.f, k1 = 0.f, k2 = 0.f, k3 = 0.f;
    if (MODE == 1) {
        k0 = coef[0];
        k1 = coef[1];
        if (live) s1[0] = z0[row];
    } else if (MODE == 2) {
        k0 = coef[0];
        k1 = coef[1];
        k2 = coef[2];
        k3 = coef[3];
        if (live) {
            s1[0] = z0[2 * row];
            s2[0] = z0[2 * row + 1];
        }
    } else if (live) {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            s1[i] = z0[(static_cast<long long>(row) * NS + i) * 2];
            s2[i] = z0[(static_cast<long long>(row) * NS + i) * 2 + 1];
        }
    }

    for (int t0 = 0; t0 < n; t0 += kSamples) {
        const int len = min(kSamples, n - t0);
        for (int r = 0; r < kRows; ++r) {
            if (row0 + r < rows && lane < len)
                tile[r][lane] = x[static_cast<long long>(row0 + r) * n + t0 + lane];
        }
        __syncwarp();
        if (live) {
            for (int t = 0; t < len; ++t) {
                float v = tile[lane][t];
                if (MODE == 0) {
#pragma unroll
                    for (int i = 0; i < NS; ++i) {
                        const float out = fmaf(c[i][0], v, s1[i]);
                        s1[i] = fmaf(-c[i][3], out, fmaf(c[i][1], v, s2[i]));
                        s2[i] = fmaf(-c[i][4], out, c[i][2] * v);
                        v = out;
                    }
                } else if (MODE == 1) {
                    s1[0] = fmaf(k1, s1[0], k0 * v);
                    v = s1[0];
                } else {
                    s1[0] = fmaf(k1, s1[0], k0 * fabsf(v));
                    s2[0] = fmaf(k3, s2[0], k2 * s1[0]);
                    v = fmaxf(s1[0], s2[0]);
                }
                tile[lane][t] = v;
            }
        }
        __syncwarp();
        for (int r = 0; r < kRows; ++r) {
            if (row0 + r < rows && lane < len)
                y[static_cast<long long>(row0 + r) * n + t0 + lane] = tile[r][lane];
        }
        __syncwarp();
    }

    if (!live) return;
    if (MODE == 1) {
        z1[row] = s1[0];
    } else if (MODE == 2) {
        z1[2 * row] = s1[0];
        z1[2 * row + 1] = s2[0];
    } else {
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            z1[(static_cast<long long>(row) * NS + i) * 2] = s1[i];
            z1[(static_cast<long long>(row) * NS + i) * 2 + 1] = s2[i];
        }
    }
}

template <int NS, int MODE>
int launch_iir(const float* x, float* y, const float* coef, const float* z0, float* z1, int rows,
               int n, cudaStream_t stream) {
    const int blocks = (rows + kRows - 1) / kRows;
    iir_cascade_kernel<NS, MODE><<<blocks, kRows, 0, stream>>>(x, y, coef, z0, z1, rows, n);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

WAVECAP_EXPORT int k9_iir_cascade(const void* x, void* y, const void* coef, const void* z0,
                                  void* z1, int rows, int n, int n_sections, int mode,
                                  void* stream) {
    const float* xi = static_cast<const float*>(x);
    float* yo = static_cast<float*>(y);
    const float* c = static_cast<const float*>(coef);
    const float* zi = static_cast<const float*>(z0);
    float* zo = static_cast<float*>(z1);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (rows <= 0) return 0;
    if (mode == 1) return launch_iir<1, 1>(xi, yo, c, zi, zo, rows, n, s);
    if (mode == 2) return launch_iir<1, 2>(xi, yo, c, zi, zo, rows, n, s);
    if (mode != 0) return static_cast<int>(cudaErrorInvalidValue);
    switch (n_sections) {
        case 1: return launch_iir<1, 0>(xi, yo, c, zi, zo, rows, n, s);
        case 2: return launch_iir<2, 0>(xi, yo, c, zi, zo, rows, n, s);
        case 3: return launch_iir<3, 0>(xi, yo, c, zi, zo, rows, n, s);
        case 4: return launch_iir<4, 0>(xi, yo, c, zi, zo, rows, n, s);
        case 5: return launch_iir<5, 0>(xi, yo, c, zi, zo, rows, n, s);
        case 6: return launch_iir<6, 0>(xi, yo, c, zi, zo, rows, n, s);
        case 7: return launch_iir<7, 0>(xi, yo, c, zi, zo, rows, n, s);
        case kMaxSections: return launch_iir<kMaxSections, 0>(xi, yo, c, zi, zo, rows, n, s);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}
