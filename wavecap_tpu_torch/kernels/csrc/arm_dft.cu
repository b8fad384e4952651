// K2: the channelizer's cross-arm DFT with its epilogue, on the tensor cores.
//
// Replaces wavecap_tpu/ops/planar.py:planar_factored_dft (and, with
// m1 = 1, planar_matmul_dft) together with the tail of
// wavecap_tpu/ops/channelizer.py:channelize.  For every output step of
// both parity stacks u[p, r, :] (M = m1*m2 arms) it computes
//
//   stage 1   A[c1, k2] = sum_k1 x[k1*m2 + k2] * W1[k1, c1]     (m1-point DFT)
//   twiddle   B[c1, k2] = A[c1, k2] * TW[c1, k2]
//   stage 2   Y[c1 + m1*c2] = sum_k2 B[c1, k2] * W2[k2, c2]      (m2-point DFT)
//   epilogue  y[c] = Y[c] * e^{-2 pi i c / M}, times (-1)^c on odd steps,
//
// and writes out[c, 2r + p]: the two stacks interleaved and transposed to
// (M, S).  The tables are the reference's f32 tables (cos and sin planes,
// built in float64 on the host), so both sides multiply by the same
// numbers.
//
// Bound on the H100: bytes.  At M = 800 = 25 x 32 and 4,920 steps it
// moves 63 MB (18.8 us at 3.35 TB/s); the factored DFT is ~1.8 GFLOP, 27
// us on the f32 CUDA cores alone, so the products go to the tensor cores.
//
// Design: each stage is a real GEMM over a tile of 4 steps, on mma.sync
// m16n8k8 TF32 in 3xTF32: every f32 operand is split into a TF32 hi and
// lo = x - hi, and hi*hi + hi*lo + lo*hi is summed in f32, which keeps
// f32 accuracy (the tensor cores read lo's top 10 mantissa bits).
// Complex numbers stay interleaved (re, im): a stage's table is the real
// (2m x 2m) form [[Wr, Wi], [-Wi, Wr]] of W, interleaved likewise, so a
// complex product keeps its four real products and a thread's pair of
// accumulators (c0, c1) is one complex output.
//
//   stage 1: rows (step, k2), K = (k1, re/im), N = (c1, re/im); the
//            epilogue multiplies by TW and stores B[(step, c1), (k2, re/im)]
//   stage 2: rows (step, c1), K = (k2, re/im), N = (c2, re/im); the
//            epilogue applies the channel twiddle and odd-step sign and
//            stages (step, c) in shared memory, so out is written in
//            runs of 4 steps (32 bytes) a channel.
//
// A block of 16 warps takes a tile; a warp's item is one 16-row tile by
// 4 column tiles: its A fragment is loaded and split once for the 4, and
// the three products of 3xTF32 go out in three passes over the 4
// accumulators, so consecutive MMAs never wait on each other.  The
// tables sit in shared memory once per block (copied with cp.async beside
// the first tile), already split into (hi, lo) pairs on the host, padded
// to multiples of 8, with row strides that put a fragment's 64-bit loads
// in distinct banks; the staged k1 stride is 16 mod 32 floats, so stage
// 1's A fragments are conflict-free too.  Past M ~1,700 the tables do
// not fit and are read through the caches; past M ~4,700 a tile is one
// step.  One persistent block an SM
// walks the tiles and brings the next tile's steps in with cp.async
// (double-buffered, 16 bytes a copy) while it computes the current one;
// out is written 16 bytes (two steps of a channel) a store.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 4;  // column tiles of a warp's item

struct Layout {
    int m1, m2, m;
    int p1, rsx;            // staged input: k1 stride (>= 2 m2, 16 mod 32), floats a step
    int xsz;                // floats of one input buffer (also the (step, c) output tile)
    int ss;                 // output tile: float2 stride of a step (m + 4)
    int rows1, mt1, nt1;    // stage 1: rows (kRows m2), 16-row tiles, 8-wide k and n tiles
    int rows2, mt2, nt2;    // stage 2: rows (kRows m1), 16-row tiles, 8-wide k and n tiles
    int s2;                 // float stride of a stage-2 row (>= 8 nt2, 4 mod 32)
    int n1s, n2s;           // tables: float2 stride of a row (4 mod 16)
    int t_b2, t_tw, t_ch, tab_floats;  // the tables: offsets of W2, TW and the twiddle
    int o_mid, o_tab, total;           // shared memory offsets, floats
};

__host__ __device__ inline int stride_mod(int n, int r, int q) { return n + (((r - n) % q) + q) % q; }

Layout make_layout(int rows, bool tab_in_smem, int m1, int m2, int k1p, int n1s, int k2p,
                   int n2s) {
    Layout L;
    L.m1 = m1;
    L.m2 = m2;
    L.m = m1 * m2;
    L.p1 = stride_mod(2 * m2, 16, 32);
    L.rsx = m1 * L.p1;
    L.ss = L.m + 4;
    L.xsz = rows * L.rsx > 2 * rows * L.ss ? rows * L.rsx : 2 * rows * L.ss;
    L.rows1 = rows * m2;
    L.mt1 = (L.rows1 + 15) / 16;
    L.nt1 = k1p / 8;
    L.rows2 = rows * m1;
    L.mt2 = (L.rows2 + 15) / 16;
    L.nt2 = k2p / 8;
    L.s2 = stride_mod(k2p, 4, 32);
    L.n1s = n1s;
    L.n2s = n2s;
    L.t_b2 = 2 * k1p * n1s;
    L.t_tw = L.t_b2 + 2 * k2p * n2s;
    L.t_ch = L.t_tw + 2 * L.m;
    L.tab_floats = L.t_ch + 2 * L.m;
    L.o_mid = 2 * L.xsz;
    L.o_tab = L.o_mid + L.rows2 * L.s2;
    L.total = L.o_tab + (tab_in_smem ? L.tab_floats : 0);
    return L;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo: hi the nearest TF32, lo the f32 remainder (exact)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// acc[j] += a * b[j] in 3xTF32 for the group's column tiles, the small
// products first and each pass over all tiles, so that consecutive
// products go to different accumulators; bt points at the first tile's
// (hi, lo) pair at (k = t, n = g), its pair at k = t + 4 lies 4 rows on
__device__ __forceinline__ void mma3_group(float (&acc)[kGroup][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const float2* bt,
                                           int stride, int tiles) {
    float2 b0[kGroup], b1[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
        b0[j] = j < tiles ? bt[8 * j] : make_float2(0.f, 0.f);
        b1[j] = j < tiles ? bt[8 * j + 4 * stride] : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
        if (j < tiles) mma_tf32(acc[j], al, __float_as_uint(b0[j].x), __float_as_uint(b1[j].x));
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
        if (j < tiles) mma_tf32(acc[j], ah, __float_as_uint(b0[j].y), __float_as_uint(b1[j].y));
#pragma unroll
    for (int j = 0; j < kGroup; ++j)
        if (j < tiles) mma_tf32(acc[j], ah, __float_as_uint(b0[j].x), __float_as_uint(b1[j].x));
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// the tile's kRows steps (out columns s = 2 step + parity) into dst, by
// rows of m2 samples (k1 fixed); columns past the last step are 0.  With
// m2 even, 16 bytes (two samples) a copy and a row on pow2(m2 / 2) lanes.
template <int kRows>
__device__ void load_tile(const float2* __restrict__ u, float* dst, int tile, int r_steps,
                          const Layout& L) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int s0 = tile * kRows;
    const bool pairs = (L.m2 & 1) == 0;
    const int per_row = pairs ? L.m2 >> 1 : L.m2;  // copies a row
    const int lpr = per_row >= 32 ? 32 : 1 << (32 - __clz(per_row - 1));  // lanes a row
    const int rpi = 32 / lpr;                                               // rows a warp step
    for (int rk = warp * rpi + lane / lpr; rk < kRows * L.m1; rk += kWarps * rpi) {
        const int r = rk / L.m1, k1 = rk - r * L.m1;
        const int s = s0 + r;
        float* d = dst + r * L.rsx + k1 * L.p1;
        const float2* src =
            u + (static_cast<long long>(s & 1) * r_steps + (s >> 1)) * L.m + k1 * L.m2;
        for (int q = lane % lpr; q < per_row; q += lpr) {
            if (s >= 2 * r_steps) {
                d[(pairs ? 4 : 2) * q] = d[(pairs ? 4 : 2) * q + 1] = 0.f;
                if (pairs) d[4 * q + 2] = d[4 * q + 3] = 0.f;
            } else if (pairs) {
                cp_async16(d + 4 * q, src + 2 * q);
            } else {
                cp_async8(d + 2 * q, src + q);
            }
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// kTabInSmem: the tables are staged in shared memory; else (large M) they
// are read where they lie, through the L1 and L2 caches
template <int kRows, bool kTabInSmem, int kBlocksPerSm>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
arm_dft_kernel(const float2* __restrict__ u, const float* __restrict__ tables,
               float2* __restrict__ out, int r_steps, const Layout L) {
    extern __shared__ float smem[];
    float* mid = smem + L.o_mid;
    const float* tab = kTabInSmem ? smem + L.o_tab : tables;
    const float2* b1 = reinterpret_cast<const float2*>(tab);
    const float2* b2 = reinterpret_cast<const float2*>(tab + L.t_b2);
    const float2* tw = reinterpret_cast<const float2*>(tab + L.t_tw);
    const float2* ch = reinterpret_cast<const float2*>(tab + L.t_ch);

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int m1 = L.m1, m2 = L.m2, m = L.m;
    const int s_total = 2 * r_steps;
    const int n_tiles = (s_total + kRows - 1) / kRows;

    for (int i = tid; i < L.o_tab; i += kThreads) smem[i] = 0.f;  // pads stay 0
    if (kTabInSmem)  // in the first tile's copy group (tab_floats is a multiple of 4)
        for (int i = 4 * tid; i < L.tab_floats; i += 4 * kThreads)
            cp_async16(smem + L.o_tab + i, tables + i);
    __syncthreads();  // the zeros land before any copy into the buffers
    if (blockIdx.x < n_tiles) load_tile<kRows>(u, smem, blockIdx.x, r_steps, L);

    int buf = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
        float* xin = smem + buf * L.xsz;
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncthreads();  // this tile's steps are in; the other buffer is free
        if (tile + gridDim.x < n_tiles)
            load_tile<kRows>(u, smem + (buf ^ 1) * L.xsz, tile + gridDim.x, r_steps, L);

        // stage 1: A[(r, k2), (c1, re/im)] = X[(r, k2), (k1, re/im)] @ B1, times TW
        const int ng1 = (L.nt1 + kGroup - 1) / kGroup;
        for (int item = warp; item < L.mt1 * ng1; item += kWarps) {
            const int mt = item / ng1, ng = kGroup * (item - mt * ng1);
            int base[2], rr[2], kk2[2];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 16 * mt + g + 8 * h;
                const int rc = row < L.rows1 ? row : 0;  // rows past the tile read row 0
                rr[h] = rc / m2;
                kk2[h] = rc - rr[h] * m2;
                base[h] = rr[h] * L.rsx + 2 * kk2[h];
            }
            {
                float acc[kGroup][4] = {};
                for (int ks = 0; ks < L.nt1; ++ks) {
                    uint32_t ah[4], al[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int kk = 8 * ks + t + 4 * (e >> 1);
                        split(kk < 2 * m1 ? xin[base[e & 1] + (kk >> 1) * L.p1 + (kk & 1)] : 0.f,
                              ah[e], al[e]);
                    }
                    mma3_group(acc, ah, al, b1 + (8 * ks + t) * L.n1s + 8 * ng + g, L.n1s,
                               L.nt1 - ng);
                }
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    const int c1 = 4 * (ng + j) + t;
                    if (ng + j >= L.nt1 || c1 >= m1) continue;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        if (16 * mt + g + 8 * h >= L.rows1) continue;
                        const float ar = acc[j][2 * h], ai = acc[j][2 * h + 1];
                        const float2 w = tw[c1 * m2 + kk2[h]];
                        *reinterpret_cast<float2*>(mid + (rr[h] * m1 + c1) * L.s2 + 2 * kk2[h]) =
                            make_float2(ar * w.x - ai * w.y, ar * w.y + ai * w.x);
                    }
                }
            }
        }
        __syncthreads();

        // stage 2: Y[(r, c1), (c2, re/im)] = B[(r, c1), (k2, re/im)] @ B2, then
        // the channel twiddle and odd-step sign, staged as (r, c) in xin
        float2* stage = reinterpret_cast<float2*>(xin);
        const int s0 = tile * kRows;
        const int ng2 = (L.nt2 + kGroup - 1) / kGroup;
        for (int item = warp; item < L.mt2 * ng2; item += kWarps) {
            const int mt = item / ng2, ng = kGroup * (item - mt * ng2);
            const float* a_row[2];  // rows g and g + 8; rows past the tile read row 0
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int row = 16 * mt + g + 8 * h;
                a_row[h] = mid + (row < L.rows2 ? row : 0) * L.s2 + t;
            }
            {
                float acc[kGroup][4] = {};
                for (int ks = 0; ks < L.nt2; ++ks) {
                    uint32_t ah[4], al[4];
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        split(a_row[e & 1][8 * ks + 4 * (e >> 1)], ah[e], al[e]);
                    mma3_group(acc, ah, al, b2 + (8 * ks + t) * L.n2s + 8 * ng + g, L.n2s,
                               L.nt2 - ng);
                }
#pragma unroll
                for (int j = 0; j < kGroup; ++j) {
                    const int c2 = 4 * (ng + j) + t;
                    if (ng + j >= L.nt2 || c2 >= m2) continue;
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = 16 * mt + g + 8 * h;
                        if (row >= L.rows2) continue;
                        const int r = row / m1, c1 = row - r * m1;
                        const int c = c1 + m1 * c2;
                        const float yr = acc[j][2 * h], yi = acc[j][2 * h + 1];
                        const float2 w = ch[c];
                        float zr = yr * w.x - yi * w.y, zi = yr * w.y + yi * w.x;
                        if (((s0 + r) & 1) && (c & 1)) {
                            zr = -zr;
                            zi = -zi;
                        }
                        stage[r * L.ss + c] = make_float2(zr, zi);
                    }
                }
            }
        }
        __syncthreads();

        if constexpr (kRows == 1) {  // one step: a channel a store
            for (int c = tid; c < m; c += kThreads) out[static_cast<long long>(c) * s_total + s0] = stage[c];
        } else {
            // two steps of a channel a 16-byte store (s0, S and r are even)
            for (int i = tid; i < m * (kRows / 2); i += kThreads) {
                const int c = i / (kRows / 2), r = 2 * (i - c * (kRows / 2));
                float2* o = out + static_cast<long long>(c) * s_total + s0 + r;
                const float2 a = stage[r * L.ss + c];
                if (s0 + r + 1 < s_total) {
                    const float2 b = stage[(r + 1) * L.ss + c];
                    *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
                } else if (s0 + r < s_total) {
                    *o = a;
                }
            }
        }
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int kRows, bool kTabInSmem, int kBlocksPerSm>
int launch_arm_dft(const Layout& L, const float2* u, const float* tables, float2* out,
                   int r_steps, cudaStream_t stream) {
    const size_t smem = sizeof(float) * L.total;
    auto kernel = arm_dft_kernel<kRows, kTabInSmem, kBlocksPerSm>;
    cudaError_t err = cudaFuncSetAttribute(kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
        return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
        cudaSuccess)
        return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    const int n_tiles = (2 * r_steps + kRows - 1) / kRows;
    const int blocks = n_tiles < sms * per_sm ? n_tiles : sms * per_sm;
    kernel<<<blocks, kThreads, smem, stream>>>(u, tables, out, r_steps, L);
    return static_cast<int>(cudaGetLastError());
}

constexpr size_t kMaxSmem = 232448;  // bytes of shared memory a block can have on Hopper

}  // namespace

// Tiles of 4 steps with the tables in shared memory where they fit; else
// tiles of 2; else (M past ~1,700) the tables read from device memory;
// else (M past ~4,700) tiles of 1 step, up to M ~9,000.
WAVECAP_EXPORT int k2_arm_dft(const void* u, const void* tables, void* out, int m1, int m2,
                              int r_steps, int k1p, int n1s, int k2p, int n2s, void* stream) {
    if (r_steps <= 0) return 0;
    const float2* ui = static_cast<const float2*>(u);
    const float* tab = static_cast<const float*>(tables);
    float2* o = static_cast<float2*>(out);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Layout l4 = make_layout(4, true, m1, m2, k1p, n1s, k2p, n2s);
    if (sizeof(float) * l4.total <= kMaxSmem) return launch_arm_dft<4, true, 1>(l4, ui, tab, o, r_steps, s);
    const Layout l2 = make_layout(2, true, m1, m2, k1p, n1s, k2p, n2s);
    if (sizeof(float) * l2.total <= kMaxSmem) return launch_arm_dft<2, true, 1>(l2, ui, tab, o, r_steps, s);
    const Layout lg = make_layout(2, false, m1, m2, k1p, n1s, k2p, n2s);
    if (sizeof(float) * lg.total <= kMaxSmem) return launch_arm_dft<2, false, 1>(lg, ui, tab, o, r_steps, s);
    const Layout l1 = make_layout(1, false, m1, m2, k1p, n1s, k2p, n2s);
    if (sizeof(float) * l1.total > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    return launch_arm_dft<1, false, 1>(l1, ui, tab, o, r_steps, s);
}
