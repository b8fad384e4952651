#!/usr/bin/env python3
"""Where K11a's time goes: the noise blanker of the port's first design
(one CTA a row, four 8-bit radix passes and the blank pass each
recomputing |x| from device memory) changed one thing at a time, and the
current design (``kernels/csrc/noise_blanker.cu``) with its cluster size
forced, without its register cap, and instrumented by phase, all timed in
one process on the card.

Run from the repository root on a machine with one NVIDIA card::

    python3 scripts/k11a_variants.py

* ``TEMPLATE``, the first design, with switches: ``STAGE=1`` each |x|
  computed once into shared memory for the select's passes; ``WARPAGG=1``
  the histogram's atomics aggregated over a warp's equal digits
  (``__match_any_sync``); ``DILATE=1`` (with ``STAGE=1``) the blank pass's
  2w+1 neighbours read from the staged |x| too.
* the current kernel's C entry with its plan's CTAs a row forced to 1, 2,
  4 and 8 (the wide rows on more than one SM); the current source built
  with ``K11A_MINB=1`` (no 64-register cap: one CTA an SM) and with
  ``K11A_CLOCKS=1`` (clock64 at each phase's end in thread 0 of each CTA:
  the median SM cycles of each phase over the CTAs); the current kernel
  through ``ops/noise.py``.

Each variant's output must equal the plain version's bit for bit on these
rows (no sample lies near the threshold).  Times are device times from
CUPTI (``chip_smoke.device_ms``) at the engine's shapes: (160, 4,920) and
(100, 4,920) complex64 and float32 rows, and the wide IF's (2, 48,000)
complex64.  One JSON line a variant and shape, with the card's name and
power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

TEMPLATE = r"""
#include "common.cuh"
#ifndef STAGE
#define STAGE 0
#endif
#ifndef WARPAGG
#define WARPAGG 0
#endif
#ifndef DILATE
#define DILATE 0
#endif
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
__global__ void variant_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int cplx,
                               float factor, int width) {
    __shared__ unsigned hist[256];
    __shared__ int s_bucket;
    __shared__ unsigned s_below;
    __shared__ unsigned s_min[32];
    extern __shared__ unsigned smag[];
    const int stride = cplx ? 2 : 1;
    const long row = blockIdx.x;
    const float* xr = x + row * n * stride;
    float* yr = out + row * n * stride;
    const RowMag gmag{xr, cplx};
#if STAGE
    for (int i = threadIdx.x; i < n; i += blockDim.x) smag[i] = __float_as_uint(gmag(i));
    __syncthreads();
    auto mag = [&](int i) { return __uint_as_float(smag[i]); };
#else
    auto mag = [&](int i) { return gmag(i); };
#endif
    const unsigned lo = static_cast<unsigned>(n - 1) / 2u, hi = static_cast<unsigned>(n) / 2u;
    unsigned prefix = 0, mask = 0, k = lo, less = 0, equal = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
        for (int b = threadIdx.x; b < 256; b += blockDim.x) hist[b] = 0;
        __syncthreads();
#if WARPAGG
        for (int i0 = 0; i0 < n; i0 += blockDim.x) {
            const int i = i0 + threadIdx.x;
            const unsigned u = i < n ? __float_as_uint(mag(i)) : 0u;
            const bool in = i < n && (u & mask) == prefix;
            const unsigned key = in ? (u >> shift) & 0xFFu : 0xFFFFFFFFu;
            const unsigned peers = __match_any_sync(0xffffffffu, key);
            if (in && (threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(&hist[key], __popc(peers));
        }
#else
        for (int i = threadIdx.x; i < n; i += blockDim.x) {
            const unsigned u = __float_as_uint(mag(i));
            if ((u & mask) == prefix) atomicAdd(&hist[(u >> shift) & 0xFFu], 1u);
        }
#endif
        __syncthreads();
        if (threadIdx.x < 32) find_bucket(hist, k, &s_bucket, &s_below);
        __syncthreads();
        const int b = s_bucket;
        k -= s_below;
        less += s_below;
        if (shift == 0) equal = hist[b];
        prefix |= static_cast<unsigned>(b) << shift;
        mask |= 0xFFu << shift;
        __syncthreads();
    }
    const float a_lo = __uint_as_float(prefix);
    float a_hi = a_lo;
    if (hi != lo && less + equal <= hi) {
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
#if DILATE
            for (int j = j0; j <= j1 && !blank; ++j) blank = mag(j) > thr;
#else
            for (int j = j0; j <= j1 && !blank; ++j) blank = gmag(j) > thr;
#endif
        }
        if (cplx) {
            const float2 v = blank ? make_float2(0.f, 0.f) : reinterpret_cast<const float2*>(xr)[i];
            reinterpret_cast<float2*>(yr)[i] = v;
        } else {
            yr[i] = blank ? 0.f : xr[i];
        }
    }
}
}  // namespace
WAVECAP_EXPORT int k11a_variant(const void* x, void* out, int rows, int n, int cplx, float factor, int width,
                                void* stream) {
    const int smem = STAGE ? 4 * n : 0;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(variant_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    variant_kernel<<<rows, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<float*>(out), n, cplx, factor, width);
    return static_cast<int>(cudaGetLastError());
}
"""

VARIANTS = {
    "first design": {},
    "staged |x| (select)": {"STAGE": 1},
    "warp-aggregated histogram": {"WARPAGG": 1},
    "staged |x| (select and dilation)": {"STAGE": 1, "DILATE": 1},
    "all three": {"STAGE": 1, "WARPAGG": 1, "DILATE": 1},
}


PHASES = ("stage",) + tuple(f"pass {p} {what}" for p in range(1, 4) for what in ("count", "sync", "sums", "locate")) + (
    "mask", "dilation", "store")


def forced_plan(noise, n: int, cplx: bool, ctas: int):
    """The kernel's plan for rows of n samples with ``ctas`` CTAs a row."""
    slice_ = -(-(-(-n // ctas)) // 32) * 32
    hists = 4 * (3 if ctas > 1 else 2) * (1 << max(noise.K11A_DIGITS))
    items = min((i for i in noise.K11A_ITEMS if slice_ <= i * noise.K11A_THREADS), default=noise.K11A_ITEMS[-1])
    return noise.K11aPlan(ctas, noise.K11A_THREADS, items, slice_, noise.K11A_DIGITS, True,
                          hists + 4 * (2 * (slice_ // 32) + slice_))


def main() -> int:
    import ctypes

    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build
    from wavecap_tpu_torch.ops import noise

    if not torch.cuda.is_available():
        print("k11a_variants: no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    vdir = build.BUILD_DIR / "k11a_variants"
    vdir.mkdir(parents=True, exist_ok=True)
    src = vdir / "variant.cu"
    src.write_text(TEMPLATE)
    nvcc = build._find_nvcc()
    jobs = [(name, src, macros) for name, macros in VARIANTS.items()]
    jobs += [("current, no register cap", build.CSRC / "noise_blanker.cu", {"K11A_MINB": 1}),
             ("current, instrumented", build.CSRC / "noise_blanker.cu", {"K11A_CLOCKS": 1})]
    procs = {}
    for i, (name, source, macros) in enumerate(jobs):
        lib = vdir / f"libvariant{i}.so"
        cmd = build.nvcc_command(source, lib, nvcc)
        cmd[1:1] = [f"-I{build.CSRC}"] + [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"k11a_variants: {name} failed to build\n{text}", file=sys.stderr)
            return 1
        libs[name] = (ctypes.CDLL(str(lib)), [ln.strip() for ln in text.splitlines() if "registers" in ln])
    first_args = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                  ctypes.c_int, ctypes.c_void_p)
    current, _ = build._function("K11a_noise_blanker")
    card = cs.card_line()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261017)
    factor = noise._threshold_factor(10.0)
    shapes = (("nbfm IQ rows", 160, 4920, True), ("nbfm IQ rows", 100, 4920, True),
              ("detector rows", 160, 4920, False), ("detector rows", 100, 4920, False),
              ("wide IF rows", 2, 48_000, True))
    clocks = np.zeros((256, 17), np.int64)
    for case, rows, n, cplx in shapes:
        x = 0.05 * rng.standard_normal((rows, n)) + 0.2
        if cplx:
            x = x + 1j * 0.05 * rng.standard_normal((rows, n))
        x = np.where(rng.random((rows, n)) < 1.0 / 400, x * 40.0, x).astype(np.complex64 if cplx else np.float32)
        xd = torch.from_numpy(x).to(dev)
        ref = noise.noise_blanker_plain(xd)
        out = torch.empty_like(xd)
        plan = noise.k11a_plan(n, cplx)
        results = []

        def run(fn, args, kernel):
            def call():
                status = fn(*args, torch.cuda.current_stream().cuda_stream)
                assert status == 0, status
            call()
            torch.cuda.synchronize()
            return cs.device_ms(call, kernel), bool(torch.equal(out, ref))

        def current_args(p):
            return (xd.data_ptr(), out.data_ptr(), None, rows, n, int(cplx), factor, 3, p.ctas, p.threads, p.items,
                    p.slice, 1, *p.digits, p.smem)

        for name, (lib, ptxas) in libs.items():
            if name in VARIANTS:
                fn = lib.k11a_variant
                fn.argtypes = first_args
                fn.restype = ctypes.c_int
                ms, same = run(fn, (xd.data_ptr(), out.data_ptr(), rows, n, int(cplx), factor, 3), "variant_kernel")
                results.append(dict(variant=name, ms=ms, equal_plain=same, ptxas=ptxas))
                continue
            fn = lib.k11a_noise_blanker
            fn.argtypes = build.KERNELS["K11a_noise_blanker"][2]
            fn.restype = ctypes.c_int
            ms, same = run(fn, current_args(plan), "noise_blanker_kernel")
            extra = {}
            if name == "current, instrumented":
                read = lib.k11a_clocks
                read.argtypes = (ctypes.c_void_p,)
                read.restype = ctypes.c_int
                fn(*current_args(plan), torch.cuda.current_stream().cuda_stream)
                torch.cuda.synchronize()
                assert read(clocks.ctypes.data) == 0
                ctas = min(rows * plan.ctas, clocks.shape[0])
                cycles = np.median(np.diff(clocks[:ctas], axis=1), axis=0)
                extra = dict(median_cycles=dict(zip(PHASES, cycles.tolist())),
                             total_cycles=float(np.median(clocks[:ctas, 16] - clocks[:ctas, 0])))
            results.append(dict(variant=name, ms=ms, equal_plain=same, ptxas=ptxas, **extra))
        for ctas in (1, 2, 4, 8):
            p = forced_plan(noise, n, cplx, ctas)
            if (ctas - 1) * p.slice >= n:
                continue
            ms, same = run(current, current_args(p), "noise_blanker_kernel")
            results.append(dict(variant=f"current, {ctas} CTAs a row", ms=ms, equal_plain=same))
        ms = cs.device_ms(lambda: noise.noise_blanker(xd), "noise_blanker_kernel")
        results.append(dict(variant="current, ops/noise.py", plan=plan._asdict(), ms=ms,
                            equal_plain=bool(torch.equal(noise.noise_blanker(xd), ref))))
        for r in results:
            print(json.dumps(dict(case=f"{case} ({rows}, {n})", card=card, **r)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
