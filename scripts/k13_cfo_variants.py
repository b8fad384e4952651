#!/usr/bin/env python3
"""Where K13's CFO estimate spends its time: ``_estimate_cfo_residual`` of
the commit before its redesign (two torch products, ``torch.fft.fft`` with
``n=``, ``torch.abs`` and the one-CTA-a-row ``cfo_lines`` kernel, built
from a checkout of it) beside the current one (K13_cfo_power, cuFFT,
K13_cfo_lines over a cluster), device op by device op; K13_cfo_lines with
its cluster size varied, instrumented by stage, and with the trials
applied as changes to its source; and a probe of torch's complex product
and ``torch.abs`` on the card; all in one process.

Run from the repository root on a machine with one NVIDIA card, with the
commit before the redesign unpacked into a directory
(``git archive 6b517c1 | tar -x -C checkout_proof/parent``)::

    python3 scripts/k13_cfo_variants.py --parent checkout_proof/parent [--out FILE]

* "probe": the nine orders of ``(a + bi)(c + di)`` with or without a fused
  product in each part, on random operands, against torch's ``x * y`` and
  ``x * x`` on the card (the count of values whose bits differ), and
  ``hypotf`` against ``torch.abs``.
* At ``chip_smoke.CFO_PATH_SHAPES`` (program B's bank, C's control channel
  and Phase 2 bank): "before" is the parent's stage, its search launched
  through ctypes from the parent's ``cfo_lines.cu``; "current" the port's
  ``_estimate_cfo_residual``.  For each, every device op as CUPTI traced
  it (``chip_smoke.device_ops``: launches and ms a call), the stage's ms
  (``chip_smoke.device_ms``) and its residuals' bits, which must be equal;
  K13_cfo_power and cuFFT alone.
* K13_cfo_lines at clusters of 8, 4, 2 and 1 CTAs a row; "instrumented"
  (``STAMPS``: clock64 by thread 0 of each CTA, the global timer at a
  CTA's start and end; the median cycles of each span over rank 0's CTAs
  and over the others) and each of ``TRIALS`` at clusters of 8 and 4.
  Each is held against the plain version (``j`` and the residual equal;
  the timing-only trials are reported, not held) and timed as device time
  from CUPTI.  One JSON line a case, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

PROBE_SRC = r"""
#include <cuda_runtime.h>
// the nine orders of (a + bi)(c + di): re = a c - b d by fma(a, c, -bd),
// fma(-b, d, ac) or no fused product; im = a d + b c by fma(a, d, bc),
// fma(b, c, ad) or none; variant 3 re + im
__global__ void probe_kernel(const float2* x, const float2* y, float2* out, float* hyp, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float a = x[i].x, b = x[i].y, c = y[i].x, d = y[i].y;
    const float re[3] = {__fmaf_rn(a, c, -__fmul_rn(b, d)), __fmaf_rn(-b, d, __fmul_rn(a, c)),
                         __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, d))};
    const float im[3] = {__fmaf_rn(a, d, __fmul_rn(b, c)), __fmaf_rn(b, c, __fmul_rn(a, d)),
                         __fadd_rn(__fmul_rn(a, d), __fmul_rn(b, c))};
    for (int v = 0; v < 9; ++v) out[static_cast<long long>(v) * n + i] = make_float2(re[v / 3], im[v % 3]);
    hyp[i] = hypotf(a, b);
}
extern "C" int run_probe(const void* x, const void* y, void* out, void* hyp, int n, void* stream) {
    probe_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float2*>(x), static_cast<const float2*>(y), static_cast<float2*>(out),
        static_cast<float*>(hyp), n);
    return static_cast<int>(cudaGetLastError());
}
"""
STAMP_MACROS = r"""
__device__ long long g_k13_clocks[4096][8];
__device__ __forceinline__ long long k13_gt() {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define STAMP(k)                                                                \
    do {                                                                        \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_k13_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
#define GSTAMP(k)                                                               \
    do {                                                                        \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_k13_clocks[blockIdx.x][k] = k13_gt(); \
    } while (0)
"""
STAMP_READER = r"""
WAVECAP_EXPORT int k13_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_k13_clocks, sizeof(g_k13_clocks)));
}
"""
ARRIVE = "        cluster_arrive_relaxed();\n    }\n"
SEND = "        cluster_wait();  // every CTA of the cluster has started: rank 0's mbarrier is there\n"
MEAN = "                s = __fadd_rn(s, __fadd_rn(hypotf(v[u].x, v[u].y), hypotf(v[u].z, v[u].w)));\n"
# stamps of K13_cfo_lines by thread 0 (SM cycles; [6], [7] the global timer
# in ns): [0] started, [1] the mean's slice summed, [2] the candidates
# searched, [3] the CTA merged, [4] the cluster's CTAs all started (rank 0:
# every part received), [5] sent and leaving (rank 0: the row written)
STAMPS = [
    (ARRIVE, ARRIVE + "    STAMP(0);\n    GSTAMP(6);\n"),
    ("    // the candidates, each thread's", "    STAMP(1);\n    // the candidates, each thread's"),
    ("    warp_merge<32>(s, best, bi);\n", "    STAMP(2);\n    warp_merge<32>(s, best, bi);\n"),
    ("    warp_merge<kWarps>(s, best, bi);\n", "    warp_merge<kWarps>(s, best, bi);\n    STAMP(3);\n"),
    (SEND, SEND + "        STAMP(4);\n"),
    ("        return;\n    }\n    if (lane == 0) {", "        STAMP(5);\n        GSTAMP(7);\n        return;\n    }\n    if (lane == 0) {"),
    ("        uint4 pc[kMaxCluster];", "        STAMP(4);\n        uint4 pc[kMaxCluster];"),
    ("        jout[r] = i;\n    }\n", "        jout[r] = i;\n    }\n    STAMP(5);\n    GSTAMP(7);\n"),
]
SPANS = {"sum the slice": (0, 1), "candidates": (1, 2), "merge the CTA": (2, 3),
         "wait for the cluster (rank 0: for the parts)": (3, 4), "send (rank 0: merge and write)": (4, 5),
         "cta": (0, 5)}
# the trials, as changes to cfo_lines.cu: name -> (changes, timing only: the results change)
TRIALS = {
    "512 threads a CTA": ([("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")], False),
    "128 threads a CTA": ([("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")], False),
    "the mean over sqrt(x^2 + y^2) (the mean's bits change)": ([(MEAN, (
        "                s = __fadd_rn(s, __fadd_rn(__fsqrt_rn(__fmaf_rn(v[u].x, v[u].x, __fmul_rn(v[u].y, v[u].y))),\n"
        "                                           __fsqrt_rn(__fmaf_rn(v[u].z, v[u].z, __fmul_rn(v[u].w, v[u].w)))));\n"))],
        True),
    "|x| + |y| for hypotf (timing only)": ([('#include "common.cuh"\n',
                                             '#include "common.cuh"\n#define hypotf(a, b) (fabsf(a) + fabsf(b))\n')], True),
    "no cluster exchange (timing only)": ([("    if (nct > 1 && rank != 0) {\n        cluster_wait();",
                                            "    if (false) {\n        cluster_wait();"),
                                           ("        if (nct > 1) {\n            unsigned done = 0;",
                                            "        if (false) {\n            unsigned done = 0;")], True),
    "return once started (timing only)": ([(ARRIVE, ARRIVE + "    if (size > 0) return;\n")], True),
}
ORDERS = [f"re {r}, im {i}" for r in ("fma(a,c,-bd)", "fma(-b,d,ac)", "ac-bd")
          for i in ("fma(a,d,bc)", "fma(b,c,ad)", "ad+bc")]


def build(vdir: Path, build_mod, parent: Path) -> dict:
    """The probe, the parent's ``cfo_lines.cu``, the current one with the
    stamps and each trial, compiled in parallel: name -> CDLL."""
    vdir.mkdir(parents=True, exist_ok=True)
    current = (build_mod.CSRC / "cfo_lines.cu").read_text()
    sources = {"probe": PROBE_SRC, "instrumented": patch(current, [
        ('#include "common.cuh"\n', '#include "common.cuh"\n' + STAMP_MACROS)] + STAMPS) + STAMP_READER}
    sources.update({name: patch(current, changes) for name, (changes, _) in TRIALS.items()})
    jobs = {"before": parent / "wavecap_tpu_torch" / "kernels" / "csrc" / "cfo_lines.cu"}
    for i, (name, text) in enumerate(sources.items()):
        jobs[name] = vdir / f"variant{i}.cu"
        jobs[name].write_text(text)
    procs = {}
    for i, (name, src) in enumerate(jobs.items()):
        lib = vdir / f"libvariant{i}.so"
        cmd = build_mod.nvcc_command(src, lib, build_mod._find_nvcc())
        cmd[1:1] = [f"-I{build_mod.CSRC}"]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build\n{text}")
        libs[name] = ctypes.CDLL(str(lib))
        if name not in ("probe", "before"):
            fn = libs[name].k13_cfo_lines
            fn.argtypes = build_mod.KERNELS["K13_cfo_lines"][2]
            fn.restype = ctypes.c_int
    return libs


def patch(text: str, changes: list) -> str:
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"{old.strip()[:60]!r} does not occur once in cfo_lines.cu")
        text = text.replace(old, new)
    return text


def stamps(lib, run, cluster: int, ctas: int) -> dict:
    """One call of the stamped kernel: the median cycles of each span over
    rank 0's CTAs and over the others, and the global timer's spread of the
    CTAs' starts and ends (ns)."""
    import torch

    lib.k13_clocks.argtypes = (ctypes.c_void_p,)
    st = np.zeros((4096, 8), np.int64)
    torch.cuda.synchronize()
    run()
    torch.cuda.synchronize()
    assert lib.k13_clocks(st.ctypes.data) == 0
    st = st[:ctas]
    rank0 = np.arange(ctas) % cluster == 0
    out = {}
    for who, sel in (("rank 0", rank0), ("other ranks", ~rank0)):
        if sel.any():
            out[who] = {k: float(np.median(st[sel, b] - st[sel, a])) for k, (a, b) in SPANS.items()}
    out["global ns: starts spread, ends spread, first start to last end"] = [
        float(st[:, 6].max() - st[:, 6].min()), float(st[:, 7].max() - st[:, 7].min()),
        float(st[:, 7].max() - st[:, 6].min())]
    return out


def probe(lib, dev) -> dict:
    import torch

    import chip_smoke as cs

    rng = np.random.default_rng(cs.SEED + 16)
    n = 1 << 20
    mag = 10.0 ** rng.uniform(-3, 3, (2, n))
    z = (mag * np.exp(1j * rng.uniform(-np.pi, np.pi, (2, n)))).astype(np.complex64)
    x, y = (torch.from_numpy(v).to(dev) for v in z)
    out = torch.empty((9, n), dtype=torch.complex64, device=dev)
    hyp = torch.empty(n, dtype=torch.float32, device=dev)
    res = {}
    for what, other, ref in (("x * y", y, x * y), ("x * x", x, x * x)):
        status = lib.run_probe(x.data_ptr(), other.data_ptr(), out.data_ptr(), hyp.data_ptr(), n,
                               torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
        torch.cuda.synchronize()
        ref_bits = torch.view_as_real(ref).view(torch.int32)
        res[what] = {ORDERS[v]: int((torch.view_as_real(out[v]).view(torch.int32) != ref_bits).any(-1).sum())
                     for v in range(9)}
    res["hypotf vs torch.abs"] = int((hyp.view(torch.int32) != torch.abs(x).view(torch.int32)).sum())
    return res


def parent_stage(lib, filt, cfg):
    """The parent's ``_estimate_cfo_residual``: torch's x^4 and padded FFT,
    ``torch.abs``, its ``k13_cfo_lines`` through ctypes: ``(resid, j)``."""
    import torch

    from wavecap_tpu_torch.models.p25 import cqpsk

    size, k4, off, step = cqpsk._cfo_search(cfg, filt.shape[-1])
    p4 = filt * filt
    p4 = p4 * p4
    spec = torch.abs(torch.fft.fft(p4, n=size, dim=-1))
    return parent_search(lib, spec, k4, off, step)


def parent_search(lib, spec, k4, off, step):
    import torch

    rows, size = spec.shape
    resid = torch.empty(rows, dtype=torch.float32, device=spec.device)
    j = torch.empty(rows, dtype=torch.int32, device=spec.device)
    status = lib.k13_cfo_lines(spec.data_ptr(), rows, size, k4, off, ctypes.c_float(step), resid.data_ptr(),
                               j.data_ptr(), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if status != 0:
        raise RuntimeError(f"the parent's cfo_lines failed to launch: {status}")
    return resid, j


def main() -> int:
    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build as build_mod
    from wavecap_tpu_torch.kernels import launch
    from wavecap_tpu_torch.models.p25 import cqpsk

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit before the redesign (its cfo_lines.cu is built)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k13_cfo_variants: no CUDA device", file=sys.stderr)
        return 2
    reports = build_mod.build_all()
    vdir = build_mod.BUILD_DIR / "k13_cfo_variants"
    libs = build(vdir, build_mod, args.parent.resolve())
    probe_lib, parent_lib = libs.pop("probe"), libs.pop("before")
    probe_lib.run_probe.argtypes = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_void_p)
    parent_lib.k13_cfo_lines.argtypes = (ctypes.c_void_p,) + (ctypes.c_int,) * 4 + (
        ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p)
    card = cs.card_line()
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        line = json.dumps(dict(card=card, **obj), default=float)
        print(line, flush=True)
        lines.append(line)

    emit(dict(phase="ptxas", cfo_lines=[ln.strip() for ln in reports.get("cfo_lines", "").splitlines()
                                        if "registers" in ln or "spill" in ln]))
    emit(dict(phase="probe: bits differing from torch on the card (of 1,048,576)", **probe(probe_lib, dev)))
    for what, prog, bank in cs.CFO_PATH_SHAPES:
        cfg, filt, cfo = cs.cfo_path_case(dev, prog, bank)
        rows, n = filt.shape
        size, k4, off, step = cqpsk._cfo_search(cfg, n)
        case = f"{what}: ({rows}, {n}), size {size}, {2 * k4 + 1} candidates"
        r_old, j_old = (cs.host(v) for v in parent_stage(parent_lib, filt, cfg))
        r_new = cs.host(cqpsk._estimate_cfo_residual(filt, cfg))
        buf_k, buf_p = cqpsk.cfo_power(filt, size), cqpsk.cfo_power_plain(filt, size)
        x = torch.fft.fft(buf_p, dim=-1)
        emit(dict(case=case, resid_equal=bool(np.array_equal(r_old, r_new)),
                  power_bits_equal=cs.same_bits(buf_k, buf_p),
                  power_max_ulp=float(np.max(cs.ulps(cs.host(torch.view_as_real(buf_p)).astype(np.float64),
                                                     cs.host(torch.view_as_real(buf_k))))),
                  resid_before=[float(v) for v in r_old], resid=[float(v) for v in r_new],
                  cfo=[float(v) for v in cfo]))
        emit(dict(case=case, variant="before", stage=cs.device_ops(lambda: parent_stage(parent_lib, filt, cfg)),
                  stage_ms=cs.device_ms(lambda: parent_stage(parent_lib, filt, cfg)),
                  lines_ms=cs.device_ms(lambda: parent_search(parent_lib, torch.abs(x), k4, off, step),
                                        ("cfo_lines_kernel",))))
        emit(dict(case=case, variant="current", stage=cs.device_ops(lambda: cqpsk._estimate_cfo_residual(filt, cfg)),
                  stage_ms=cs.device_ms(lambda: cqpsk._estimate_cfo_residual(filt, cfg)),
                  power_ms=cs.device_ms(lambda: cqpsk.cfo_power(filt, size), ("cfo_power_kernel",)),
                  cufft_ms=cs.device_ms(lambda: torch.fft.fft(buf_p, dim=-1))))
        r_p, j_p = (cs.host(v) for v in cqpsk.cfo_lines_plain(x, k4, off, step))
        resid = torch.empty(rows, dtype=torch.float32, device=dev)
        j = torch.empty(rows, dtype=torch.int32, device=dev)
        runs = [(f"clusters of {c}", None, c) for c in (8, 4, 2, 1)]
        runs += [(name, lib, c) for name, lib in libs.items() for c in (8, 4)]
        for name, lib, cluster in runs:
            plan = cqpsk.cfo_lines_plan(rows, size, k4, off, cluster)
            args_ = (x, rows, size, k4, plan.cluster, plan.per, *plan.split, *plan.centre, float(step), resid, j)
            if lib is None:
                def search(args_=args_):
                    launch("K13_cfo_lines", dev, *args_)
            else:
                def search(lib=lib, args_=args_):
                    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args_]
                    status = lib.k13_cfo_lines(*c_args, torch.cuda.current_stream().cuda_stream)
                    if status != 0:
                        raise RuntimeError(f"{name} failed to launch: {status}")
            search()
            same = bool(np.array_equal(cs.host(resid), r_p) and np.array_equal(cs.host(j), j_p))
            rec = dict(case=case, variant=f"K13_cfo_lines, {name}", cluster=plan.cluster, ctas=plan.ctas, per=plan.per,
                       equal_to_plain=same, ms=cs.device_ms(search, ("cfo_lines_kernel",)))
            if name == "instrumented":
                rec.update(stamps(lib, search, plan.cluster, plan.ctas))
            elif lib is not None and not TRIALS[name][1] and not same:
                raise RuntimeError(f"{name} differs from the plain version at {case}")
            emit(rec)
        del filt, buf_k, buf_p, x
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
