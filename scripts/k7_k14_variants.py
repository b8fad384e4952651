#!/usr/bin/env python3
"""Where K14's and K7's time goes: the port's first designs of the echo
fit (``kernels/csrc/echo_fit.cu``) and the strided FIR
(``kernels/csrc/strided_fir.cu``) beside the current ones, with the
current ones' plans forced, and every design instrumented by stage, all
timed in one process on the card.

Run from the repository root on a machine with one NVIDIA card, with the
commit before the redesign unpacked into a directory
(``git archive 1e99d42 | tar -x -C checkout_proof/k7_k14_parent``)::

    python3 scripts/k7_k14_variants.py --parent checkout_proof/k7_k14_parent [--out FILE]

* the first designs, that checkout's ``echo_fit.cu`` and
  ``strided_fir.cu``, as they were before their redesign: K14's acf one CTA a row (the row staged in shared
  memory, 29 lags one after another, two block sums each), its residuals
  one thread a candidate walking every row, its taps one thread a tap
  summing 512 double terms with a ``sincospi`` each; K7 one thread an
  output walking every tap, 128-output tiles.  Built as they are and,
  with ``OLD_STAMPS`` applied to a copy, with ``OLD_CLOCKS=1`` (clock64 at
  each stage's end in thread 0 of each CTA).
* the current kernels through their wrappers; built with ``K14_CLOCKS=1``
  / ``K7_CLOCKS=1`` (the same stamps); and the trials that did not win,
  each the current source with one change (``PATCHES``, applied to a copy
  in the build directory): K14 with its residual grid aimed at 132 and
  528 CTAs (against 264) and its candidates pruned exactly after 4, 8 and
  12 lags (against none); K7 with 4 and 16 outputs a thread (against 8)
  and a CTA an item (against persistent CTAs); and K7 with its plan's
  groups, phase sets and splits, or its direct variant, forced (the
  wrapper's ``k7_plan`` replaced for the call).

Every variant runs behind the port's wrappers (the launcher's function is
swapped), is held against the plain version at the thresholds of
``chip_smoke.py`` (K14: the candidate and the gate equal, taps rel L2 <=
1e-5, acf <= 1e-6, alias scores <= 1e-5; K7: rel L2 <= 1e-5, phases
bit-exact) and timed as device time from CUPTI (``chip_smoke.device_ms``)
at the paths' shapes: K14's fit at program B's (21, 7,500) and on one
60,000-sample row, its alias scores at (63, 7,500); K7's wide slots (2 x
48,000 outputs, 1,031 taps, stride 41, the NCO) whole and at a mesh
shard's 6,000 outputs, those of a 20 Msps capture (2 x 48,193 outputs,
2,085 taps, stride 83), the equaliser (21 rows, 41 complex taps), program
A's and program F's per-shard P25 filters (50 rows: the 63-tap low-pass
on complex rows, the 83-tap RRC on real rows) and the up == 1 resampler
(101 taps, stride 5).  A stage's time is the median over the CTAs of SM
cycles between its stamps.  One JSON line a case and variant, with the
card's name and power limit.
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


def after(anchor: str, text: str) -> tuple:
    return anchor, anchor + text


# the designs before their redesign are the parent checkout's sources
# (commit 1e99d42); ``OLD_STAMPS`` adds the stamps the docstring
# lists to a copy (built with OLD_CLOCKS=1)
OLD_STAMPS = {
    "echo_fit.cu": [
        after('namespace {\n',
              '#ifndef OLD_CLOCKS\n#define OLD_CLOCKS 0\n#endif\n#if OLD_CLOCKS\n__device__ long long g_old_clocks[3][1024][4];  // K14: acf / residual / epilogue; K7: [0]\n#define STAMP(which, k) do { if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < 1024) \\\n    g_old_clocks[which][blockIdx.y * gridDim.x + blockIdx.x][k] = clock64(); } while (0)\n#else\n#define STAMP(which, k) do {} while (0)\n#endif\n'),
        after('    const float2* row = x + static_cast<long long>(r) * n;\n',
              '    STAMP(0, 0);\n'),
        after('    for (int i = threadIdx.x; i < n; i += blockDim.x) xs[i] = row[i];\n    __syncthreads();\n',
              '    STAMP(0, 1);\n'),
        after('        }\n    }\n',
              '    STAMP(0, 2);\n'),
        after('    best[r] = ~0ull;\n',
              '    STAMP(0, 3);\n'),
        after('    extern __shared__ float2 as[];\n',
              '    STAMP(1, 0);\n'),
        after('        p[t] = (valid && t < lags) ? preds[static_cast<long long>(c) * lags + t] : make_float2(0.f, 0.f);\n    }\n',
              '    STAMP(1, 1);\n'),
        after('        if ((threadIdx.x & 31) == 0 && key != ~0ull) atomicMin(best + r, key);\n    }\n',
              '    STAMP(1, 2);\n'),
        after('    __shared__ float echo[3];  // a, theta, d\n    const int r = blockIdx.x;\n',
              '    STAMP(2, 0);\n'),
        after('        j_out[r] = j;\n    }\n    __syncthreads();\n',
              '    STAMP(2, 1);\n'),
        after('        w[k] = make_float2(__fdiv_rn(hr, den), -__fdiv_rn(hi, den));\n    }\n    __syncthreads();\n',
              '    STAMP(2, 2);\n'),
        after('    taps[static_cast<long long>(r) * n_taps + t] = v;\n',
              '    STAMP(2, 3);\n'),
        after('}  // namespace\n',
              '\n#if OLD_CLOCKS\nWAVECAP_EXPORT int old_clocks(void* host) {\n    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));\n}\n#endif\n'),
    ],
    "strided_fir.cu": [
        after('namespace {\n',
              '#ifndef OLD_CLOCKS\n#define OLD_CLOCKS 0\n#endif\n#if OLD_CLOCKS\n__device__ long long g_old_clocks[3][1024][4];  // K14: acf / residual / epilogue; K7: [0]\n#define STAMP(which, k) do { if (threadIdx.x == 0 && blockIdx.y * gridDim.x + blockIdx.x < 1024) \\\n    g_old_clocks[which][blockIdx.y * gridDim.x + blockIdx.x][k] = clock64(); } while (0)\n#else\n#define STAMP(which, k) do {} while (0)\n#endif\n'),
        after('    }\n\n',
              '    STAMP(0, 0);\n'),
        after('    __syncthreads();\n',
              '    STAMP(0, 1);\n'),
        after('    y[static_cast<long long>(row) * n_out + m0 + threadIdx.x] = acc.value();\n',
              '    STAMP(0, 2);\n'),
        after('}  // namespace\n\n',
              '#if OLD_CLOCKS\nWAVECAP_EXPORT int old_clocks(void* host) {\n    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));\n}\n#endif\n\n'),
    ],
}


# K14's exact pruning: a candidate whose first HEAD lags already exceed the
# whole residual of the tile's least such partial cannot be the least
# (the terms are >= 0 and summed in lag order; NaN never prunes).  Measured
# slower at 4, 8 and 12 lags: the barriers a row and the divergent warps
# cost more than the terms saved.
K14_PRUNED_PART = r"""
// lags [T0, T1) of a candidate's residual against an acf row a, added to s
template <int L, int T0, int T1>
__device__ __forceinline__ float residual_part(const float2 (&p)[L], const float2* a, float s) {
#pragma unroll
    for (int t = T0; t < T1; ++t) {
        s = __fadd_rn(s, sq_abs(make_float2(__fsub_rn(p[t].x, a[t].x), __fsub_rn(p[t].y, a[t].y))));
    }
    return s;
}

// a residual and its candidate as one key"""

K14_PRUNED_LOOP = r"""
    __shared__ unsigned long long lead[kResThreads / 32 + 1];  // the warps' least partials, the tile's
    __shared__ float bound;  // the whole residual of the tile's least partial
    constexpr int kHead = HEAD < L ? HEAD : L;
    for (int r = 0; r < nr; ++r) {
        const float2* a = as + r * L;
        unsigned long long key = ~0ull;
        const float s = residual_part<L, 0, kHead>(p, a, 0.f);
        unsigned long long k = warp_min(valid ? pack(s, tid) : ~0ull);
        if ((tid & 31) == 0) lead[tid >> 5] = k;
        __syncthreads();
        if (tid < 32) {
            k = warp_min(tid < kResThreads / 32 ? lead[tid] : ~0ull);
            if (tid == 0) lead[kResThreads / 32] = k;
        }
        __syncthreads();
        const unsigned long long lk = lead[kResThreads / 32];
        if (lk != ~0ull && tid == static_cast<int>(lk & 0xffffffffull)) {
            bound = residual_part<L, kHead, L>(p, a, s);
        }
        __syncthreads();
        if (valid && (lk == ~0ull || !(s > bound))) key = pack(residual_part<L, kHead, L>(p, a, s), c);
        key = warp_min(key);
        if ((tid & 31) == 0 && key != ~0ull) atomicMin(mins + r, key);
        __syncthreads();  // lead and bound are free for the next row
    }"""

K14_LOOP = """
    for (int r = 0; r < nr; ++r) {
        const unsigned long long key = warp_min(valid ? pack(residual<L>(p, as + r * L), c) : ~0ull);
        if ((tid & 31) == 0 && key != ~0ull) atomicMin(mins + r, key);
    }"""


def pruned(head: int) -> list:
    return [("\n// a residual and its candidate as one key", K14_PRUNED_PART),
            (K14_LOOP, K14_PRUNED_LOOP.replace("HEAD", str(head)))]


# the trials that lost: variant -> (source, [(text, its replacement)]); each
# text must occur once in the current source
PATCHES = {
    "K14 current, residuals aimed at 132 CTAs": (
        "echo_fit.cu", [("constexpr int kResTarget = 2 * 132;", "constexpr int kResTarget = 132;")]),
    "K14 current, residuals aimed at 528 CTAs": (
        "echo_fit.cu", [("constexpr int kResTarget = 2 * 132;", "constexpr int kResTarget = 528;")]),
    "K14 current, pruning after 4 lags": ("echo_fit.cu", pruned(4)),
    "K14 current, pruning after 8 lags": ("echo_fit.cu", pruned(8)),
    "K14 current, pruning after 12 lags": ("echo_fit.cu", pruned(12)),
    "K7 current, R = 4": ("strided_fir.cu", [("constexpr int kR = 8;", "constexpr int kR = 4;")]),
    "K7 current, R = 16": ("strided_fir.cu", [("constexpr int kR = 8;", "constexpr int kR = 16;")]),
    "K7 current, a CTA an item": (
        "strided_fir.cu", [("const long resident = static_cast<long>(per_sm > 1 ? per_sm : 1) * sms;",
                            "const long resident = all_items;")]),
}


def patched(csrc: Path, vdir: Path, name: str) -> Path:
    """The current source with one variant's changes, written beside the builds."""
    stem, changes = PATCHES[name]
    text = (csrc / stem).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old.strip()[:60]!r} does not occur once in {stem}")
        text = text.replace(old, new)
    out = vdir / f"{name.replace(' ', '_').replace(',', '').replace('=', '')}.cu"
    out.write_text(text)
    return out


K14_FUNCTIONS = ("acf_kernel", "residual_kernel", "epilogue_kernel")
K7_FUNCTIONS = ("strided_fir_kernel",)


def median_cycles(stamps: np.ndarray, spans: dict) -> dict:
    """Median SM cycles over the CTAs of each named span ``(start, end)``
    column pair; a span given as one column is a duration the kernel
    summed itself."""
    out = {}
    for name, cols in spans.items():
        v = stamps[:, cols] if isinstance(cols, int) else stamps[:, cols[1]] - stamps[:, cols[0]]
        out[name] = float(np.median(v)) if len(v) else None
    return out


def changed(before: np.ndarray, after: np.ndarray) -> np.ndarray:
    """The rows (CTAs) whose first stamp this run wrote anew."""
    return after[(after[:, 0] != before[:, 0]) & (after[:, 0] != 0)]



def stamped_source(old: Path, vdir: Path, stem: str) -> Path:
    """The parent checkout's ``stem`` with ``OLD_STAMPS`` applied, written
    beside the builds."""
    text = (old / stem).read_text()
    for anchor, new in OLD_STAMPS[stem]:
        if text.count(anchor) != 1:
            raise RuntimeError(f"{stem}: {anchor.strip()[:60]!r} does not occur once in {old / stem}")
        text = text.replace(anchor, new)
    out = vdir / f"stamped_{stem}"
    out.write_text(text)
    return out


def build(vdir: Path, build_mod, parent: Path) -> dict:
    """Every variant's library, compiled in parallel: name -> (CDLL, ptxas lines)."""
    vdir.mkdir(parents=True, exist_ok=True)
    csrc = build_mod.CSRC
    old = parent / "wavecap_tpu_torch" / "kernels" / "csrc"
    jobs = {
        "K14 first design": (old / "echo_fit.cu", {}),
        "K14 first design, instrumented": (stamped_source(old, vdir, "echo_fit.cu"), {"OLD_CLOCKS": 1}),
        "K14 current, instrumented": (csrc / "echo_fit.cu", {"K14_CLOCKS": 1}),
        "K7 first design": (old / "strided_fir.cu", {}),
        "K7 first design, instrumented": (stamped_source(old, vdir, "strided_fir.cu"), {"OLD_CLOCKS": 1}),
        "K7 current, instrumented": (csrc / "strided_fir.cu", {"K7_CLOCKS": 1}),
    }
    jobs.update({name: (patched(csrc, vdir, name), {}) for name in PATCHES})
    nvcc = build_mod._find_nvcc()
    procs = {}
    for i, (name, (src, macros)) in enumerate(jobs.items()):
        lib = vdir / f"libvariant{i}.so"
        cmd = build_mod.nvcc_command(src, lib, nvcc)
        include = old if "first design" in name else csrc
        cmd[1:1] = [f"-I{include}"] + [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build\n{text}")
        libs[name] = (ctypes.CDLL(str(lib)), [ln.strip() for ln in text.splitlines() if "registers" in ln])
    return libs


def swap(build_mod, kernel: str, lib, symbol: str, drop: int = 0):
    """Point the launcher's ``kernel`` at ``symbol`` of ``lib``; ``drop``:
    the wrapper's last int arguments before the stream that the symbol
    does not take (the first K7's entry takes no plan)."""
    fn = getattr(lib, symbol)
    types = build_mod.KERNELS[kernel][2]
    fn.argtypes = tuple(types[:len(types) - 1 - drop]) + (types[-1],)
    fn.restype = ctypes.c_int
    lib.wavecap_error_string.argtypes = (ctypes.c_int,)
    lib.wavecap_error_string.restype = ctypes.c_char_p
    call = fn if not drop else (lambda *a: fn(*a[:-1 - drop], a[-1]))
    build_mod._FUNCTIONS[kernel] = (call, lib)


def k14_cases(cs, dev):
    import torch

    from wavecap_tpu_torch.capture.pipeline import p25_cfg_for
    from wavecap_tpu_torch.models.p25 import cqpsk

    cfgs = cs.p25_configs()
    cfg_b = p25_cfg_for(cfgs["B"])
    grid = cqpsk._cfg_grid(cfg_b, dev)
    rng = np.random.default_rng(cs.SEED + 7)
    rows, n_b = cfgs["B"].p25_capacity, 2 * cfgs["B"].block_size // cfgs["B"].channelizer().channel_count
    x = cs.cqpsk_rows(rng, rows, n_b, cfg_b.sample_rate, 4800.0, 0.2, cfo=np.zeros(rows))
    x[::2] += (0.8 * np.exp(2.98j)) * np.roll(x[::2], 4, axis=-1)
    xl = cs.cqpsk_rows(rng, 1, 60_000, cfg_b.sample_rate, 4800.0, 0.2, cfo=np.zeros(1))
    xl = xl + (0.8 * np.exp(2.98j)) * np.roll(xl, 4, axis=-1)
    x, xl = (torch.from_numpy(v.astype(np.complex64)).to(dev) for v in (x, xl))
    lags = grid.n_tau + 1
    acc = torch.zeros((rows, lags), dtype=torch.complex64, device=dev)
    acc[1::2] = 0.5
    enable = torch.from_numpy(np.arange(rows) != 5).to(dev)
    rot = torch.from_numpy(np.exp(2j * np.pi * 1200.0 * np.arange(n_b) / cfg_b.sample_rate)
                           .astype(np.complex64)).to(dev)
    x3 = torch.cat([x, x * rot, torch.flip(x, [0])])
    return [
        ("fit (21, 7500)", "fit", (x, acc, enable, grid)),
        ("alias scores (63, 7500)", "score", (x3, grid)),
        ("fit, one 60,000-sample row", "fit", (xl, torch.zeros((1, lags), dtype=torch.complex64, device=dev),
                                               torch.ones(1, dtype=torch.bool, device=dev), grid)),
    ]


def k14_run(cs, eqz, mode, args):
    if mode == "fit":
        x, acc, enable, grid = args
        return lambda: eqz.echo_fit(x, acc, enable, grid, 41, 0.01, 0.35, 0.6, 0.5), \
            lambda: eqz.echo_fit_plain(x, acc, enable, grid, 41, 0.01, 0.35, 0.6, 0.5)
    x, grid = args
    return lambda: eqz.echo_score(x, grid), lambda: eqz.echo_score_plain(x, grid)


def k14_agree(cs, mode, got, ref, enable=None) -> dict:
    if mode == "score":
        err = cs.rel_l2(cs.host(ref), cs.host(got))
        return dict(score_rel_l2=err, ok=err <= 1e-5)
    t_k, a_k, s_k, j_k = (cs.host(v) for v in got)
    t_p, a_p, s_p, j_p = (cs.host(v) for v in ref)
    on = cs.host(enable)
    res = dict(j_equal=bool(np.array_equal(j_k[on], j_p[on])), sig_equal=bool(np.array_equal(s_k, s_p)),
               taps_rel_l2=cs.rel_l2(t_p, t_k), acf_rel_l2=cs.rel_l2(a_p, a_k))
    res["ok"] = res["j_equal"] and res["sig_equal"] and res["taps_rel_l2"] <= 1e-5 and res["acf_rel_l2"] <= 1e-6
    return res


def k7_cases(cs, dev):
    import torch

    from wavecap_tpu_torch.models.p25 import c4fm
    from wavecap_tpu_torch.ops import fir
    from wavecap_tpu_torch.ops.nco import tuning_word

    rng = np.random.default_rng(cs.SEED + 8)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def cnoise(*shape):
        return (0.1 * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(np.complex64)

    wide = fir.design_decimation_fir(41, 10_000_000.0)
    tw = t(wide)
    tw20 = t(fir.design_decimation_fir(83, 20_000_000.0))
    dphi20 = tuning_word(-t(np.array([700_000.0, -1_200_000.0], np.float32)), 20_000_000.0)
    dphi = tuning_word(-t(np.array([700_000.0, -1_200_000.0], np.float32)), 10_000_000.0)
    p0 = t(np.array([0xFFFF0000, 12345], np.uint32))
    lpf, rrc = (t(v) for v in (c4fm.design_baseband_lpf(50_000.0), c4fm.design_rrc(50_000.0)))
    r5 = t(fir.design_resample_poly_filter(1, 5))
    eq_taps = t((rng.standard_normal((21, 41)) + 1j * rng.standard_normal((21, 41))).astype(np.complex64) * 0.2)
    return [
        ("wide slots (2 x 1,968,000 + head -> 48,000)", (t(cnoise(1_968_000)), tw, 41, t(cnoise(2, 1030)), (dphi, p0))),
        ("a mesh shard's wide slots (2 x 247,030 -> 6,000)", (t(cnoise(247_030)), tw, 41, None, (dphi, p0))),
        ("wide slots at 20 Msps (2 x 4,000,000 + head -> 48,193)",
         (t(cnoise(4_000_000)), tw20, 83, t(cnoise(2, 2084)), (dphi20, p0))),
        ("equaliser (21, 7,540) c64, 41 complex taps a row", (t(cnoise(21, 7_540)), eq_taps, 1, None, None)),
        ("program A's low-pass (50, 12,562) c64, 63 taps", (t(cnoise(50, 12_562)), lpf, 1, None, None)),
        ("program F's per-shard low-pass (50, 1,562) c64, 63 taps", (t(cnoise(50, 1_562)), lpf, 1, None, None)),
        ("program F's per-shard RRC (50, 1,582) f32, 83 taps",
         (t((0.3 * rng.standard_normal((50, 1_582))).astype(np.float32)), rrc, 1, None, None)),
        ("up == 1: 1/5 (2, 48,000) f32 + head, 101 taps",
         (t(rng.standard_normal((2, 48_000)).astype(np.float32)), r5, 5,
          t(rng.standard_normal((2, 100)).astype(np.float32)), None)),
    ]


def forced_plans(fir, args) -> tuple:
    """The kernel's own plan, and plans to try beside it: groups, phase
    sets (stride > 1) and splits over a small grid, inside a block's
    threads and shared memory."""
    x, taps, stride, head, nco = args
    rows = fir._k7_rows(x, head, nco)
    rows = int(np.prod(rows)) if rows else 1
    total = x.shape[-1] + (0 if head is None else head.shape[-1])
    n_out = (total - taps.shape[-1]) // stride + 1
    shape = (taps.shape[-1], stride, rows, n_out, x.is_complex(), taps.is_complex())
    own = fir.k7_plan(*shape)
    q = -(-taps.shape[-1] // stride)
    if stride == 1:
        grid = [(g, 1, s, 0) for g in (8, 16, 32, 64) for s in (1, 2, 4, 8)]
    else:
        grid = [(g, ps, s, 0) for g in (4, 8, 12, 16, 24, 32) for ps in sorted({stride, 16, 8, 4})
                if ps <= stride for s in (1, 2)]
    grid.append((0, 0, 0, 1))  # the direct variant
    out = []
    for g, ps, s, direct in grid:
        plan = fir.k7_plan(*shape, forced=(g, ps, s, direct))
        same = plan.direct == own.direct and (own.direct or (g, ps, s) == (own.groups, own.phase_sets, own.splits))
        if not same and 32 <= plan.threads <= 512 and (s <= 1 or plan.threads % 32 == 0) \
                and plan.smem <= fir._K7_SMEM_MAX and (s <= 1 or q >= 2 * s * plan.r):
            out.append((g, ps, s, direct))
    return own, out


def main() -> int:
    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build as build_mod
    from wavecap_tpu_torch.models.p25 import equalizer as eqz
    from wavecap_tpu_torch.ops import fir

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit before the redesign (its kernel sources are built)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_k14_variants: no CUDA device", file=sys.stderr)
        return 2
    build_mod.build_all()
    libs = build(build_mod.BUILD_DIR / "k7_k14_variants", build_mod, args.parent.resolve())
    card = cs.card_line()
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        line = json.dumps(dict(card=card, **obj), default=float)
        print(line, flush=True)
        lines.append(line)

    current14 = build_mod._function("K14_echo_fit")
    current7 = build_mod._function("K7_strided_fir")
    own_plan = fir.k7_plan
    acf_c = np.zeros((1024, 5), np.int64)
    res_c = np.zeros((1024, 4), np.int64)
    epi_c = np.zeros((256, 4), np.int64)
    old_c = np.zeros((3, 1024, 4), np.int64)  # the first K14's stamps
    old7_c = np.zeros((3, 1024, 4), np.int64)  # the first K7's

    # --- K14 ---
    for case, mode, cargs in k14_cases(cs, dev):
        kern, plain = k14_run(cs, eqz, mode, cargs)
        ref = plain()
        variants = [("K14 current", None)] + [(k, v) for k, v in libs.items() if k.startswith("K14")]
        for name, entry in variants:
            if entry is None:
                build_mod._FUNCTIONS["K14_echo_fit"] = current14
            else:
                swap(build_mod, "K14_echo_fit", entry[0], "k14_echo_fit")
            rec = dict(kernel="K14", case=case, variant=name, ptxas=entry[1] if entry else None)
            try:
                got = kern()
                torch.cuda.synchronize()
            except RuntimeError as e:  # the first design stages the row: refused past its shared memory
                emit(dict(rec, refused=str(e)))
                continue
            rec.update(k14_agree(cs, mode, got, ref, cargs[2] if mode == "fit" else None))
            rec["ms"] = cs.device_ms(kern, K14_FUNCTIONS)
            rec["ms_by_kernel"] = {k: cs.device_ms(kern, k) for k in K14_FUNCTIONS}
            if name.endswith("instrumented"):
                lib = entry[0]
                if "first" in name:
                    read = lib.old_clocks
                    read.argtypes = (ctypes.c_void_p,)
                    before = old_c.copy()
                    kern()
                    torch.cuda.synchronize()
                    assert read(old_c.ctypes.data) == 0
                    rec["median_cycles"] = dict(
                        acf=median_cycles(changed(before[0], old_c[0]), {"stage row": (0, 1), "29 lags": (1, 2),
                                                                          "finish": (2, 3)}),
                        residuals=median_cycles(changed(before[1], old_c[1]), {"stage": (0, 1), "rows": (1, 2)}))
                    if mode == "fit":  # score mode's epilogue only copies the minimum
                        rec["median_cycles"]["epilogue"] = median_cycles(
                            changed(before[2], old_c[2]), {"gate": (0, 1), "W": (1, 2), "taps": (2, 3)})
                else:
                    read = lib.k14_clocks
                    read.argtypes = (ctypes.c_void_p,) * 3
                    b_acf, b_res, b_epi = acf_c.copy(), res_c.copy(), epi_c.copy()
                    kern()
                    torch.cuda.synchronize()
                    assert read(acf_c.ctypes.data, res_c.ctypes.data, epi_c.ctypes.data) == 0
                    a = changed(b_acf, acf_c)
                    red = a[:, 3] - a[:, 0] - a[:, 1] - a[:, 2]
                    fin = a[:, 4] - a[:, 3]
                    rec["median_cycles"] = dict(
                        acf=dict(median_cycles(a, {"stage chunks": 1, "products": 2}),
                                 reduce_and_cluster=float(np.median(red)),
                                 finish_rank0=float(np.median(fin[fin > 0])) if (fin > 0).any() else None),
                        residuals=median_cycles(changed(b_res, res_c), {"stage": (0, 1), "rows": (1, 2),
                                                                        "atomics": (2, 3)}))
                    if mode == "fit":
                        rec["median_cycles"]["epilogue"] = median_cycles(
                            changed(b_epi, epi_c), {"gate and table": (0, 1), "W": (1, 2), "taps": (2, 3)})
            emit(rec)
        build_mod._FUNCTIONS["K14_echo_fit"] = current14

    # --- K7 ---
    k7_c = np.zeros((1024, 6), np.int64)
    for case, cargs in k7_cases(cs, dev):
        def kern(a=cargs):
            return fir.strided_fir(*a)

        ref = fir.strided_fir_plain(*cargs)
        own, forced = forced_plans(fir, cargs)
        variants = [("K7 current", None, None)] + [(k, v, None) for k, v in libs.items() if k.startswith("K7")]
        variants += [("K7 current, forced direct variant" if dv else
                      f"K7 current, forced groups {g}, phase sets {ps}, splits {sp}", None, (g, ps, sp, dv))
                     for g, ps, sp, dv in forced]
        for name, entry, plan in variants:
            build_mod._FUNCTIONS["K7_strided_fir"] = current7
            fir.k7_plan = own_plan
            if plan is not None:
                fir.k7_plan = lambda *a, plan=plan: own_plan(*a, forced=plan)
            elif entry is not None:
                swap(build_mod, "K7_strided_fir", entry[0], "k7_strided_fir", drop=4 if "first" in name else 0)
            rec = dict(kernel="K7", case=case, variant=name, plan=own._asdict() if name == "K7 current" else None,
                       ptxas=entry[1] if entry else None)
            try:
                got = kern()
                torch.cuda.synchronize()
            except RuntimeError as e:
                emit(dict(rec, refused=str(e)))
                continue
            err = cs.rel_l2(cs.host(ref[0]), cs.host(got[0]))
            same_phase = ref[2] is None or torch.equal(ref[2], got[2])
            rec.update(rel_l2=err, phases_equal=bool(same_phase), ok=err <= 1e-5 and same_phase,
                       ms=cs.device_ms(kern, K7_FUNCTIONS))
            if name.endswith("instrumented"):
                lib = entry[0]
                first = "first" in name
                read = lib.old_clocks if first else lib.k7_clocks
                read.argtypes = (ctypes.c_void_p,)
                buf = old7_c if first else k7_c
                before = buf.copy()
                kern()
                torch.cuda.synchronize()
                assert read(buf.ctypes.data) == 0
                if first:
                    rec["median_cycles"] = median_cycles(changed(before[0], buf[0]), {"stage span": (0, 1),
                                                                                      "taps and store": (1, 2)})
                else:
                    rows_c = changed(before, buf)
                    if not len(rows_c):  # the direct variant carries no stamps
                        emit(rec)
                        continue
                    items = np.maximum(rows_c[:, 5], 1)[:, None]
                    per_item = np.concatenate([rows_c[:, :1], rows_c[:, 1:4] / items], 1)
                    rec["median_cycles"] = dict(
                        median_cycles(per_item, {"stage span, an item": 1, "taps, an item": 2,
                                                 "add partials and store, an item": 3}),
                        cta_lifetime=float(np.median(rows_c[:, 4] - rows_c[:, 0])),
                        cta_lifetime_max=float(np.max(rows_c[:, 4] - rows_c[:, 0])),
                        items_a_cta=float(np.median(rows_c[:, 5])))
                    shape = np.zeros(2, np.int32)
                    lib.k7_launch_shape(shape.ctypes.data_as(ctypes.c_void_p))
                    rec.update(ctas_an_sm=int(shape[0]), ctas=int(shape[1]), ctas_stamped=len(rows_c))
            emit(rec)
        build_mod._FUNCTIONS["K7_strided_fir"] = current7
        fir.k7_plan = own_plan
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
