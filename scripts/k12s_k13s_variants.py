#!/usr/bin/env python3
"""Where K12s's and K13s' time goes: the P25 per-symbol timing scans
(``kernels/csrc/p25_scan.cu``) of the commit before their redesign, taken
from a checkout of it, beside the current ones, each instrumented by
stage, with the trials that lost applied as patches, and the latencies of
the operations on the walk's chain, all in one process on the card.

Run from the repository root on a machine with one NVIDIA card, with the
commit before the redesign unpacked into a directory
(``git archive dc97306 | tar -x -C checkout_proof/parent``)::

    python3 scripts/k12s_k13s_variants.py --parent checkout_proof/parent [--out FILE] [--sass DIR]

* "before": the parent's ``p25_scan.cu`` built as it is, and with
  ``OLD_STAMPS`` (clock64 in the walking thread, thread 0 of each CTA:
  [0] start, [1] row staged, [2] walk done, [3] epilogue done), launched
  by :func:`parent_launch` with the parent's own arguments (the row
  staged where it fits; "rows from global" forces it out), and the
  parent with one change at a time (``PATCHES`` on ``parent:``): the
  division by a per-row reciprocal (a multiply and two fused
  multiply-adds), the floor by ``__float2int_rd``, and two that change
  the results and are timed only: no division, no sample loads.
* "current": the kernels through the port's wrappers, built with
  ``K12S_CLOCKS=1`` (the walking thread stamps [0] start, [1] the first
  group's chunks landed, [2] walk done, [3] the helper warp's sums done,
  [4] end), and the trials that lost (``PATCHES`` on the current source):
  every step checked (the window checks and a per-step redo branch
  everywhere), the two windows split over two walking lanes (a shuffle
  swaps y and y_mid), the three clips as the reference writes them, the
  window's floor by ``floorf`` at use, the window floors by
  ``__float2int_rd``, the steps not unrolled, IEEE division, and the
  helper and producer warps polling with relaxed loads.

Every variant runs at ``chip_smoke.scan_path_shapes()`` (the parent
refuses the long rows), is held against the plain version at
``chip_smoke.py``'s thresholds (dibits equal, soft and state within
1e-3) and against the parent's bits (soft, dibits, the carried state and
last symbol), and is timed as device time from CUPTI
(``chip_smoke.device_ms``).  A span's cycles are the median over the CTAs
of SM cycles between its stamps; the walk's cycles a symbol are its
span over the row's symbols.  First ``chip_smoke.scan_op_latencies``: one
dependent operation's cycles each.  One JSON line a case and variant,
with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STAMP_MACROS = r"""
__device__ long long g_old_clocks[4096][8];
#define STAMP(k)                                                              \
    do {                                                                      \
        if (threadIdx.x == 0 && blockIdx.x < 4096) g_old_clocks[blockIdx.x][k] = clock64(); \
    } while (0)
"""
STAMP_READER = r"""
WAVECAP_EXPORT int old_clocks(void* host) {
    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));
}
"""
END_NS = "}  // namespace\n"


def after(anchor: str, text: str) -> tuple:
    return anchor, anchor + text


def before(anchor: str, text: str) -> tuple:
    return anchor, text + anchor


OLD_STAMPS = [
    after('#include "p25_common.cuh"\n', STAMP_MACROS),
    after("    const V* buf = src;\n", "    STAMP(0);\n"),
    after("    __syncthreads();  // publishes the staged row\n", "    STAMP(1);\n"),
    before("        carry[0] = pos;\n", "        STAMP(2);\n"),
    after("        for (int q = 0; q < 6; ++q) out[q * rows + r] = vals[q];\n    }\n", "    STAMP(3);\n"),
    after(END_NS, STAMP_READER),
]
OLD_SPANS = {"stage row": (0, 1), "walk": (1, 2), "epilogue": (2, 3), "cta": (0, 3)}
NEW_SPANS = {"first chunk": (0, 1), "walk": (1, 2), "helpers after the walk": (2, 3),
             "rescale": (3, 4), "cta": (0, 4)}

# --- the trials: the parent with one change, or the current source with one
OLD_DIV = "    return clip(__fdiv_rn(__fmul_rn(__fsub_rn(prev, y), ym), den), -2.f, 2.f);\n"
OLD_DIV_RCP = """    const float x = __fmul_rn(__fsub_rn(prev, y), ym);
    const float rc = __frcp_rn(den);
    const float q = __fmul_rn(x, rc);
    return clip(__fmaf_rn(__fmaf_rn(-q, den, x), rc, q), -2.f, 2.f);
"""
OLD_NO_DIV = "    return clip(__fmul_rn(__fmul_rn(__fsub_rn(prev, y), ym), 0.25f), -2.f, 2.f);\n"
OLD_FLOOR = """    const float f = floorf(pos);
    const float fr = __fsub_rn(pos, f);
    const int i0 = static_cast<int>(clip(f, 0.f, static_cast<float>(last)));
"""
OLD_FLOOR_RD = """    const int fi = __float2int_rd(pos);
    const float fr = __fsub_rn(pos, static_cast<float>(fi));
    const int i0 = min(max(fi, 0), last);
"""
OLD_NO_LOADS = """    const int i0 = static_cast<int>(clip(f, 0.f, static_cast<float>(last)));
    return lerp(buf[i0], buf[i0 + 1], fr);
"""
OLD_NO_LOADS_NEW = """    const int i0 = static_cast<int>(clip(f, 0.f, static_cast<float>(last)));
    return lerp(buf[last & 7], buf[(last & 7) + 1], __fadd_rn(fr, static_cast<float>(i0 & 0)));
"""

NEW_INTERIOR = "        if (w.narrow && wm.at >= 0 && wy.at < last && "
NEW_MERGED = """            integ = clip(__fadd_rn(integ, __fmul_rn(w.beta, q)), lo_i, hi_i);
            const float t = __fadd_rn(c.sps, integ);
            freq = kClipFreq ? clip(t, c.fmin, c.fmax) : t;
            pos = __fadd_rn(__fadd_rn(pos, freq), clip(__fmul_rn(w.alpha, q), -a2, a2));
"""
NEW_WRITTEN = """            const float err = clip(q, -2.f, 2.f);
            (void)lo_i;
            (void)hi_i;
            integ = clip(__fadd_rn(integ, __fmul_rn(w.beta, err)), c.integ_lo, c.integ_hi);
            freq = clip(__fadd_rn(c.sps, integ), c.fmin, c.fmax);
            pos = __fadd_rn(__fadd_rn(pos, freq), __fmul_rn(w.alpha, err));
"""
NEW_SELECT = """        const bool up = p >= b1;
        const float fr = up ? __fsub_rn(p, b1) : __fsub_rn(p, b);
"""
NEW_FLOORF = """        const float f = floorf(p);
        const bool up = f >= b1;
        const float fr = __fsub_rn(p, f);
"""
NEW_MARKSTEIN = "                q = __fmaf_rn(__fmaf_rn(-q0, den, x), rden, q0);\n"
NEW_IEEE = "                q = __fdiv_rn(x, den);\n"

NEW_SHIFT = """        const float t = __fadd_rd(lo, kFloorShift);
        at = __float_as_int(t) - __float_as_int(kFloorShift);
        b = __fsub_rn(t, kFloorShift);
"""
NEW_F2I = """        at = __float2int_rd(lo);
        b = static_cast<float>(at);
        const float t = __int_as_float(at + __float_as_int(kFloorShift));  // its bits & mask: at & mask
"""
NEW_UNROLL = "#pragma unroll 2\n"

# lanes 0 and 1 of warp 0 walk in step, lane 0 loading and interpolating
# y's window, lane 1 y_mid's, the two values swapped by a shuffle
TWO_LANES = [
    before("// interp(p) straight from the row, clamped", """// the other walking lane's value
__device__ __forceinline__ float xshfl(float v) { return __shfl_xor_sync(3u, v, 1); }
__device__ __forceinline__ float2 xshfl(float2 v) {
    return make_float2(__shfl_xor_sync(3u, v.x, 1), __shfl_xor_sync(3u, v.y, 1));
}

"""),
    ("""    Window<V> wy, wm;
    auto fetch = [&](float ly) {
        wy.load(w.ring, mask, ly);
        wm.load(w.ring, mask, __fsub_rn(ly, hmax));
    };
""", """    Window<V> win;  // lane 0: y's window, lane 1: y_mid's
    const unsigned lane = threadIdx.x & 1;
    auto fetch = [&](float ly) { win.load(w.ring, mask, lane ? __fsub_rn(ly, hmax) : ly); };
"""),
    ("""            V y = wy.sample(pos), ym = wm.sample(pm);
            bool ok = true;
            if constexpr (decltype(checked)::value) ok = wy.holds(pos, last) && wm.holds(pm, last);
""", """            const float mine = lane ? pm : pos;
            const V v = win.sample(mine);
            const V o = xshfl(v);
            V y = lane ? o : v, ym = lane ? v : o;
            bool ok = true;
            if constexpr (decltype(checked)::value) ok = __all_sync(3u, win.holds(mine, last));
"""),
    ("""        int split = m;
        if (w.narrow && wm.at >= 0 && wy.at < last && """, """        int split = m;
        const int at_o = __shfl_xor_sync(3u, win.at, 1);
        if (w.narrow && (lane ? win.at : at_o) >= 0 && (lane ? at_o : win.at) < last && """),
    ("""    } else if (tid == 0) {
        // --- the walk
""", """    } else if (tid < 2) {
        // --- the walk
"""),
]

NEW_HELPER_POLL = """                    while (avail < need) {
                        avail = load_acquire(&progress);
                        if (avail < need) __nanosleep(32);
                    }
"""
NEW_HELPER_RELAXED = """                    if (avail < need) {
                        while ((avail = *reinterpret_cast<volatile int*>(&progress)) < need) __nanosleep(256);
                        __threadfence_block();
                    }
"""
NEW_PRODUCER_POLL = "                while (load_acquire(&low) < need) __nanosleep(64);\n"
NEW_PRODUCER_RELAXED = """                while (*reinterpret_cast<volatile int*>(&low) < need) __nanosleep(256);
                __threadfence_block();
"""

# name -> (source, changes, macros, timing only: the results change)
PATCHES = {
    "current, every step checked": (
        "p25_scan.cu", [(NEW_INTERIOR, "        if (false && w.narrow && wm.at >= 0 && wy.at < last && ")], {},
        False),
    "current, the two windows on two lanes": ("p25_scan.cu", TWO_LANES, {}, False),
    "current, three clips as the reference writes them": ("p25_scan.cu", [(NEW_MERGED, NEW_WRITTEN)], {}, False),
    "current, floor by floorf": ("p25_scan.cu", [(NEW_SELECT, NEW_FLOORF)], {}, False),
    "current, window floors by __float2int_rd": ("p25_scan.cu", [(NEW_SHIFT, NEW_F2I)], {}, False),
    "current, steps not unrolled": ("p25_scan.cu", [(NEW_UNROLL, "")], {}, False),
    "current, IEEE division": ("p25_scan.cu", [(NEW_MARKSTEIN, NEW_IEEE)], {}, False),
    "current, the helper and the producer poll relaxed, sleeping 256 ns": (
        "p25_scan.cu", [(NEW_HELPER_POLL, NEW_HELPER_RELAXED), (NEW_PRODUCER_POLL, NEW_PRODUCER_RELAXED)], {}, False),
    "before, division by the per-row reciprocal": ("parent:p25_scan.cu", [(OLD_DIV, OLD_DIV_RCP)], {}, False),
    "before, floor by __float2int_rd": ("parent:p25_scan.cu", [(OLD_FLOOR, OLD_FLOOR_RD)], {}, False),
    "before, no division (timing only)": ("parent:p25_scan.cu", [(OLD_DIV, OLD_NO_DIV)], {}, True),
    "before, no sample loads (timing only)": ("parent:p25_scan.cu", [(OLD_NO_LOADS, OLD_NO_LOADS_NEW)], {}, True),
}


def patched(csrc: Path, parent_csrc: Path, vdir: Path, name: str) -> tuple:
    """One variant's source with its changes, written beside the builds:
    ``(path, the directory of its headers)``."""
    stem, changes, _, _ = PATCHES[name]
    base = parent_csrc if stem.startswith("parent:") else csrc
    stem = stem.removeprefix("parent:")
    text = (base / stem).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old.strip()[:60]!r} does not occur once in {base / stem}")
        text = text.replace(old, new)
    out = vdir / (re.sub(r"\W+", "_", name) + ".cu")
    out.write_text(text)
    return out, base


def stamped_source(parent_csrc: Path, vdir: Path) -> Path:
    text = (parent_csrc / "p25_scan.cu").read_text()
    for old, new in OLD_STAMPS:
        if text.count(old) != 1:
            raise RuntimeError(f"stamps: {old.strip()[:60]!r} does not occur once in the parent's p25_scan.cu")
        text = text.replace(old, new)
    out = vdir / "before_instrumented.cu"
    out.write_text(text)
    return out


def build(vdir: Path, build_mod, parent: Path) -> dict:
    """Every variant's library, compiled in parallel: name -> (CDLL, ptxas lines)."""
    vdir.mkdir(parents=True, exist_ok=True)
    csrc = build_mod.CSRC
    parent_csrc = parent / "wavecap_tpu_torch" / "kernels" / "csrc"
    jobs = {"before": (parent_csrc / "p25_scan.cu", parent_csrc, {}),
            "before, instrumented": (stamped_source(parent_csrc, vdir), parent_csrc, {})}
    redesigned = (csrc / "p25_scan.cu").read_text() != (parent_csrc / "p25_scan.cu").read_text()
    if redesigned:
        jobs["current, instrumented"] = (csrc / "p25_scan.cu", csrc, {"K12S_CLOCKS": 1})
    for name, (stem, _, macros, _) in PATCHES.items():
        if stem.startswith("parent:") or redesigned:
            jobs[name] = (*patched(csrc, parent_csrc, vdir, name), macros)
    nvcc = build_mod._find_nvcc()
    procs = {}
    for i, (name, (src, include, macros)) in enumerate(jobs.items()):
        lib = vdir / f"libvariant{i}.so"
        cmd = build_mod.nvcc_command(src, lib, nvcc)
        cmd[1:1] = [f"-I{include}"] + [f"-D{k}={v}" for k, v in macros.items()]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name} failed to build\n{text}")
        libs[name] = (ctypes.CDLL(str(lib)), [ln.strip() for ln in text.splitlines() if "registers" in ln])
    return libs


def parent_launch(lib, kernel: str, buf, st, n_sym: int, cfg, staged=None):
    """The parent's ``launch_scan``: one CTA a row, every symbol staged in
    shared memory, the row too where it fits (``staged`` forces it);
    refuses what the parent refused."""
    import torch

    from wavecap_tpu_torch.models.p25 import c4fm
    from wavecap_tpu_torch.models.p25.c4fm import _loop_gains, _scan_dc, timing_consts

    cqpsk = kernel.startswith("K13s")
    c = timing_consts(cfg.sps, cfg.max_clock_ppm, 0.002 if cqpsk else 0.005)
    rows, length = buf.shape
    item = buf.element_size()
    fixed = n_sym * item + (n_sym * 4 if cqpsk else 0)
    limit = 200 * 1024
    if fixed > limit:
        raise NotImplementedError(f"{kernel} stages {n_sym} symbols: too many")
    if staged is None:
        staged = int(fixed + length * item <= limit)
    dev = buf.device
    soft = torch.empty((rows, n_sym), dtype=torch.float32, device=dev)
    dibits = torch.empty((rows, n_sym), dtype=torch.uint8, device=dev)
    out = torch.empty((6, rows), dtype=torch.float32, device=dev)
    dc0 = None if cqpsk else _scan_dc(buf, st).contiguous()
    alpha, beta = (float(np.float32(g)) for g in _loop_gains(cfg))
    fn = getattr(lib, "k13s_cqpsk_scan" if cqpsk else "k12s_c4fm_scan")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = (P,) * 6 + (I,) * 4 + (F,) * 10 + (P,)
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(dev).cuda_stream
    status = fn(buf.data_ptr(), st.data_ptr(), None if dc0 is None else dc0.data_ptr(), soft.data_ptr(),
                dibits.data_ptr(), out.data_ptr(), rows, length, n_sym, staged, *c, alpha, beta, stream)
    if status != 0:
        raise RuntimeError(f"{kernel} (parent) failed to launch: {status}")
    del c4fm
    return soft, dibits, out


def swap(build_mod, kernel: str, lib, symbol: str):
    """Point the launcher's ``kernel`` at ``symbol`` of ``lib`` (the current
    entry's arguments)."""
    fn = getattr(lib, symbol)
    fn.argtypes = build_mod.KERNELS[kernel][2]
    fn.restype = ctypes.c_int
    lib.wavecap_error_string.argtypes = (ctypes.c_int,)
    lib.wavecap_error_string.restype = ctypes.c_char_p
    build_mod._FUNCTIONS[kernel] = (fn, lib)


def median_cycles(stamps: np.ndarray, spans: dict) -> dict:
    return {name: float(np.median(stamps[:, b] - stamps[:, a])) if len(stamps) else None
            for name, (a, b) in spans.items()}


def stamped(lib, symbol: str, run) -> np.ndarray:
    """The stamps of the CTAs that one call of ``run`` wrote anew."""
    import torch

    read = getattr(lib, symbol)
    read.argtypes = (ctypes.c_void_p,)
    before_ = np.zeros((4096, 8), np.int64)
    after_ = np.zeros((4096, 8), np.int64)
    torch.cuda.synchronize()
    assert read(before_.ctypes.data) == 0
    run()
    torch.cuda.synchronize()
    assert read(after_.ctypes.data) == 0
    return after_[(after_[:, 0] != before_[:, 0]) & (after_[:, 0] != 0)]


def main() -> int:
    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build as build_mod

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit before the redesign (its kernel sources are built)")
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--sass", help="write cuobjdump -sass of the current build and the parent's here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k12s_k13s_variants: no CUDA device", file=sys.stderr)
        return 2
    build_mod.build_all()
    libs = build(build_mod.BUILD_DIR / "k12s_k13s_variants", build_mod, args.parent.resolve())
    card = cs.card_line()
    dev = torch.device("cuda")
    lines = []
    if args.sass:
        sass_dir = Path(args.sass)
        sass_dir.mkdir(parents=True, exist_ok=True)
        cuobjdump = str(Path(build_mod._find_nvcc()).with_name("cuobjdump"))
        vdir = build_mod.BUILD_DIR / "k12s_k13s_variants"
        for tag, lib in (("current", build_mod.BUILD_DIR / "libp25_scan.so"), ("before", vdir / "libvariant0.so")):
            sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True).stdout
            (sass_dir / f"p25_scan_{tag}.sass").write_text(sass)

    def emit(obj):
        line = json.dumps(dict(card=card, **obj), default=float)
        print(line, flush=True)
        lines.append(line)

    emit(dict(probe="scan op latencies, SM cycles", cycles=cs.scan_op_latencies()))
    symbols = {"K12s_c4fm_scan": "k12s_c4fm_scan", "K13s_cqpsk_scan": "k13s_cqpsk_scan"}
    for what, kind, rows, n, change in cs.scan_path_shapes():
        kfn, pfn, buf, st, n_sym, cfg = cs.scan_path_case(dev, kind, rows, n, change)
        kernel = cs.SCAN_NAMES[kind]
        plain = [cs.host(v) for v in pfn(buf, st, n_sym, cfg)]
        parent = None
        try:
            parent = [cs.host(v) for v in parent_launch(libs["before"][0], kernel, buf, st, n_sym, cfg)]
        except NotImplementedError as e:
            emit(dict(kernel=kernel, case=what, variant="before", refused=str(e)))
        current = build_mod._function(kernel)
        variants = [("current", None, None)]
        variants += [(name, lib, None) for name, lib in libs.items() if name.startswith("before")]
        variants.append(("before, rows from global", libs["before"], 0))
        variants += [(name, lib, None) for name, lib in libs.items() if name.startswith("current,")]
        for name, entry, staged in variants:
            timing_only = PATCHES.get(name, (0, 0, 0, False))[3]
            if name.startswith("before"):
                if parent is None:
                    continue
                run = (lambda lib=entry[0], staged=staged:  # noqa: E731
                       parent_launch(lib, kernel, buf, st, n_sym, cfg, staged))
            else:
                build_mod._FUNCTIONS[kernel] = current
                if entry is not None:
                    swap(build_mod, kernel, entry[0], symbols[kernel])
                run = (lambda: kfn(buf, st, n_sym, cfg))  # noqa: E731
            rec = dict(kernel=kernel, case=what, variant=name, n_sym=n_sym, ptxas=entry[1] if entry else None)
            try:
                got = [cs.host(v) for v in run()]
            except NotImplementedError as e:  # only a design before the redesign refuses rows
                emit(dict(rec, refused=str(e)))
                continue
            if not timing_only:
                rec.update(dibits_equal_plain=bool(np.array_equal(got[1], plain[1])),
                           soft_max_abs_plain=cs.max_abs(plain[0], got[0]),
                           state_max_abs_plain=float(np.max(np.abs(got[2] - plain[2]))))
                rec["ok"] = bool(rec["dibits_equal_plain"] and rec["soft_max_abs_plain"] <= 1e-3
                                 and rec["state_max_abs_plain"] <= 1e-3)
                if parent is not None:
                    rec["bits_equal_parent"] = {k: bool(np.array_equal(np.asarray(a).view(np.uint8),
                                                                       np.asarray(b).view(np.uint8)))
                                                for k, a, b in zip(("soft", "dibits", "state"), got, parent)}
                    rec["state_rows_equal_parent"] = [bool(np.array_equal(got[2][q].view(np.uint32),
                                                                          parent[2][q].view(np.uint32)))
                                                      for q in range(6)]
            if n < cs.SCAN_LONG:
                rec["ms"] = cs.device_ms(run, "scan_kernel")
            if name.endswith("instrumented"):
                old = name.startswith("before")
                stamps = stamped(entry[0], "old_clocks" if old else "k12s_clocks", run)
                rec["median_cycles"] = median_cycles(stamps, OLD_SPANS if old else NEW_SPANS)
                rec["walk_cycles_per_symbol"] = (rec["median_cycles"]["walk"] / n_sym
                                                 if rec["median_cycles"]["walk"] is not None else None)
                rec["ctas_stamped"] = len(stamps)
            emit(rec)
        build_mod._FUNCTIONS[kernel] = current
        del buf
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
