#!/usr/bin/env python3
"""Where K1's and K3's time goes: the port's earlier designs of the unpack
and polyphase arms (``kernels/csrc/unpack_arms.cu``) and the slot front
end (``kernels/csrc/slot_frontend.cu``) beside the current ones, with the
current ones' plans forced, every design instrumented by stage, all timed
in one process on the card.

Run from the repository root on a machine with one NVIDIA card, with the
commit before the redesign unpacked into a directory
(``git archive aa9bb67 | tar -x -C checkout_proof/k1_k3_parent``)::

    python3 scripts/k1_k3_variants.py --parent checkout_proof/k1_k3_parent [--out FILE]

* the designs before their redesign, that checkout's ``unpack_arms.cu``
  and ``slot_frontend.cu``: K1 one thread a (parity, column) walking runs
  of 8 rows, each output loading and unpacking its 9 samples and its 9
  taps; K3 one CTA of 256 threads a slot row, the mixed row staged in
  shared memory for the discriminator (rows of at most ~27,000 samples in
  modes 0 and 1).  Built as they are and, with ``OLD_STAMPS`` applied to a
  copy, with ``OLD_CLOCKS=1`` (clock64 in thread 0 of each CTA: K1 [0]
  start, [1] rows done; K3 [0] start, [1] row mixed, [2] power summed, [3]
  discriminator done).
* the current kernels through their wrappers, built with ``K1_CLOCKS=1``
  / ``K3_CLOCKS=1`` (K1 [0] start, [1] taps loaded, [2] window loaded and
  x_out written, [3] outputs written; K3 [0] start, [1] samples done, [2]
  power summed, [3] the cluster's sum done), the trials that did not win
  (``PATCHES``: the current source with one change, written beside the
  builds), and the current kernels with their plans forced (K1's rows a
  tile; K3's CTAs a row and threads a CTA: the wrapper's ``k1_plan`` /
  ``k3_plan`` replaced for the call).

Every variant runs behind the port's wrappers (the launcher's function is
swapped) at the shapes of ``chip_smoke.py``'s ``K3_PATH_SHAPES`` and
``K1_PATH_SHAPES`` (K1 on i16 words at all three, on i8, i4 and complex
samples at program D's), is held against the plain version at
``chip_smoke.py``'s thresholds (K3: phases exact, RSSI within 1e-3 dB,
discriminator SNR >= 80 dB or rows rel L2 <= 1e-6; K1: the unpacked block
exact, stacks rel L2 <= 1e-6) and against the earlier design's output
(``bit_equal_to_old``), and timed as device time from CUPTI
(``chip_smoke.device_ms``).  A stage's time is the median over the CTAs of
SM cycles between its stamps.  One JSON line a case and variant, with the
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
# (commit aa9bb67); ``OLD_STAMPS`` adds the stamps the docstring
# lists to a copy (built with OLD_CLOCKS=1)
OLD_STAMPS = {
    "slot_frontend.cu": [
        after('namespace {\n\n',
              '#ifndef OLD_CLOCKS\n#define OLD_CLOCKS 0\n#endif\n#if OLD_CLOCKS\n__device__ long long g_old_clocks[4096][4];\n#define STAMP(k) do { const unsigned b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\\n    if (threadIdx.x == 0 && b_ < 4096) g_old_clocks[b_][k] = clock64(); } while (0)\n#else\n#define STAMP(k) do {} while (0)\n#endif\n\n'),
        after('    __shared__ float scratch[32];\n',
              '    STAMP(0);\n'),
        after('        power += w.x * w.x + w.y * w.y;\n    }\n',
              '    STAMP(1);\n'),
        after('    power = block_sum(power, scratch);  // its barrier also publishes y\n',
              '    STAMP(2);\n'),
        after('            phase1[slot] = p0 + static_cast<unsigned>(s_len) * d;\n        }\n',
              '        STAMP(3);\n'),
        after('        last[slot] = s_len > 0 ? y[s_len - 1] : before;\n    }\n',
              '    STAMP(3);\n'),
        after('}  // namespace\n',
              '\n#if OLD_CLOCKS\nWAVECAP_EXPORT int old_clocks(void* host) {\n    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));\n}\n#endif\n'),
    ],
    "unpack_arms.cu": [
        after('namespace {\n',
              '\n#ifndef OLD_CLOCKS\n#define OLD_CLOCKS 0\n#endif\n#if OLD_CLOCKS\n__device__ long long g_old_clocks[4096][4];\n#define STAMP(k) do { const unsigned b_ = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z); \\\n    if (threadIdx.x == 0 && b_ < 4096) g_old_clocks[b_][k] = clock64(); } while (0)\n#else\n#define STAMP(k) do {} while (0)\n#endif\n'),
        after('                                   int m, int t, int r_steps, int rows_per_block) {\n',
              '    STAMP(0);\n'),
        after('        }\n    }\n',
              '    STAMP(1);\n'),
        after('}  // namespace\n',
              '\n#if OLD_CLOCKS\nWAVECAP_EXPORT int old_clocks(void* host) {\n    return static_cast<int>(cudaMemcpyFromSymbol(host, g_old_clocks, sizeof(g_old_clocks)));\n}\n#endif\n'),
    ],
}


# the trials that lost: variant -> (source, [(text, its replacement)]); each
# text must occur once in the current source
# K3's power sum as first written: two full cluster barriers, every CTA
# waiting while the last one reads the others' sums
K3_SPLIT_BARRIER = r"""
    power = block_sum(power, scratch);
    STAMP(2);
    if (nct > 1) {
        cluster_wait();  // every CTA of the cluster has started: its shared memory is there
        if (threadIdx.x == 0) *cluster.map_shared_rank(&parts[rank], nct - 1) = power;
        cluster_arrive_release();
        if (rank != nct - 1) {  // the last CTA reads the sums; the others are done
            STAMP(3);
            return;
        }
        cluster_wait();
    } else if (threadIdx.x == 0) {
        parts[0] = power;
    }
    if (threadIdx.x == 0) {
        float tot = 0.f;
        for (int r = 0; r < nct; ++r) tot += parts[r];"""
K3_TWO_SYNCS = r"""
    power = block_sum(power, scratch);
    STAMP(2);
    if (nct > 1) {
        cluster_wait();
        if (threadIdx.x == 0) parts[0] = power;
        cluster.sync();  // every CTA's sum is in its shared memory
    } else if (threadIdx.x == 0) {
        parts[0] = power;
    }
    if (rank == nct - 1 && threadIdx.x == 0) {
        float tot = 0.f;
        for (int r = 0; r < nct; ++r) tot += nct > 1 ? *cluster.map_shared_rank(&parts[0], r) : parts[0];"""

# K1's window as first written: the history-or-block choice a branch at
# each sample, so each word's unpack waited on its own load
K1_PREDICATED = r"""
        typename Source::Raw raw[R + T];
        float2 hv[R + T];
#pragma unroll
        for (int j = 0; j < R + T; ++j) {
            const long i = i0 + static_cast<long>(j) * m;
            const bool need = (j < R + T - 1 || p.low || p.last_tile) && i < len;
            raw[j] = need && i >= h_len ? src.load(i - h_len) : typename Source::Raw{};
            hv[j] = need && i < h_len ? hist[i] : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < R + T; ++j)
            w[j] = i0 + static_cast<long>(j) * m < h_len ? hv[j] : src.convert(raw[j]);
"""
K1_BRANCHED = r"""
#pragma unroll
        for (int j = 0; j < R + T; ++j) {
            const long i = i0 + static_cast<long>(j) * m;
            const bool need = (j < R + T - 1 || p.low || p.last_tile) && i < len;
            w[j] = need ? (i < h_len ? hist[i] : src.convert(src.load(i - h_len))) : make_float2(0.f, 0.f);
        }
"""

PATCHES = {
    "K1 current, a branch at each load": ("unpack_arms.cu", [(K1_PREDICATED, K1_BRANCHED)]),
    "K3 current, cosf and sinf": (
        "slot_frontend.cu", [("    float c, s;\n    sincosf(ph, &s, &c);\n",
                              "    const float c = cosf(ph), s = sinf(ph);\n")]),
    "K3 current, two cluster syncs": (
        "slot_frontend.cu", [(K3_SPLIT_BARRIER, K3_TWO_SYNCS), ('        phase1[slot] = p0 + static_cast<unsigned>(s_len) * d;\n    }\n    STAMP(3);\n}', '        phase1[slot] = p0 + static_cast<unsigned>(s_len) * d;\n    }\n    if (nct > 1) cluster.sync();  // no CTA leaves while the last one reads its sum\n    STAMP(3);\n}')[0:2]]),
}

K1_FUNCTIONS = ("unpack_arms_kernel",)
K3_FUNCTIONS = ("slot_frontend_kernel",)


def patched(csrc: Path, vdir: Path, name: str) -> Path:
    """The current source with one variant's changes, written beside the builds."""
    stem, changes = PATCHES[name]
    text = (csrc / stem).read_text()
    for old, new in changes:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old.strip()[:60]!r} does not occur once in {stem}")
        text = text.replace(old, new)
    out = vdir / f"{name.replace(' ', '_').replace(',', '')}.cu"
    out.write_text(text)
    return out



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
        "K3 before": (old / "slot_frontend.cu", {}),
        "K3 before, instrumented": (stamped_source(old, vdir, "slot_frontend.cu"), {"OLD_CLOCKS": 1}),
        "K3 current, instrumented": (csrc / "slot_frontend.cu", {"K3_CLOCKS": 1}),
        "K1 before": (old / "unpack_arms.cu", {}),
        "K1 before, instrumented": (stamped_source(old, vdir, "unpack_arms.cu"), {"OLD_CLOCKS": 1}),
        "K1 current, instrumented": (csrc / "unpack_arms.cu", {"K1_CLOCKS": 1}),
    }
    jobs.update({name: (patched(csrc, vdir, name), {}) for name in PATCHES})
    nvcc = build_mod._find_nvcc()
    procs = {}
    for i, (name, (src, macros)) in enumerate(jobs.items()):
        lib = vdir / f"libvariant{i}.so"
        cmd = build_mod.nvcc_command(src, lib, nvcc)
        include = old if "before" in name else csrc
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
    does not take (the earlier designs' entries take no plan)."""
    fn = getattr(lib, symbol)
    types = build_mod.KERNELS[kernel][2]
    fn.argtypes = tuple(types[:len(types) - 1 - drop]) + (types[-1],)
    fn.restype = ctypes.c_int
    lib.wavecap_error_string.argtypes = (ctypes.c_int,)
    lib.wavecap_error_string.restype = ctypes.c_char_p
    call = fn if not drop else (lambda *a: fn(*a[:-1 - drop], a[-1]))
    build_mod._FUNCTIONS[kernel] = (call, lib)


def median_cycles(stamps: np.ndarray, spans: dict) -> dict:
    """Median SM cycles over the CTAs of each named span ``(start, end)``."""
    return {name: float(np.median(stamps[:, b] - stamps[:, a])) if len(stamps) else None
            for name, (a, b) in spans.items()}


def stamped(lib, symbol: str, run) -> np.ndarray:
    """The stamps of the CTAs that one call of ``run`` wrote anew."""
    import torch

    read = getattr(lib, symbol)
    read.argtypes = (ctypes.c_void_p,)
    before = np.zeros((4096, 4), np.int64)
    after = np.zeros((4096, 4), np.int64)
    torch.cuda.synchronize()
    assert read(before.ctypes.data) == 0
    run()
    torch.cuda.synchronize()
    assert read(after.ctypes.data) == 0
    return after[(after[:, 0] != before[:, 0]) & (after[:, 0] != 0)]


def k3_forced(cb, slots: int, s: int, mode: int) -> list:
    """Plans to try beside the kernel's own: CTAs a row x threads a CTA."""
    own = cb.k3_plan(slots, s, mode)
    out = []
    for cluster in (1, 2, 4, 8):
        for threads in (128, 256, 512):
            plan = cb.k3_plan(slots, s, mode, forced=(cluster, threads))
            if (plan.cluster, plan.threads) != (own.cluster, own.threads) and (plan.cluster, plan.threads) not in out:
                out.append((plan.cluster, plan.threads))
    return out


def main() -> int:
    import torch

    import chip_smoke as cs
    from wavecap_tpu_torch.kernels import build as build_mod
    from wavecap_tpu_torch.models import channel_bank as cb
    from wavecap_tpu_torch.ops import channelizer as chz

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="a checkout of the commit before the redesign (its kernel sources are built)")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_k3_variants: no CUDA device", file=sys.stderr)
        return 2
    build_mod.build_all()
    libs = build(build_mod.BUILD_DIR / "k1_k3_variants", build_mod, args.parent.resolve())
    card = cs.card_line()
    dev = torch.device("cuda")
    lines = []

    def emit(obj):
        line = json.dumps(dict(card=card, **obj), default=float)
        print(line, flush=True)
        lines.append(line)

    # --- K3 ---
    current3 = build_mod._function("K3_slot_frontend")
    own3 = cb.k3_plan
    for what, slots, bins, s, mode in cs.K3_PATH_SHAPES:
        cargs = cs.k3_path_case(dev, slots, bins, s, mode)
        ref = [cs.host(v) for v in cb.slot_frontend_plain(*cargs)]
        old_out = None
        variants = [("K3 current", None, None), ("K3 before", libs["K3 before"], None),
                    ("K3 before, instrumented", libs["K3 before, instrumented"], None),
                    ("K3 current, instrumented", libs["K3 current, instrumented"], None)]
        variants += [(k, v, None) for k, v in libs.items() if k.startswith("K3 current,") and "instrumented" not in k]
        variants += [(f"K3 current, forced {cl} CTAs a row x {th} threads", None, (cl, th))
                     for cl, th in k3_forced(cb, slots, s, mode)]
        for name, entry, plan in variants:
            build_mod._FUNCTIONS["K3_slot_frontend"] = current3
            cb.k3_plan = own3
            if plan is not None:
                cb.k3_plan = lambda *a, plan=plan: own3(*a, forced=plan)
            elif entry is not None:
                swap(build_mod, "K3_slot_frontend", entry[0], "k3_slot_frontend",
                     drop=3 if "before" in name else 0)
            rec = dict(kernel="K3", case=what, variant=name, ptxas=entry[1] if entry else None,
                       plan=cb.k3_plan(slots, s, mode)._asdict() if "before" not in name else None)

            def kern():
                return cb.slot_frontend(*cargs)

            try:
                got = [cs.host(v) for v in kern()]
            except (NotImplementedError, RuntimeError) as e:  # the earlier K3 stages its row
                emit(dict(rec, refused=str(e)))
                continue
            if name == "K3 before":
                old_out = got
            ok = np.array_equal(got[2], ref[2])
            rec.update(phases_equal=bool(ok), rssi_max_abs_db=float(np.max(np.abs(got[1] - ref[1]))))
            if mode == 2:
                rec["rows_rel_l2"] = cs.rel_l2(ref[0], got[0])
                ok = ok and rec["rows_rel_l2"] <= 1e-6
            else:
                rec["fm_snr_db"] = cs.snr_db(ref[0], got[0])
                ok = ok and rec["fm_snr_db"] >= 80.0 and cs.rel_l2(ref[3], got[3]) <= 1e-5
            rec["ok"] = bool(ok and rec["rssi_max_abs_db"] <= 1e-3)
            if old_out is not None and "before" not in name:
                rec["bit_equal_to_old"] = bool(np.array_equal(got[0].view(np.uint8), old_out[0].view(np.uint8))
                                               and (mode == 2 or np.array_equal(got[3], old_out[3])))
                rec["rssi_vs_old_db"] = float(np.max(np.abs(got[1] - old_out[1])))
                rec["out_max_abs_vs_old"] = float(np.max(np.abs(got[0] - old_out[0])))
                rec["out_differing_vs_old"] = int(np.count_nonzero(got[0] != old_out[0]))
            rec["ms"] = cs.device_ms(kern, K3_FUNCTIONS)
            if name.endswith("instrumented"):
                if "before" in name:
                    st = stamped(entry[0], "old_clocks", kern)
                    spans = {"mix row": (0, 1), "block sum": (1, 2), "discriminator": (2, 3), "cta": (0, 3)}
                else:
                    st = stamped(entry[0], "k3_clocks", kern)
                    spans = {"samples": (0, 1), "block sum": (1, 2), "cluster sum": (2, 3), "cta": (0, 3)}
                rec["median_cycles"] = median_cycles(st, spans)
                rec["ctas_stamped"] = len(st)
            emit(rec)
        build_mod._FUNCTIONS["K3_slot_frontend"] = current3
        cb.k3_plan = own3
        del cargs

    # --- K1 ---
    current1 = build_mod._function("K1_unpack_arms")
    own1 = chz.k1_plan
    k1_cases = [(what, m, n, "i16") for what, m, n in cs.K1_PATH_SHAPES]
    k1_cases += [(cs.K1_PATH_SHAPES[0][0], cs.K1_PATH_SHAPES[0][1], cs.K1_PATH_SHAPES[0][2], kind)
                 for kind in ("i8", "i4", "complex64")]
    for what, m, n, kind in k1_cases:
        x, hist, cfg, scale = cs.k1_path_case(dev, m, n, kind)
        x_ref, u_ref = chz.unpack_arms_plain(x, hist, cfg, scale)
        u_ref = cs.host(u_ref)
        old_u = None
        variants = [("K1 current", None, None), ("K1 before", libs["K1 before"], None),
                    ("K1 before, instrumented", libs["K1 before, instrumented"], None),
                    ("K1 current, instrumented", libs["K1 current, instrumented"], None)]
        variants += [(k, v, None) for k, v in libs.items() if k.startswith("K1 current,") and "instrumented" not in k]
        own_rows = own1(m, 9, n // m, 0).rows
        variants += [(f"K1 current, forced {r} rows a tile", None, r) for r in (2, 4, 8, 16) if r != own_rows]
        for name, entry, rows in variants:
            build_mod._FUNCTIONS["K1_unpack_arms"] = current1
            chz.k1_plan = own1
            if rows is not None:
                chz.k1_plan = lambda *a, rows=rows: own1(*a, forced=rows)
            elif entry is not None:
                swap(build_mod, "K1_unpack_arms", entry[0], "k1_unpack_arms", drop=2 if "before" in name else 0)
            rec = dict(kernel="K1", case=f"{what}, {n:,} {kind}", variant=name, ptxas=entry[1] if entry else None,
                       plan=chz.k1_plan(m, 9, n // m, 0)._asdict() if "before" not in name else None)

            def kern():
                return chz.unpack_arms(x, hist, cfg, scale)

            x_k, u_k = kern()
            u_k = cs.host(u_k)
            if name == "K1 before":
                old_u = u_k
            rec.update(x_equal=bool(torch.equal(x_k, x_ref)), rel_l2=cs.rel_l2(u_ref, u_k))
            rec["ok"] = rec["x_equal"] and rec["rel_l2"] <= 1e-6
            if old_u is not None and "before" not in name:
                rec["bit_equal_to_old"] = bool(np.array_equal(u_k.view(np.uint8), old_u.view(np.uint8)))
            rec["ms"] = cs.device_ms(kern, K1_FUNCTIONS)
            if name.endswith("instrumented"):
                if "before" in name:
                    st = stamped(entry[0], "old_clocks", kern)
                    spans = {"rows": (0, 1)}
                else:
                    st = stamped(entry[0], "k1_clocks", kern)
                    spans = {"taps": (0, 1), "window and x_out": (1, 2), "outputs": (2, 3), "cta": (0, 3)}
                rec["median_cycles"] = median_cycles(st, spans)
                rec["ctas_stamped"] = len(st)
            emit(rec)
            del x_k, u_k
        build_mod._FUNCTIONS["K1_unpack_arms"] = current1
        chz.k1_plan = own1
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("".join(line + "\n" for line in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
