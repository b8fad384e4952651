"""Programs G1, G2, H and I of ``chip_smoke.py`` alone on the card.

Run from the repository root on a machine with one NVIDIA card::

    python3 scripts/chip_programs.py [h] [g1] [g2] [i] [--out DIR]

Builds the kernels, then runs each program named (all four by default)
in its own ``try``, so that one failure does not hide the others: each
report goes to standard output as a JSON line and, with ``--out``, to
``DIR/<program>.json``.  The card's name and power limit come first and
last.  Exits non-zero if any program failed.
"""

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from wavecap_tpu_torch.kernels import build_all  # noqa: E402

PROGRAMS = {"g1": c.run_program_g1, "g2": c.run_program_g2, "h": c.run_program_h, "i": c.run_program_i}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Programs G1, G2, H and I of chip_smoke.py alone on the card.")
    ap.add_argument("programs", nargs="*", help="of g1, g2, h, i (all four by default)")
    ap.add_argument("--out", help="also write each report to DIR/<program>.json")
    args = ap.parse_args(argv)
    bad = sorted(set(args.programs) - set(PROGRAMS))
    if bad:
        ap.error(f"no program {bad}: choose from {sorted(PROGRAMS)}")
    if not torch.cuda.is_available():
        print("chip_programs: no CUDA device", file=sys.stderr)
        return 2
    c.log(c.card_line())
    t0 = time.perf_counter()
    build_all()
    c.log(dict(build_s=time.perf_counter() - t0))
    out = Path(args.out) if args.out else None
    if out:
        out.mkdir(parents=True, exist_ok=True)
    ok = True
    for name in args.programs or ["h", "g1", "g2", "i"]:
        t0 = time.perf_counter()
        try:
            report = PROGRAMS[name](torch.device("cuda"))
            c.log(report)
            if out:
                (out / f"{name}.json").write_text(json.dumps(report, default=str))
        except Exception as e:
            ok = False
            c.log(dict(program=name, failed=repr(e)))
            traceback.print_exc()
        c.log(dict(program=name, wall_s=time.perf_counter() - t0))
    c.log(c.card_line())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
