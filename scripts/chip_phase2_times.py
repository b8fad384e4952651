"""Where ``chip_smoke.py``'s phase 2 spends its seconds, on the card.

Run from the repository root on a machine with one NVIDIA card::

    python3 scripts/chip_phase2_times.py [--out FILE]

Builds the kernels, then runs phase 2's checks in ``chip_smoke.main``'s
order (``kernel_checks``, the K1/K3 and K4/K12 path cases, the empty
blocks, ``p25_kernel_checks``, ``engine_kernel_checks``,
``mixed_kernel_checks``, ``scan_kernel_checks``, the geometry checks)
and prints one JSON line: each check's wall seconds, the seconds of it
spent inside the timers (``device_ms``, ``time_ms``), and for the scans
the seconds of each shape of ``scan_path_shapes()``.  The card's name
and power limit come first.  Also the 25 timer call sites that took
the most seconds, by ``chip_smoke.py`` line.
"""

import argparse
import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from wavecap_tpu_torch.kernels import build_all  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Seconds of chip_smoke.py's phase 2, check by check.")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_phase2_times: no CUDA device", file=sys.stderr)
        return 2
    c.log(c.card_line())
    build_all()
    device = torch.device("cuda")
    in_timers = [0.0]
    by_line = collections.defaultdict(lambda: [0, 0.0])  # chip_smoke.py line -> [calls, seconds]
    device_ms, time_ms = c.device_ms, c.time_ms

    def timed(fn):
        def wrapper(*a, **k):
            frame = sys._getframe(1)
            while frame is not None and frame.f_code.co_filename != c.__file__:
                frame = frame.f_back
            where = f"{fn.__name__} at chip_smoke.py:{frame.f_lineno if frame else '?'}"
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                dt = time.perf_counter() - t0
                in_timers[0] += dt
                by_line[where][0] += 1
                by_line[where][1] += dt
        return wrapper

    # the checks call the timers by their module names and through their
    # defaults (bound when chip_smoke was imported): both are wrapped
    c.device_ms, c.time_ms = timed(device_ms), timed(time_ms)
    timers = dict(timer=c.device_ms, wall_timer=c.time_ms)
    shapes, case = [], c.scan_path_case

    def scan_case(device_, kind, rows, n, change=None, **kw):
        shapes.append((f"{kind} {rows} x {n}", time.perf_counter()))
        return case(device_, kind, rows, n, change, **kw)

    c.scan_path_case = scan_case
    cfg = c.slice_config()
    checks = [
        ("kernel_checks", lambda: c.kernel_checks(cfg, device, **timers)),
        ("k1_k3_path_checks", lambda: c.k1_k3_path_checks(device, timer=c.device_ms)),
        ("k4_k12_path_checks", lambda: c.k4_k12_path_checks(device, timer=c.device_ms)),
        ("empty_block_checks", lambda: c.empty_block_checks(device)),
        ("p25_kernel_checks", lambda: c.p25_kernel_checks(c.p25_configs(), device, **timers)),
        ("engine_kernel_checks", lambda: c.engine_kernel_checks(device, timer=c.device_ms)),
        ("mixed_kernel_checks", lambda: c.mixed_kernel_checks(c.mixed_config(), device, **timers)),
        ("scan_kernel_checks", lambda: c.scan_kernel_checks(device, **timers)),
        ("other_geometry_checks", lambda: c.other_geometry_checks(device)),
    ]
    report = []
    for name, fn in checks:
        in_timers[0] = 0.0
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        report.append(dict(check=name, seconds=t1 - t0, in_timers=in_timers[0]))
        if name == "scan_kernel_checks":
            ends = [t for _, t in shapes[1:]] + [t1]
            report[-1]["shapes"] = [dict(shape=s, seconds=e - t) for (s, t), e in zip(shapes, ends)]
    top = sorted(by_line.items(), key=lambda kv: -kv[1][1])[:25]
    line = dict(phase="phase 2 seconds", card=c.card_line(), checks=report,
                timers=[dict(where=w, calls=n, seconds=t) for w, (n, t) in top])
    c.log(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
