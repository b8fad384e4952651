"""Host decode of N P25 channels: the port's ``P25Attachment`` fed by hand
on one thread against N attachments on their own threads.

Run from the repository root (no card needed; the decoders are host
numpy)::

    python3 scripts/attachment_threads.py [N ...] [--blocks B]

Each attachment gets a block of 1,200 soft symbols of a control channel's
TSDU loop with noise (a 250 ms block at 4800 baud), B times; by hand each
block goes through every attachment's ``process`` in turn, threaded it is
published to every channel's ``symbols`` fan-out and waited for by the
attachments' ``batches``.  Prints one JSON line per N: wall and process
CPU ms a block for both ways.  The host's own numbers, not a device's.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402
from wavecap_tpu_torch.models.p25.c4fm import DIBIT_SYMBOLS  # noqa: E402


def run(n: int, blocks: int, threaded: bool) -> tuple:
    soft = np.tile(DIBIT_SYMBOLS[c.g_tsdu_loop(0x100, site=1)[0]], 4).astype(np.float32)[:1200]
    rng = np.random.default_rng(0)
    chans = [c.g_stand_in(f"c{i}") for i in range(n)]
    atts = [c.g_attach("p25", ch) for ch in chans]
    try:
        t0, c0 = time.perf_counter(), time.process_time()
        for k in range(blocks):
            x = (soft + rng.normal(0, 0.05, soft.size)).astype(np.float32)
            if threaded:
                for ch in chans:
                    ch.symbols.publish({"soft": x})
                c.attachments_wait(dict(enumerate(atts)), k + 1, "attachment_threads")
            else:
                for a in atts:
                    a.process({"soft": x})
        return (time.perf_counter() - t0) / blocks * 1e3, (time.process_time() - c0) / blocks * 1e3
    finally:
        for a in atts:
            a.stop()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", nargs="*", type=int, default=[1, 10, 20, 40])
    ap.add_argument("--blocks", type=int, default=6)
    args = ap.parse_args()
    for n in args.n:
        by_hand = run(n, args.blocks, threaded=False)
        threads = run(n, args.blocks, threaded=True)
        print(json.dumps(dict(channels=n, blocks=args.blocks, by_hand_ms=by_hand[0], by_hand_cpu_ms=by_hand[1],
                              threads_ms=threads[0], threads_cpu_ms=threads[1])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
