"""Where the time of the PyTorch port's capture step goes, on one CUDA card.

Runs chip_smoke.py's slice (10 Msps, M = 800, 800 NBFM slots, 1,968,000-
sample blocks of i16 words resident on the card, packed output fetched
to the host) warm under ``torch.profiler`` and prints, per block: wall
time, device-busy time (the sum of kernel and copy times on the card),
the device's idle share, and the ops with the most device time: the
profiler's table first, then one JSON line.

Run on the card from the repository root:  python scripts/profile_torch_slice.py
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCKS = 8


def main() -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from wavecap_tpu_torch.capture.engine import pack_i16_words
    from wavecap_tpu_torch.capture.pipeline import capture_multi, pipeline_init

    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    cfg = cs.slice_config()
    stream = cs.station_scene(cfg)
    words = torch.from_numpy(
        pack_i16_words([stream.read(cfg.block_size)[0] for _ in range(BLOCKS)])
    ).to(device)
    ctl = cs.slice_control(cfg, device)

    def run():
        outs, _ = capture_multi(words, pipeline_init(cfg, device=device), ctl, cfg)
        return outs["_packed"].cpu()

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall_ms = (time.perf_counter() - t0) * 1e3 / BLOCKS

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3 / BLOCKS

    def dev_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0) or 0.0)

    events = prof.key_averages()
    # kernels and copies on the card; the host ops that launched them
    # carry the same time again, so they are left out of the sum
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(dev_us(e) for e in on_card) / 1e3 / BLOCKS
    top = sorted(on_card, key=dev_us, reverse=True)[:12]
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    print(json.dumps({
        "card": cs.card_line(),
        "blocks": BLOCKS,
        "wall_ms_per_block": plain_wall_ms,
        "traced_wall_ms_per_block": traced_wall_ms,
        "device_busy_ms_per_block": busy_ms,
        "device_idle_share": 1.0 - busy_ms / traced_wall_ms,
        "top_device_ms_per_block": [
            {"op": e.key, "calls_per_block": e.count / BLOCKS, "ms": dev_us(e) / 1e3 / BLOCKS}
            for e in top if dev_us(e) > 0
        ],
        "host_self_cpu_ms_per_block": sum(
            e.self_cpu_time_total for e in events if e.device_type == DeviceType.CPU
        ) / 1e3 / BLOCKS,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
