"""Server entry point: ``python -m wavecap_tpu_torch.server --port 8087``.

Reference parity: ``__main__.py`` (port lockfile, config load, uvicorn run).

In the port the server's device comes from ``WAVECAP_TORCH_DEVICE``
(``utils/torchenv.py:entry_device``: the CUDA card unless ``cpu``).

The port's copy of ``wavecap_tpu/server/__main__.py``, with the same public names.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import signal
import sys
from pathlib import Path

from wavecap_tpu_torch.utils import config as config_mod
from wavecap_tpu_torch.utils.observability import LOG_RING, RateLimitFilter
from .app import AppServer


def _acquire_lock(port: int) -> Path | None:
    """Port lockfile (reference __main__.py:19-80) so two servers don't race."""
    path = Path(f"/tmp/wavecap_tpu-{port}.lock")
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        os.write(fd, str(os.getpid()).encode())
        os.close(fd)
        return path
    except FileExistsError:
        try:
            pid = int(path.read_text())
            os.kill(pid, 0)
        except (ValueError, ProcessLookupError, PermissionError):
            path.unlink(missing_ok=True)
            return _acquire_lock(port)
        print(f"port {port} already locked by pid {pid}", file=sys.stderr)
        return None


async def _run(args, device=None) -> int:
    cfg = config_mod.load_config(args.config)
    if args.bind:
        cfg.server.host = args.bind
    if args.port:
        cfg.server.port = args.port
    if args.mesh:
        # multi-chip backend for every capture created on this server
        # (capture/mesh.py; e.g. --mesh stream=1,time=8)
        cfg.stream.mesh = args.mesh
    lock = _acquire_lock(cfg.server.port)
    if lock is None:
        return 1
    server = AppServer(cfg, device=device)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:  # pragma: no cover
            pass
    # POST /shutdown resolves the same event as SIGINT/SIGTERM
    server.state.on_shutdown_request = lambda: loop.call_soon_threadsafe(stop.set)
    try:
        await server.start()
        print(f"wavecap_tpu listening on {cfg.server.host}:{server.port}")
        await stop.wait()
    finally:
        await server.stop()
        lock.unlink(missing_ok=True)
    return 0


def main(device=None) -> int:
    import faulthandler

    from wavecap_tpu_torch.utils.torchenv import entry_device

    device = entry_device() if device is None else device
    # kill -USR1 <pid> dumps all thread stacks to stderr (hang diagnosis)
    if hasattr(signal, "SIGUSR1"):
        faulthandler.register(signal.SIGUSR1, all_threads=True)
    p = argparse.ArgumentParser("wavecap_tpu server")
    p.add_argument("--config", default=None)
    p.add_argument("--bind", default=None)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--log-level", default=None)
    p.add_argument(
        "--mesh",
        default=None,
        help="multi-chip mesh spec for captures, e.g. stream=1,time=8",
    )
    args = p.parse_args()

    level = args.log_level or os.environ.get("WAVECAP_LOG_LEVEL", "INFO")
    root = logging.getLogger()
    root.setLevel(getattr(logging, level.upper(), logging.INFO))
    handler = logging.StreamHandler()
    handler.addFilter(RateLimitFilter(0.5))
    root.addHandler(handler)
    root.addHandler(LOG_RING)
    return asyncio.run(_run(args, device))


if __name__ == "__main__":
    sys.exit(main())
