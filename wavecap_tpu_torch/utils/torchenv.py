"""Device choice and numeric settings (counterpart of ``utils/jaxenv.py``).

The port runs on the CUDA card unless the caller asks for the CPU.  There
is no silent fallback: an entry point called without a device on a
machine with no card raises, so a CPU run is always one that was asked
for (the tests pass ``device="cpu"``).

The entry points started from a shell (the server, the CLI, the harness)
take their device from ``WAVECAP_TORCH_DEVICE`` (:func:`entry_device`),
the counterpart of ``JAX_PLATFORMS``: unset means the card, ``cpu`` the
CPU.  There is no compile cache to set up: the kernels' build directory
(``kernels/build.py``) is the port's counterpart.
"""

from __future__ import annotations

import os

import torch

DeviceLike = str | torch.device | None


def disable_tf32() -> None:
    """Full f32 for matmuls and cuDNN convolutions (both default to TF32
    somewhere: cuDNN's conv1d would skew the plain FIR by ~1e-3)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA card; raise if it is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU"
        )
    return dev


def entry_device() -> torch.device:
    """The device of a process's entry point: ``WAVECAP_TORCH_DEVICE``
    (a torch device name such as ``cpu`` or ``cuda:0``), unset or empty
    meaning the card.  Raises where that is the card and there is none."""
    return resolve_device(os.environ.get("WAVECAP_TORCH_DEVICE") or None)


def devices(device: DeviceLike = None) -> list[torch.device]:
    """The devices a mesh may take, the counterpart of ``jax.devices()``:
    every CUDA card (``cuda:0..n-1``), or the CPU alone for ``device="cpu"``.

    ``WAVECAP_TORCH_DEVICE_COUNT=n`` gives ``n`` copies of the one device
    instead (the CPU, or the card ``device`` names), the counterpart of
    XLA's ``--xla_force_host_platform_device_count``: a mesh of ``n``
    shards on one device, each with its own CUDA stream, whose exchanges
    are copies on that device.  Tests and ``chip_smoke.py`` set it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    forced = os.environ.get("WAVECAP_TORCH_DEVICE_COUNT")
    if forced:
        return [dev] * int(forced)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]
