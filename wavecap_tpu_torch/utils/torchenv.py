"""Device choice and numeric settings (counterpart of ``utils/jaxenv.py``).

The port runs on the CUDA card unless the caller asks for the CPU.  There
is no silent fallback: an entry point called without a device on a
machine with no card raises, so a CPU run is always one that was asked
for (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

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
