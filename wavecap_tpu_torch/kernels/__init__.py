"""Hand-written Hopper kernels (CUDA C++ under ``csrc/``) and their launcher.

The wrappers live beside their plain PyTorch versions in the modules
that call them: K1 and K2 in ``ops/channelizer.py``, K3 and K4 in
``models/channel_bank.py``, K5 and K7 in ``ops/fir.py``, K9 in
``ops/iir.py`` (and ``ops/agc.py``), K10 in ``ops/pll.py``, K11a and
K11b in ``ops/noise.py``, K12 and the scan K12s in
``models/p25/c4fm.py``, K13 (timing, the 4th power and its line search)
and the scan K13s in ``models/p25/cqpsk.py``, K14 in
``models/p25/equalizer.py``.  The mesh's exchanges (K15) are device
copies, in ``parallel/collectives.py``.
"""

from .build import (
    KERNELS,
    build_all,
    launch,
    launch_counts,
    nvcc_command,
    reset_launch_counts,
)

__all__ = [
    "KERNELS",
    "build_all",
    "launch",
    "launch_counts",
    "nvcc_command",
    "reset_launch_counts",
]
