"""Device mesh construction (counterpart of ``wavecap_tpu/parallel/mesh.py``).

Axes, as in the reference:
  stream : data-parallel over independent captures
  time   : sequence-parallel over sub-blocks of one wideband stream, with
           the halo exchange of the channelizer history

The port keeps the reference's single controller: one process holds the
mesh, a ``(stream, time)`` grid of devices, and each place of the grid is
a :class:`~.collectives.Shard` with a CUDA stream of its own.  The grid
may repeat one device (``WAVECAP_TORCH_DEVICE_COUNT``), as the
reference's tests repeat virtual CPU devices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.torchenv import DeviceLike, devices as all_devices
from .collectives import Shard


class Mesh:
    """A grid of devices with named axes and one shard (device + stream)
    per place."""

    def __init__(self, grid: np.ndarray, axis_names: tuple):
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D grid needs {grid.ndim} axis names")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shards = [[Shard.new(d) for d in row] for row in grid.reshape(grid.shape[0], -1)]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def device_grid(devs: list[torch.device], shape: tuple) -> np.ndarray:
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return grid.reshape(shape)


def make_mesh(n_streams: int = 1, n_time: int | None = None, device: DeviceLike = None) -> Mesh:
    """Build a ``(stream, time)`` mesh over the available devices
    (:func:`~..utils.torchenv.devices`)."""
    devs = all_devices(device)
    n = len(devs)
    if n_time is None:
        if n % n_streams != 0:
            raise ValueError(f"{n} devices not divisible by {n_streams} streams")
        n_time = n // n_streams
    if n_streams * n_time > n:
        raise ValueError(f"mesh {n_streams}x{n_time} needs {n_streams * n_time} devices, have {n}")
    return Mesh(device_grid(devs[: n_streams * n_time], (n_streams, n_time)), ("stream", "time"))
