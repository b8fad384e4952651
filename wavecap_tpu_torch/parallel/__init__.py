"""The multi-device mesh: the time-sharded channelizer and the
channel-sharded demod banks (counterpart of ``wavecap_tpu/parallel``)."""

from .collectives import (
    Shard,
    all_gather,
    all_to_all_tiled,
    copy_counts,
    ppermute,
    reset_copy_counts,
)
from .mesh import Mesh, make_mesh
from .sharded import (
    GridControl,
    GridState,
    ShardedGridConfig,
    control_init,
    grid_init,
    sharded_grid_step,
)

__all__ = [
    "GridControl",
    "GridState",
    "Mesh",
    "Shard",
    "ShardedGridConfig",
    "all_gather",
    "all_to_all_tiled",
    "control_init",
    "copy_counts",
    "grid_init",
    "make_mesh",
    "ppermute",
    "reset_copy_counts",
    "sharded_grid_step",
]
