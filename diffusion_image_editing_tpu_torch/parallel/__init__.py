"""Sweeps over one batch, device meshes over torch.distributed, and one
edit split over a mesh (the CFG pair over `cfg`, the rows over `sp` or the
whole mesh): the port of `parallel/`."""

from .edit_shard import (  # noqa: F401
    ShardedCfgEpsClosure,
    ShardedEpsClosure,
    SpatialDecodeClosure,
    SpatialEncodeClosure,
    cfg_mesh,
    check_cfg_mesh,
    make_sharded_cfg_eps_fn,
    shard_decode_fn,
    spatial_shard,
)
from ..ops.split import SpatialSplit, spatial_split  # noqa: F401
from .mesh import (  # noqa: F401
    axis_group,
    gather_leading_axis,
    initialize_distributed,
    make_mesh,
    mean_over,
    shard_leading_axis,
)
from .sweep import guided_edit_sweep, seed_sweep_generate, sweep_attr_func  # noqa: F401
