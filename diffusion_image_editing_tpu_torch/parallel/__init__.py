"""Sweeps over one batch, device meshes over torch.distributed, and the
CFG-pair split of one edit: the port of `parallel/`. The spatial split
(`sp`) is ROADMAP Queue A item 18b."""

from .edit_shard import (  # noqa: F401
    ShardedCfgEpsClosure,
    cfg_mesh,
    check_cfg_mesh,
    make_sharded_cfg_eps_fn,
)
from .mesh import (  # noqa: F401
    axis_group,
    gather_leading_axis,
    initialize_distributed,
    make_mesh,
    mean_over,
    shard_leading_axis,
)
from .sweep import guided_edit_sweep, seed_sweep_generate, sweep_attr_func  # noqa: F401
