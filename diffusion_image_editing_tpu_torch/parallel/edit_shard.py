"""The CFG-pair split of one edit over two ranks: the CFG half of the port
of `parallel/edit_shard.py`.

Classifier-free guidance is one batched-2 UNet call, [uncond; cond]
(`engine.denoise.CfgEpsClosure`). On a mesh with a `cfg` axis of size 2,
rank r runs the UNet on branch r only (0 the unconditional one), the two
eps are all-gathered, and every rank mixes them as `CfgEpsClosure` does.
The rest of the step (the scheduler's update, the decode and the guidance
gradient) runs whole on every rank, so the ranks stay equal. On a `cfg`
axis of size 1 the closure is `CfgEpsClosure`.

The JAX package also splits the latent's rows over an `sp` axis (GSPMD
partitions every conv, GroupNorm and attention): `ShardedEpsClosure`,
`SpatialEncodeClosure`, `SpatialDecodeClosure`, `spatial_shard`,
`shard_decode_fn`. For the port's hand-written kernels that needs a
distributed design of its own (halo rows, GroupNorm statistics reduced
across ranks, K/V gathered for attention): ROADMAP Queue A item 18b. A
mesh whose `sp` axis (or any axis but `cfg`) is larger than 1 raises.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from ..engine.denoise import CfgEpsClosure
from .mesh import all_gather_into, axis_group, make_mesh

SPATIAL_TODO = ("spatial sharding (an sp mesh axis, or any axis but cfg, larger than 1) is "
                "ROADMAP Queue A item 18b, not ported yet")


def check_cfg_mesh(mesh: DeviceMesh) -> int:
    """The size of the mesh's `cfg` axis (1 without one). Raises
    NotImplementedError naming item 18b when another axis is larger
    than 1, and ValueError for a `cfg` axis of another size than 1 or 2."""
    names = mesh.mesh_dim_names or ()
    sizes = dict(zip(names, mesh.shape))
    other = {n: s for n, s in sizes.items() if n != "cfg" and s > 1}
    if other:
        raise NotImplementedError(f"{SPATIAL_TODO}: mesh axes {other}")
    cfg = sizes.get("cfg", 1)
    if cfg not in (1, 2):
        raise ValueError(f"a cfg axis splits the [uncond; cond] pair: size 1 or 2, got {cfg}")
    return cfg


def cfg_mesh(cfg: int = 2, sp: int = 1) -> DeviceMesh:
    """A (cfg, sp) mesh over every rank of the default group; `sp` must be
    1 (item 18b), so the group has `cfg` ranks."""
    if sp != 1:
        raise NotImplementedError(f"{SPATIAL_TODO}: sp={sp}")
    if dist.is_initialized() and dist.get_world_size() != cfg * sp:
        raise ValueError(f"cfg_mesh(cfg={cfg}, sp={sp}) needs {cfg * sp} ranks, have "
                         f"{dist.get_world_size()}")
    mesh = make_mesh((cfg, sp), ("cfg", "sp"))
    check_cfg_mesh(mesh)
    return mesh


class ShardedCfgEpsClosure(CfgEpsClosure):
    """`CfgEpsClosure` with its pair split over the mesh's `cfg` axis:
    the same [uncond; cond] order and mix, each rank running one branch."""

    def __init__(self, unet: nn.Module, text_emb: torch.Tensor, cfg_scale: float = 3.5,
                 mesh: DeviceMesh = None):
        super().__init__(unet, text_emb, cfg_scale)
        self.mesh = mesh
        self.cfg = check_cfg_mesh(mesh)

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        if self.cfg == 1:
            return super().__call__(x, t)
        b = x.shape[0]
        r = self.mesh.get_local_rank("cfg")
        t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t, device=x.device)
        ctx = self.text_emb[r:r + 1].repeat_interleave(b, dim=0)
        with torch.no_grad():
            eps_r = self.unet(x, t, ctx).contiguous()
        eps = torch.empty((2 * b,) + tuple(eps_r.shape[1:]), dtype=eps_r.dtype,
                          device=eps_r.device)
        all_gather_into(eps, eps_r, axis_group(self.mesh["cfg"]))
        eps_uncond, eps_text = eps.chunk(2)
        return eps_uncond + self.cfg_scale * (eps_text - eps_uncond)


def make_sharded_cfg_eps_fn(unet: nn.Module, text_emb: torch.Tensor, cfg_scale: float,
                            mesh: DeviceMesh) -> ShardedCfgEpsClosure:
    return ShardedCfgEpsClosure(unet, text_emb, cfg_scale, mesh)
