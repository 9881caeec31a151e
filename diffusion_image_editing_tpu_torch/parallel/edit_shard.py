"""One edit split over a mesh of ranks: the port of `parallel/edit_shard.py`.

* **The CFG pair** (`cfg` axis, size 2). Classifier-free guidance is one
  batched-2 UNet call, [uncond; cond] (`engine.denoise.CfgEpsClosure`);
  rank r of the `cfg` axis runs branch r only (0 the unconditional one),
  the two eps are all-gathered and every rank mixes them.
* **The rows** (`sp` axis, or the whole mesh). The JAX package shards H by
  sharding constraints and GSPMD partitions every conv, GroupNorm and
  attention. The port's hand-written kernels have no partitioner, so the
  closures scatter the latent's rows, run the model under
  `ops.split.spatial_split` (halo rows for the convs, GroupNorm
  moments folded over the ranks, K/V gathered for self-attention) and
  gather the result: whole tensors in and out, the same on every rank.
  The UNet's rows split over `sp` (`ShardedCfgEpsClosure`) or over the
  whole mesh when there is no pair (`ShardedEpsClosure`); the codec's over
  the whole mesh (`SpatialEncodeClosure`, `SpatialDecodeClosure`), `cfg`
  included, since the decode runs on a batch-1 latent.

The decode ends in an all-gather, and its gradient with respect to the
latent in another (each rank's rows of it), so every rank's latent update
reads the same bytes and the ranks cannot part, even where the guidance
loss's own backward is not deterministic. The rest of each step (the
scheduler's update) runs whole on every rank.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from ..engine.denoise import CfgEpsClosure, DecodeClosure
from ..ops.split import (SpatialSplit, gather_rows, scatter_rows, spatial_split, split_of,
                         spread_over)
from .mesh import all_gather_into, axis_group, make_mesh

Axes = Union[None, str, Sequence[str]]


def mesh_axes(mesh: DeviceMesh) -> Dict[str, int]:
    """{axis name: size} of a mesh, in its order."""
    return dict(zip(mesh.mesh_dim_names or (), mesh.shape))


def _mesh_name(mesh: DeviceMesh) -> str:
    return "x".join(f"{n}{s}" for n, s in mesh_axes(mesh).items())


def check_cfg_mesh(mesh: DeviceMesh) -> int:
    """The size of the mesh's `cfg` axis (1 without one) for a CFG call.
    As the JAX package's `P("cfg", "sp")`, a mesh that splits anything
    needs a `cfg` axis, and only `cfg` and `sp` may be larger than 1:
    ValueError naming the mesh otherwise, and for a `cfg` axis of another
    size than 1 or 2."""
    sizes = mesh_axes(mesh)
    split = {n: s for n, s in sizes.items() if s > 1}
    if split and "cfg" not in sizes:
        raise ValueError(f"a CFG call splits its pair over a cfg axis: mesh {_mesh_name(mesh)} "
                         "has none (an unconditional call splits its rows over any mesh)")
    other = {n: s for n, s in split.items() if n not in ("cfg", "sp")}
    if other:
        raise ValueError(f"a CFG call splits over the cfg and sp axes only: mesh "
                         f"{_mesh_name(mesh)} also has {other}")
    cfg = sizes.get("cfg", 1)
    if cfg not in (1, 2):
        raise ValueError(f"a cfg axis splits the [uncond; cond] pair: size 1 or 2, got {cfg}")
    return cfg


def cfg_mesh(cfg: int = 2, sp: Optional[int] = None) -> DeviceMesh:
    """A (cfg, sp) mesh over every rank of the default group, `cfg` major;
    `sp` defaults to the ranks left over."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if sp is None:
        sp = max(world // cfg, 1)
    if world != cfg * sp:
        raise ValueError(f"cfg_mesh(cfg={cfg}, sp={sp}) needs {cfg * sp} ranks, have {world}")
    mesh = make_mesh((cfg, sp), ("cfg", "sp"))
    check_cfg_mesh(mesh)
    return mesh


_SPLITS: Dict[Tuple[DeviceMesh, Tuple[str, ...]], Optional[SpatialSplit]] = {}


def spatial_shard(mesh: DeviceMesh, axis: Axes = "sp") -> Optional[SpatialSplit]:
    """The split of the rows over mesh axis `axis` (a name, a tuple of names
    in mesh order, or None for the whole mesh): the port's counterpart of
    the JAX package's per-stage constraint, entered with
    `ops.split.spatial_split`. None when the axes hold one rank.
    The first call for a set of axes may make a process group, which every
    rank must do together."""
    names = tuple(mesh.mesh_dim_names or ())
    axes = names if axis is None else ((axis,) if isinstance(axis, str) else tuple(axis))
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh {_mesh_name(mesh)} has no axis {missing}")
    key = (mesh, axes)
    if key not in _SPLITS:
        if axes == names:
            _SPLITS[key] = split_of(mesh.mesh.flatten().tolist())
        elif len(axes) == 1:
            _SPLITS[key] = SpatialSplit(mesh[axes[0]].get_group()) if mesh[axes[0]].size() > 1 \
                else None
        else:
            raise ValueError(f"the rows split over one axis or the whole mesh, not {axes}")
    return _SPLITS[key]


def _t(t, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(t) if not torch.is_tensor(t) else t, device=device)


class ShardedCfgEpsClosure(CfgEpsClosure):
    """`CfgEpsClosure` split over the mesh: the pair over `cfg` (each rank
    runs one branch) and the rows over `sp`; the same [uncond; cond] order
    and mix. The eps rows are gathered within `sp`, then the pair over
    `cfg`. With the pair split, a tensor of the call lies on every rank of
    the mesh (`ops.split.spread_over`: an int8 conv's scale is the max over
    them all, as over the whole batch)."""

    def __init__(self, unet: nn.Module, text_emb: torch.Tensor, cfg_scale: float = 3.5,
                 mesh: DeviceMesh = None):
        super().__init__(unet, text_emb, cfg_scale)
        self.mesh = mesh
        self.cfg = check_cfg_mesh(mesh)
        self.split = spatial_shard(mesh, "sp") if "sp" in mesh_axes(mesh) else None
        self.spread = spatial_shard(mesh, None) if self.cfg == 2 else None

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        if self.cfg == 1 and self.split is None:
            return super().__call__(x, t)
        if self.cfg == 2:
            b = x.shape[0]
            r = self.mesh.get_local_rank("cfg")
            x_in, t_in = x, _t(t, x.device)
            ctx = self.text_emb[r:r + 1].repeat_interleave(b, dim=0)
        else:
            x_in, t_in, ctx = self._pair(x, t)
        with torch.no_grad():
            rows = scatter_rows(x_in, self.split)
            with spatial_split(self.split), spread_over(self.spread):
                eps_r = self.unet(rows, t_in, ctx)
            eps_r = gather_rows(eps_r, self.split).contiguous()
        if self.cfg == 1:
            return self._mix(eps_r)
        eps = torch.empty((2 * eps_r.shape[0],) + tuple(eps_r.shape[1:]), dtype=eps_r.dtype,
                          device=eps_r.device)
        all_gather_into(eps, eps_r, axis_group(self.mesh["cfg"]))
        return self._mix(eps)


class ShardedEpsClosure:
    """An unconditional denoiser (no pair) with the rows over mesh `axes`
    (the whole mesh by default): `EpsClosure`'s eps = unet(x, t)."""

    def __init__(self, unet: nn.Module, mesh: DeviceMesh, axes: Axes = None):
        self.unet = unet
        self.mesh = mesh
        self.split = spatial_shard(mesh, axes)

    def __call__(self, x: torch.Tensor, t) -> torch.Tensor:
        with torch.no_grad():
            rows = scatter_rows(x, self.split)
            with spatial_split(self.split):
                eps = self.unet(rows, t)
            return gather_rows(eps, self.split)


class SpatialEncodeClosure:
    """Image -> latent, `EncodeClosure`'s encode(x) * scale, with the rows
    over mesh `axes` (the whole mesh by default); `vae=None` is the
    identity codec."""

    def __init__(self, vae: Optional[nn.Module] = None, scale: float = 1.0,
                 mesh: DeviceMesh = None, axes: Axes = None):
        self.vae, self.scale, self.mesh = vae, scale, mesh
        self.split = spatial_shard(mesh, axes)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.vae is None:
            return x
        with torch.no_grad():
            rows = scatter_rows(x, self.split)
            with spatial_split(self.split):
                z = self.vae.encode(rows) * self.scale
            return gather_rows(z, self.split)


class SpatialDecodeClosure:
    """Latent -> image, `DecodeClosure`'s decode(z / scale), with the rows
    over mesh `axes` (the whole mesh by default), forward and gradient;
    `remat=True` checkpoints the decoder's blocks, which recompute under
    the same split. `vae=None` is the identity codec: its rows still go out
    and back, so that its gradient too is assembled from every rank's rows
    by one all-gather (the same bytes on every rank, whatever the guidance
    loss computes on each)."""

    def __init__(self, vae: Optional[nn.Module] = None, scale: float = 1.0,
                 mesh: DeviceMesh = None, axes: Axes = None, remat: bool = False):
        self.vae, self.scale, self.mesh, self.remat = vae, scale, mesh, remat
        self.split = spatial_shard(mesh, axes)

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        rows = scatter_rows(z, self.split)
        if self.vae is None:
            return gather_rows(rows, self.split)
        with spatial_split(self.split):
            out = self.vae.decode(rows / self.scale, remat=self.remat)
        return gather_rows(out, self.split)


def make_sharded_cfg_eps_fn(unet: nn.Module, text_emb: torch.Tensor, cfg_scale: float,
                            mesh: DeviceMesh) -> ShardedCfgEpsClosure:
    return ShardedCfgEpsClosure(unet, text_emb, cfg_scale, mesh)


def shard_decode_fn(decode_fn: DecodeClosure, mesh: DeviceMesh,
                    axes: Axes = "sp") -> SpatialDecodeClosure:
    """A wrapper's `DecodeClosure` on the mesh (the same module, scale and
    remat), its rows over `axes`: pass None (the whole mesh) on a cfg x sp
    mesh, so that the batch-1 decode and its gradient split over every rank.
    Every decoder stage runs split (the JAX package threads
    `spatial_shard` into the decoder for that; here the split is the call's
    context)."""
    return SpatialDecodeClosure(decode_fn.vae, decode_fn.scale, mesh, axes, decode_fn.remat)
