"""Process groups and device meshes over `torch.distributed`: the port of
`parallel/mesh.py`.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named
dimensions, one rank per device: NCCL on CUDA, gloo on the CPU. Its
collectives are the backend's, called explicitly by the code that needs
them (the sweep's gather, the trainer's means, synced ABN's statistics,
the CFG pair's gather). `initialize_distributed` starts the default group
from the environment `torchrun` sets; a single process needs none.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.split import all_gather_into, all_reduce_sum

Group = Union[dist.ProcessGroup, DeviceMesh]


def initialize_distributed(device_type: str = "cuda", **kwargs) -> bool:
    """`init_process_group` from the environment `torchrun` sets (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT), with NCCL for `device_type`
    "cuda" and gloo for "cpu"; on CUDA each rank first takes the device
    LOCAL_RANK. A no-op when the group is up or when WORLD_SIZE is unset or
    1 (a single process). Returns whether a group of more than one rank is
    up."""
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        kwargs.setdefault("backend", "nccl" if device_type == "cuda" else "gloo")
        dist.init_process_group(**kwargs)
    return dist.is_initialized() and dist.get_world_size() > 1


def world_size() -> int:
    """The default group's ranks (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_first_rank() -> bool:
    """Rank 0 of the default group, or a single process: the one that
    writes a run's outputs."""
    return not dist.is_initialized() or dist.get_rank() == 0


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",)) -> DeviceMesh:
    """A mesh over every rank of the default group, named `axis_names`;
    by default a 1-D `data` mesh (the whole world on the first axis). Its
    devices are CUDA under NCCL, the CPU otherwise. Needs the group up
    (`initialize_distributed`, or `init_process_group`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialized: run under torchrun "
                           "and call initialize_distributed(), or init_process_group()")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes {tuple(axis_names)}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axis_names))


def axis_group(axis: Group) -> dist.ProcessGroup:
    """The process group of a group, or of a 1-D mesh (`mesh["dp"]`, a
    mesh dimension)."""
    return axis.get_group() if isinstance(axis, DeviceMesh) else axis


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh[axis].size()


def _rows(n: int, mesh: DeviceMesh, axis: str) -> slice:
    size, rank = axis_size(mesh, axis), mesh.get_local_rank(axis)
    if n % size:
        raise ValueError(f"{n} rows do not split over the {size} ranks of mesh axis {axis!r}")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def shard_leading_axis(x, mesh: DeviceMesh, axis: str = "data"):
    """This rank's share of the leading axis of a tensor (or of each tensor
    of a tuple, list or dict), split evenly over mesh axis `axis` in rank
    order."""
    if isinstance(x, (tuple, list)):
        return type(x)(shard_leading_axis(a, mesh, axis) for a in x)
    if isinstance(x, dict):
        return {k: shard_leading_axis(a, mesh, axis) for k, a in x.items()}
    return x[_rows(x.shape[0], mesh, axis)]


def gather_leading_axis(x: torch.Tensor, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """The inverse of `shard_leading_axis`: every rank's share of mesh axis
    `axis`, concatenated in rank order on every rank (an all-gather)."""
    size = axis_size(mesh, axis)
    if size == 1:
        return x
    x = x.contiguous()
    out = torch.empty((size * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    all_gather_into(out, x, axis_group(mesh[axis]))
    return out


def mean_over(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """Replace each tensor, in place, by its mean over the group's ranks
    (one all-reduce of the tensors packed together; floating tensors of
    one dtype and device)."""
    tensors = list(tensors)
    if not tensors:
        return
    group = axis_group(group)
    world = dist.get_world_size(group)
    flat = all_reduce_sum(torch.cat([t.reshape(-1) for t in tensors]), group)
    flat /= world
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
