"""Batched edit sweeps: guidance-scale and seed grids as one batch, the
port of `parallel/sweep.py`.

The reference runs one edit per configuration. Here a grid of G points
rides the batch axis, as bench.py's `sweep` workload does (BASELINE
config 5): `xt` (and `zs`) repeat G times, the swept AttrFunc leaves hold
one value a sample, and one `edit_split` runs them all, each sample's
guidance gradient taken on its own (`AttrFunc.apply_batched`). Results are
(G, B, C, H, W), NCHW where the JAX package has (G, B, H, W, C).

With `mesh=` (a mesh with a `data` axis), each rank runs its share of the
grid, in rank order, and every rank receives the whole result (an
all-gather): the output is that of the run without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device
from ..core.schedule import Schedule
from ..engine.denoise import EpsFn, generate
from ..engine.edit import edit_split
from ..guidance.attr_functions import AttrFunc, DecodeFn
from .mesh import gather_leading_axis, shard_leading_axis


def sweep_attr_func(attr_func: AttrFunc, **grids) -> AttrFunc:
    """`attr_func` with the given leaves replaced by 1-D grids on the host:
    `sweep_attr_func(af, loss_scale=np.linspace(0, 20, 8))`. Floats become
    float32 (as the JAX package's `jnp.asarray`), integers int64."""
    def grid(v) -> torch.Tensor:
        a = np.asarray(v.detach().cpu() if torch.is_tensor(v) else v)
        if a.ndim != 1:
            raise ValueError(f"a sweep grid is 1-D, got shape {a.shape}")
        return torch.from_numpy(a.astype(np.float32) if a.dtype.kind == "f" else a)

    return dataclasses.replace(attr_func, **{k: grid(v) for k, v in grids.items()})


def _grid_size(attr_func: AttrFunc, swept_fields: Sequence[str]) -> int:
    sizes = {f: getattr(getattr(attr_func, f), "shape", (None,))[0] for f in swept_fields}
    if None in sizes.values() or len(set(sizes.values())) != 1:
        raise ValueError(f"swept fields need 1-D grids of one length, got {sizes} "
                         "(see sweep_attr_func)")
    return next(iter(sizes.values()))


def _per_point(a: Optional[torch.Tensor], b: int, g: int) -> Optional[torch.Tensor]:
    """A per-sample tensor (leading dim b > 1) repeated for g grid points;
    a shared one (batch 1, or None) as it is."""
    if a is None or b == 1 or a.shape[0] != b:
        return a
    return a.repeat((g,) + (1,) * (a.dim() - 1))


def guided_edit_sweep(
    sched: Schedule,
    eps_fn: EpsFn,
    xt: torch.Tensor,
    attr_func: AttrFunc,
    swept_fields: Sequence[str] = ("loss_scale",),
    eta: float = 0.0,
    zs: Optional[torch.Tensor] = None,
    decode_fn: Optional[DecodeFn] = None,
    mask: Optional[torch.Tensor] = None,
    x0_ref: Optional[torch.Tensor] = None,
    step_rule: str = "ddim",
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
) -> torch.Tensor:
    """The guided edit at every grid point of the swept AttrFunc fields.

    `attr_func` holds (G,) grids in `swept_fields` (see `sweep_attr_func`);
    the same xt (B, C, H, W) and zs (S, B, C, H, W) feed every point.
    Returns the (G, B, C, H, W) final latents."""
    g, b = _grid_size(attr_func, swept_fields), xt.shape[0]
    grids = {f: getattr(attr_func, f) for f in swept_fields}
    if mesh is not None:
        grids = shard_leading_axis(grids, mesh, axis)
    local = next(iter(grids.values())).shape[0]
    # Grid-major rows: sample j of point i is row i * b + j.
    af = dataclasses.replace(
        attr_func, **{f: v.repeat_interleave(b) for f, v in grids.items()})
    x = xt.repeat((local,) + (1,) * (xt.dim() - 1))
    z = None if zs is None else zs.repeat((1, local) + (1,) * (zs.dim() - 2))
    out = edit_split(sched, eps_fn, x, eta=eta, zs=z, attr_func=af, decode_fn=decode_fn,
                     mask=_per_point(mask, b, local), x0_ref=_per_point(x0_ref, b, local),
                     step_rule=step_rule).x0
    if mesh is not None:
        out = gather_leading_axis(out, mesh, axis)
    return out.reshape((g, b) + tuple(xt.shape[1:]))


def seed_draws(seed: int, latent_shape, num_steps: int, eta: float,
               device: torch.device):
    """xt and, when eta > 0, zs (num_steps, *latent_shape), drawn in that
    order from a generator on `device` seeded with `seed`."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    xt = torch.randn(tuple(latent_shape), generator=gen, device=device)
    zs = None
    if eta > 0:
        zs = torch.randn((num_steps,) + tuple(latent_shape), generator=gen, device=device)
    return xt, zs


def seed_sweep_generate(
    sched: Schedule,
    eps_fn: EpsFn,
    latent_shape,
    seeds: Sequence[int],
    eta: float = 0.0,
    mesh: Optional[DeviceMesh] = None,
    axis: str = "data",
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """One generation per seed, all seeds as one batch: each seed's noise
    is `seed_draws(seed, ...)` on `device` (CUDA unless the caller asks for
    the CPU). Returns (len(seeds), *latent_shape) final latents; with
    `mesh=`, each rank generates its share of the seeds."""
    device = resolve_device(device)
    seeds = [int(s) for s in seeds]
    if mesh is not None:
        seeds = shard_leading_axis(torch.tensor(seeds), mesh, axis).tolist()
    n = sched.num_inference_steps
    draws = [seed_draws(s, latent_shape, n, eta, device) for s in seeds]
    xt = torch.cat([d[0] for d in draws])
    zs = torch.cat([d[1] for d in draws], dim=1) if eta > 0 else None
    out = generate(sched, eps_fn, xt, eta=eta, zs=zs).x0
    if mesh is not None:
        out = gather_leading_axis(out, mesh, axis)
    return out.reshape((-1,) + tuple(latent_shape))
