"""The spatial split of one call: the rows of every NCHW activation over a
process group, the port's counterpart of the JAX package's `sp` sharding
(GSPMD partitions the convs, GroupNorms and attention there). It sits
below the layers that read it and imports nothing else of the package:
`parallel.edit_shard`'s closures build on it.

A `SpatialSplit` holds the ranks that share the rows, in mesh order (`cfg`
major, `sp` minor, as JAX's `P(None, ("cfg", "sp"))`): rank i of the group
holds rows [i * H / n, (i + 1) * H / n) of every activation. A closure
enters `with spatial_split(split):` for its call, and the layers below read
`current()`:

* a 3x3 conv (`ops.conv`, every conv mode) and a stride-2 conv
  (`models.layers.Downsample2D`) take their neighbours' edge rows
  (`halo_rows`, zeros at the global edges); an int8 conv's per-tensor
  scale is the max over the ranks (`all_reduce_max`): over `tensor_ranks()`,
  the split's ranks, or every rank of the mesh where the CFG pair too is
  split over ranks (`spread_over`), since a tensor of the call is then
  spread over both;
* the fused GroupNorm+SiLU -> conv (`ops.fused_conv`, K7) folds the
  ranks' per-channel moments (`combine_moments`) into its (A, B) and takes
  its neighbours' raw edge rows, which it activates itself;
* GroupNorm (`ops.groupnorm`) folds the ranks' moments (`combine_moments`)
  between K5 and K6 and sums its backward's per-group terms over them;
* self-attention gathers K and V along the tokens (`gather_sum`: the
  backward adds every rank's partial dK and dV and keeps the rank's own).

At the boundary the closures take and return whole tensors, the same on
every rank: `scatter_rows` keeps the rank's rows (its backward gathers the
gradient's rows), `gather_rows` all-gathers them (its backward keeps the
rank's slice without summing, because all that follows is replicated: a
sum would multiply the gradient by the ranks). The gathered result, and
the gathered gradient, are the same bytes on every rank.

Rows must split evenly at every stage: a stage whose rows do not divide
by the group raises ValueError naming it (GSPMD pads such stages).
Weights' gradients under a split are each rank's share, not summed: the
split serves the guidance gradient with respect to the latent.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist


def _through_host(t: torch.Tensor, group: dist.ProcessGroup) -> bool:
    """A CUDA tensor in a gloo group goes through a host copy: gloo's CUDA
    collectives are not all there (several processes sharing one card run
    the split over gloo). The kernels still run on the card."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group: dist.ProcessGroup) -> None:
    """`out` = the group's `x`s concatenated on the leading axis in rank
    order (`all_gather_single` where torch has it, else its older name)."""
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    if _through_host(x, group):
        host = torch.empty(out.shape, dtype=out.dtype)
        gather(host, x.cpu(), group=group)
        out.copy_(host)
        return
    gather(out, x, group=group)


def _all_reduce(x: torch.Tensor, group: dist.ProcessGroup, op) -> torch.Tensor:
    if _through_host(x, group):
        host = x.cpu().clone()
        dist.all_reduce(host, op=op, group=group)
        return host.to(x.device)
    out = x.clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def all_reduce_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The sum of `x` over the group's ranks, a new tensor on every rank."""
    return _all_reduce(x, group, dist.ReduceOp.SUM)


def all_reduce_max(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """The elementwise max of `x` over the group's ranks, the same bits on
    every rank (an int8 conv's per-tensor scale)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)


class SpatialSplit:
    """The ranks that share the rows: `group`, this rank's `index` in it,
    and its `size`."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)

    def __repr__(self) -> str:
        return f"SpatialSplit(rank {self.index} of {self.size})"

    def rows(self, n: int, what: str = "rows") -> slice:
        """This rank's share of `n` rows; ValueError when they do not split."""
        if n % self.size:
            raise ValueError(f"{what}: {n} rows do not split over {self.size} ranks (the "
                             "spatial split needs every stage's rows to divide by its ranks)")
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


_CURRENT: Optional[SpatialSplit] = None
_SPREAD: Optional[SpatialSplit] = None


def current() -> Optional[SpatialSplit]:
    """The split of the call in progress, or None (a whole call)."""
    return _CURRENT


def tensor_ranks() -> Optional[SpatialSplit]:
    """The ranks that one tensor of the call in progress lies on: those of
    `spread_over` where the batch too is split, else the split's (None for
    a whole call). Per-tensor statistics reduce over them."""
    return _SPREAD if _SPREAD is not None else _CURRENT


@contextlib.contextmanager
def spread_over(ranks: Optional[SpatialSplit]):
    """Run the body with each tensor spread over `ranks` (the CFG pair's
    ranks times the split's), beside the rows' split."""
    global _SPREAD
    prev = _SPREAD
    _SPREAD = ranks if ranks is not None and ranks.size > 1 else None
    try:
        yield
    finally:
        _SPREAD = prev


@contextlib.contextmanager
def spatial_split(split: Optional[SpatialSplit]):
    """Run the body with the rows split over `split` (None, or a group of
    one rank, runs it whole)."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = split if split is not None and split.size > 1 else None
    try:
        yield
    finally:
        _CURRENT = prev


def recompute_context():
    """`context_fn` for a non-reentrant `torch.utils.checkpoint`: the
    recomputation in the backward runs under the split of the forward."""
    return contextlib.nullcontext(), spatial_split(current())


def _gather(x: torch.Tensor, split: SpatialSplit, dim: int) -> torch.Tensor:
    """Every rank's `x` concatenated along `dim` in rank order."""
    x = x.contiguous()
    out = torch.empty((split.size,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    all_gather_into(out.view((split.size * x.shape[0],) + tuple(x.shape[1:])), x, split.group)
    return torch.cat(out.unbind(0), dim=dim)


def _slice(x: torch.Tensor, split: SpatialSplit, dim: int) -> torch.Tensor:
    return x.narrow(dim, split.index * (x.shape[dim] // split.size),
                    x.shape[dim] // split.size).contiguous()


class _ScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim = split, dim
        split.rows(x.shape[dim], f"input of {tuple(x.shape)}")
        return _slice(x, split, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.split, ctx.dim), None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim = split, dim
        return _gather(x, split, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.split, ctx.dim), None, None


class _GatherSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split, dim):
        ctx.split, ctx.dim = split, dim
        return _gather(x, split, dim)

    @staticmethod
    def backward(ctx, g):
        total = all_reduce_sum(g.float(), ctx.split.group)
        return _slice(total, ctx.split, ctx.dim).to(g.dtype), None, None


def scatter_rows(x: torch.Tensor, split: Optional[SpatialSplit], dim: int = 2) -> torch.Tensor:
    """This rank's rows of a whole tensor (the same on every rank)."""
    if split is None or split.size == 1:
        return x
    return _ScatterRows.apply(x, split, dim)


def gather_rows(x: torch.Tensor, split: Optional[SpatialSplit], dim: int = 2) -> torch.Tensor:
    """The whole tensor from every rank's rows, the same bytes on every rank."""
    if split is None or split.size == 1:
        return x
    return _GatherRows.apply(x, split, dim)


def gather_sum(x: torch.Tensor, split: SpatialSplit, dim: int = 1) -> torch.Tensor:
    """Every rank's `x` along `dim` (self-attention's K and V along the
    tokens); the backward sums the ranks' gradients (in f32) and keeps the
    rank's slice."""
    return _GatherSum.apply(x, split, dim)


class _HaloRows(torch.autograd.Function):
    """x (N, C, h, W) -> the rows [`above` of the rank before; x; `below` of
    the rank after], zeros where there is no such rank."""

    @staticmethod
    def forward(ctx, x, split, above, below):
        ctx.split, ctx.above, ctx.below = split, above, below
        h = x.shape[2]
        edges = _gather(torch.stack([x[:, :, 0], x[:, :, h - 1]]), split, 0)  # (2R, N, C, W)
        r, last = split.index, split.size - 1
        parts = []
        if above:
            row = edges[2 * r - 1] if r > 0 else torch.zeros_like(edges[0])
            parts.append(row[:, :, None])
        parts.append(x)
        if below:
            row = edges[2 * r + 2] if r < last else torch.zeros_like(edges[0])
            parts.append(row[:, :, None])
        return torch.cat(parts, dim=2)

    @staticmethod
    def backward(ctx, g):
        split, above, below = ctx.split, ctx.above, ctx.below
        h = g.shape[2] - above - below
        dx = g[:, :, above:above + h].clone()
        zero = torch.zeros_like(g[:, :, 0])
        sent = torch.stack([g[:, :, 0] if above else zero,
                            g[:, :, above + h] if below else zero])
        sent = _gather(sent, split, 0)  # (2R, N, C, W): each rank's (above, below) gradients
        r, last = split.index, split.size - 1
        if below and r > 0:  # the rank before's `below` row is this rank's first
            dx[:, :, 0] += sent[2 * (r - 1) + 1]
        if above and r < last:  # the rank after's `above` row is this rank's last
            dx[:, :, h - 1] += sent[2 * (r + 1)]
        return dx, None, None, None


def halo_rows(x: torch.Tensor, split: SpatialSplit, above: int = 1,
              below: int = 1) -> torch.Tensor:
    """`x` with one row of each neighbour on the sides asked for (0 or 1)."""
    return _HaloRows.apply(x, split, int(above), int(below))


def combine_moments(mean: torch.Tensor, m2: torch.Tensor, count: int,
                    split: SpatialSplit) -> tuple:
    """The whole (mean, M2) from every rank's (mean, M2) over `count`
    values: one all-gather, then Chan's formula in rank order on every rank,
    so the ranks get the same bits."""
    both = _gather(torch.stack([mean.float(), m2.float()])[None], split, 0)  # (R, 2, ...)
    n = float(count)
    mean_t, m2_t = both[0, 0], both[0, 1]
    for r in range(1, split.size):
        mb, m2b = both[r, 0], both[r, 1]
        total = n + count
        d = mb - mean_t
        mean_t = (mean_t * n + mb * count) / total
        m2_t = m2_t + m2b + d * d * (n * count / total)
        n = total
    return mean_t, m2_t


def split_of(ranks: Sequence[int]) -> Optional[SpatialSplit]:
    """A split over the given global ranks (a group made on every rank of
    the default group, as `new_group` needs), or None for one rank."""
    ranks = [int(r) for r in ranks]
    if len(ranks) <= 1:
        return None
    if ranks == list(range(dist.get_world_size())):
        return SpatialSplit(dist.group.WORLD)
    return SpatialSplit(dist.new_group(ranks))
