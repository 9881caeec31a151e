"""Gradient-guidance attribute functions: the port of
`guidance/attr_functions.py`: colour, segmentation (face-parsing) and
attribute-classifier (anyGAN) guidance.

The nudge is -grad(loss_scale * loss(decode(pred_x0(x_t)))) * alpha_bar_t^2,
taken with `torch.autograd.grad` with respect to x_t only; eps is detached.
Images are NCHW, so a colour channel is `images[:, idx]`. `remat_decode`
runs the decode under a non-reentrant checkpoint, and `vjp_chunk` sets how
many samples of a batch share one decode and one gradient.

`loss_scale`, `t1`, `t2` and `lambda_` may be swept: a 1-D tensor (or
array) with one value per sample of the batch, as `parallel.sweep_attr_func`
makes them. `apply_batched` then gives each sample its own value, in its
loss and in its `t1 <= step_idx < t2` window; `apply` takes scalars only.
Swept values are read on the host, so keep them on the CPU.

In `apply_batched` each sample's loss is normalised over its own image, as
the reference edits images one by one. Where no leaf is swept, a chunk's
losses take one call on its n images (`sample_losses`: the built-in losses
have a row form, `loss_rows`, so the classifier runs once at batch n);
with swept leaves, one call a sample at its own values.

Tracing: a nudge (`apply`, or `apply_batched` over its chunks) runs in the
span `guidance.nudge`; inside it, the decode in `guidance.decode`, the loss
in `guidance.loss` (once a chunk, or with swept leaves once a sample) and
the gradient in `guidance.vjp`, whose backward, on autograd's thread, holds
the decoder's backward kernels. The counters `guidance.loss_samples.batched`
and `guidance.loss_samples.looped` count the samples whose loss took one
call for the chunk and one call of their own.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import schedule as S
from ..utils.logging import COUNTERS, span

DecodeFn = Callable[[torch.Tensor], torch.Tensor]  # latent -> image, differentiable
SWEEPABLE = ("loss_scale", "t1", "t2", "lambda_")  # leaves that may hold one value a sample


def l2_norm(x: torch.Tensor, y: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """sqrt of the summed squared error; with `rows`, each row's, (B,)."""
    err = (x - y) ** 2
    return torch.sqrt(err.flatten(1).sum(1) if rows else torch.sum(err))


def single_color_loss(images: torch.Tensor, idx: int, target,
                      rows: bool = False) -> torch.Tensor:
    """Mean absolute error of channel `idx` against `target`, in f32; with
    `rows`, each image's over its own pixels, (B,)."""
    err = torch.abs(images[:, idx].float() - target)
    return err.mean(dim=(1, 2)) if rows else torch.mean(err)


def color_loss(images: torch.Tensor, r, g, b, rows: bool = False) -> torch.Tensor:
    """Target-weighted per-channel MAE; with `rows`, each image's, (B,)."""
    return (single_color_loss(images, 0, r, rows) * r + single_color_loss(images, 1, g, rows) * g
            + single_color_loss(images, 2, b, rows) * b)


@dataclasses.dataclass(frozen=True)
class AttrFunc:
    """Base guidance strategy. The nudge applies on steps t1 <= idx < t2
    (and idx % stride == 0); other steps cost nothing."""

    loss_scale: float = 1.0
    t1: int = 0
    t2: int = 50
    lambda_: float = 0.01
    nudge_xt: bool = True
    nudge_zt: bool = False
    use_mask: bool = False
    mask_attr_grad: bool = False
    mask_pred_original_sample: bool = False
    metric: Optional[str] = None  # "l2" | "lpips"
    # (a, b) -> (B,) distances, e.g. `evals.make_lpips_fn(LPIPS(...))`
    metric_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None
    # The decode in the gradient under a checkpoint: its activations are not
    # kept, and its forward runs again in the backward.
    remat_decode: bool = False
    # Samples of a batch that `apply_batched` takes through one decode and
    # one gradient (1: one at a time).
    vjp_chunk: int = 1
    stride: int = 1

    @property
    def name(self) -> str:
        return type(self).__name__

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def loss_rows(self, decoded: torch.Tensor) -> torch.Tensor:
        """Each image's own `loss`, (B,), for a loss with a row form (each
        row a function of its own image alone). The base class has none:
        `sample_losses` then calls `calculate_loss` once a sample."""
        raise NotImplementedError

    def _metric(self, a: torch.Tensor, b: torch.Tensor, rows: bool = False) -> torch.Tensor:
        """The background distance of `a` from `b`; with `rows`, each row's
        from its row (or the shared one) of `b`, (B,)."""
        if self.metric == "l2":
            return l2_norm(a, b, rows)
        if self.metric == "lpips" and self.metric_fn is None:
            raise ValueError("lpips metric requires metric_fn")
        if self.metric_fn is not None:
            if rows:
                return self.metric_fn(a, b.expand_as(a)).reshape(a.shape[0], -1).sum(1)
            return torch.sum(self.metric_fn(a, b))
        raise ValueError("No metric specified")

    def calculate_loss(self, decoded: torch.Tensor, mask: Optional[torch.Tensor],
                       x0: Optional[torch.Tensor]) -> torch.Tensor:
        """Masked region loss + lambda * background-preservation term."""
        if self.mask_pred_original_sample:
            if mask is None or x0 is None:
                raise ValueError("mask_pred_original_sample requires mask and x0")
            bg = 1.0 - mask
            return self.loss(mask * decoded) + self.lambda_ * self._metric(bg * decoded, bg * x0)
        return self.loss(decoded)

    def sample_losses(self, decoded: torch.Tensor, mask: Optional[torch.Tensor],
                      x0: Optional[torch.Tensor]) -> torch.Tensor:
        """Each of the n images' own `calculate_loss` (with its own rows of
        `mask` and `x0` where they have one a sample), (n,): in one call of
        `loss_rows` where the loss has a row form, else one
        `calculate_loss` a sample."""
        n = decoded.shape[0]
        if type(self).loss_rows is AttrFunc.loss_rows:
            return torch.stack([self.calculate_loss(decoded[i:i + 1],
                                                    _rows(mask, slice(i, i + 1), n),
                                                    _rows(x0, slice(i, i + 1), n))
                                for i in range(n)])
        if not self.mask_pred_original_sample:
            return self.loss_rows(decoded)
        if mask is None or x0 is None:
            raise ValueError("mask_pred_original_sample requires mask and x0")
        bg = 1.0 - mask
        return (self.loss_rows(mask * decoded)
                + self.lambda_ * self._metric(bg * decoded, bg * x0, rows=True))

    def in_window(self, step_idx: int) -> bool:
        inside = self.t1 <= step_idx < self.t2
        return inside and (self.stride <= 1 or step_idx % self.stride == 0)

    def apply(
        self,
        xt: torch.Tensor,
        zt: Optional[torch.Tensor],
        eps: torch.Tensor,
        t: int,
        step_idx: int,
        sched: S.Schedule,
        decode_fn: DecodeFn,
        mask: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One guidance nudge: pred-x0 from x_t (eps detached), decode WITH
        gradient, nudge by -grad(scale * loss) * alpha_bar_t^2. The loss
        takes the batch as a whole."""
        swept = self.swept_fields()
        if swept:
            raise ValueError(f"apply takes scalar {swept}; an AttrFunc with one value a "
                             "sample runs through apply_batched")
        with span("guidance.nudge"):
            return self._nudge(xt, zt, eps, t, step_idx, sched, decode_fn, mask, x0,
                               per_sample=False)

    def swept_fields(self, batch: Optional[int] = None) -> Tuple[str, ...]:
        """The leaves of `SWEEPABLE` that hold one value a sample (any 1-D
        leaf, or with `batch` given, those of that length)."""
        return tuple(f for f in SWEEPABLE if getattr(getattr(self, f), "ndim", 0) >= 1
                     and (batch is None or getattr(self, f).shape[0] == batch))

    def _per_sample_funcs(self, n: int) -> list:
        """One AttrFunc a sample of an n-sample batch, with scalar leaves:
        each swept leaf's value for that sample, read on the host."""
        swept = self.swept_fields()
        if not swept:
            return [self] * n
        bad = [f for f in swept if getattr(self, f).shape[0] != n]
        if bad:
            raise ValueError(f"swept {bad} have {[getattr(self, f).shape[0] for f in bad]} "
                             f"values for a batch of {n}")
        values = {f: _host_values(getattr(self, f)) for f in swept}
        return [dataclasses.replace(self, **{f: v[i] for f, v in values.items()})
                for i in range(n)]

    def _nudge(self, xt, zt, eps, t, step_idx, sched, decode_fn, mask, x0,
               per_sample: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The nudge of `apply`. With `per_sample`, the objective is the sum
        over the batch of each sample's own loss times its own `loss_scale`
        (its own rows of `mask` and `x0` where they have one per sample, its
        own `lambda_`), so that a batch of k through one decode takes each
        sample's gradient at its own strength; a sample outside its own
        window adds nothing to the objective and its nudge is 0."""
        if self.mask_attr_grad and mask is None:
            raise ValueError("mask_attr_grad requires a mask")
        n = xt.shape[0]
        funcs = self._per_sample_funcs(n) if per_sample else [self]
        inside = [f.in_window(int(step_idx)) for f in funcs]
        if not any(inside):
            return xt, zt
        a_t = S.bcast(S.alpha_bar(sched, t), xt)
        eps_sg = eps.detach()
        m = mask if self.use_mask else None
        with torch.enable_grad():
            x = xt.detach().requires_grad_(True)
            px0 = (x - torch.sqrt(1.0 - a_t) * eps_sg) / torch.sqrt(a_t)
            with span("guidance.decode"):
                if self.remat_decode:
                    decoded = checkpoint(decode_fn, px0, use_reentrant=False)
                else:
                    decoded = decode_fn(px0)
            if not per_sample:
                loss = _traced_loss(self, decoded, m, x0) * self.loss_scale
            elif funcs[0] is self:  # no leaf swept: one scale and window for the chunk
                with span("guidance.loss"):
                    loss = self.loss_scale * self.sample_losses(decoded, m, x0).sum()
                COUNTERS["guidance.loss_samples.batched"] += n
            else:
                # Each sample's loss times its own scale, one call a sample: a
                # vector of the scales would be a host-to-device copy a step.
                loss = sum(_traced_loss(f, decoded[i:i + 1], _rows(m, slice(i, i + 1), n),
                                        _rows(x0, slice(i, i + 1), n)) * f.loss_scale
                           for i, f in enumerate(funcs) if inside[i])
                COUNTERS["guidance.loss_samples.looped"] += sum(inside)
            with span("guidance.vjp"):
                (grad,) = torch.autograd.grad(loss, x)
        attr_grad = -grad
        if self.mask_attr_grad:
            attr_grad = mask * attr_grad
        nudge = attr_grad * a_t**2
        if not all(inside):
            keep = torch.tensor(inside, device=xt.device).reshape((n,) + (1,) * (xt.dim() - 1))
            nudge = torch.where(keep, nudge, torch.zeros_like(nudge))
        if self.nudge_xt:
            xt = xt + nudge
        if self.nudge_zt and zt is not None:
            zt = zt + nudge
        return xt, zt

    def apply_batched(
        self,
        xt: torch.Tensor,
        zt: Optional[torch.Tensor],
        eps: torch.Tensor,
        t: int,
        step_idx: int,
        sched: S.Schedule,
        decode_fn: DecodeFn,
        mask: Optional[torch.Tensor] = None,
        x0: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """`apply` for batch >= 2 with each image's loss normalised on its
        own (the reference edits images one by one; a loss over the batch
        would divide the colour losses' means, and the guidance, by the
        batch), `vjp_chunk` samples at a time: each chunk runs one decode and
        one gradient of the sum of its samples' losses. Only one chunk's
        decoder backward is live at a time. Per-sample `mask`/`x0` (leading
        dim == batch) go with their sample; batch-1 ones are shared. Swept
        leaves (`SWEEPABLE` with leading dim == batch) go with their sample
        too: each chunk takes its rows of them."""
        b = xt.shape[0]
        swept = self.swept_fields(b)
        if b == 1 and not swept:
            return self.apply(xt, zt, eps, t, step_idx, sched, decode_fn, mask=mask, x0=x0)
        chunk = max(1, min(int(self.vjp_chunk), b))
        xs, zs = [], []
        with span("guidance.nudge"):
            for s in range(0, b, chunk):
                rows = slice(s, s + chunk)
                af = dataclasses.replace(self, **{f: getattr(self, f)[rows] for f in swept})
                xn, zn = af._nudge(xt[rows], None if zt is None else zt[rows], eps[rows], t,
                                   step_idx, sched, decode_fn, _rows(mask, rows, b),
                                   _rows(x0, rows, b), per_sample=True)
                xs.append(xn)
                zs.append(zn)
            return torch.cat(xs), (None if zt is None else torch.cat(zs))


def _traced_loss(f: AttrFunc, decoded: torch.Tensor, mask: Optional[torch.Tensor],
                 x0: Optional[torch.Tensor]) -> torch.Tensor:
    """`f.calculate_loss` in the tracer's span `guidance.loss`."""
    with span("guidance.loss"):
        return f.calculate_loss(decoded, mask, x0)


def _host_values(leaf) -> list:
    """A swept leaf's values as Python numbers."""
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().tolist()
    return np.asarray(leaf).tolist()


def _rows(a: Optional[torch.Tensor], rows: slice, b: int) -> Optional[torch.Tensor]:
    """The batch's `rows` of a per-sample tensor (leading dim `b`); a shared
    one (or None) as it is."""
    return a[rows] if a is not None and a.shape[0] == b else a


@dataclasses.dataclass(frozen=True)
class SingleColorAttrFunc(AttrFunc):
    """One-channel colour guidance."""

    target: float = 0.5
    color_idx: int = 0

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        return single_color_loss(decoded, self.color_idx, self.target)

    def loss_rows(self, decoded: torch.Tensor) -> torch.Tensor:
        return single_color_loss(decoded, self.color_idx, self.target, rows=True)


@dataclasses.dataclass(frozen=True)
class MultiColorAttrFunc(AttrFunc):
    """RGB colour guidance."""

    r_target: float = 0.0
    g_target: float = 0.0
    b_target: float = 0.0

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        return color_loss(decoded, self.r_target, self.g_target, self.b_target)

    def loss_rows(self, decoded: torch.Tensor) -> torch.Tensor:
        return color_loss(decoded, self.r_target, self.g_target, self.b_target, rows=True)


@dataclasses.dataclass(frozen=True)
class NetAttrFunc(AttrFunc):
    """Face-parsing (BiSeNet) guidance: the softmax probability mass of the
    classes `idx_for_class`, each the mean over H and W of one image, summed
    over the classes and the batch.

    `seg_apply_fn` maps an NCHW image (the decoded one, in [-1, 1]) to NCHW
    logits (B, n_classes, H, W), differentiably, with the segmentation
    network's parameters inside it, e.g. `lambda img: seg.logits_fn(
    imagenet_normalize(to_unit_range(img.float())))` for a
    `SegmentationModel` `seg`. (The JAX package passes `seg_params` beside
    it.) Without it, `loss` raises."""

    seg_apply_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    idx_for_class: Tuple[int, ...] = (17,)

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        return self.loss_rows(decoded).sum()

    def loss_rows(self, decoded: torch.Tensor) -> torch.Tensor:
        """Each image's mass of the classes, (B,)."""
        if self.seg_apply_fn is None:
            raise ValueError("NetAttrFunc needs seg_apply_fn, a callable from an NCHW image "
                             "to NCHW segmentation logits")
        probs = torch.softmax(self.seg_apply_fn(decoded).float(), dim=1)
        class_mass = probs.mean(dim=(2, 3))  # (B, n_classes)
        return class_mass[:, list(self.idx_for_class)].sum(1)


@dataclasses.dataclass(frozen=True)
class ClassifierAttrFunc(AttrFunc):
    """Attribute-classifier (anyGAN ResNet-50) guidance: the logits
    reshaped (B, 40, 2), the logit [idx_for_class][idx_of_interest] of each
    image summed over the batch (each row depends on its own image, so the
    gradient stays per sample), plus, with `regularize_idx`, the quadratic
    term sum((logit[regularize_idx][regularize_pred_idx] +
    regularize_score[regularize_pred_idx]) ** 2).

    `clf_apply_fn` maps the decoded NCHW image in [-1, 1] to (B, 80) logits,
    differentiably, with the classifier's parameters inside it, e.g.
    `lambda img: clf(imagenet_normalize(to_unit_range(img.float())))` for
    the module of `get_pretrained_anygan`. (The JAX package passes
    `clf_params` beside it.) Without it, `loss` raises."""

    clf_apply_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    idx_for_class: int = 0
    idx_of_interest: int = 0
    regularize_idx: Optional[int] = None
    regularize_pred_idx: Optional[int] = None
    regularize_score: Optional[Tuple[float, float]] = None

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        return self.loss_rows(decoded).sum()

    def loss_rows(self, decoded: torch.Tensor) -> torch.Tensor:
        """Each image's logit and regulariser term, (B,)."""
        if self.clf_apply_fn is None:
            raise ValueError("ClassifierAttrFunc needs clf_apply_fn, a callable from an NCHW "
                             "image to (B, 80) attribute logits")
        logits = self.clf_apply_fn(decoded).float().reshape(-1, 40, 2)
        value = logits[:, self.idx_for_class, self.idx_of_interest]
        if self.regularize_idx is not None:
            other = logits[:, self.regularize_idx, self.regularize_pred_idx]
            score = self.regularize_score[self.regularize_pred_idx]
            value = value + (other + score) ** 2
        return value


# The reference's other name for it.
AnyGANAttrFunc = ClassifierAttrFunc
