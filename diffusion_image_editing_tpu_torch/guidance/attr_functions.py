"""Gradient-guidance attribute functions: the port of
`guidance/attr_functions.py`: colour, segmentation (face-parsing) and
attribute-classifier (anyGAN) guidance.

The nudge is -grad(loss_scale * loss(decode(pred_x0(x_t)))) * alpha_bar_t^2,
taken with `torch.autograd.grad` with respect to x_t only; eps is detached.
Images are NCHW, so a colour channel is `images[:, idx]`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from ..core import schedule as S

DecodeFn = Callable[[torch.Tensor], torch.Tensor]  # latent -> image, differentiable


def l2_norm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """sqrt of the summed squared error."""
    return torch.sqrt(torch.sum((x - y) ** 2))


def single_color_loss(images: torch.Tensor, idx: int, target) -> torch.Tensor:
    """Mean absolute error of channel `idx` against `target`, in f32."""
    return torch.mean(torch.abs(images[:, idx].float() - target))


def color_loss(images: torch.Tensor, r, g, b) -> torch.Tensor:
    """Target-weighted per-channel MAE."""
    return (single_color_loss(images, 0, r) * r + single_color_loss(images, 1, g) * g
            + single_color_loss(images, 2, b) * b)


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
    metric: Optional[str] = None  # "l2"
    stride: int = 1

    @property
    def name(self) -> str:
        return type(self).__name__

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def _metric(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.metric == "l2":
            return l2_norm(a, b)
        raise ValueError(f"Unsupported metric {self.metric!r}")

    def calculate_loss(self, decoded: torch.Tensor, mask: Optional[torch.Tensor],
                       x0: Optional[torch.Tensor]) -> torch.Tensor:
        """Masked region loss + lambda * background-preservation term."""
        if self.mask_pred_original_sample:
            if mask is None or x0 is None:
                raise ValueError("mask_pred_original_sample requires mask and x0")
            bg = 1.0 - mask
            return self.loss(mask * decoded) + self.lambda_ * self._metric(bg * decoded, bg * x0)
        return self.loss(decoded)

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
        gradient, nudge by -grad(scale * loss) * alpha_bar_t^2."""
        if self.mask_attr_grad and mask is None:
            raise ValueError("mask_attr_grad requires a mask")
        if not self.in_window(int(step_idx)):
            return xt, zt
        a_t = S.bcast(S.alpha_bar(sched, t), xt)
        eps_sg = eps.detach()
        with torch.enable_grad():
            x = xt.detach().requires_grad_(True)
            px0 = (x - torch.sqrt(1.0 - a_t) * eps_sg) / torch.sqrt(a_t)
            decoded = decode_fn(px0)
            m = mask if self.use_mask else None
            objective = self.calculate_loss(decoded, m, x0) * self.loss_scale
            (grad,) = torch.autograd.grad(objective, x)
        attr_grad = -grad
        if self.mask_attr_grad:
            attr_grad = mask * attr_grad
        nudge = attr_grad * a_t**2
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
        """`apply` one sample at a time for batch >= 2: each image's loss is
        normalised on its own (the reference edits images one by one) and
        only one decoder backward is live at a time. Per-sample `mask`/`x0`
        (leading dim == batch) go with their sample; batch-1 ones are shared."""
        b = xt.shape[0]
        if b == 1:
            return self.apply(xt, zt, eps, t, step_idx, sched, decode_fn, mask=mask, x0=x0)
        xs, zs = [], []
        for i in range(b):
            m = mask[i:i + 1] if mask is not None and mask.shape[0] == b else mask
            r = x0[i:i + 1] if x0 is not None and x0.shape[0] == b else x0
            xn, zn = self.apply(xt[i:i + 1], None if zt is None else zt[i:i + 1],
                                eps[i:i + 1], t, step_idx, sched, decode_fn, mask=m, x0=r)
            xs.append(xn)
            zs.append(zn)
        return torch.cat(xs), (None if zt is None else torch.cat(zs))


@dataclasses.dataclass(frozen=True)
class SingleColorAttrFunc(AttrFunc):
    """One-channel colour guidance."""

    target: float = 0.5
    color_idx: int = 0

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        return single_color_loss(decoded, self.color_idx, self.target)


@dataclasses.dataclass(frozen=True)
class MultiColorAttrFunc(AttrFunc):
    """RGB colour guidance."""

    r_target: float = 0.0
    g_target: float = 0.0
    b_target: float = 0.0

    def loss(self, decoded: torch.Tensor) -> torch.Tensor:
        return color_loss(decoded, self.r_target, self.g_target, self.b_target)


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
        if self.seg_apply_fn is None:
            raise ValueError("NetAttrFunc needs seg_apply_fn, a callable from an NCHW image "
                             "to NCHW segmentation logits")
        probs = torch.softmax(self.seg_apply_fn(decoded).float(), dim=1)
        class_mass = probs.mean(dim=(2, 3))  # (B, n_classes)
        return class_mass[:, list(self.idx_for_class)].sum()


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
        if self.clf_apply_fn is None:
            raise ValueError("ClassifierAttrFunc needs clf_apply_fn, a callable from an NCHW "
                             "image to (B, 80) attribute logits")
        logits = self.clf_apply_fn(decoded).float().reshape(-1, 40, 2)
        value = logits[:, self.idx_for_class, self.idx_of_interest].sum()
        if self.regularize_idx is not None:
            other = logits[:, self.regularize_idx, self.regularize_pred_idx]
            score = self.regularize_score[self.regularize_pred_idx]
            value = value + ((other + score) ** 2).sum()
        return value


# The reference's other name for it.
AnyGANAttrFunc = ClassifierAttrFunc
