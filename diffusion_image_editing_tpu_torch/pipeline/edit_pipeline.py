"""EditPipeline, the top-level editing API: the port of
`pipeline/edit_pipeline.py` for real-image edits without segmentation:
encode -> edit-friendly DDPM inversion -> guided denoise -> decode."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..engine import invert as I
from ..engine.edit import edit_split
from ..guidance.attr_functions import AttrFunc
from .wrappers import SD


@dataclasses.dataclass
class EditorOutput:
    imgs: torch.Tensor  # decoded image(s), NCHW in [-1, 1]
    pred_original_samples: Optional[torch.Tensor] = None  # (S, B, C, H, W) latent
    model_outputs: Optional[torch.Tensor] = None  # (S, B, C, H, W) latent


class EditPipeline:
    """Real-image editing with a diffusion wrapper and attribute functions.
    Ported so far: DDPM inversion in "batched" mode and the "split" edit,
    with a given mask; segmentation and resynthesis come in a later slice."""

    def __init__(self, diffusion_wrapper: SD, segmentation_fn=None):
        if segmentation_fn is not None:
            raise NotImplementedError("segmentation comes in a later slice of the port")
        self.diffusion_wrapper = diffusion_wrapper

    def check_inputs(self, attr_func, eta, mask, resynthesize, zs) -> None:
        if eta > 0 and zs is None:
            raise ValueError("eta > 0 and zs is empty")
        if zs is not None and eta == 0:
            raise ValueError("eta == 0 and zs is not empty")
        if attr_func is None and (mask is None or resynthesize is None):
            raise ValueError("attr_func is None and mask is None implies no edit")

    def prepare_for_edit(self, img: torch.Tensor, classes: Optional[Sequence[int]] = None):
        """Encode; returns (latent, mask=None, parsing=None)."""
        if classes is not None:
            raise NotImplementedError("segmentation classes come in a later slice of the port")
        return self.diffusion_wrapper.encode(img), None, None

    def prepare_real_image_edit(
        self,
        img: torch.Tensor,
        eta: float = 0.0,
        inversion_method: str = "ddim",
        classes: Optional[Sequence[int]] = None,
        prompt_ids=None,
        cfg_scale: float = 3.5,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        mode: Optional[str] = None,
        t_skip: Optional[int] = None,
        chunk: int = 10,
    ):
        """Invert a real image (NCHW in [-1, 1]) for editing. Returns
        (xt, zs, xts, mask, parsing).

        The defaults are the JAX package's: DDIM inversion at eta 0, and
        `mode=None` picks "batched" for DDPM and "split" for DDIM. DDIM
        inversion is not ported yet, so a call that leaves them raises
        NotImplementedError. The forward trajectory's noise is `noise`
        (S, B, C, H, W) or drawn from `generator`. `t_skip`: the edit will
        skip its first t_skip steps, so z is extracted only for the suffix
        it reads."""
        if mode is None:
            mode = "batched" if inversion_method == "ddpm" else "split"
        if inversion_method == "ddim" and eta > 0:
            raise ValueError("eta > 0 and inversion_method == 'ddim' is not possible")
        if inversion_method not in ("ddim", "ddpm"):
            raise ValueError(f"Unknown inversion method: {inversion_method}")
        if inversion_method != "ddpm" or mode != "batched":
            raise NotImplementedError(
                "ported so far: inversion_method='ddpm' with mode='batched'")
        w = self.diffusion_wrapper
        latent, mask, parsing = self.prepare_for_edit(img, classes)
        sched = w.schedule
        eps_fn = w.eps_fn(w.prep_text(prompt_ids), cfg_scale)
        start = _clamp_t_skip(t_skip, sched.num_inference_steps)
        res = I.ddpm_invert_batched(sched, eps_fn, latent, eta=eta, generator=generator,
                                    noise=noise, chunk=chunk, start=start)
        return res.xt, res.zs, res.xts, mask, parsing

    def edit_image(
        self,
        xt: torch.Tensor,
        eta: float = 0.0,
        zs: Optional[torch.Tensor] = None,
        xts: Optional[torch.Tensor] = None,
        mask: Optional[torch.Tensor] = None,
        attr_func: Optional[AttrFunc] = None,
        prompt_ids=None,
        cfg_scale: float = 3.5,
        inversion_method: str = "ddim",
        t_skip: Optional[int] = None,
        resynthesize: bool = False,
        x0_ref: Optional[torch.Tensor] = None,
        collect: bool = True,
        mode: str = "split",
    ) -> EditorOutput:
        """Guided denoise of the inverted noise maps, then decode.

        With `xts`, starts from xts[t_skip] and reads zs[t_skip:], with
        t_skip clamped to the last step as `prepare_real_image_edit` clamps
        the inversion's start. `mask` (NCHW, at latent resolution, or
        broadcastable to the latent) goes to the attribute function's
        masked options (`use_mask`, `mask_attr_grad`,
        `mask_pred_original_sample`)."""
        if mode != "split":
            raise NotImplementedError("ported so far: mode='split'")
        self.check_inputs(attr_func, eta, mask, resynthesize, zs)
        if resynthesize:
            raise NotImplementedError("resynthesis comes in a later slice of the port")
        if xts is not None:
            if t_skip is None:
                raise ValueError("xts given but t_skip is None")
            t_skip = _clamp_t_skip(t_skip, xts.shape[0] - 1)
            xt = xts[t_skip]
            zs = zs[t_skip:]
        w = self.diffusion_wrapper
        eps_fn = w.eps_fn(w.prep_text(prompt_ids), cfg_scale)
        step_rule = "ddpm" if (inversion_method == "ddpm" and t_skip is not None) else "ddim"
        result = edit_split(
            w.schedule, eps_fn, xt, eta=eta, zs=zs, attr_func=attr_func,
            decode_fn=w.decode_fn(), mask=mask, x0_ref=x0_ref, step_rule=step_rule,
            collect=collect,
        )
        return EditorOutput(imgs=w.decode(result.x0),
                            pred_original_samples=result.pred_original_samples,
                            model_outputs=result.model_outputs)


def _clamp_t_skip(t_skip: Optional[int], steps: int) -> int:
    """t_skip within [0, steps - 1]: the CLI's default t_skip exceeds the
    step count at small --steps, and the JAX package clamps it there too."""
    return min(max(int(t_skip or 0), 0), steps - 1)
