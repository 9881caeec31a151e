"""EditPipeline, the top-level editing API: the port of
`pipeline/edit_pipeline.py` for real-image edits with any model family
(DDPM, LDM, SD): segment -> class mask at
latent resolution -> encode -> DDIM or edit-friendly DDPM inversion ->
optional resynthesis inside the mask -> guided denoise -> decode. The JAX
package runs segment, mask and encode as one jitted dispatch; here they
are three calls in sequence."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..engine import invert as I
from ..engine.edit import edit
from ..guidance.attr_functions import AttrFunc
from ..utils.constants import ATTRS
from .masks import MaskCreator, apply_mask
from .wrappers import DDPM, LDM, SD, DiffusionWrapper


@dataclasses.dataclass
class EditorOutput:
    imgs: torch.Tensor  # decoded image(s), NCHW in [-1, 1]
    pred_original_samples: Optional[torch.Tensor] = None  # (S, B, C, H, W) latent
    model_outputs: Optional[torch.Tensor] = None  # (S, B, C, H, W) latent


class EditPipeline:
    """Real-image editing with a diffusion wrapper, an optional segmentation
    model and attribute functions: a class mask from the parsing map, DDIM
    or DDPM inversion in every mode of the JAX package, then the guided edit
    in either mode, with the mask and resynthesis. Random draws come from a
    `torch.Generator` or from explicit tensors.

    `segmentation_fn`: (B, 3, H, W) image in [-1, 1] -> (H, W) integer
    parsing map (`models.bisenet.SegmentationModel.__call__`)."""

    def __init__(self, diffusion_wrapper: DiffusionWrapper,
                 segmentation_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None):
        self.diffusion_wrapper = diffusion_wrapper
        self.segmentation_fn = segmentation_fn

    def check_classes(self, classes: Optional[Sequence[int]]) -> None:
        """Class ids must be parsing classes, `range(len(ATTRS))`; None
        passes. Raises ValueError (the JAX package asserts)."""
        if classes is None:
            return
        for x in classes:
            if not 0 <= x < len(ATTRS):
                raise ValueError(f"class {x} out of range")

    def check_inputs(self, attr_func, eta, mask, resynthesize, zs) -> None:
        if eta > 0 and zs is None:
            raise ValueError("eta > 0 and zs is empty")
        if zs is not None and eta == 0:
            raise ValueError("eta == 0 and zs is not empty")
        if attr_func is None and (mask is None or resynthesize is None):
            raise ValueError("attr_func is None and mask is None implies no edit")

    def create_mask(self, classes: Sequence[int], dilate_mask: bool, parsing: torch.Tensor,
                    dim: int) -> torch.Tensor:
        return MaskCreator(dilate_mask=dilate_mask, resize_size=(dim, dim)).create_mask(
            parsing, classes)

    def prepare_for_edit(self, img: torch.Tensor, classes: Optional[Sequence[int]] = None,
                         dilate_mask: bool = False):
        """Segment -> mask of `classes` (each class dilated 7 x 7 first when
        `dilate_mask`) at the latent's resolution, on the wrapper's device
        -> encode. Returns (latent, mask, parsing); without `classes` the
        mask and the parsing map are None, and `dilate_mask` does nothing."""
        self.check_classes(classes)
        w = self.diffusion_wrapper
        mask = parsing = None
        if classes is not None:
            if self.segmentation_fn is None:
                raise ValueError("classes given but no segmentation model")
            parsing = self.segmentation_fn(img)
            mask = self.create_mask(classes, dilate_mask, parsing,
                                    w.data_dimensionality).to(w.device)
        return w.encode(img), mask, parsing

    def _generator(self, generator: Optional[torch.Generator]) -> torch.Generator:
        """The caller's generator, else one on the device seeded with 0 (the
        JAX package's default key)."""
        if generator is not None:
            return generator
        return torch.Generator(device=self.diffusion_wrapper.device).manual_seed(0)

    def edit_noise_map(self, noise_map: torch.Tensor, mask: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Resynthesis blend: fresh noise inside the mask, for a (B, C, H, W)
        x_T or (S, B, C, H, W) noise maps. The fresh noise is `noise`, or is
        drawn from `generator`."""
        if noise is None:
            noise = torch.randn(noise_map.shape, generator=self._generator(generator),
                                device=noise_map.device, dtype=noise_map.dtype)
        return apply_mask(mask, noise_map, noise.to(noise_map.device, noise_map.dtype))

    def edit_noise_maps(self, xt, zs, mask, resynthesize,
                        generator: Optional[torch.Generator] = None,
                        noise: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None):
        """x_T and zs with fresh noise inside the mask when `resynthesize`;
        `noise` = (fresh x_T, fresh zs) replaces the draws (x_T's first, then
        zs's, from one generator)."""
        if mask is not None and resynthesize:
            fresh_xt, fresh_zs = noise if noise is not None else (None, None)
            gen = self._generator(generator) if noise is None else None
            xt = self.edit_noise_map(xt, mask, gen, fresh_xt)
            if zs is not None:
                zs = self.edit_noise_map(zs, mask, gen, fresh_zs)
        return xt, zs

    def prepare_real_image_edit(
        self,
        img: torch.Tensor,
        eta: float = 0.0,
        inversion_method: str = "ddim",
        classes: Optional[Sequence[int]] = None,
        dilate_mask: bool = False,
        prompt_ids=None,
        cfg_scale: float = 3.5,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        mode: Optional[str] = None,
        refine_iters: int = 0,
        t_skip: Optional[int] = None,
        chunk: int = 10,
    ):
        """Invert a real image (NCHW in [-1, 1]) for editing. Returns
        (xt, zs, xts, mask, parsing). With `classes`, the mask
        (`prepare_for_edit`) gains an all-ones fourth channel for SD's
        4-channel latents: (1, 4, h, w). A DDPM or LDM wrapper must have an
        unclipped schedule (`create_diffusion_model(...,
        sample_clipping=False)`): a real image's pred-x0 is not clipped, and
        a clipping schedule raises ValueError (the JAX package asserts).

        The defaults are the JAX package's: DDIM inversion at eta 0, and
        `mode=None` picks "batched" for DDPM and "split" for DDIM. DDIM's
        modes "split" and "fused" are the same loop (`refine_iters` refines
        each step toward the exact inverse). DDPM: "split" extracts the
        noise maps one timestep at a time, "batched" `chunk` timesteps a
        UNet call, "fused" one at a time over the whole trajectory (it
        ignores `t_skip`, as the JAX package's scan does). The DDPM forward
        trajectory's noise is `noise` (S, B, C, H, W) or drawn from
        `generator`. `t_skip`: the edit will skip its first t_skip steps,
        so "split" and "batched" extract z only for the suffix it reads."""
        if mode is None:
            mode = "batched" if inversion_method == "ddpm" else "split"
        if inversion_method == "ddim" and eta > 0:
            raise ValueError("eta > 0 and inversion_method == 'ddim' is not possible")
        if inversion_method not in ("ddim", "ddpm"):
            raise ValueError(f"Unknown inversion method: {inversion_method}")
        modes = ("split", "fused") + (("batched",) if inversion_method == "ddpm" else ())
        if mode not in modes:
            raise ValueError(f"Unknown mode {mode!r} for {inversion_method}; choose from {modes}")
        w = self.diffusion_wrapper
        latent, mask, parsing = self.prepare_for_edit(img, classes, dilate_mask)
        if isinstance(w, (DDPM, LDM)) and w.schedule.clip_sample:
            raise ValueError("real-image edit requires clip_sample=False")
        sched = w.schedule
        eps_fn = w.eps_fn(w.prep_text(prompt_ids), cfg_scale)
        if inversion_method == "ddim":
            xt = I.ddim_invert(sched, eps_fn, latent, refine_iters=refine_iters)
            zs = xts = None
        else:
            start = _clamp_t_skip(t_skip, sched.num_inference_steps)
            if mode == "batched":
                res = I.ddpm_invert_batched(sched, eps_fn, latent, eta=eta, generator=generator,
                                            noise=noise, chunk=chunk, start=start)
            else:
                res = I.ddpm_invert(sched, eps_fn, latent, eta=eta, generator=generator,
                                    noise=noise, start=start if mode == "split" else 0)
            xt, zs, xts = res.xt, res.zs, res.xts
        if isinstance(w, SD) and mask is not None:
            mask = torch.cat([mask, torch.ones_like(mask[:, :1])], dim=1)
        return xt, zs, xts, mask, parsing

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
        generator: Optional[torch.Generator] = None,
        noise: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
        collect: bool = True,
        mode: str = "fused",
        decode_remat: str = "auto",
        encoder_reuse: int = 1,
        guidance_codec: str = "full",
    ) -> EditorOutput:
        """Guided denoise of the (possibly resynthesized) noise maps, then
        decode.

        `resynthesize` with a `mask` draws fresh noise inside the mask for
        x_T and zs (`edit_noise_maps`: from `generator`, else one seeded
        with 0, or the explicit pair `noise`), before `xts`/`t_skip` pick
        the start. With `xts`, starts from xts[t_skip] and reads
        zs[t_skip:], with t_skip clamped to the last step as
        `prepare_real_image_edit` clamps the inversion's start. `mask`
        (NCHW, at latent resolution, or broadcastable to the latent) also
        goes to the attribute function's masked options (`use_mask`,
        `mask_attr_grad`, `mask_pred_original_sample`). Both modes run
        `engine.edit.edit`: the JAX package's jitted scan ("fused") and host
        loop ("split") are one host loop in torch. `decode_remat="blocks"`
        checkpoints each decoder block in the guidance gradient (less
        memory, one more decoder forward a nudge); "auto" and "none" do
        not. Opt-in accelerations, both approximate: `guidance_codec="proxy"`
        runs the guidance gradient through the wrapper's fitted affine
        latent -> RGB proxy (`guidance_decode_proxy`) instead of the decoder
        (the output image is still decoded by the real decoder);
        `encoder_reuse=k > 1` runs the UNet's down path on every k-th step
        only (encoder propagation)."""
        if mode not in ("fused", "split"):
            raise ValueError(f"Unknown mode {mode!r}")
        if decode_remat not in ("auto", "blocks", "none"):
            raise ValueError(f"Unknown decode_remat: {decode_remat}")
        if guidance_codec not in ("full", "proxy"):
            raise ValueError(f"Unknown guidance_codec: {guidance_codec}")
        self.check_inputs(attr_func, eta, mask, resynthesize, zs)
        xt, zs = self.edit_noise_maps(xt, zs, mask, resynthesize, generator, noise)
        if xts is not None:
            if t_skip is None:
                raise ValueError("xts given but t_skip is None")
            t_skip = _clamp_t_skip(t_skip, xts.shape[0] - 1)
            xt = xts[t_skip]
            zs = zs[t_skip:]
        w = self.diffusion_wrapper
        eps_fn = w.eps_fn(w.prep_text(prompt_ids), cfg_scale, features=encoder_reuse > 1)
        step_rule = "ddpm" if (inversion_method == "ddpm" and t_skip is not None) else "ddim"
        dec_fn = (w.guidance_decode_proxy() if guidance_codec == "proxy"
                  else w.decode_fn(remat_blocks=decode_remat == "blocks"))
        result = edit(
            w.schedule, eps_fn, xt, eta=eta, zs=zs, attr_func=attr_func, decode_fn=dec_fn,
            mask=mask, x0_ref=x0_ref, step_rule=step_rule, collect=collect,
            encoder_reuse=encoder_reuse,
        )
        return EditorOutput(imgs=w.decode(result.x0),
                            pred_original_samples=result.pred_original_samples,
                            model_outputs=result.model_outputs)


def _clamp_t_skip(t_skip: Optional[int], steps: int) -> int:
    """t_skip within [0, steps - 1]: the CLI's default t_skip exceeds the
    step count at small --steps, and the JAX package clamps it there too."""
    return min(max(int(t_skip or 0), 0), steps - 1)
