"""Model-family wrappers: the port of `pipeline/wrappers.py`. A wrapper holds
the UNet, the schedule and the codec on one device: the identity for DDPM
(pixel space), the VQ autoencoder for LDM (latent scale 1.0), and the KL
autoencoder with the 0.18215 latent scale plus CLIP prompts for SD, the
same at 1024 px with the 0.13025 scale and a given conditioning for SDXL;
and the generation API."""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.device import resolve_device
from ..core.schedule import Schedule
from ..engine import denoise as D
from ..engine.denoise import (CfgEpsClosure, CfgEpsFeatClosure, DecodeClosure, EncodeClosure,
                              EpsClosure, EpsFeatClosure)
from ..utils.logging import span


class DiffusionWrapper:
    """UNet + schedule + codec on one device. The base class's codec is the
    identity and it takes no prompt (`prep_text` is None), as the JAX
    package's. `device=None` means CUDA and raises without it; the modules
    and the schedule are moved there, in eval mode and without gradients
    of their own (the guidance gradient is taken with respect to the
    latent: XLA drops the weights' gradients in the JAX package; here
    autograd then skips them, the fused conv's dw included). Whether pred-x0
    is clipped is the schedule's `clip_sample`."""

    family = "base"

    def __init__(self, unet: nn.Module, sched: Schedule, device=None):
        self.device = resolve_device(device)
        self.unet = self._frozen(unet)
        self.schedule = sched.to(self.device)
        self.data_dimensionality = unet.config.sample_size
        self.latent_channels = unet.config.in_channels
        self._encode = EncodeClosure()
        self._decode = self._decode_remat = DecodeClosure()  # the identity either way
        self._decode_proxy = None
        self._mesh = None

    def _frozen(self, module: Optional[nn.Module]) -> Optional[nn.Module]:
        if module is None:
            return None
        return module.to(self.device).eval().requires_grad_(False)

    def _codec(self) -> Tuple[Optional[nn.Module], float]:
        """(autoencoder, latent scale); None for the identity codec."""
        return None, 1.0

    def _set_codec(self) -> None:
        """The codec closures of `_codec()`, off any mesh (a subclass calls
        it once its autoencoder is set)."""
        vae, scale = self._codec()
        self._encode = EncodeClosure(vae, scale)
        self._decode = DecodeClosure(vae, scale)
        self._decode_remat = DecodeClosure(vae, scale, remat=True)

    def to_mesh(self, mesh) -> "DiffusionWrapper":
        """A shallow copy (the same modules) whose closures split one edit
        over the mesh (`parallel.edit_shard`): a CFG UNet call's pair over
        the `cfg` axis and its rows over `sp`, an unconditional call's rows
        over the whole mesh, and the codec's (encode, decode and the
        decode's gradient, checkpointed or not) over the whole mesh. The same
        EditPipeline / generate / invert code then runs split:

            mesh = parallel.cfg_mesh(cfg=2, sp=2)   # under torchrun, 4 ranks
            pipe = EditPipeline(wrapper.to_mesh(mesh), seg_model)

        Every rank gets the same bytes from every closure. Making the
        closures may make process groups: every rank calls `to_mesh`."""
        from ..parallel.edit_shard import SpatialDecodeClosure, SpatialEncodeClosure

        w = copy.copy(self)
        w._mesh = mesh
        w._decode_proxy = None
        vae, scale = self._codec()
        w._encode = SpatialEncodeClosure(vae, scale, mesh)
        w._decode = SpatialDecodeClosure(vae, scale, mesh)
        w._decode_remat = SpatialDecodeClosure(vae, scale, mesh, remat=True)
        return w

    # ---- codec boundary --------------------------------------------------
    def decode_fn(self, remat_blocks: bool = False) -> DecodeClosure:
        """Differentiable latent -> image callable for guidance.
        `remat_blocks=True` returns one whose gradient checkpoints each
        decoder block (`models.vae.Decoder`), with the same weights."""
        return self._decode_remat if remat_blocks else self._decode

    def guidance_decode_proxy(self, generator: Optional[torch.Generator] = None, n: int = 8,
                              refresh: bool = False):
        """The fitted affine latent -> RGB proxy codec for guidance
        (`guidance/proxy.py`): the guidance gradient runs through a per-pixel
        affine map instead of the decoder. Opt-in; fitted once per wrapper
        (one n-batch decode, latents from `generator`, else one seeded with
        0 on the device) and cached until `refresh`."""
        if self._decode_proxy is None or refresh:
            from ..guidance.proxy import fit_decode_proxy

            d = self.data_dimensionality
            self._decode_proxy = fit_decode_proxy(
                self.decode_fn(), (self.latent_channels, d, d), generator=generator, n=n,
                device=self.device)
        return self._decode_proxy

    def encode(self, sample: torch.Tensor) -> torch.Tensor:
        with span("models.encode"):
            return self._encode(sample.to(self.device))

    def decode(self, latent: torch.Tensor) -> torch.Tensor:
        with span("models.decode"), torch.no_grad():
            return self._decode(latent)

    # ---- text ------------------------------------------------------------
    def prep_text(self, prompt_ids=None) -> Optional[torch.Tensor]:
        """Unconditional families take no prompt."""
        return None

    # ---- denoiser --------------------------------------------------------
    def eps_fn(self, text_emb: Optional[torch.Tensor] = None, cfg_scale: float = 3.5,
               features: bool = False):
        """The (CFG) denoiser. `features=True` returns the encoder-propagation
        closure (`full` / `reuse`; `encoder_reuse` in the loops), which is
        not combined with a mesh, as in the JAX package."""
        if features:
            if self._mesh is not None:
                raise ValueError("encoder propagation + to_mesh not supported")
            if text_emb is None:
                return EpsFeatClosure(self.unet)
            return CfgEpsFeatClosure(self.unet, text_emb, cfg_scale)
        if self._mesh is not None:
            from ..parallel.edit_shard import ShardedEpsClosure, make_sharded_cfg_eps_fn

            if text_emb is None:
                return ShardedEpsClosure(self.unet, self._mesh)
            return make_sharded_cfg_eps_fn(self.unet, text_emb, cfg_scale, self._mesh)
        if text_emb is None:
            return EpsClosure(self.unet)
        return CfgEpsClosure(self.unet, text_emb, cfg_scale)

    # ---- sampling helpers --------------------------------------------------
    def latent_shape(self, batch: int = 1) -> Tuple[int, ...]:
        d = self.data_dimensionality
        return (batch, self.latent_channels, d, d)

    def initialize_random_samples(self, generator: Optional[torch.Generator],
                                  num_inference_steps: int, eta: float,
                                  batch: int = 1) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x_T (and the per-step noise zs when eta > 0), f32 on the device,
        drawn from `generator` (which lives on the same device)."""
        shape = self.latent_shape(batch)
        xt = torch.randn(shape, generator=generator, device=self.device)
        zs = None
        if eta > 0:
            zs = torch.randn((num_inference_steps,) + shape, generator=generator,
                             device=self.device)
        return xt, zs

    # ---- generation API ----------------------------------------------------
    def generate_image(
        self,
        xt: torch.Tensor,
        eta: float = 0.0,
        zs: Optional[torch.Tensor] = None,
        num_inference_steps: int = 50,
        prompt_ids=None,
        cfg_scale: float = 3.5,
        collect: bool = False,
        mode: str = "fused",
        encoder_reuse: int = 1,
    ) -> Tuple[torch.Tensor, D.Trajectory]:
        """One denoising run; returns (decoded image NCHW in [-1, 1],
        Trajectory). Both modes run `engine.denoise.generate`: the JAX
        package's jitted scan ("fused") and host loop ("split") are one host
        loop in torch. `encoder_reuse=k > 1`: encoder propagation (opt-in,
        approximate; k = 1 is exact)."""
        if mode not in ("fused", "split"):
            raise ValueError(f"Unknown mode {mode!r}")
        sched = self._sched_for(num_inference_steps)
        eps_fn = self.eps_fn(self.prep_text(prompt_ids), cfg_scale, features=encoder_reuse > 1)
        zs = None if zs is None else zs.to(self.device)
        traj = D.generate(sched, eps_fn, xt.to(self.device), eta=eta, zs=zs, collect=collect,
                          encoder_reuse=encoder_reuse)
        return self.decode(traj.x0), traj

    def generate_images(
        self,
        num_images: int = 1,
        eta: float = 0.0,
        num_inference_steps: int = 50,
        seed: Optional[int] = None,
        prompt_ids=None,
        cfg_scale: float = 3.5,
        collect: bool = False,
        encoder_reuse: int = 1,
    ):
        """A batch of `num_images` from one batched run, its noise drawn from
        a generator on the device seeded with `seed` (0 when None). Returns
        (images, Trajectory, xt, zs)."""
        generator = torch.Generator(device=self.device).manual_seed(
            0 if seed is None else int(seed))
        xt, zs = self.initialize_random_samples(generator, num_inference_steps, eta,
                                                batch=num_images)
        img, traj = self.generate_image(
            xt, eta=eta, zs=zs, num_inference_steps=num_inference_steps,
            prompt_ids=prompt_ids, cfg_scale=cfg_scale, collect=collect,
            encoder_reuse=encoder_reuse)
        return img, traj, xt, zs

    def _sched_for(self, num_inference_steps: int) -> Schedule:
        if num_inference_steps == self.schedule.num_inference_steps:
            return self.schedule
        return self.schedule.with_num_inference_steps(num_inference_steps)


class DDPM(DiffusionWrapper):
    """Pixel-space model: the identity codec."""

    family = "ddpm"


class LDM(DiffusionWrapper):
    """VQ latent model: encode is the pre-quantization latent, decode
    quantizes (straight-through) and decodes; latent scale 1.0."""

    family = "ldm"

    def __init__(self, unet: nn.Module, sched: Schedule, vqvae: nn.Module, device=None):
        super().__init__(unet, sched, device)
        self.vqvae = self._frozen(vqvae)
        self._set_codec()

    def _codec(self):
        return self.vqvae, 1.0


class SD(DiffusionWrapper):
    """Stable Diffusion: UNet + schedule + KL-VAE codec, and optionally the
    CLIP text encoder and its tokenizer, on one device.

    `prep_text(None)` is None, as in the JAX package: the run is then
    unconditional. Prompt ids need the text encoder; a single sequence is
    paired with the empty prompt, which needs the tokenizer."""

    family = "sd"

    def __init__(self, unet: nn.Module, vae: nn.Module, sched: Schedule,
                 text_encoder: Optional[nn.Module] = None, tokenizer=None, device=None):
        super().__init__(unet, sched, device)
        self.vae = self._frozen(vae)
        self.text_encoder = self._frozen(text_encoder)
        self.tokenizer = tokenizer
        self._set_codec()

    def _codec(self):
        return self.vae, self.vae.config.scaling_factor

    # ---- text ------------------------------------------------------------
    def encode_text_ids(self, input_ids) -> torch.Tensor:
        """(B, L) token ids -> (B, L, D) f32 CLIP hidden states."""
        if self.text_encoder is None:
            raise ValueError("prompt ids need a text encoder")
        ids = torch.as_tensor(np.asarray(input_ids) if not torch.is_tensor(input_ids)
                              else input_ids, device=self.device)
        with torch.no_grad():
            return self.text_encoder(ids)

    def prep_text(self, prompt_ids=None) -> Optional[torch.Tensor]:
        """prompt_ids: (L,) or (2, L) token ids, or None. A single sequence
        is paired with the empty prompt's ids: the embedding is always
        [uncond; cond]."""
        if prompt_ids is None:
            return None
        ids = torch.as_tensor(np.asarray(prompt_ids) if not torch.is_tensor(prompt_ids)
                              else prompt_ids).long()
        if ids.dim() == 1:
            if self.tokenizer is None:
                raise ValueError("pairing with the empty prompt requires a tokenizer")
            uncond = torch.as_tensor(self.tokenizer.encode(""), dtype=torch.long)
            ids = torch.stack([uncond, ids.cpu()])
        return self.encode_text_ids(ids)


SDXL_TIME_IDS = (1024, 1024, 0, 0, 1024, 1024)  # original size, crop's top-left, target size


class SDXLText(NamedTuple):
    """SDXL's conditioning of a classifier-free guidance pair, each tensor
    [uncond; cond] on the batch axis: `context`, the two text encoders'
    hidden states concatenated (CLIP ViT-L's 768 and OpenCLIP bigG's 1280),
    (2, L, 2048); `text_embeds`, bigG's pooled embedding, (2, 1280);
    `time_ids`, the micro-conditioning (2, 6) (`SDXL_TIME_IDS` at 1024 px)."""

    context: torch.Tensor
    text_embeds: torch.Tensor
    time_ids: torch.Tensor

    def added_cond(self) -> dict:
        return {"text_embeds": self.text_embeds, "time_ids": self.time_ids}

    def to(self, device) -> "SDXLText":
        return SDXLText(*(t.to(device) for t in self))


class SDXL(SD):
    """Stable Diffusion XL: the SDXL UNet (`SDXLUNetConfig`, `text_time`
    added conditioning) and the KL VAE, whose config gives the latent scale
    (0.13025). The port has neither of SDXL's text encoders, so the wrapper
    is given its conditioning (`SDXLText`), which `prep_text()` returns;
    prompt ids raise."""

    family = "sdxl"

    def __init__(self, unet: nn.Module, vae: nn.Module, sched: Schedule,
                 text: Optional[SDXLText] = None, device=None):
        super().__init__(unet, vae, sched, device=device)
        self.text = None if text is None else text.to(self.device)

    def prep_text(self, prompt_ids=None) -> Optional[SDXLText]:
        if prompt_ids is not None:
            raise ValueError("SDXL's prompts need CLIP ViT-L and OpenCLIP bigG text encoders, "
                             "which the port does not have: give the wrapper its SDXLText")
        return self.text

    def eps_fn(self, text_emb: Optional[SDXLText] = None, cfg_scale: float = 5.0,
               features: bool = False):
        """The CFG denoiser with SDXL's conditioning `text_emb` (an
        `SDXLText`); 5.0 is diffusers' SDXL pipeline's default scale."""
        if text_emb is None:
            raise ValueError("the SDXL UNet needs its conditioning: an SDXLText")
        if self._mesh is not None:
            raise ValueError("SDXL's added conditioning is not split over a mesh")
        closure = CfgEpsFeatClosure if features else CfgEpsClosure
        return closure(self.unet, text_emb.context, cfg_scale, text_emb.added_cond())
