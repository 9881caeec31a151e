"""Builds a configuration's models on both sides from its file
(`benchmark/configs/<name>.json`): the program's modules and wrapper, in
the dtype the configuration serves, and the float32 reference modules, each
filled with the same seeded weights.

What differs by model family lives in the family's module,
`benchmark/families/<family>.py`, found by the configuration's "family"
(`cell.family`). A family module provides:
- `ROWS`: the denoiser's rows a sample a step (2 for a classifier-free
  guidance pair, 1 otherwise);
- `image_size(cfg)`: the side of the edited images, in pixels;
- `build_program(cfg, seed, device, steps) -> Program`: the port's wrapper
  (its schedule preset, its fixed conditioning), the classifier if any,
  weights drawn from the seed;
- `reference_modules(cfg, device)`: a `Reference` subclass with its modules
  not yet filled (the meta device gives shapes only, for counting FLOPs);
- `tiny() -> dict`: the configuration's sizes at the port's TINY widths,
  for the CPU tests.
So a new family is new files only: the family module, its reference
models, a configuration and a workload.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Optional

import torch

from . import cell as C
from .weights import fill_seeded

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def serve_dtype(cfg: dict) -> torch.dtype:
    return DTYPES[cfg["dtype"]]


@dataclasses.dataclass
class Program:
    wrapper: object  # the port's DiffusionWrapper
    classifier: Optional[torch.nn.Module] = None
    clf_apply_fn: Optional[object] = None


def build_program(cfg: dict, seed: int, device, steps: int) -> Program:
    """The port's wrapper for `cfg` at `steps` inference steps, weights from
    `seed`."""
    return C.family(cfg["family"]).build_program(cfg, seed, device, steps)


@dataclasses.dataclass
class Reference:
    """A family's float32 reference: the UNet, the codec (None for the
    identity), its latent scale and an optional classifier. A family's
    subclass adds its conditioning, implements `encode`, `eps_fn` and
    `unet_once`, and names its codec's weight tag."""

    unet: torch.nn.Module
    codec: Optional[torch.nn.Module]
    scale: float
    classifier: Optional[torch.nn.Module] = None
    codec_tag: ClassVar[str]  # the tag of the codec's seeded weights, as the program's

    def encode(self, img: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.codec.decode(z / self.scale)

    def eps_fn(self):
        """The denoiser eps(x, t) with the family's conditioning."""
        raise NotImplementedError

    def unet_once(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One UNet call at x (one sample) with its conditioning, no
        guidance pair: the call whose FLOPs `drive.piece_flops` counts."""
        raise NotImplementedError

    def fill(self, cfg: dict, seed: int, device) -> None:
        """Every tensor drawn from the seed under the program's tags: the
        UNet and the codec in the served dtype's draw, the classifier in
        float32's. A subclass with conditioning of its own draws it too."""
        dt = serve_dtype(cfg)
        fill_seeded(self.unet, seed, "unet", dt, device)
        if self.codec is not None:
            fill_seeded(self.codec, seed, self.codec_tag, dt, device)
        if self.classifier is not None:
            fill_seeded(self.classifier, seed, "classifier", torch.float32, device)

    def modules(self) -> list:
        return [m for m in (self.unet, self.codec, self.classifier) if m is not None]


def reference_modules(cfg: dict, device) -> Reference:
    """The float32 reference modules of `cfg` on `device`, not yet filled
    (the meta device gives shapes only, for counting FLOPs)."""
    return C.family(cfg["family"]).reference_modules(cfg, device)


def build_reference(cfg: dict, seed: int, device) -> Reference:
    """The reference of `cfg` with the program's seeded weights, float32,
    eval mode, no parameter gradients."""
    ref = reference_modules(cfg, "meta")
    for name in ("unet", "codec", "classifier"):
        if getattr(ref, name) is not None:
            setattr(ref, name, getattr(ref, name).to_empty(device=device))
    ref.fill(cfg, seed, device)
    for m in ref.modules():
        m.float().eval().requires_grad_(False)
    return ref


def tuples(d: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}


def config_dict(cfg) -> dict:
    """A port's configuration dataclass as a configuration file's dict."""
    out = dataclasses.asdict(cfg)
    out.pop("fused_conv", None)
    return {k: list(v) if isinstance(v, tuple) else v for k, v in out.items()}
