"""Linear latent -> RGB proxy codec for gradient guidance: the port of
`guidance/proxy.py`.

The guided step's largest cost is the guidance gradient through the full VAE
decoder. The guidance losses are low-frequency colour and region statistics
of the decoded image, and SD-style latents are well approximated per pixel
by an affine map to RGB (the "latent preview" trick). So: fit, once per
model, a least-squares affine map from a latent pixel to the mean RGB of
its decoded patch, and run the guidance gradient through that instead of
the decoder. The proxy's gradient is one small matmul.

Opt-in (`EditPipeline.edit_image(guidance_codec="proxy")`): the gradient is
an approximation of the full decode's, exact only for an affine decoder.
The output image is always decoded by the real decoder; the proxy only
steers the nudges."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.device import resolve_device
from ..models.bisenet import upsample_nearest


class ProxyDecodeClosure:
    """Affine latent -> image codec, NCHW: y = upsample_nearest(w^T z + b)
    per pixel, by the whole factor `up`. A drop-in `DecodeFn`, so masks at
    image resolution, background terms and NetAttrFunc's parsing net work
    on top of it unchanged."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor, up: int = 1):
        self.w = w  # (C_latent, C_image), f32
        self.b = b  # (C_image,), f32
        self.up = up

    def __call__(self, z: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("nchw,cd->ndhw", z.to(self.w.dtype), self.w) + self.b[:, None, None]
        if self.up > 1:
            h, w = y.shape[2:]
            y = upsample_nearest(y, h * self.up, w * self.up)
        return y


def solve_decode_proxy(z: torch.Tensor, imgs: torch.Tensor,
                       ridge: float = 1e-6) -> ProxyDecodeClosure:
    """The ridge least-squares affine map from latents `z` (n, C, h, w) to
    their decodes `imgs` (n, C_img, H, W), each image mean-pooled to the
    latent grid first; the (C+1) x (C+1) normal equations solved in f32."""
    n, c, h, w = z.shape
    _, ci, hh, ww = imgs.shape
    if hh % h or ww % w:
        raise ValueError(f"decoded {hh}x{ww} not an integer multiple of latent {h}x{w}")
    up = hh // h
    tgt = imgs.float().reshape(n, ci, h, up, w, ww // w).mean(dim=(3, 5))
    a = z.float().permute(0, 2, 3, 1).reshape(-1, c)
    a = torch.cat([a, torch.ones_like(a[:, :1])], dim=-1)
    bt = tgt.permute(0, 2, 3, 1).reshape(-1, ci)
    g = a.T @ a + ridge * torch.eye(c + 1, dtype=torch.float32, device=a.device)
    sol = torch.linalg.solve(g, a.T @ bt)  # (C+1, C_img)
    return ProxyDecodeClosure(w=sol[:c], b=sol[c], up=up)


def fit_decode_proxy(
    decode_fn,
    latent_shape: tuple,
    generator: Optional[torch.Generator] = None,
    n: int = 8,
    latent_scale: float = 1.0,
    ridge: float = 1e-6,
    device=None,
) -> ProxyDecodeClosure:
    """Fits the affine proxy against the real decoder: one batched decode of
    `n` standard-normal latents of `latent_shape` (C, h, w), in the units
    `decode_fn` takes, drawn from `generator` (default: one on `device`,
    None meaning CUDA, seeded with 0), then `solve_decode_proxy`."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device)).manual_seed(0)
    z = torch.randn((n,) + tuple(latent_shape), generator=generator,
                    device=generator.device) * latent_scale
    with torch.no_grad():
        imgs = decode_fn(z)
    return solve_decode_proxy(z, imgs, ridge)
