"""Whether the PyTorch port's block-checkpointed guidance (`decode_remat`,
`vjp_chunk`) gives the plain path's numbers on the GPU, and where reruns
part: chip_smoke.py's [remat] setting taken apart.

    python3 scripts/torch_remat_determinism.py [--deterministic]

On the [main] models (SD-1.5 UNet and SD VAE, bf16, seeded random weights,
as chip_smoke.py builds them) it prints, each as (max |a - b| / max |b|,
RMS(a - b) / RMS(b), bit-equal):
  * one decode of a 64 x 64 latent and its latent gradient, with and
    without `remat=True`, and a rerun of each, against the first plain one;
  * one guidance nudge (`apply_batched` at batch 2 on fixed latents, at
    the inversion's 45th step) of chip_smoke.py's [remat] guidance, with the
    LPIPS background term and with the l2 one: the plain decode, the
    block-checkpointed one, a rerun of the plain one and two samples a VJP,
    against the first;
  * whole edits of [remat]'s ten guided steps from one DDPM inversion of two
    random 512 px images: a rerun, the block-checkpointed decode and two
    samples a VJP against the plain one, the image and each step's pred-x0.
`--deterministic` sets `torch.backends.cudnn.deterministic` first.
Prints the card's name and power limit first. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402


def compare(a, b):
    a, b = a.float(), b.float()
    return (f"({((a - b).abs().max() / b.abs().max()).item():.3e}, "
            f"{((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt()).item():.3e}, "
            f"{torch.equal(a, b)})")


def main() -> int:
    from diffusion_image_editing_tpu_torch.evals import make_lpips_fn
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--deterministic", action="store_true",
                   help="torch.backends.cudnn.deterministic = True")
    args = p.parse_args()
    C.phase_device()
    torch.backends.cudnn.deterministic = args.deterministic
    C.log(f"cudnn.deterministic {torch.backends.cudnn.deterministic}")
    dev = torch.device("cuda")
    unet, vae = C.build_models(dev)
    sd, pipe, _ = C.make_pipeline(unet, vae, dev)
    rng = np.random.default_rng(1)
    lat, size = 64, vae.config.sample_size

    def randn(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dev)

    z, w = randn(1, 4, lat, lat), randn(1, 3, size, size)
    decodes = []
    for remat in (False, True, False, True):
        zz = z.clone().requires_grad_(True)
        d = sd.decode_fn(remat_blocks=remat)(zz)
        (g,) = torch.autograd.grad((d.float() * w).sum(), zz)
        decodes.append((remat, d.detach(), g))
    for i, (remat, d, g) in enumerate(decodes[1:], 1):
        C.log(f"decode {i} remat={remat} against the first plain one: output "
              f"{compare(d, decodes[0][1])}, gradient {compare(g, decodes[0][2])}")

    imgs = torch.from_numpy(rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)).to(dev)
    mask = torch.zeros((1, 1, size, size), device=dev)
    mask[..., size // 4:3 * size // 4, size // 8:5 * size // 8] = 1.0
    lpips_fn = make_lpips_fn(C.seeded_lpips().to(dev))
    x, eps = randn(2, 4, lat, lat), randn(2, 4, lat, lat)
    sched = sd.schedule
    ways = (("plain", False, 1), ("blocks", True, 1), ("plain rerun", False, 1),
            ("blocks, 2 a VJP", True, 2))

    def attr(metric, chunk):
        return SingleColorAttrFunc(**dict(C.REMAT_GUIDE, metric=metric), vjp_chunk=chunk,
                                   metric_fn=lpips_fn if metric == "lpips" else None)

    for metric in ("lpips", "l2"):
        nudges = []
        for name, remat, chunk in ways:
            xn, _ = attr(metric, chunk).apply_batched(
                x, None, eps, int(sched.timesteps[45]), 0, sched,
                sd.decode_fn(remat_blocks=remat), mask=mask, x0=imgs)
            nudges.append(xn - x)
        rms = (nudges[0].pow(2).mean().sqrt() / x.pow(2).mean().sqrt()).item()
        for (name, _, _), n in zip(ways[1:], nudges[1:]):
            C.log(f"nudge {metric} {name} against plain: {compare(n, nudges[0])} (the nudge's "
                  f"RMS {rms:.3e} of the latent's)")

    t_skip = C.STEPS - C.REMAT_GUIDED
    xt, zs, xts, _, _ = pipe.prepare_real_image_edit(
        imgs, eta=1.0, inversion_method="ddpm", mode="batched", t_skip=t_skip, chunk=C.CHUNK,
        generator=torch.Generator(device=dev).manual_seed(5))
    for metric in ("lpips", "l2"):
        edits = []
        for name, remat, chunk in ways:
            edits.append(pipe.edit_image(
                xt, eta=1.0, zs=zs, xts=xts, mask=mask, x0_ref=imgs, attr_func=attr(metric, chunk),
                inversion_method="ddpm", t_skip=t_skip, collect=True, mode="split",
                decode_remat="blocks" if remat else "none"))
        for (name, _, _), e in zip(ways[1:], edits[1:]):
            steps = ", ".join(compare(a, b) for a, b in zip(
                e.pred_original_samples, edits[0].pred_original_samples))
            C.log(f"edit {metric} {name} against plain: image {compare(e.imgs, edits[0].imgs)}; "
                  f"pred-x0 a step {steps}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
