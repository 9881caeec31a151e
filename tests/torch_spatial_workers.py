"""Rank code of tests/test_torch_spatial.py: the spatial split of one edit
over a real gloo process group on the CPU. Each rank runs every check of
its world (2 or 4 ranks) and puts its results (numpy arrays and numbers)
on a queue; the test compares them across ranks, with the port run whole
and with the JAX package. It imports torch and the port only, so that the
ranks start quickly."""

import contextlib
import datetime
import io
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist

STEPS = 3


def run_rank(rank: int, world: int, store_path: str, payload: dict, queue) -> None:
    torch.set_num_threads(1)
    # A collective whose peer has died fails within the timeout, not gloo's 30 min.
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        if world == 2:
            out = {"ops": _ops(), "uneven": _uneven(), "decode": _decode(payload),
                   "sd": {spec: _sd_edit(payload, spec) for spec in ("sp2", "cfg2")},
                   "ddpm": _ddpm_edit(payload),
                   "cli": {spec: _cli(payload, spec) for spec in ("sp2", "cfg2")},
                   "cli_refused": _cli_refused(payload)}
        else:
            out = {"sd": {"cfg2xsp2": _sd_edit(payload, "cfg2xsp2")},
                   "cli": {"cfg2xsp2": _cli(payload, "cfg2xsp2")}}
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _whole_and_split(fn, x: torch.Tensor, cot: torch.Tensor, split):
    """(out, dx) of `fn` on the whole `x` and on this rank's rows under the
    split (gathered), with the gradient of sum(out * cot)."""
    from diffusion_image_editing_tpu_torch.ops.split import (gather_rows, scatter_rows,
                                                                    spatial_split)

    res = []
    for s in (None, split):
        xs = x.clone().requires_grad_(True)
        rows = scatter_rows(xs, s)
        with spatial_split(s):
            y = fn(rows)
        y = gather_rows(y, s)
        (dx,) = torch.autograd.grad((y * cot).sum(), xs)
        res.append((y.detach(), dx))
    return res


def _ops() -> dict:
    """Each split op against the whole op, forward and gradient: the 3x3
    conv's halo (4 rows a rank, and one), both stride-2 paddings,
    GroupNorm+SiLU (the moments' fold and the backward's sums), and
    self-attention (K/V gathered, dK/dV summed back)."""
    from diffusion_image_editing_tpu_torch.models.layers import (AttentionBlock2D,
                                                                 Downsample2D, GroupNormLayer)
    from diffusion_image_editing_tpu_torch.ops.conv import Conv3x3
    from diffusion_image_editing_tpu_torch.ops.split import SpatialSplit

    split = SpatialSplit(dist.group.WORLD)
    torch.manual_seed(0)
    fk = dict(device="cpu")
    gn = GroupNormLayer(16, 4, 1e-6, "silu", **fk)
    with torch.no_grad():
        gn.weight.uniform_(0.5, 1.5)
        gn.bias.uniform_(-0.2, 0.2)
    attn = AttentionBlock2D(16, 8, 4, 1e-6, **fk)
    cases = {"conv": (Conv3x3(8, 16, **fk), (1, 8, 8, 6)),
             "conv_one_row": (Conv3x3(8, 16, **fk), (1, 8, 2, 6)),
             "down_pad1": (Downsample2D(8, 16, padding=1, **fk), (1, 8, 8, 6)),
             "down_pad0": (Downsample2D(8, 16, padding=0, **fk), (1, 8, 8, 6)),
             "groupnorm": (gn, (2, 16, 8, 6)),
             "attention": (attn, (1, 16, 8, 6))}
    gen = torch.Generator().manual_seed(1)
    out = {}
    for name, (module, shape) in cases.items():
        x = 0.5 + torch.randn(shape, generator=gen)
        (y0, d0), (y1, d1) = _whole_and_split(module, x, torch.randn(
            module(x).shape, generator=gen), split)
        out[name] = {"fwd": (y1 - y0).abs().max().item(), "grad": (d1 - d0).abs().max().item(),
                     "scale": max(y0.abs().max().item(), d0.abs().max().item()),
                     "y": _np(y1), "dx": _np(d1)}
    return out


def _uneven() -> str:
    """A stage whose rows do not divide by the ranks raises, naming it."""
    from diffusion_image_editing_tpu_torch.models.layers import Downsample2D
    from diffusion_image_editing_tpu_torch.ops.split import (SpatialSplit, scatter_rows,
                                                                    spatial_split)

    split = SpatialSplit(dist.group.WORLD)
    down = Downsample2D(4, 4, padding=1, device="cpu")
    try:
        with spatial_split(split):
            down(scatter_rows(torch.zeros(1, 4, 6, 6), split))
    except ValueError as e:
        return str(e)
    return "no error"


class _FixedTextSD:
    """The port's SD with a fixed [uncond; cond] text embedding (no CLIP
    weights), made on first use so that the module imports no port code."""

    @staticmethod
    def make(payload, steps: int = STEPS):
        from diffusion_image_editing_tpu_torch import models as TM
        from diffusion_image_editing_tpu_torch.core import schedule_for_model
        from diffusion_image_editing_tpu_torch.pipeline import SD

        text = torch.from_numpy(payload["text"])

        class FixedTextSD(SD):
            def prep_text(self, prompt_ids=None):
                return text

        unet = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")
        unet.load_state_dict({k: torch.from_numpy(v) for k, v in payload["unet"].items()})
        vae = TM.AutoencoderKL(TM.TINY_VAE, device="cpu")
        vae.load_state_dict({k: torch.from_numpy(v) for k, v in payload["vae"].items()})
        return FixedTextSD(unet, vae, schedule_for_model("sd", steps), device="cpu")


def _mesh(spec: str):
    from diffusion_image_editing_tpu_torch.parallel import cfg_mesh, make_mesh

    return {"sp2": lambda: cfg_mesh(cfg=1, sp=2), "cfg2": lambda: cfg_mesh(cfg=2, sp=1),
            "cfg2xsp2": lambda: cfg_mesh(cfg=2, sp=2),
            "ddpm_sp2": lambda: make_mesh((2,), ("sp",))}[spec]()


def _decode(payload) -> dict:
    """The decode and the gradient of sum(decode(z)^2) with the rows over
    the whole mesh (`shard_decode_fn(..., axes=None)`), plain and
    checkpointed, against the same whole."""
    from diffusion_image_editing_tpu_torch.parallel import shard_decode_fn

    sd = _FixedTextSD.make(payload)
    mesh = _mesh("cfg2")
    z = torch.from_numpy(payload["z"])
    out = {}
    for name, fn in (("whole", sd.decode_fn()),
                     ("split", shard_decode_fn(sd.decode_fn(), mesh, axes=None)),
                     ("split_remat", shard_decode_fn(sd.decode_fn(remat_blocks=True), mesh,
                                                     axes=None))):
        zz = z.clone().requires_grad_(True)
        img = fn(zz)
        (g,) = torch.autograd.grad(img.square().sum(), zz)
        out[name] = {"img": _np(img), "grad": _np(g)}
    return out


def _sd_edit(payload, spec: str) -> dict:
    """DDIM inversion of an image, then a colour-guided edit, through the
    public pipeline on the mesh and off it."""
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline

    sd = _FixedTextSD.make(payload)
    img = torch.from_numpy(payload["img"])
    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=5.0, t1=0, t2=STEPS)
    out = {}
    for name, w in (("mesh", sd.to_mesh(_mesh(spec))), ("whole", sd)):
        pipe = EditPipeline(w)
        xt, *_ = pipe.prepare_real_image_edit(img, eta=0.0, inversion_method="ddim",
                                              cfg_scale=2.0)
        res = pipe.edit_image(xt, attr_func=attr, cfg_scale=2.0, collect=False)
        out[name] = {"xt": _np(xt), "imgs": _np(res.imgs)}
    out["eps_fn"] = type(sd.to_mesh(_mesh(spec)).eps_fn(torch.zeros(2, 7, 32))).__name__
    return out


def _ddpm_edit(payload) -> dict:
    """DDPM: the unconditional UNet's rows over the whole mesh (sp2), a DDIM
    inversion and a colour-guided edit, on the mesh and off it."""
    from diffusion_image_editing_tpu_torch import models as TM
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import DDPM, EditPipeline

    unet = TM.UNet2D(TM.TINY_UNET2D, device="cpu")
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in payload["unet2d"].items()})
    ddpm = DDPM(unet, schedule_for_model("ddpm", STEPS, clip_sample=False), device="cpu")
    img = torch.from_numpy(payload["img16"])
    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=5.0, t1=0, t2=STEPS)
    out = {}
    for name, w in (("mesh", ddpm.to_mesh(_mesh("ddpm_sp2"))), ("whole", ddpm)):
        pipe = EditPipeline(w)
        xt, *_ = pipe.prepare_real_image_edit(img, eta=0.0, inversion_method="ddim")
        res = pipe.edit_image(xt, attr_func=attr, collect=False)
        out[name] = {"xt": _np(xt), "imgs": _np(res.imgs)}
    out["eps_fn"] = type(ddpm.to_mesh(_mesh("ddpm_sp2")).eps_fn()).__name__
    return out


def _cli(payload, spec: str) -> dict:
    """The CLI under a group that is up, as under torchrun: `generate` of
    the DDPM directory on sp2, `edit` of the SD directory on cfg2 and on
    cfg2xsp2."""
    from diffusion_image_editing_tpu_torch import cli

    root = payload["cli_dir"]
    if spec == "sp2":
        prefix = os.path.join(root, "gen_sp2")
        argv = ["generate", "--device", "cpu", "--family", "ddpm", "--checkpoint-dir",
                payload["ddpm_dir"], "--steps", "2", "--out-prefix", prefix]
        want = f"{prefix}_0.png"
    else:
        want = os.path.join(root, f"edit_{spec}.png")
        argv = ["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir",
                payload["sd_dir"], "--image", payload["face"], "--steps", "2", "--attr-func",
                "SingleColorAttrFunc", "--out", want]
    text = io.StringIO()
    with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv + ["--shard", spec])
    dist.barrier()
    return {"rc": rc, "out": text.getvalue(), "written": os.path.exists(want)}


def _cli_refused(payload) -> str:
    """`edit --family sd --shard sp2`: the SD CLI runs CFG, which needs a
    `cfg` axis; the refusal comes before any model is loaded."""
    from diffusion_image_editing_tpu_torch import cli

    try:
        cli.main(["edit", "--device", "cpu", "--family", "sd", "--checkpoint-dir",
                  payload["sd_dir"], "--image", payload["face"], "--shard", "sp2"])
    except SystemExit as e:
        return str(e)
    return "no refusal"
