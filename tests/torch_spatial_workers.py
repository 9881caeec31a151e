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
    def make(payload, steps: int = STEPS, fused_conv: bool = False):
        import dataclasses

        from diffusion_image_editing_tpu_torch import models as TM
        from diffusion_image_editing_tpu_torch.core import schedule_for_model
        from diffusion_image_editing_tpu_torch.pipeline import SD

        text = torch.from_numpy(payload["text"])

        class FixedTextSD(SD):
            def prep_text(self, prompt_ids=None):
                return text

        unet = TM.UNet2DCondition(dataclasses.replace(TM.TINY_SD_UNET, fused_conv=fused_conv),
                                  device="cpu")
        unet.load_state_dict({k: torch.from_numpy(v) for k, v in payload["unet"].items()})
        vae = TM.AutoencoderKL(dataclasses.replace(TM.TINY_VAE, fused_conv=fused_conv),
                               device="cpu")
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


def _sd_edit(payload, spec: str, fused_conv: bool = False) -> dict:
    """DDIM inversion of an image, then a colour-guided edit, through the
    public pipeline on the mesh and off it."""
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline

    sd = _FixedTextSD.make(payload, fused_conv=fused_conv)
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


# ---------------------------------------------------------------------------
# tests/test_torch_spatial_modes.py: fused_conv (K7) and the conv modes split
# ---------------------------------------------------------------------------

MODES_MIN_H = 32  # int8_large's gate in the TINY SD edit: the VAE's 32-row stage


def run_modes_rank(rank: int, world: int, store_path: str, payload: dict, queue) -> None:
    """A rank of tests/test_torch_spatial_modes.py: every split op of the
    opt-in accelerations against the whole op, the moment fold's control,
    and the TINY SD edit on sp2 with fused_conv and with int8_large."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        out = {"ops": _mode_ops(), "fold_control": _fold_control(),
               "cfg_int8": _cfg_pair_int8(payload),
               "sd": {v: _sd_mode_edit(payload, v) for v in ("fused", "int8_large")}}
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _counted_fused_calls():
    """Counts `ResnetBlock2D`'s fused branch by where it runs: "split" or
    "whole"."""
    from diffusion_image_editing_tpu_torch.models import layers
    from diffusion_image_editing_tpu_torch.ops.split import current

    counts = {"split": 0, "whole": 0}
    orig = layers.gn_silu_conv3x3

    def counted(*args, **kwargs):
        counts["whole" if current() is None else "split"] += 1
        return orig(*args, **kwargs)

    layers.gn_silu_conv3x3 = counted
    try:
        yield counts
    finally:
        layers.gn_silu_conv3x3 = orig


def _mode_cases():
    """name -> (function of a rank's rows, whole input shape, conv mode or
    None): a fused ResnetBlock2D with a temb shift at 4 rows a rank, the
    fused GroupNorm+SiLU -> conv at 1 row a rank, and a Conv3x3 in each
    conv mode (int8_large's gate passes on the whole map's 8 rows and not
    on a rank's 4)."""
    from diffusion_image_editing_tpu_torch.models.layers import ResnetBlock2D
    from diffusion_image_editing_tpu_torch.ops.conv import Conv3x3
    from diffusion_image_editing_tpu_torch.ops.fused_conv import gn_silu_conv3x3

    torch.manual_seed(0)
    block = ResnetBlock2D(16, 24, 12, 4, fused_conv=True, device="cpu")
    with torch.no_grad():
        for norm in (block.norm1, block.norm2):
            norm.weight.uniform_(0.5, 1.5)
            norm.bias.uniform_(-0.2, 0.2)
    temb = torch.randn(2, 12)
    norm, conv = block.norm1, block.conv1
    shift = 0.3 * torch.randn(2, 16)
    conv8 = Conv3x3(8, 16, device="cpu")
    return {
        "fused_block": (lambda r: block(r, temb), (2, 16, 8, 6), None),
        "fused_one_row": (lambda r: gn_silu_conv3x3(r, norm.weight, norm.bias, 4, 1e-6,
                                                    conv.weight, conv.bias, shift),
                          (2, 16, 2, 6), None),
        "int8": (conv8, (1, 8, 8, 6), ("int8", 128, False)),
        "int8_bwd": (conv8, (1, 8, 8, 6), ("int8", 128, True)),
        "int8_large": (conv8, (1, 8, 8, 6), ("int8_large", 8, True)),
        "shift9": (conv8, (1, 8, 8, 6), ("shift9", 128, False)),
    }


def _mode_ops(cases=None) -> dict:
    """Each case split over the two ranks against the whole, forward and
    gradient (`_whole_and_split`); the conv paths the split run took."""
    from diffusion_image_editing_tpu_torch.ops import conv as C
    from diffusion_image_editing_tpu_torch.ops.split import SpatialSplit

    split = SpatialSplit(dist.group.WORLD)
    gen = torch.Generator().manual_seed(1)
    out = {}
    for name, (fn, shape, mode) in (cases or _mode_cases()).items():
        x = 0.5 + torch.randn(shape, generator=gen)
        cot = torch.randn(fn(x).shape, generator=gen)
        before = dict(C.CALL_COUNTS)
        with contextlib.ExitStack() as stack:
            if mode is not None:
                stack.enter_context(C.conv_mode(mode[0], min_h=mode[1], int8_bwd=mode[2]))
            fused = stack.enter_context(_counted_fused_calls())
            (y0, d0), (y1, d1) = _whole_and_split(fn, x, cot, split)
        out[name] = {"fwd": (y1 - y0).abs().max().item(), "grad": (d1 - d0).abs().max().item(),
                     "scale": max(y0.abs().max().item(), d0.abs().max().item()),
                     "fwd_equal": bool(torch.equal(y0, y1)),
                     "grad_equal": bool(torch.equal(d0, d1)),
                     "paths": {k: C.CALL_COUNTS[k] - before[k] for k in C.CALL_COUNTS},
                     "fused": fused, "y": _np(y1), "dx": _np(d1)}
    return out


def _fold_control() -> dict:
    """The fused block with the ranks' gradients of the folded moments not
    summed (each rank keeps its own share): the forward is as before, the
    gradient is not."""
    from diffusion_image_editing_tpu_torch.ops import fused_conv

    orig = fused_conv.all_reduce_sum
    fused_conv.all_reduce_sum = lambda x, group: x.clone()
    try:
        cases = _mode_cases()
        return _mode_ops({"fused_block": cases["fused_block"]})["fused_block"]
    finally:
        fused_conv.all_reduce_sum = orig


def _cfg_pair_int8(payload) -> dict:
    """The TINY SD's CFG eps under conv mode "int8" with the pair over
    `cfg_mesh(cfg=2, sp=1)` against the pair whole: each branch's int8
    scales are the max over both ranks, as over the whole batch. The
    control keeps each rank's own max."""
    from diffusion_image_editing_tpu_torch.ops.conv import conv_mode

    sd = _FixedTextSD.make(payload)
    text = sd.prep_text(None)
    x = torch.randn((1, 4, 16, 16), generator=torch.Generator().manual_seed(2))
    with conv_mode("int8"):
        whole = sd.eps_fn(text, 2.0)(x, 501)
        pair = sd.to_mesh(_mesh("cfg2")).eps_fn(text, 2.0)
        split = pair(x, 501)
        pair.spread = None
        control = pair(x, 501)
    scale = whole.abs().max().item()
    return {"fwd": (split - whole).abs().max().item(), "scale": scale,
            "control": (control - whole).abs().max().item(), "eps": _np(split)}


def _sd_mode_edit(payload, variant: str) -> dict:
    """The TINY SD edit (`_sd_edit`) on sp2 with fused_conv, or under
    int8_large at MODES_MIN_H; the fused calls and conv paths it took."""
    from diffusion_image_editing_tpu_torch.ops import conv as C

    before = dict(C.CALL_COUNTS)
    with contextlib.ExitStack() as stack:
        if variant == "int8_large":
            stack.enter_context(C.conv_mode("int8_large", min_h=MODES_MIN_H))
        fused = stack.enter_context(_counted_fused_calls())
        out = _sd_edit(payload, "sp2", fused_conv=variant == "fused")
    return dict(out, fused=fused, paths={k: C.CALL_COUNTS[k] - before[k] for k in C.CALL_COUNTS})
