"""Rank code of tests/test_torch_dist.py: the port's multi-rank pieces over
a real gloo process group on the CPU. Each rank runs every check and puts
its results (numpy arrays and numbers) on a queue; the test compares them
across ranks, with the one-process versions and with the JAX package. It
imports torch and the port only, so that the ranks start quickly."""

import contextlib
import datetime
import io
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist


def run_rank(rank: int, world: int, store_path: str, payload: dict, queue) -> None:
    torch.set_num_threads(1)
    # A collective whose peer has died fails within the timeout, not gloo's 30 min.
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=300))
    try:
        out = {"abn": _abn(rank, payload["abn"]),
               "train": {norm: _train(payload["train"], norm) for norm in ("abn_sync", "bn")},
               "cfg": _cfg(),
               "sweep": _sweep(),
               "cli": _cli(payload["cli_dir"])}
        queue.put((rank, out))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _abn(rank: int, p: dict) -> dict:
    """Synced statistics on this rank's half of the batch against the
    unsynced ones on the whole batch (computed here too)."""
    from diffusion_image_editing_tpu_torch.ops import abn as T
    from diffusion_image_editing_tpu_torch.parallel import make_mesh

    mesh = make_mesh((dist.get_world_size(),), ("data",))
    group = dist.group.WORLD
    rows = slice(rank * 2, rank * 2 + 2)
    x, xhat, dz, cot = (torch.from_numpy(p[k]) for k in ("x", "xhat", "dz", "cot"))
    errs = {}
    for name, got, want in (("mean_var", T.mean_var(x[rows], group), T.mean_var(x)),
                            ("edz_eydz", T.edz_eydz(xhat[rows], dz[rows], mesh),
                             T.edz_eydz(xhat, dz))):
        errs[name] = max((g - w).abs().max().item() for g, w in zip(got, want))

    def layer_run(axis, xs, cs):
        layer = T.FusedABNorm(x.shape[1], axis_name=axis)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(p["w"]))
            layer.bias.copy_(torch.from_numpy(p["b"]))
        xs = xs.clone().requires_grad_(True)
        y = layer(xs)
        dx, dw, db = torch.autograd.grad((y * cs).sum(), (xs, layer.weight, layer.bias))
        return {"y": y, "dx": dx, "dw": dw, "db": db, "rm": layer.running_mean,
                "rv": layer.running_var}

    got = layer_run(mesh, x[rows], cot[rows])
    want = layer_run(None, x, cot)
    for k in ("y", "dx"):
        want[k] = want[k][rows]
    return {"errs": errs, "layer": {k: _np(got[k]) for k in got},
            "layer_want": {k: _np(want[k]) for k in want}}


def _train(p: dict, norm: str) -> dict:
    """Two data-parallel steps from the given weights on this rank's share
    of each global batch."""
    from diffusion_image_editing_tpu_torch.parallel import make_mesh
    from diffusion_image_editing_tpu_torch.seg import train as TT

    mesh = make_mesh(axis_names=("dp",))
    cfg = TT.TrainConfig(**p["cfg"][norm], norm=norm)
    axis = mesh["dp"] if norm == "abn_sync" else None
    model, state = TT.create_train_state(cfg, 0, "cpu", axis_name=axis)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in p["start"][norm].items()})
    step = TT.make_sharded_train_step(model, cfg, mesh)
    losses = []
    for batch in p["batches"]:
        state, loss = step(state, *TT.shard_batch(batch, mesh))
        losses.append(float(loss))
    return {"losses": losses, "state": {k: _np(v) for k, v in model.state_dict().items()},
            "step": state.step}


def _tiny_sd(steps: int):
    from diffusion_image_editing_tpu_torch import models as TM
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import SD

    torch.manual_seed(0)
    unet = TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")
    vae = TM.AutoencoderKL(TM.TINY_VAE, device="cpu")
    rng = np.random.default_rng(5)
    emb = torch.from_numpy(rng.standard_normal((2, 7, 32)).astype(np.float32))
    xt = torch.from_numpy(rng.standard_normal((1, 4, 16, 16)).astype(np.float32))
    return SD(unet, vae, schedule_for_model("sd", steps), device="cpu"), emb, xt


def _cfg() -> dict:
    """The CFG pair over a cfg axis of 2 (one branch a rank) against the
    one-process closure: one call at batch 2, and a 3-step guided edit of
    the wrapper on the mesh against the same edit off it."""
    from diffusion_image_editing_tpu_torch.engine import CfgEpsClosure, edit_split
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.parallel import ShardedCfgEpsClosure, cfg_mesh

    sd, emb, xt = _tiny_sd(3)
    mesh = cfg_mesh(cfg=2, sp=1)
    x = torch.cat([xt, 0.5 * xt])
    sharded = ShardedCfgEpsClosure(sd.unet, emb, 3.5, mesh)(x, 501)
    plain = CfgEpsClosure(sd.unet, emb, 3.5)(x, 501)
    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=3)
    on_mesh = sd.to_mesh(mesh)
    edits = [edit_split(w.schedule, w.eps_fn(emb, 3.5), xt, attr_func=attr,
                        decode_fn=w.decode_fn()).x0 for w in (on_mesh, sd)]
    return {"eps": _np(sharded), "eps_plain": _np(plain), "edit": _np(edits[0]),
            "edit_plain": _np(edits[1]), "eps_fn": type(on_mesh.eps_fn(emb)).__name__}


def _sweep() -> dict:
    """A loss-scale grid of 4 and a seed sweep of 4, two points a rank over
    a data axis of 2, against the same without a mesh."""
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.parallel import (
        guided_edit_sweep, make_mesh, seed_sweep_generate, sweep_attr_func)

    sd, emb, xt = _tiny_sd(2)
    mesh = make_mesh((2,), ("data",))
    af = sweep_attr_func(SingleColorAttrFunc(target=0.9, color_idx=0, t1=0, t2=2),
                         loss_scale=[0.0, 5.0, 10.0, 20.0])
    eps_fn = sd.eps_fn(emb)
    runs = [guided_edit_sweep(sd.schedule, eps_fn, xt, af, decode_fn=sd.decode_fn(), mesh=m)
            for m in (mesh, None)]
    seeds = [seed_sweep_generate(sd.schedule, eps_fn, (1, 4, 16, 16), [1, 2, 3, 4], eta=1.0,
                                 mesh=m, device="cpu") for m in (mesh, None)]
    return {"edit": _np(runs[0]), "edit_plain": _np(runs[1]), "seeds": _np(seeds[0]),
            "seeds_plain": _np(seeds[1])}


def _cli(root: str) -> dict:
    """`seg-train --norm abn_sync` as under torchrun: the group is up."""
    from diffusion_image_editing_tpu_torch import cli

    ckpt = os.path.join(root, "ckpt")
    text = io.StringIO()
    with contextlib.redirect_stdout(text), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["seg-train", "--device", "cpu", "--image-size", "32", "--batch-size",
                       "2", "--width", "4", "--norm", "abn_sync", "--num-steps", "2",
                       "--prefetch", "0", "--num-workers", "0", "--raw-feed", "--ckpt-dir",
                       ckpt])
    dist.barrier()
    files = sorted(os.listdir(ckpt)) if os.path.isdir(ckpt) else []
    return {"rc": rc, "out": text.getvalue(), "files": files}
