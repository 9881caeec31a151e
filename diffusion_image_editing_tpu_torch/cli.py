"""Command line of the port:

    python -m diffusion_image_editing_tpu_torch.cli generate --checkpoint-dir SD --prompt ...
    python -m diffusion_image_editing_tpu_torch.cli edit --checkpoint-dir SD --image in.png ...
    python -m diffusion_image_editing_tpu_torch.cli seg-train [--norm abn] ...

`generate` and `edit` run the SD family from an HF-layout checkpoint
directory (`unet/`, `vae/`, `text_encoder/`, `tokenizer/`), which they
require: the prompt is tokenized, and an empty `--prompt` runs CFG between
two empty prompts. (The JAX package's CLI passes no prompt ids for an empty
prompt, and its SD UNet cannot run without a context.) `seg-train` trains BiSeNet
on CelebAMask-HQ (`--data-root`) or, without it, on synthetic data. Each
runs on one CUDA device unless `--device cpu` asks for the CPU; none falls
back to the CPU on its own. The flags are the JAX package's; the options
of later slices exit with a message naming their ROADMAP Queue A item.
`metrics` and `seg-eval` come with item 20.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

import torch

# Options of the JAX package's CLI that the port does not have yet, and the
# ROADMAP Queue A item that brings each; their defaults are None, so that
# setting one in any way is refused.
UNPORTED = {
    "align": ("--align", "20 (host/alignment.py)"),
    "landmarks": ("--landmarks", "20 (host/alignment.py)"),
    "classes": ("--classes", "15a (segmentation guidance)"),
    "bisenet_ckpt": ("--bisenet-ckpt", "15a (segmentation guidance)"),
    "dilate_mask": ("--dilate-mask", "15a (segmentation guidance)"),
    "sample_clipping": ("--sample-clipping", "14 (the ddpm and ldm families; SD never clips)"),
    "shard": ("--shard", "18 (parallel/)"),
}


def _refuse_unported(args) -> None:
    for dest, (flag, item) in UNPORTED.items():
        if getattr(args, dest, None) is not None:
            raise SystemExit(f"{flag} is not ported yet: Queue A item {item}")
    if args.encoder_reuse > 1:
        raise SystemExit("--encoder-reuse > 1 is not ported yet: Queue A item 16")
    if getattr(args, "guidance_codec", "full") != "full":
        raise SystemExit("--guidance-codec proxy is not ported yet: Queue A item 16")


def _build_wrapper(args):
    from .pipeline import create_diffusion_model

    _refuse_unported(args)
    if args.family == "sd" and not (
            args.checkpoint_dir and os.path.isdir(os.path.join(args.checkpoint_dir, "tokenizer"))):
        raise SystemExit("--family sd needs --checkpoint-dir with a tokenizer/ directory to "
                         "encode the prompt")
    return create_diffusion_model(
        args.family, checkpoint_dir=args.checkpoint_dir, num_inference_steps=args.steps,
        device=args.device)


def _prompt_ids(w, prompt: str):
    """The prompt's ids, paired with the empty prompt's by `SD.prep_text`:
    an empty prompt runs CFG between two empty prompts."""
    return torch.tensor(w.tokenizer.encode(prompt), dtype=torch.long)


def cmd_generate(args) -> None:
    from .host.transforms import tensors_to_pils

    w = _build_wrapper(args)
    imgs, *_ = w.generate_images(
        num_images=args.num_images, eta=args.eta, num_inference_steps=args.steps,
        seed=args.seed, prompt_ids=_prompt_ids(w, args.prompt), cfg_scale=args.cfg_scale)
    for i, pil in enumerate(tensors_to_pils(imgs)):
        path = f"{args.out_prefix}_{i}.png"
        pil.save(path)
        print(path)


def cmd_edit(args) -> None:
    from PIL import Image

    from .guidance import create_attr_func_registry
    from .host.transforms import pil_to_tensor, tensor_to_pil
    from .pipeline import EditPipeline

    w = _build_wrapper(args)
    pipe = EditPipeline(w)
    size = args.image_size or w.vae.config.sample_size
    img = pil_to_tensor(Image.open(args.image).convert("RGB").resize((size, size)))
    attr = None
    if args.attr_func:
        params = dict(loss_scale=args.loss_scale, t1=args.t1, t2=args.t2,
                      stride=args.guidance_stride)
        if args.attr_func == "SingleColorAttrFunc":
            params.update(target=args.color_target, color_idx=args.color_idx)
        attr = create_attr_func_registry().get(args.attr_func, params)
    ids = _prompt_ids(w, args.prompt)
    t_skip = args.t_skip if args.inversion_method == "ddpm" else None
    xt, zs, xts, mask, _ = pipe.prepare_real_image_edit(
        img, eta=args.eta, inversion_method=args.inversion_method, prompt_ids=ids,
        cfg_scale=args.cfg_scale, t_skip=t_skip,
        generator=torch.Generator(device=w.device).manual_seed(args.seed))
    if args.resynthesize:
        # No segmentation mask before Queue A item 15a: resynthesis covers
        # the whole latent.
        mask = torch.ones_like(xt)
    out = pipe.edit_image(
        xt, eta=args.eta, zs=zs, xts=xts, mask=mask, attr_func=attr, prompt_ids=ids,
        cfg_scale=args.cfg_scale, inversion_method=args.inversion_method, t_skip=t_skip,
        resynthesize=args.resynthesize, mode=args.edit_mode,
        generator=torch.Generator(device=w.device).manual_seed(args.seed))
    tensor_to_pil(out.imgs).save(args.out)
    print(args.out)


def cmd_seg_train(args) -> None:
    from .seg import FaceMaskDataset, SyntheticFaceMask, TrainConfig, batch_iterator, train_loop

    cfg = TrainConfig(
        image_size=args.image_size, batch_size_per_device=args.batch_size,
        max_iter=args.max_iter, norm=args.norm, width=args.width,
        compute_dtype=args.compute_dtype,
    )
    if args.data_root:
        ds = FaceMaskDataset(args.data_root, (args.image_size, args.image_size),
                             raw=args.raw_feed)
    else:
        print("WARNING: synthetic data (no --data-root)", file=sys.stderr)
        ds = SyntheticFaceMask(size=args.image_size, raw=args.raw_feed)
    data = batch_iterator(ds, args.batch_size, prefetch=args.prefetch,
                          num_workers=args.num_workers)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    _, state, losses = train_loop(cfg, data, ckpt_dir=args.ckpt_dir, num_steps=args.num_steps,
                                  logger=logging.getLogger("seg-train"), device=args.device)
    last = f"{losses[-1]:.4f}" if losses else "none"
    print(f"seg-train: step {state.step}, {len(losses)} steps this run, last loss {last}")


def _common(sp) -> None:
    sp.add_argument("--family", default="sd", choices=["ddpm", "ldm", "sd"],
                    help="model family; ddpm and ldm come with Queue A item 14")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--encoder-reuse", type=int, default=1,
                    help="encoder propagation interval; only 1 (exact) is ported")
    sp.add_argument("--shard", default=None, metavar="SPEC", help="not ported (item 18)")
    sp.add_argument("--prompt", default="")
    sp.add_argument("--cfg-scale", type=float, default=3.5)
    sp.add_argument("--eta", type=float, default=0.0)
    sp.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; 'cpu' for the CPU)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="diffusion_image_editing_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate")
    _common(g)
    g.add_argument("--num-images", type=int, default=1)
    g.add_argument("--sample-clipping", action=argparse.BooleanOptionalAction, default=None,
                   help="clip pred-x0 to [-1, 1]: the ddpm and ldm families only, not ported "
                        "(item 14)")
    g.add_argument("--out-prefix", default="generated")
    g.set_defaults(fn=cmd_generate)

    e = sub.add_parser("edit")
    _common(e)
    e.add_argument("--image", required=True)
    e.add_argument("--image-size", type=int, default=None,
                   help="pixels a side (default: the VAE's sample size)")
    e.add_argument("--align", action="store_true", default=None, help="not ported (item 20)")
    e.add_argument("--landmarks", default=None, help="not ported (item 20)")
    e.add_argument("--inversion-method", default="ddim", choices=["ddim", "ddpm"])
    e.add_argument("--t-skip", type=int, default=36)
    e.add_argument("--attr-func", default=None)
    e.add_argument("--loss-scale", type=float, default=1.0)
    e.add_argument("--t1", type=int, default=0)
    e.add_argument("--t2", type=int, default=50)
    e.add_argument("--color-target", type=float, default=0.9)
    e.add_argument("--color-idx", type=int, default=0)
    e.add_argument("--classes", type=int, nargs="*", default=None,
                   help="segmentation class ids; not ported (item 15a)")
    e.add_argument("--bisenet-ckpt", default=None, help="not ported (item 15a)")
    e.add_argument("--dilate-mask", action="store_true", default=None,
                   help="not ported (item 15a)")
    e.add_argument("--resynthesize", action="store_true", default=False,
                   help="fresh noise inside the mask (the whole latent without --classes)")
    e.add_argument("--edit-mode", default="split", choices=["split", "fused"],
                   help="the edit loop's mode (the same loop in the port)")
    e.add_argument("--guidance-codec", default="full", choices=["full", "proxy"],
                   help="proxy: not ported (item 16)")
    e.add_argument("--guidance-stride", type=int, default=1,
                   help="apply the guidance nudge every K-th step inside [t1, t2)")
    e.add_argument("--out", default="edited.png")
    e.set_defaults(fn=cmd_edit)
    t = sub.add_parser("seg-train")
    t.add_argument("--data-root", default=None)
    t.add_argument("--image-size", type=int, default=448)
    t.add_argument("--batch-size", type=int, default=16)
    t.add_argument("--max-iter", type=int, default=80000)
    t.add_argument("--num-steps", type=int, default=None)
    t.add_argument("--norm", default="bn", choices=["bn", "abn", "abn_sync"])
    t.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                   help="conv compute dtype (parameters and norms stay f32)")
    t.add_argument("--width", type=int, default=64)
    t.add_argument("--ckpt-dir", default=None)
    t.add_argument("--prefetch", type=int, default=2,
                   help="batches kept in flight by the background prefetch thread (0: none)")
    t.add_argument("--raw-feed", action="store_true",
                   help="ship uint8 batches and ImageNet-normalise on the device")
    t.add_argument("--num-workers", type=int, default=2,
                   help="thread-pool workers loading the items of a batch")
    t.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; 'cpu' for the CPU)")
    t.set_defaults(fn=cmd_seg_train)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.fn(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
