"""Command line of the port:

    python -m diffusion_image_editing_tpu_torch.cli generate [--family ddpm|ldm|sd] ...
    python -m diffusion_image_editing_tpu_torch.cli edit --image in.png [--align] ...
    python -m diffusion_image_editing_tpu_torch.cli metrics [--attr-func NAME] ...
    python -m diffusion_image_editing_tpu_torch.cli seg-train [--norm abn] ...
    python -m diffusion_image_editing_tpu_torch.cli seg-eval --image-dir DIR ...

`--family` defaults to ddpm, as in the JAX package's CLI. The unconditional
families take no prompt: `--family ddpm` reads `unet/`, `--family ldm`
`unet/` and `vqvae/` from `--checkpoint-dir`, or seeded random weights
without it; generation clips pred-x0 unless `--no-sample-clipping`, and a
real-image edit never clips, as in the JAX package. `--family sd` needs an
HF-layout directory (`unet/`, `vae/`, `text_encoder/`, `tokenizer/`): the
prompt is tokenized, and an empty `--prompt` runs CFG between two empty
prompts. (The JAX package's CLI passes no prompt ids for an empty prompt,
and its SD UNet cannot run without a context.) `edit --classes 17` masks the
edit to face-parsing classes, from a BiSeNet checkpoint (`--bisenet-ckpt`)
or seeded random weights; `edit --align` aligns the face first (FFHQ
geometry), from dlib's landmarks (`--landmarks PATH`) or from the BiSeNet
parsing. `metrics` generates, edits and scores: with `--attr-func`, the
anyGAN attribute consistency and score deltas; without it, an inversion
round trip's PSNR. `seg-train` trains BiSeNet on CelebAMask-HQ
(`--data-root`) or, without it, on synthetic data; `seg-eval` writes
parsing overlays of a directory of images. Each runs on one CUDA device
unless `--device cpu` asks for the CPU; none falls back to the CPU on its
own. The flags are the JAX package's, `--encoder-reuse` (encoder
propagation) and `edit --guidance-codec proxy` among them.

Under `torchrun --nproc-per-node N` each rank takes `cuda:LOCAL_RANK` (NCCL;
gloo with `--device cpu`). `seg-train` then trains data-parallel over the
N ranks (each rank's share of a global batch of N x `--batch-size`;
`--norm abn_sync` syncs the norms' statistics over them), and `generate`,
`edit` and `metrics` take `--shard SPEC` over the N ranks (`wrapper.to_mesh`):
`cfg2` splits the CFG pair (one branch a rank), `sp2` / `dp8` the latent's
rows, `cfg2xsp2` / `cfg2xsp4` both; the codec's rows split over every
rank. A CFG call (`--family sd`) needs a `cfg` axis, as in the JAX package.
The first rank writes the outputs.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import re
import sys

import torch
import torch.distributed as dist

from .parallel.mesh import is_first_rank, world_size


def _parse_mesh(spec: str):
    """--shard mesh spec, as the JAX package's: "cfg2" (the CFG pair over two
    ranks), "cfg2xsp4", "sp8", "dp8": axes joined by "x". (The JAX package's
    parser reads "cfg2xsp4" as the axes "cfg" and "xsp" and refuses it.)
    The run needs as many ranks as the spec's sizes multiply to."""
    from .parallel import make_mesh

    pairs = [re.fullmatch(r"([a-z]+)(\d+)", part) for part in spec.split("x")]
    if not all(pairs):
        raise SystemExit(f"bad --shard spec {spec!r} (e.g. cfg2xsp4, sp8)")
    pairs = [m.groups() for m in pairs]
    names = tuple(a for a, _ in pairs)
    sizes = tuple(int(n) for _, n in pairs)
    if len(set(names)) != len(names) or min(sizes) < 1:
        raise SystemExit(f"bad --shard spec {spec!r}: each axis once, each of size 1 or more")
    total = math.prod(sizes)
    if total != world_size():
        raise SystemExit(f"--shard {spec} needs {total} devices, have {world_size()} "
                         f"(run it under torchrun --nproc-per-node {total})")
    return make_mesh(sizes, names) if dist.is_initialized() else None


def _build_wrapper(args, sample_clipping: bool):
    from .pipeline import create_diffusion_model

    mesh = _parse_mesh(args.shard) if args.shard else None
    if mesh is not None and args.family == "sd":  # the SD CLI always runs CFG
        from .parallel import check_cfg_mesh

        try:
            check_cfg_mesh(mesh)
        except ValueError as e:
            raise SystemExit(f"--shard {args.shard}: {e}") from None
    if args.family == "sd" and not (
            args.checkpoint_dir and os.path.isdir(os.path.join(args.checkpoint_dir, "tokenizer"))):
        raise SystemExit("--family sd needs --checkpoint-dir with a tokenizer/ directory to "
                         "encode the prompt")
    w = create_diffusion_model(
        args.family, sample_clipping=sample_clipping, checkpoint_dir=args.checkpoint_dir,
        num_inference_steps=args.steps, device=args.device)
    return w if mesh is None else w.to_mesh(mesh)


def _prompt_ids(w, prompt: str):
    """SD: the prompt's ids, paired with the empty prompt's by
    `SD.prep_text` (an empty prompt runs CFG between two empty prompts).
    The unconditional families take none."""
    if w.family != "sd":
        return None
    return torch.tensor(w.tokenizer.encode(prompt), dtype=torch.long)


def _image_size(w) -> int:
    """The codec's sample size (the UNet's for DDPM's pixel space)."""
    codec = {"sd": "vae", "ldm": "vqvae"}.get(w.family)
    return getattr(w, codec).config.sample_size if codec else w.data_dimensionality


def cmd_generate(args) -> None:
    from .host.transforms import tensors_to_pils

    w = _build_wrapper(args, args.sample_clipping)
    imgs, *_ = w.generate_images(
        num_images=args.num_images, eta=args.eta, num_inference_steps=args.steps,
        seed=args.seed, prompt_ids=_prompt_ids(w, args.prompt), cfg_scale=args.cfg_scale,
        encoder_reuse=args.encoder_reuse)
    if not is_first_rank():
        return
    for i, pil in enumerate(tensors_to_pils(imgs)):
        path = f"{args.out_prefix}_{i}.png"
        pil.save(path)
        print(path)


def _attr_func(args, **extra):
    """The registry's strategy named by `--attr-func`, or None."""
    from .guidance import create_attr_func_registry

    if not args.attr_func:
        return None
    params = dict(loss_scale=args.loss_scale, t1=args.t1, t2=args.t2, **extra)
    if args.attr_func == "SingleColorAttrFunc":
        params.update(target=args.color_target, color_idx=args.color_idx)
    return create_attr_func_registry().get(args.attr_func, params)


def _load_image(args, size: int, seg_fn):
    """The `--image` at `size` x `size`: resized, or with `--align` aligned
    (landmarks from dlib with `--landmarks`, else from the parsing)."""
    import numpy as np
    from PIL import Image

    from .host.transforms import pil_to_tensor

    pil = Image.open(args.image).convert("RGB")
    if not args.align:
        return pil_to_tensor(pil.resize((size, size)))
    from .host.alignment import align_face, align_from_parsing, dlib_landmarker

    if args.landmarks:
        lm = dlib_landmarker(args.landmarks)(np.asarray(pil))
        pil = align_face(pil, landmarks=lm, output_size=size, transform_size=size)
    else:
        parsing = seg_fn(pil_to_tensor(pil)).cpu().numpy()
        pil = align_from_parsing(pil, parsing, output_size=size)
    return pil_to_tensor(pil)


def cmd_edit(args) -> None:
    from .host.transforms import tensor_to_pil
    from .pipeline import EditPipeline, create_segmentation_model

    w = _build_wrapper(args, False)  # a real-image edit runs unclipped
    seg_fn = None
    if args.classes or (args.align and not args.landmarks):
        seg_fn = create_segmentation_model(args.bisenet_ckpt, device=args.device)
    pipe = EditPipeline(w, seg_fn)
    img = _load_image(args, args.image_size or _image_size(w), seg_fn)
    attr = _attr_func(args, stride=args.guidance_stride)
    ids = _prompt_ids(w, args.prompt)
    t_skip = args.t_skip if args.inversion_method == "ddpm" else None
    xt, zs, xts, mask, _ = pipe.prepare_real_image_edit(
        img, eta=args.eta, inversion_method=args.inversion_method, classes=args.classes,
        dilate_mask=args.dilate_mask, prompt_ids=ids, cfg_scale=args.cfg_scale, t_skip=t_skip,
        generator=torch.Generator(device=w.device).manual_seed(args.seed))
    if args.resynthesize and mask is None:
        # Without --classes, resynthesis covers the whole latent.
        mask = torch.ones_like(xt)
    out = pipe.edit_image(
        xt, eta=args.eta, zs=zs, xts=xts, mask=mask, attr_func=attr, prompt_ids=ids,
        cfg_scale=args.cfg_scale, inversion_method=args.inversion_method, t_skip=t_skip,
        resynthesize=args.resynthesize, mode=args.edit_mode,
        generator=torch.Generator(device=w.device).manual_seed(args.seed),
        encoder_reuse=args.encoder_reuse, guidance_codec=args.guidance_codec)
    if is_first_rank():
        tensor_to_pil(out.imgs).save(args.out)
        print(args.out)


def cmd_metrics(args) -> None:
    """Generate -> guided edit -> anyGAN attribute consistency and score
    deltas; without `--attr-func`, an inversion round trip's PSNR and MSE.
    The predictor takes the images as they are, [-1, 1], as the JAX
    package's CLI passes them."""
    from .evals import inversion_roundtrip_metrics, run_attribute_evaluation
    from .pipeline import EditPipeline, get_pretrained_anygan

    w = _build_wrapper(args, False)
    if args.attr_func:
        predict, _ = get_pretrained_anygan(args.anygan_ckpt, device=args.device)
        res = run_attribute_evaluation(
            w, EditPipeline(w), predict, _attr_func(args), n_samples=args.n,
            num_inference_steps=args.steps, seed=args.seed, eta=args.eta,
            inversion=args.inversion, t_skip=args.t_skip, resynthesize=args.resynthesize)
        for name, pct in res["attribute_consistency"].items():
            print(f"{name} {pct:.2f}%")
        for idx, name, delta in res["score_deltas"]:
            print(f"{idx} {name}: {delta:+.3f}")
        return

    from .engine import ddpm_invert, ddpm_sample

    gen = torch.Generator(device=w.device).manual_seed(args.seed)
    x0 = torch.randn(w.latent_shape(args.n), generator=gen, device=w.device) * 0.5
    res = ddpm_invert(w.schedule, w.eps_fn(), x0, eta=1.0, generator=gen)
    recon = ddpm_sample(w.schedule, w.eps_fn(), res.zs, res.xts, t_skip=0)
    print(inversion_roundtrip_metrics(x0, recon))


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
    # Under torchrun every rank reads the same global batch (as the JAX
    # package's one process does) and steps on its share of it.
    data = batch_iterator(ds, args.batch_size * world_size(), prefetch=args.prefetch,
                          num_workers=args.num_workers, process_index=0, process_count=1)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    _, state, losses = train_loop(cfg, data, ckpt_dir=args.ckpt_dir, num_steps=args.num_steps,
                                  logger=logging.getLogger("seg-train"), device=args.device)
    if is_first_rank():
        last = f"{losses[-1]:.4f}" if losses else "none"
        print(f"seg-train: step {state.step}, {len(losses)} steps this run, last loss {last}"
              + (f", {world_size()} ranks" if world_size() > 1 else ""))


def cmd_seg_eval(args) -> None:
    from .models import SegmentationModel
    from .seg.evaluate import evaluate_dir
    from .seg.train import TrainConfig, create_train_state, restore_checkpoint

    model, state = create_train_state(TrainConfig(width=args.width), device=args.device)
    if args.ckpt_dir:
        state = restore_checkpoint(args.ckpt_dir, state)
    evaluate_dir(SegmentationModel(model), args.image_dir, args.out_dir)
    print(args.out_dir)


def _common(sp) -> None:
    sp.add_argument("--family", default="ddpm", choices=["ddpm", "ldm", "sd"],
                    help="model family (ddpm and ldm take no prompt)")
    sp.add_argument("--checkpoint-dir", default=None)
    sp.add_argument("--steps", type=int, default=50)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--encoder-reuse", type=int, default=1,
                    help="encoder propagation interval k (Faster Diffusion, arXiv "
                         "2312.09608): the UNet's down path runs every k-th step only; "
                         "1 = exact")
    sp.add_argument("--shard", default=None, metavar="SPEC",
                    help="split one edit over the ranks of torchrun, axes joined by x: "
                         "cfg2 (the CFG pair over two ranks), sp8 (the rows over eight), "
                         "cfg2xsp4; a CFG call (--family sd) needs a cfg axis")
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
    g.add_argument("--sample-clipping", action=argparse.BooleanOptionalAction, default=True,
                   help="clip pred-x0 to [-1, 1] (ddpm and ldm; SD never clips)")
    g.add_argument("--out-prefix", default="generated")
    g.set_defaults(fn=cmd_generate)

    e = sub.add_parser("edit")
    _common(e)
    e.add_argument("--image", required=True)
    e.add_argument("--image-size", type=int, default=None,
                   help="pixels a side (default: the codec's sample size, 256 for ddpm and ldm)")
    e.add_argument("--align", action="store_true", default=False,
                   help="FFHQ face alignment before editing; landmarks from --landmarks or "
                        "the BiSeNet parsing")
    e.add_argument("--landmarks", default=None,
                   help="dlib shape-predictor .dat path for --align (needs dlib)")
    e.add_argument("--inversion-method", default="ddim", choices=["ddim", "ddpm"])
    e.add_argument("--t-skip", type=int, default=36)
    e.add_argument("--attr-func", default=None)
    e.add_argument("--loss-scale", type=float, default=1.0)
    e.add_argument("--t1", type=int, default=0)
    e.add_argument("--t2", type=int, default=50)
    e.add_argument("--color-target", type=float, default=0.9)
    e.add_argument("--color-idx", type=int, default=0)
    e.add_argument("--classes", type=int, nargs="*", default=None,
                   help="segmentation class ids to mask-edit (a face-parsing BiSeNet)")
    e.add_argument("--bisenet-ckpt", default=None,
                   help="the face-parsing BiSeNet's .pth (default: seeded random weights)")
    e.add_argument("--dilate-mask", action="store_true", default=False,
                   help="dilate each class's mask 7 x 7 before resizing it to the latent")
    e.add_argument("--resynthesize", action="store_true", default=False,
                   help="fresh noise inside the mask (the whole latent without --classes)")
    e.add_argument("--edit-mode", default="split", choices=["split", "fused"],
                   help="the edit loop's mode (the same loop in the port)")
    e.add_argument("--guidance-codec", default="full", choices=["full", "proxy"],
                   help="proxy: guidance gradients through the fitted affine latent -> "
                        "RGB map instead of the decoder; the output is still decoded by "
                        "the decoder")
    e.add_argument("--guidance-stride", type=int, default=1,
                   help="apply the guidance nudge every K-th step inside [t1, t2)")
    e.add_argument("--out", default="edited.png")
    e.set_defaults(fn=cmd_edit)

    m = sub.add_parser("metrics")
    _common(m)
    m.add_argument("--n", type=int, default=4)
    m.add_argument("--attr-func", default=None,
                   help="run the anyGAN attribute evaluation with this guidance")
    m.add_argument("--anygan-ckpt", default=None,
                   help="the anyGAN ResNet-50's .pth (default: seeded random weights)")
    m.add_argument("--loss-scale", type=float, default=1.0)
    m.add_argument("--t1", type=int, default=0)
    m.add_argument("--t2", type=int, default=50)
    m.add_argument("--color-target", type=float, default=0.9)
    m.add_argument("--color-idx", type=int, default=0)
    m.add_argument("--inversion", default=None, choices=["ddpm"],
                   help="re-invert the generated images with edit-friendly DDPM inversion "
                        "(needs --eta > 0)")
    m.add_argument("--t-skip", type=int, default=None)
    m.add_argument("--resynthesize", action="store_true", default=False)
    m.set_defaults(fn=cmd_metrics)

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

    v = sub.add_parser("seg-eval")
    v.add_argument("--image-dir", required=True)
    v.add_argument("--out-dir", default="seg_vis")
    v.add_argument("--ckpt-dir", default=None, help="a seg-train checkpoint directory")
    v.add_argument("--width", type=int, default=64)
    v.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device; 'cpu' for the CPU)")
    v.set_defaults(fn=cmd_seg_eval)
    return p


def main(argv=None) -> int:
    from .parallel import initialize_distributed

    args = build_parser().parse_args(argv)
    device = torch.device("cuda" if args.device is None else args.device)
    started = not dist.is_initialized()
    initialize_distributed(device.type)
    try:
        args.fn(args)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
