"""Command line of the port. One subcommand so far:

    python -m diffusion_image_editing_tpu_torch.cli seg-train [--norm abn] ...

trains BiSeNet on CelebAMask-HQ (`--data-root`) or, without it, on
synthetic data, on one CUDA device (`--device cpu` for the CPU). The flags
are those of the JAX package's `seg-train`; its other four subcommands are
not ported yet (ROADMAP Queue A item 20).
"""

from __future__ import annotations

import argparse
import logging
import sys


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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="diffusion_image_editing_tpu_torch.cli")
    sub = p.add_subparsers(dest="cmd", required=True)
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
