"""Build and time K7, the fused GroupNorm+SiLU -> conv3x3 kernel, alone.

    python3 scripts/torch_bench_fused_conv.py [--batch 20] [--tile-cout 128] [--splits 4]

Needs one CUDA GPU and nvcc. Builds `ops/csrc/affine_silu_conv3x3.cu` only
(seconds), prints what ptxas used (registers, spills, shared memory), then
for every distinct fused-conv shape of the SD-1.5 512 px path (the UNet's
64, 32, 16 and 8 px stages at batch 2 with their concatenated input widths,
and the VAE's 64 px stage at batch 1) holds the kernel against its plain
version within `chip_smoke.CONV_TOL` and prints the kernel's, the plain
version's and cuDNN's milliseconds beside the bound, timed as
`chip_smoke.py` times them (CUDA events over 10 calls queued behind a sleep
kernel). `--batch N` adds the UNet's 64 px shape at batch N (the batched
inversion runs batch 20). Then times `gn_affine_coeffs`, which makes the
kernel's (A, B) from x on the fused path, at each distinct input shape, and
two calls on the same inputs for bit-equality. For tuning, `--tile-cout BN`
forces the kernel's cout tile and `--splits S` its Cin splits (at most a
shape's chunks) in place of what `ops/fused_conv.py` would choose. Prints the card's name and
power limit first; exits non-zero if a shape disagrees.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import _build  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import fused_conv as FC  # noqa: E402

KERNEL = "affine_silu_conv3x3"
# (px, Cin, Cout) of every ResnetBlock conv of the SD-1.5 UNet that fuses:
# down and mid blocks, then the up blocks with their skip concatenations.
UNET_SHAPES = [
    (64, 320, 320), (64, 640, 320), (64, 960, 320),
    (32, 320, 640), (32, 640, 640), (32, 960, 640), (32, 1280, 640), (32, 1920, 640),
    (16, 640, 1280), (16, 1280, 1280), (16, 1920, 1280), (16, 2560, 1280),
    (8, 1280, 1280), (8, 2560, 1280),
]
VAE_SHAPES = [(64, 512, 512)]  # the decoder's and the encoder's 64 px blocks, batch 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=0,
                        help="also time the UNet's 64 px shape at this batch")
    parser.add_argument("--tile-cout", type=int, choices=FC.TILE_COUTS,
                        help="force the kernel's cout tile")
    parser.add_argument("--splits", type=int, help="force the kernel's Cin splits")
    parser.add_argument("--only", default="",
                        help="time only the shapes whose label contains this, and skip the rest")
    opts = parser.parse_args()
    if opts.tile_cout:
        FC.tile_cout = lambda cout: opts.tile_cout
    if opts.splits:
        def forced_splits(n, cin, *rest):  # the nearest count that leaves no split empty
            chunks = -(-cin // FC.CHUNK_CIN)
            return -(-chunks // -(-chunks // min(opts.splits, chunks)))

        FC.cin_splits = forced_splits
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build([KERNEL])
    print(f"[build] {KERNEL} in {time.perf_counter() - t0:.1f} s")
    for line in _build.ptxas_report(KERNEL).splitlines():
        print(f"[build] {line}")
    for line in _build.library_path(KERNEL).with_suffix(".log").read_text().splitlines():
        if "arning" in line or "Performance" in line:  # wgmma serialized, and the like
            print(f"[build] {line.strip()}")

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(f"unet {px}x{px} {cin}->{cout} b2", 2, cin, cout, px, px)
             for px, cin, cout in UNET_SHAPES]
    cases += [(f"vae {px}x{px} {cin}->{cout} b1", 1, cin, cout, px, px)
              for px, cin, cout in VAE_SHAPES]
    if opts.batch:
        cases.append((f"unet 64x64 320->320 b{opts.batch}", opts.batch, 320, 320, 64, 64))
    cases = [case for case in cases if opts.only in case[0]]
    failed, total_ms, total_lib = [], 0.0, 0.0
    for case in cases:
        entry, ok = chip_smoke.conv_case(*case, gen, dev)
        total_ms += entry["ms"]
        total_lib += entry["library_ms"]
        if not ok:
            failed.append(case[0])
        torch.cuda.empty_cache()
    print(f"[sum] {len(cases)} shapes: kernel {total_ms:.4f} ms, cuDNN {total_lib:.4f} ms, "
          f"on {smi}")

    if opts.only:
        return 1 if failed else 0
    for n, c, px in sorted({(n, cin, h) for _, n, cin, _, h, _ in cases}):
        x = torch.randn((n, c, px, px), generator=gen, device=dev).to(torch.bfloat16)
        scale, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
        shift = torch.randn((n, c), generator=gen, device=dev)
        with torch.no_grad():
            ms = chip_smoke.time_ms(lambda: FC.gn_affine_coeffs(x, scale, bias, 32, 1e-6, shift))
        print(f"[coeffs] gn_affine_coeffs x{(n, c, px, px)}: {ms:.4f} ms")

    x, a, b, wt, bias = (torch.randn(s, generator=gen, device=dev) for s in
                         ((2, 320, 16, 16), (2, 320), (2, 320), (640, 320, 3, 3), (640,)))
    args = (x.to(torch.bfloat16), a, b, (wt / 54).to(torch.bfloat16), bias)
    same = torch.equal(FC.affine_silu_conv3x3_kernel(*args), FC.affine_silu_conv3x3_kernel(*args))
    print(f"[determinism] two calls on the same inputs bit-equal: {same}")
    if failed or not same:
        print(f"[FAIL] {failed or 'not deterministic'}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
