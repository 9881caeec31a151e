"""Time the GroupNorm kernels (K4, or K5 + K6) at every GroupNorm shape of one
`chip_smoke.py` `[main]` run, weighted by its launches.

    python3 scripts/torch_bench_groupnorm.py

Needs one CUDA GPU and nvcc. Builds chip_smoke.py's SD-1.5 UNet and SD VAE
(bf16, seeded random weights), runs one CFG UNet call, one decode with its
latent gradient and one encode (`chip_smoke.forward_pieces`) with the port's
`group_norm` wrapped to record each call's (shape, groups, eps, activation),
and weighs each piece by its calls in a `[main]` run (`chip_smoke.UNET_CALLS`
UNet calls, `chip_smoke.DECODES` decodes, `chip_smoke.ENCODES` encodes; the
decode's gradient runs GroupNorm's backward in torch ops, no kernel). At
each distinct call it times the kernels the route takes
(`ops.groupnorm.uses_fused_kernel`: K4 alone, or K5 then K6, each timed
alone too) with `chip_smoke.time_ms` (CUDA events over 10 calls queued
behind a sleep kernel) and prints them beside the bytes bound (x read once,
the output written once; K5 reads x alone). The last lines are each
kernel's launch-weighted sums of ms and of bound ms for one `[main]` run,
and, at the VAE's shape of `chip_smoke.GN_CASES` (1, 128, 512, 512) and
at the largest K5 shape, the time of `torch.var_mean` over the groups, the
one PyTorch call that computes K5's statistics.

Prints the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffusion_image_editing_tpu_torch.models import layers  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import groupnorm as GN  # noqa: E402

# Calls of each piece in one [main] run (chip_smoke.path_launches).
WEIGHTS = {"eps": chip_smoke.UNET_CALLS, "decode": chip_smoke.DECODES,
           "encode": chip_smoke.ENCODES}


def record_calls(pieces) -> Counter:
    """(shape, groups, eps, act) -> calls in one [main] run."""
    calls: Counter = Counter()
    original = layers.group_norm
    piece = ""

    def recording(x, scale, bias, num_groups=32, eps=1e-6, act="silu"):
        calls[(tuple(x.shape), int(num_groups), float(eps), act)] += WEIGHTS[piece]
        return original(x, scale, bias, num_groups, eps, act)

    layers.group_norm = recording
    try:
        for piece, fn in pieces.items():
            fn()
        torch.cuda.synchronize()
    finally:
        layers.group_norm = original
    return calls


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    dev = torch.device("cuda")
    unet, vae = chip_smoke.build_models(dev)
    sd, _, _ = chip_smoke.make_pipeline(unet, vae, dev)
    calls = record_calls(chip_smoke.forward_pieces(sd, dev))
    del sd, unet, vae
    torch.cuda.empty_cache()

    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {name: [0, 0.0, 0.0] for name in ("group_norm_fused", "group_norm_stats",
                                             "group_norm_apply")}  # launches, ms, bound ms
    largest = None
    for (shape, groups, eps, act), n in sorted(calls.items(), key=lambda kv: -kv[1]):
        x = chip_smoke._randn(shape, gen, dev)
        c = shape[1]
        scale = (1 + 0.2 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.2 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        nx = 2.0 * x.numel()  # bytes of x
        stats = 8.0 * shape[0] * groups  # the (N, G) f32 mean and rstd
        with torch.no_grad():
            if GN.uses_fused_kernel(shape, groups):
                ms = chip_smoke.time_ms(lambda: GN.group_norm_fused(x, scale, bias, groups, eps,
                                                                    act))
                bound, _ = chip_smoke.bound_ms(10.0 * x.numel(), 2 * nx + 4 * c + stats,
                                               chip_smoke.PEAK_F32_FLOPS)
                parts = {"group_norm_fused": (ms, bound)}
            else:
                mean, rstd = GN.group_norm_stats(x, groups, eps)
                st_ms = chip_smoke.time_ms(lambda: GN.group_norm_stats(x, groups, eps))
                ap_ms = chip_smoke.time_ms(lambda: GN.group_norm_apply(x, mean, rstd, scale, bias,
                                                                       act))
                st_bound, _ = chip_smoke.bound_ms(3.0 * x.numel(), nx + stats,
                                                  chip_smoke.PEAK_F32_FLOPS)
                ap_bound, _ = chip_smoke.bound_ms(7.0 * x.numel(), 2 * nx + 4 * c + stats,
                                                  chip_smoke.PEAK_F32_FLOPS)
                parts = {"group_norm_stats": (st_ms, st_bound),
                         "group_norm_apply": (ap_ms, ap_bound)}
                if largest is None or x.numel() > largest.numel():
                    largest = x
        line = f"[shape] {shape} groups {groups} act {act}: {n} launches a run"
        for name, (ms, bound) in parts.items():
            sums[name][0] += n
            sums[name][1] += n * ms
            sums[name][2] += n * bound
            line += f"; {name} {ms:.4f} ms (bound {bound:.4f}, gap {ms - bound:.4f})"
        print(line, flush=True)
        del x
    for name, (n, ms, bound) in sums.items():
        print(f"[sum] {name}: {n} launches a [main] run, {ms:.2f} ms, bound {bound:.2f} ms, "
              f"gap {ms - bound:.2f} ms; on {smi}", flush=True)
    vae = dict(chip_smoke.GN_CASES)["vae 512x512x128 b1"]
    for x in [chip_smoke._randn(vae, gen, dev)] + ([largest] if largest is not None else []):
        view = x.view(x.shape[0], chip_smoke.GN_GROUPS, -1)
        with torch.no_grad():
            lib_ms = chip_smoke.time_ms(lambda: torch.var_mean(view, dim=-1, correction=0))
            st_ms = chip_smoke.time_ms(lambda: GN.group_norm_stats(x, chip_smoke.GN_GROUPS,
                                                                   chip_smoke.GN_EPS))
        print(f"[library] {tuple(x.shape)}: torch.var_mean over the groups {lib_ms:.4f} ms, "
              f"K5 {st_ms:.4f} ms; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
