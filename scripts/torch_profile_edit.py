"""Where the PyTorch port's SD-1.5 512 px main path spends its time on the
GPU, through the pipeline's own calls.

    python3 scripts/torch_profile_edit.py [--fused | --sweep]

Builds the port's SD-1.5 UNet and SD VAE (bf16, seeded random weights), a
512 px image and an `EditPipeline`, as chip_smoke.py does, then on the card:
  * times with CUDA events, each the mean of 3 calls after one warm-up:
    the inversion (`prepare_real_image_edit`: VAE encode + DDPM inversion,
    batched, chunk 10, t_skip 10), the edit (`edit_image`, 40 guided steps +
    final decode), the same edit over its last 5 steps only, and the per-step
    wall time from the difference of the two edits. Two pieces of a guided
    step are timed alone as well: the batched-2 CFG UNet call and the
    guidance nudge (decode with gradient through the VAE decoder);
  * profiles one inversion and one 5-step edit with torch.profiler (device
    activity only) and prints the kernels by device time, the
    flash-attention kernels' share, the GroupNorm kernels' share and each of
    them, the device's busy time (the union of the kernels' intervals), and
    the idle share of the wall time. The idle
    share is given against the events wall time of the same call without
    the profiler, and against the wall time under the profiler, which
    counts the profiler's own host overhead.
With `--fused` the models are built in the fused-conv configuration
(`fused_conv=True`: ResnetBlock convs 4 to 64 px wide run K7 with their
GroupNorm folded in) and the 5-step edit's device time is split into K7
(kernels of namespace fc), `gn_affine_coeffs` forward and its autograd
backward, the fused conv's backward (`conv_transpose2d`, `silu_backward`, the
sums) and the rest. The pieces other than K7 are profiler ranges opened
around them (`install_fused_ranges`), so that run also records host
activity.
With `--sweep`, chip_smoke.py's `[sweep]` instead (bench.py's sweep workload:
8 loss scales of SingleColorAttrFunc on one random latent as one batch):
times its two pieces of a step, the CFG UNet call at batch 16 and the swept
nudge (8 batch-1 decodes with their gradient), and a 5-step
`guided_edit_sweep`, then profiles that sweep as above.
Prints the card's name and power limit first. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from diffusion_image_editing_tpu_torch.core import schedule_for_model  # noqa: E402
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc  # noqa: E402
from diffusion_image_editing_tpu_torch.models import (  # noqa: E402
    SD15_UNET, SD_VAE, AutoencoderKL, UNet2DCondition)
from diffusion_image_editing_tpu_torch.pipeline import EditPipeline  # noqa: E402

ATTN_KERNELS = ("fa::flash_",)  # the port's flash-attention kernels (namespace fa)
# GroupNorm: the port's forward kernels (namespace gn) and PyTorch's GroupNorm
# kernels (its forward statistics, and the backward the port calls).
GN_KERNELS = ("gn::", "GroupNorm", "RowwiseMoments", "ComputeInternalGradients",
              "ComputeFusedParams")
K7_KERNELS = ("fc::",)  # the fused conv's kernels (namespace fc)
STEPS, T_SKIP, CHUNK, SHORT = 50, 10, 10, 5
# Profiler ranges of the fused path's pieces that are not K7 itself.
RANGES = {"coeffs": "fused/gn_affine_coeffs", "coeffs_bwd": "fused/gn_affine_coeffs backward",
          "conv_bwd": "fused/conv backward"}


def event_ms(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _Mark(torch.autograd.Function):
    """Identity; its backward opens (`opens`) or closes the profiler range
    `name` once, shared through `state` by the marks of one call."""

    @staticmethod
    def forward(ctx, t, name, state, opens):
        ctx.name, ctx.state, ctx.opens = name, state, opens
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.profiler import record_function

        state = ctx.state
        if ctx.opens and "range" not in state:
            state["range"] = record_function(ctx.name)
            state["range"].__enter__()
        elif not ctx.opens and state.get("range") is not None:
            state["range"].__exit__(None, None, None)
            state["range"] = None
        return g, None, None, None


def install_fused_ranges() -> None:
    """Wraps `gn_affine_coeffs` as the ResnetBlock calls it, and the fused
    conv's backward, in profiler ranges. The autograd backward of
    `gn_affine_coeffs` gets a range too: identity marks on its outputs open
    it (their backward runs first) and a mark on its input closes it (its
    backward runs once every node between them has run)."""
    from torch.profiler import record_function

    from diffusion_image_editing_tpu_torch.models import layers
    from diffusion_image_editing_tpu_torch.ops import fused_conv as FC

    coeffs, backward = layers.gn_affine_coeffs, FC._AffineSiluConv3x3.backward

    def ranged_coeffs(x, *args, **kwargs):
        marked = torch.is_grad_enabled() and x.requires_grad
        state = {}
        if marked:
            x = _Mark.apply(x, RANGES["coeffs_bwd"], state, False)
        with record_function(RANGES["coeffs"]):
            a, b = coeffs(x, *args, **kwargs)
        if marked:
            a, b = (_Mark.apply(t, RANGES["coeffs_bwd"], state, True) for t in (a, b))
        return a, b

    def ranged_backward(ctx, g):
        with record_function(RANGES["conv_bwd"]):
            return backward(ctx, g)

    layers.gn_affine_coeffs = ranged_coeffs
    FC._AffineSiluConv3x3.backward = staticmethod(ranged_backward)


def profile(label, fn, events_wall_ms, top=12, ranges=False):
    """Device kernels of one call of `fn` under torch.profiler; with `ranges`
    also host activity, and the device time under each of RANGES."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if ranges else [])
    with torch_profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # With host activity on, each range also appears as a device-side span
    # from its first kernel to its last; those are not kernels.
    spans = [e for e in prof.events()
             if e.device_type == DeviceType.CUDA and e.name in RANGES.values()]
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in RANGES.values()]
    if not kernels:
        raise RuntimeError(f"{label}: the profiler recorded no device kernels")
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in kernels:
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + e.time_range.elapsed_us(), count + 1)
    busy_ms = busy_us / 1e3
    attn_ms = sum(t for n, (t, _) in by_name.items() if any(k in n for k in ATTN_KERNELS)) / 1e3
    gn = {n: tc for n, tc in by_name.items() if any(k in n for k in GN_KERNELS)}
    gn_ms = sum(t for t, _ in gn.values()) / 1e3
    print(f"[{label}] device busy {busy_ms:.2f} ms, {len(kernels)} kernels; idle share "
          f"{max(0.0, 1 - busy_ms / events_wall_ms):.3f} of the events wall {events_wall_ms:.2f} "
          f"ms without the profiler ({max(0.0, 1 - busy_ms / wall_ms):.3f} of the wall "
          f"{wall_ms:.2f} ms under it); flash attention {attn_ms:.2f} ms = "
          f"{attn_ms / max(busy_ms, 1e-9):.3f} of busy time")
    for name, (t, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{label}]   {t / 1e3:9.3f} ms  x{count:<5d} {name[:110]}")
    print(f"[{label}] GroupNorm kernels {gn_ms:.2f} ms = {gn_ms / max(busy_ms, 1e-9):.3f} of "
          f"busy time (the f32 casts around the backward are not counted):")
    for name, (t, count) in sorted(gn.items(), key=lambda kv: -kv[1][0]):
        print(f"[{label}]   {t / 1e3:9.3f} ms  x{count:<5d} {name[:160]}")
    if not ranges:
        return
    k7 = [tc for n, tc in by_name.items() if any(k in n for k in K7_KERNELS)]
    parts = {"K7": (sum(t for t, _ in k7) / 1e3, sum(c for _, c in k7))}

    def kernel_us(event):  # the kernels an op launched, and those of the ops inside it
        return sum(k.duration for k in event.kernels) + sum(map(kernel_us, event.cpu_children))

    for name in RANGES.values():
        calls = [e for e in prof.events() if e.device_type == DeviceType.CPU and e.name == name]
        parts[name] = (sum(map(kernel_us, calls)) / 1e3, len(calls))
    rest = busy_ms - sum(ms for ms, _ in parts.values())
    print(f"[{label}] the fused path's pieces, device ms (calls, share of busy time): "
          + "; ".join(f"{name} {ms:.2f} (x{count}, {ms / busy_ms:.3f})"
                      for name, (ms, count) in parts.items())
          + f"; the rest {rest:.2f} ({rest / busy_ms:.3f})")
    span_ms = {name: sum(e.time_range.elapsed_us() for e in spans if e.name == name) / 1e3
               for name in RANGES.values()}
    print(f"[{label}] the same ranges on the device, first kernel to last, gaps included, ms: "
          + "; ".join(f"{name} {ms:.2f}" for name, ms in span_ms.items()))


def profile_sweep(sd, dev) -> int:
    from diffusion_image_editing_tpu_torch.parallel import guided_edit_sweep, sweep_attr_func

    g = chip_smoke.SWEEP_GRID
    swept = sweep_attr_func(SingleColorAttrFunc(**chip_smoke.SWEEP_GUIDE),
                            loss_scale=chip_smoke.SWEEP_SCALES)
    lat = sd.unet.config.sample_size
    gen = torch.Generator(device=dev).manual_seed(11)
    x1 = torch.randn((1, sd.unet.config.in_channels, lat, lat), generator=gen, device=dev)
    xg = x1.repeat(g, 1, 1, 1)
    eps_fn, sched, decode = sd.eps_fn(sd.prep_text(None), 3.5), sd.schedule, sd.decode_fn()
    t, idx = int(sched.timesteps[20]), 20
    eps = eps_fn(xg, t)
    short = schedule_for_model("sd", SHORT)

    def sweep():
        return guided_edit_sweep(short, eps_fn, x1, swept, decode_fn=decode)

    unet_ms = event_ms(lambda: eps_fn(xg, t), reps=5)
    nudge_ms = event_ms(lambda: swept.apply_batched(xg, None, eps, t, idx, sched, decode), 3)
    sweep_ms = event_ms(sweep)
    print(f"[events] sweep of {g}: CFG UNet call (batch {2 * g}) {unet_ms:.2f} ms; swept nudge "
          f"({g} decodes with their gradient) {nudge_ms:.2f} ms; {SHORT}-step sweep "
          f"{sweep_ms:.2f} ms = {sweep_ms / SHORT:.2f} ms a step, "
          f"{g * SHORT / sweep_ms * 1e3:.3f} sample-steps/s")
    profile(f"sweep {SHORT} steps", sweep, sweep_ms)
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = parser.add_mutually_exclusive_group()
    mode.add_argument("--fused", action="store_true",
                      help="profile the fused-conv configuration and split its device time")
    mode.add_argument("--sweep", action="store_true",
                      help="profile chip_smoke.py's [sweep]: a grid of 8 loss scales as one batch")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    print(f"[config] {'fused_conv' if opts.fused else 'default'}")
    if opts.fused:
        install_fused_ranges()
    unet = UNet2DCondition(dataclasses.replace(SD15_UNET, fused_conv=opts.fused), device=dev,
                           dtype=torch.bfloat16)
    vae = AutoencoderKL(dataclasses.replace(SD_VAE, fused_conv=opts.fused), device=dev,
                        dtype=torch.bfloat16)
    text = torch.from_numpy(rng.standard_normal((2, 77, 768), dtype=np.float32))
    img = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (1, 3, SD_VAE.sample_size, SD_VAE.sample_size)).astype(np.float32))
    sd = chip_smoke.fixed_text_sd(unet, vae, schedule_for_model("sd", STEPS),
                                  text.to(torch.bfloat16), dev)
    pipe = EditPipeline(sd)
    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)
    if opts.sweep:
        return profile_sweep(sd, dev)

    def invert():
        return pipe.prepare_real_image_edit(
            img, eta=1.0, inversion_method="ddpm", mode="batched", t_skip=T_SKIP, chunk=CHUNK,
            generator=torch.Generator(device=dev).manual_seed(5))

    xt, zs, xts, _, _ = invert()

    def edit(t_skip):
        return lambda: pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, attr_func=attr,
                                       inversion_method="ddpm", t_skip=t_skip, mode="split")

    eps_fn = sd.eps_fn(sd.prep_text(None), 3.5)
    sched, decode = sd.schedule, sd.decode_fn()
    x, z = xts[20], zs[20]
    t, idx = int(sched.timesteps[20]), 20
    eps = eps_fn(x, t)

    inv_ms = event_ms(invert)
    full_ms = event_ms(edit(T_SKIP))
    short_ms = event_ms(edit(STEPS - SHORT))
    guided = STEPS - T_SKIP
    print(f"[events] inversion {inv_ms:.2f} ms; edit ({guided} guided steps + decode) "
          f"{full_ms:.2f} ms; edit ({SHORT} guided steps + decode) {short_ms:.2f} ms; "
          f"one guided step {(full_ms - short_ms) / (guided - SHORT):.2f} ms")
    print(f"[events] pieces of a guided step: CFG UNet call (batch 2) "
          f"{event_ms(lambda: eps_fn(x, t), reps=5):.2f} ms; guidance nudge (decode + its "
          f"gradient) {event_ms(lambda: attr.apply_batched(x, z, eps, t, idx, sched, decode), 5):.2f}"
          f" ms")
    profile("inversion", invert, inv_ms)
    profile(f"edit {SHORT} steps", edit(STEPS - SHORT), short_ms, ranges=opts.fused)
    return 0


if __name__ == "__main__":
    sys.exit(main())
