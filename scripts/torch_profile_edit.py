"""Where the PyTorch port's SD-1.5 512 px main path spends its time on the
GPU, through the pipeline's own calls.

    python3 scripts/torch_profile_edit.py

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
Prints the card's name and power limit first. Needs one CUDA GPU.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffusion_image_editing_tpu_torch.core import schedule_for_model  # noqa: E402
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc  # noqa: E402
from diffusion_image_editing_tpu_torch.models import (  # noqa: E402
    SD15_UNET, SD_VAE, AutoencoderKL, UNet2DCondition)
from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline  # noqa: E402

ATTN_KERNELS = ("fa::flash_",)  # the port's flash-attention kernels (namespace fa)
# GroupNorm: the port's forward kernels (namespace gn) and PyTorch's GroupNorm
# kernels (its forward statistics, and the backward the port calls).
GN_KERNELS = ("gn::", "GroupNorm", "RowwiseMoments", "ComputeInternalGradients",
              "ComputeFusedParams")
STEPS, T_SKIP, CHUNK, SHORT = 50, 10, 10, 5


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


def profile(label, fn, events_wall_ms, top=12):
    """Device kernels of one call of `fn` under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")
    dev = torch.device("cuda")
    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    unet = UNet2DCondition(SD15_UNET, device=dev, dtype=torch.bfloat16)
    vae = AutoencoderKL(SD_VAE, device=dev, dtype=torch.bfloat16)
    text = torch.from_numpy(rng.standard_normal((2, 77, 768), dtype=np.float32))
    img = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (1, 3, SD_VAE.sample_size, SD_VAE.sample_size)).astype(np.float32))
    sd = SD(unet, vae, schedule_for_model("sd", STEPS), text_emb=text.to(torch.bfloat16),
            device=dev)
    pipe = EditPipeline(sd)
    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)

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
    profile(f"edit {SHORT} steps", edit(STEPS - SHORT), short_ms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
