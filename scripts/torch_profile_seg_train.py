"""Where one step of the PyTorch port's BiSeNet trainer with `--norm abn`
(or `abn_sync`) spends its time on the GPU.

    python3 scripts/torch_profile_seg_train.py [--dtypes float32,bfloat16] [--steps 5]
        [--norms abn,abn_sync]

Builds the trainer at the reference recipe (BiSeNet, ResNet-18 context
path, width 64, 19 classes, 448 px crops, batch 16, OHEM 3-head loss, SGD
with warmup -> poly over four groups, `norm="abn"`) with seeded random
weights and a uint8 synthetic batch, as chip_smoke.py's `[seg]` phase does,
then for each compute dtype on the card:
  * times `--steps` train steps with CUDA events after two warm-up steps
    (the mean per step, the host launching as it does in `train_loop`),
    every dtype before the first profiler session;
  * profiles one step with torch.profiler (CPU and CUDA activity) and
    prints the kernels by device time, the device's busy time (the union of
    the kernels' intervals) and its idle share against the events wall time
    of a step without the profiler, and the share of busy time in: the ABN
    forward kernel K8 (`abn_apply_kernel`), the ABN statistics
    (`ops.abn.mean_var`), the ABN backward (`ops.abn.abn_backward`), the
    convolutions (cuDNN and its layout transposes), and the OHEM loss.
    Kernels are given to a part by the torch op that launched them: the
    script wraps `mean_var`, `abn_backward` and `ohem_ce_loss` in profiler
    ranges for the run, and `torch.distributed.all_reduce` and the
    trainer's `mean_over` (the step's all-reduce of the gradients, loss and
    running statistics).
With `--norms abn_sync` the synced trainer runs too, through
`make_sharded_train_step` over a one-rank NCCL group and a `dp` mesh: its
collectives are NCCL's, over one rank. Prints the card's name and power
limit first. Needs one CUDA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diffusion_image_editing_tpu_torch.ops import abn as A  # noqa: E402
from diffusion_image_editing_tpu_torch.seg import SyntheticFaceMask, batch_iterator  # noqa: E402
from diffusion_image_editing_tpu_torch.seg import train as T  # noqa: E402

RANGES = {"abn.mean_var": (A, "mean_var"), "abn.backward": (A, "abn_backward"),
          "seg.ohem_loss": (T, "ohem_ce_loss"), "dist.all_reduce": (dist, "all_reduce"),
          "seg.mean_over": (T, "mean_over")}
K8 = "abn_apply_kernel"
CONV_KERNELS = ("conv", "Conv", "cudnn", "xmma", "cutlass", "sm90_", "nchwToNhwc",
                "nhwcToNchw", "implicit_gemm", "dgrad", "wgrad")


def ranged(name, fn):
    def wrapper(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapper


def part_of(evt) -> str:
    """The part a CPU op belongs to: the innermost range among its ancestors."""
    e = evt
    while e is not None:
        if e.name in RANGES:
            return e.name
        e = e.cpu_parent
    return "other"


def profile_step(label, step, events_ms, top=14):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       acc_events=True) as prof:
        step()
        torch.cuda.synchronize()
    events = prof.events()
    # The ranges appear on the device's timeline too, as annotations that
    # span their kernels: their spans are read apart, not counted as kernels.
    spans = defaultdict(float)
    for e in events:
        if e.device_type == DeviceType.CUDA and e.is_user_annotation:
            spans[e.name] += e.time_range.elapsed_us() / 1e3
    kernels = [e for e in events if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    if not kernels:
        raise RuntimeError(f"{label}: the profiler recorded no device kernels")
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    busy_ms = busy_us / 1e3
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e.name][0] += e.time_range.elapsed_us() / 1e3
        by_name[e.name][1] += 1
    parts = defaultdict(float)
    attributed = 0.0
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        attributed += ms
        parts[part_of(e)] += ms
    k8_ms = sum(t for n, (t, _) in by_name.items() if K8 in n)
    conv_ms = sum(t for n, (t, _) in by_name.items() if any(k in n for k in CONV_KERNELS))
    print(f"[{label}] device busy {busy_ms:.2f} ms, {len(kernels)} kernels; idle share "
          f"{max(0.0, 1 - busy_ms / events_ms):.3f} of the events wall {events_ms:.2f} ms of a "
          f"step without the profiler")
    kernel_ms = sum(t for t, _ in by_name.values())
    print(f"[{label}] kernel time {kernel_ms:.2f} ms: K8 {k8_ms:.2f} ms ({k8_ms / kernel_ms:.3f}), "
          f"convolutions {conv_ms:.2f} ms ({conv_ms / kernel_ms:.3f}); by launching op "
          f"({attributed:.2f} ms attributed): "
          + ", ".join(f"{name} {ms:.2f} ms ({ms / kernel_ms:.3f})"
                      for name, ms in sorted(parts.items(), key=lambda kv: -kv[1])))
    print(f"[{label}] device spans of the ranges (kernels and the gaps between them): "
          + ", ".join(f"{name} {ms:.2f} ms" for name, ms in sorted(spans.items())))
    for name, (t, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"[{label}]   {t:9.3f} ms  x{count:<5d} {name[:120]}")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--dtypes", default="float32,bfloat16")
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--norms", default="abn",
                   help="abn and/or abn_sync (through make_sharded_train_step over one NCCL rank)")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}; torch {torch.__version__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("[device] allow_tf32: matmul False, cudnn False")
    dev = torch.device("cuda")
    images, labels = next(batch_iterator(SyntheticFaceMask(n=16, size=448, raw=True), 16))
    for name, (mod, attr) in RANGES.items():
        setattr(mod, attr, ranged(name, getattr(mod, attr)))
    norms = args.norms.split(",")
    mesh = None
    if "abn_sync" in norms:
        store = os.path.join(tempfile.mkdtemp(prefix="profile_store_"), "store")
        dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0, world_size=1)
        from diffusion_image_editing_tpu_torch.parallel import make_mesh

        mesh = make_mesh(axis_names=("dp",))
    # Every run is timed before the first profiler session, so that no
    # timing follows the profiler's set-up and tear-down in this process.
    runs = []
    for norm, dtype in ((n, d) for n in norms for d in args.dtypes.split(",")):
        cfg = T.TrainConfig(norm=norm, compute_dtype=dtype)
        torch.cuda.reset_peak_memory_stats()
        if norm == "abn_sync":
            model, state = T.create_train_state(cfg, 0, dev, axis_name=mesh["dp"])
            step_fn = T.make_sharded_train_step(model, cfg, mesh)
        else:
            model, state = T.create_train_state(cfg, 0, dev)
            step_fn = T.make_train_step(model, cfg)

        def step(step_fn=step_fn, state=state):
            return step_fn(state, images, labels)[1]

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(args.steps):
            loss = step()
        end.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / args.steps
        ms = start.elapsed_time(end) / args.steps
        label = dtype if norm == "abn" else f"{norm} {dtype}"
        print(f"[{label}] {ms:.2f} ms/step from CUDA events over {args.steps} steps "
              f"({16 / ms * 1e3:.1f} img/s; host clock {host_ms:.2f} ms/step), loss "
              f"{float(loss):.4f}, peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
              f"GiB, on {smi}")
        runs.append((label, step, ms))
    for label, step, ms in runs:
        profile_step(label, step, ms)
    if mesh is not None:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
