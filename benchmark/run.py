"""Runs one cell of the benchmark once, on the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration with weights made on the device from the
seed, warms up the cell's shapes, then measures whole calls for `--seconds`
(see `harness/window.py`). With `--trace 1` the window also times the
inversion and the guided loop apart, and a few more calls run under the
profiler for the per-layer metrics. Then the program is freed and what the
window produced is checked against the float32 reference. The last line of
standard output is one JSON object (see README.md); the numbers compared,
each beside its limit, are the last lines of standard error.

Exits 2 without a result when no CUDA device, or fewer than the cell asks
for, is present, or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def _device_info(device, chips: int, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": device.type, "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader", "-i",
             str(device.index or 0)], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        info["power_limit"] = "not read"
    return info


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell`; returns the result object (without printing)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import cell as C
    from benchmark.harness import compare, guard, models, ranges, trace as T
    from benchmark.harness.drive import sync
    from benchmark.harness.window import Window

    if device.type == "cuda":
        from diffusion_image_editing_tpu_torch.ops import _build

        _build.build()
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    params = cell.workload["params"]
    ctx = types.SimpleNamespace(cell=cell, seed=seed, device=device, params=params,
                                program=models.build_program(cell.config, seed, device,
                                                             params["steps"]))
    traffic = C.traffic(cell.workload["kind"]).Traffic(ctx)
    traffic.warm_up()
    sync(device)
    setup_s = time.perf_counter() - t_start
    timings = {"invert_s": [], "edit_s": [], "guided_steps": 0} if trace else None
    window = Window(seconds)
    window.run(lambda i: traffic.call(i, timings=timings))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    found = guard.loaded_forbidden()
    if found:
        raise SystemExit(f"forbidden modules loaded: {found}")
    traced = None
    if trace:
        work = ranges.Work()
        traced_timings = {"invert_s": [], "edit_s": [], "guided_steps": 0}
        activities = [ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with ranges.layer_ranges(work), profile(activities=activities) as prof:
            with record_function(ranges.WINDOW):
                for j in range(params.get("trace_calls", 1)):
                    traffic.call(window.calls + j, ranged=True, timings=traced_timings,
                                keep=False)
        traced = T.from_profiler(prof)
        del prof
    mctx = types.SimpleNamespace(
        setup_s=setup_s, window_s=window.elapsed, calls=window.calls, unit=traffic.unit,
        trace_calls=params.get("trace_calls", 1),
        units_per_call=traffic.units_per_call, timings=timings, trace=traced,
        work=work if trace else None, timings_traced=traced_timings if trace else None,
        flops_per_call=traffic.flops_per_call() if trace else None)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = C.reader(m["name"])(mctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = _device_info(device, cell.chips, peak)
    breakdown = None
    if traced is not None:
        dev_info.update(busy_s=traced.busy_s(), window_s=traced.window_s)
        breakdown = {"device_ops": traced.device_ops(), "idle_gaps": traced.idle_gaps()}
    del traced, mctx
    traffic.drop_program()
    ctx.program = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        numbers = traffic.check(*traffic.reservoir.kept)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    checks = compare.judge(numbers, cell.workload["limits"])
    result = {"correct": compare.all_ok(checks), "attempted": window.calls, "failed": 0,
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    extra = {k: v for k, v in numbers.items() if k not in checks}
    if extra:
        result["extra"] = extra
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import guard

    cell = C.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {cell.chips} CUDA device(s), have {have}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = guard.loaded_forbidden()
    if found:
        print(f"run.py: forbidden modules loaded: {found}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
