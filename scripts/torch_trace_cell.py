"""Runs one cell of the benchmark with the port's tracer on, and reads what
the tracer recorded.

    python3 scripts/torch_trace_cell.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--spans 0|1]

The run is `benchmark/run.py`'s own (`run_cell`: set-up, the window, the
profiled calls with `--trace 1`, the check), with the benchmark's files
unchanged. With `--spans 1` the tracer (`utils/logging.py`) is on from the
start, each call sets its index as the request id, and the profiled calls'
trace keeps the program's `die.` ranges beside the benchmark's `bench.`
ones, so that the result's `breakdown` labels each idle gap by the
innermost range of either kind. `--spans 0` is `benchmark/run.py` itself.

The last line of standard output is run.py's result object; with `--spans
1` it also holds "spans", the tracer's readings (`read_spans`):

- `host_syncs_per_step`: host-device synchronisations in the profiled
  calls over their engine steps; `sync_sites`: each synchronising line's
  count a step (the benchmark's own among them: its timer's and its
  end-of-call synchronisation); `window_host_syncs_per_step`: the same
  over the window; `step_host_syncs_per_step`: those of the profiled
  calls made inside an `engine.step` span, over their steps;
- `step_p95_ms`, `step_mean_ms`: the window's `engine.step` durations
  (host clock), and `steps`, how many;
- `spans_per_step`: spans the window recorded over its engine steps;
- `nudge_ms`, `loss_ms`, `vjp_ms`, `unet_ms`: device ms a profiled engine
  step launched in `die.guidance.nudge`, `die.guidance.loss`,
  `die.guidance.vjp` (any thread) and `die.models.unet`;
- `attn_bwd_roofline`: the flash backward's bound (`flash_bwd_work`) over
  the device time launched in `die.ops.attention.bwd`, in %;
- `agree`: device ms of each span and of the benchmark's range around
  the same calls, and their ratio;
- `idle_labelled`: the share of the profiled calls' idle time whose
  innermost range is a `die.` span, and the idle seconds by label;
- `build_s`, `compile_s`: seconds `ops._build.build` spent hashing the
  kernels' sources (the counter `ops.build_ns`) and compiling them
  (`ops.compile_ns`).

A reading with nothing to read is None. The readers (`read_spans`, `p95`,
`flash_bwd_work`) are functions of the span log, the counters and a trace;
`traced_run` and `die_ranges` drive the benchmark's harness around them.
The script goes once `benchmark/run.py` turns the tracer on itself and the
readers become metrics of `benchmark/metrics/`. Needs the CUDA devices the
cell asks for, as run.py does.
"""

from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

T_START = time.perf_counter()

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

AGREE = (("die.models.unet", "bench.unet"), ("die.guidance.nudge", "bench.nudge"),
         ("die.ops.attention", "bench.attn"), ("die.ops.group_norm", "bench.gn"))


def p95(values: List[float]) -> Optional[float]:
    """The 95th percentile (`statistics.quantiles`, inclusive), None for
    fewer than two values."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=20, method="inclusive")[-1]


def flash_bwd_work(q_shape, k_shape, elem_bytes: int) -> List[tuple]:
    """(FLOPs, bytes) of K2 and of K3 for one flash backward, (B, S, H, D)
    operands: K2 recomputes S and dP and forms dQ, 6 S_q S_k D a head, and
    moves Q, dO, K, V, dQ and the f32 lse and delta; K3 recomputes S^T and
    dP^T and forms dK and dV, 8 S_q S_k D a head, and moves Q, dO, K, V,
    dK, dV, lse and delta."""
    b, sq, h, d = q_shape
    sk = k_shape[1]
    heads, stats = b * h, 2 * 4 * b * h * sq
    k2 = (6.0 * heads * sq * sk * d, elem_bytes * heads * d * (3 * sq + 2 * sk) + stats)
    k3 = (8.0 * heads * sq * sk * d, elem_bytes * heads * d * (2 * sq + 4 * sk) + stats)
    return [k2, k3]


def _ancestors(s: dict, by_id: Dict[int, dict]) -> List[str]:
    names = []
    while s["parent"] in by_id:
        s = by_id[s["parent"]]
        names.append(s["name"])
    return names


def _per_step(counts: Dict[str, int], key: str) -> Optional[float]:
    steps = counts.get("engine.steps", 0)
    return counts[key] / steps if steps and key in counts else None


def read_spans(spans: List[dict], window_calls: int, window_counts: Dict[str, int],
               traced_counts: Dict[str, int], counts: Dict[str, int], trace=None,
               bound_s: Optional[Callable[[float, float], float]] = None) -> dict:
    """The tracer's readings (see the module's docstring) from the spans of
    the run (`span_log` dicts; request id = call index, the profiled calls
    after the window's), the counters' change over the window and over the
    profiled calls, the counters at the end of the run, and for the device
    readings the profiled calls' trace with its `die.` ranges (anything with
    `range_device_s`, `range_count` and `idle_gaps` as the benchmark's Trace
    has them) and `bound_s(flops, bytes)`, the card's bound in seconds."""
    window = [s for s in spans if isinstance(s["request"], int) and s["request"] < window_calls]
    steps = [(s["end_ns"] - s["start_ns"]) * 1e-6 for s in window if s["name"] == "engine.step"]
    traced_steps = traced_counts.get("engine.steps", 0)
    out = {"steps": len(steps), "step_p95_ms": p95(steps),
           "step_mean_ms": statistics.fmean(steps) if steps else None,
           "spans_per_step": len(window) / len(steps) if steps else None,
           "build_s": counts["ops.build_ns"] / 1e9 if "ops.build_ns" in counts else None,
           "compile_s": (counts.get("ops.compile_ns", 0) / 1e9 if "ops.build_ns" in counts
                         else None)}
    out["host_syncs_per_step"] = _per_step(traced_counts, "host_syncs")
    out["window_host_syncs_per_step"] = _per_step(window_counts, "host_syncs")
    out["sync_sites"] = {k[len("host_syncs."):]: v / traced_steps
                         for k, v in sorted(traced_counts.items())
                         if k.startswith("host_syncs.") and v and traced_steps}
    traced = {s["id"]: s for s in spans
              if isinstance(s["request"], int) and s["request"] >= window_calls}
    out["step_host_syncs_per_step"] = (
        sum(s["host_syncs"] for s in traced.values()
            if "engine.step" in [s["name"]] + _ancestors(s, traced)) / traced_steps
        if traced_steps and "host_syncs" in traced_counts else None)
    if trace is None or not traced_steps:
        return out
    for key, name in (("nudge_ms", "die.guidance.nudge"), ("loss_ms", "die.guidance.loss"),
                      ("vjp_ms", "die.guidance.vjp"), ("unet_ms", "die.models.unet")):
        out[key] = (trace.range_device_s(name) / traced_steps * 1e3
                    if trace.range_count(name) else None)
    bwd = [s for s in traced.values() if s["name"] == "ops.attention.bwd"]
    spent = trace.range_device_s("die.ops.attention.bwd")
    out["attn_bwd_roofline"] = (100.0 * sum(bound_s(f, b) for s in bwd for f, b in
                                            flash_bwd_work(*s["shapes"], s["elem_bytes"]))
                                / spent if bwd and spent > 0 and bound_s else None)
    out["agree"] = {}
    for die, bench in AGREE:
        if trace.range_count(die) and trace.range_count(bench):
            a, b = trace.range_device_s(die) * 1e3, trace.range_device_s(bench) * 1e3
            out["agree"][die] = {"die_ms": a, "bench_ms": b, "ratio": a / b if b else None}
    gaps = trace.idle_gaps(n=10 ** 6)
    idle = sum(s for _, s in gaps)
    out["idle_labelled"] = {
        "die_share": sum(s for k, s in gaps if k.startswith("die.")) / idle if idle else None,
        "by_label": gaps[:12]}
    return out


def _change(before: Dict[str, int], after: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def die_ranges(prof) -> Dict[str, list]:
    """The host intervals of the profiler's `die.` ranges, by name, sorted,
    in the benchmark trace's seconds."""
    from torch.autograd import DeviceType

    from benchmark.harness.trace import _ns
    from diffusion_image_editing_tpu_torch.utils.logging import PREFIX

    out = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA and ev.name().startswith(PREFIX):
            out[ev.name()].append((_ns(ev, "start"), _ns(ev, "end")))
    for lst in out.values():
        lst.sort()
    return dict(out)


def traced_run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
               spans: bool = True) -> dict:
    """`benchmark/run.py`'s `run_cell` with, for `spans`, the tracer on from
    here and its readings under "spans" in the result."""
    from benchmark import run as R
    from benchmark.harness import cell as C
    from benchmark.harness import trace as T
    from benchmark.harness.flops import bound_s
    from benchmark.harness import window as W
    from diffusion_image_editing_tpu_torch.utils import logging as L

    if not spans:
        return R.run_cell(cell, seed, seconds, trace, device, t_start)
    traffic = C.traffic(cell.workload["kind"]).Traffic
    saved = call, run, from_profiler = traffic.call, W.Window.run, T.from_profiler
    marks: dict = {}

    def requested_call(self, i, *a, **k):
        L.set_request(i)
        return call(self, i, *a, **k)

    def cleared_run(self, fn):
        L.clear_spans()  # the warm-up's
        marks["before_window"] = dict(L.COUNTERS)
        run(self, fn)
        marks.update(window_calls=self.calls, after_window=dict(L.COUNTERS))

    def with_spans(prof):
        marks["after_traced"] = dict(L.COUNTERS)
        trace = from_profiler(prof)
        # the spans' mirrors on the device timeline are no device work
        trace.ops = [op for op in trace.ops if not op[0].startswith(L.PREFIX)]
        trace.ranges.update(die_ranges(prof))
        marks["trace"] = trace
        return trace

    traffic.call, W.Window.run, T.from_profiler = requested_call, cleared_run, with_spans
    L.enable_tracing()
    try:
        result = R.run_cell(cell, seed, seconds, trace, device, t_start)
    finally:
        L.disable_tracing()
        traffic.call, W.Window.run, T.from_profiler = saved
    after = marks["after_window"]
    result["spans"] = read_spans(
        L.span_log(), marks["window_calls"], _change(marks["before_window"], after),
        _change(after, marks.get("after_traced", after)), dict(L.COUNTERS),
        marks.get("trace"), bound_s)
    L.clear_spans()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as C

    cell = C.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"torch_trace_cell.py: {args.workload} needs {cell.chips} CUDA device(s)",
              file=sys.stderr)
        return 2
    result = traced_run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), T_START, bool(args.spans))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
