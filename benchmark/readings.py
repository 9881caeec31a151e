"""The readings that a cell's correctness limits are set from, in one
process: the numbers its check compares, over many seeds of the program as
it runs in the benchmark (the lower readings), and over seeds of the
control, which the limits must fail: the reference put in the program's
place with every matrix product and convolution, forward and backward, on
float8 operands, the precision below the bfloat16 that the configurations
state (`reference/precision.py`). `--witness-seeds` reads, for an edit cell
with DDIM inversion, each sample's x_T error with the program inverting
the whole batch and with it inverting that sample alone.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 1] [--trace-seed 8] [--witness-seeds 9]

Prints one JSON line a run: {"workload", "seed", "control", "numbers",
"correct", "metrics"}. Each run is a short window of whole calls (one call
at least) and the cell's own check.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def control_run(cell, seed: int, device) -> dict:
    """The numbers of the control: the reference with its products on
    float8 operands, in the program's place, on call 0's inputs."""
    import types

    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import compare
    from benchmark.harness.models import build_reference

    ctx = types.SimpleNamespace(cell=cell, seed=seed, device=device,
                                params=cell.workload["params"], program=None)
    traffic = C.traffic(cell.workload["kind"]).Traffic(ctx)
    ref = build_reference(cell.config, seed, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = traffic.control_outputs(ref, 0)
        numbers = traffic.check(0, out, ref)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    checks = compare.judge(numbers, cell.workload["limits"])
    return {"correct": compare.all_ok(checks), "attempted": 1, "metrics": {},
            "device": {"fp8_calls": out.get("fp8_calls") if isinstance(out, dict) else None},
            "checks": {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()},
            "extra": {k: v for k, v in numbers.items() if k not in checks}}


def witness_run(cell, seed: int, device) -> dict:
    """Call 0's x_T error of each sample against the reference's inversion
    of the batch: with the program inverting the whole batch ("batch") and
    inverting that sample alone ("alone")."""
    import types

    import torch

    from benchmark.harness import cell as C
    from benchmark.harness import compare, models

    p = cell.workload["params"]
    ctx = types.SimpleNamespace(cell=cell, seed=seed, device=device, params=p,
                                program=models.build_program(cell.config, seed, device,
                                                             p["steps"]))
    traffic = C.traffic(cell.workload["kind"]).Traffic(ctx)
    img, _ = traffic.inputs(0)

    def invert(x):
        return traffic.pipe.prepare_real_image_edit(x, inversion_method="ddim")[0]

    batch = invert(img)
    alone = torch.cat([invert(img[j:j + 1]) for j in range(img.shape[0])])
    traffic.drop_program()
    ctx.program = None
    torch.cuda.empty_cache()
    ref = models.build_reference(cell.config, seed, device)
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        s, eps_fn, _, _, _ = traffic._reference(ref)
        want = traffic._invert(ref, s, eps_fn, 0)["xt"]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    return {"batch": [compare.rel_err(batch[j:j + 1], want[j:j + 1])
                      for j in range(img.shape[0])],
            "alone": [compare.rel_err(alone[j:j + 1], want[j:j + 1])
                      for j in range(img.shape[0])]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace-seed", type=int, default=None)
    args = ap.parse_args(argv)

    import torch

    from benchmark.harness import cell as C
    from benchmark.run import run_cell

    cell = C.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = [(int(s), None, False) for s in args.seeds.split(",") if s]
    runs += [(int(s), "fp8", False) for s in args.control_seeds.split(",") if s]
    if args.trace_seed is not None:
        runs.append((args.trace_seed, None, True))
    failed = 0
    for seed in (int(s) for s in args.witness_seeds.split(",") if s):
        t0 = time.perf_counter()
        try:
            w = witness_run(cell, seed, dev)
        except Exception:
            traceback.print_exc()
            failed += 1
            continue
        print(json.dumps({"workload": cell.name, "seed": seed, "witness": w,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    for seed, control, trace in runs:
        t0 = time.perf_counter()
        try:
            if control == "fp8":
                r = control_run(cell, seed, dev)
            else:
                r = run_cell(cell, seed, args.seconds, trace, dev, t0)
        except Exception:  # one seed's failure is itself a reading; go on with the rest
            traceback.print_exc()
            print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                              "error": traceback.format_exc(limit=3)}), flush=True)
            failed += 1
            continue
        print(json.dumps({"workload": cell.name, "seed": seed, "control": control,
                          "trace": trace, "correct": r["correct"], "numbers": r["checks"],
                          "extra": r.get("extra"), "attempted": r["attempted"],
                          "metrics": r["metrics"], "device": r["device"],
                          "breakdown": r.get("breakdown"),
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
