"""Tiny cells for the benchmark's CPU tests: each real workload with its
configuration cut to the port's TINY widths, float32 on both sides, and
its traffic cut to a few steps."""

from __future__ import annotations

import copy

from benchmark.harness import cell as C

TINY_STEPS = 4


def tiny_config(name: str) -> dict:
    cfg = copy.deepcopy(C.load_json("configs", name))
    cfg["dtype"] = "float32"
    cfg.update(C.family(cfg["family"]).tiny())
    return cfg


def tiny_cell(name: str, limits: dict = None) -> C.Cell:
    cell = C.load_cell(name)
    cell.config = tiny_config(cell.config["name"])
    w = copy.deepcopy(cell.workload)
    p = w["params"]
    p["steps"] = TINY_STEPS
    if p.get("t_skip"):
        p.update(t_skip=1, chunk=2)
    if "attr" in p:
        p["attr"]["t2"] = TINY_STEPS
    if "batch" in p and p["batch"] > 1:
        p["batch"] = 2
        p["attr"]["vjp_chunk"] = 2
    if "loss_scales" in p:
        p["loss_scales"] = p["loss_scales"][::2]
        p["check_points"] = 2
        p["check_steps"] = 2
    if "seeds" in p:
        p["seeds"] = 2
    if limits is not None:
        w["limits"] = limits
    cell.workload = w
    return cell
