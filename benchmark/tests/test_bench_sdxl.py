"""The SDXL family and the sweep kind on the CPU (the sound runs and the
common faults of every cell are in `test_bench_faults.py`): a TINY `sdxl`
cell is not correct with its denoiser closure ignoring the added
conditioning; the full-size cells' FLOPs, counted on the meta device, are
pinned; the family's transformer ranges open only while a profiler
records."""

import time
import types

import pytest
import torch

from benchmark import run
from benchmark.harness import cell as C
from benchmark.harness import drive, models
from benchmark.tests.bench_tiny import tiny_cell

CPU = torch.device("cpu")
SEED = 2 ** 33 + 25

# Counted on the plain reference modules at published widths: one sample's
# SDXL UNet call, its 1024 px decode, and a whole call of each new cell.
SDXL_PIECES = {"unet": 6761236398080, "decode": 10470392594432}
FLOPS_PER_CALL = {"sdxl-1024.seeds4": 2746376129609728,
                  "sd15-512.sweep8": 2434924066373632}


def _run(cell):
    return run.run_cell(cell, SEED, 0.01, False, CPU, time.perf_counter())


@pytest.mark.parametrize("drop", ["time_ids", "text_embeds"])
def test_closure_ignoring_added_conditioning_fails(drop, monkeypatch):
    """The CFG closure hands the UNet a constant in place of one piece of
    the added conditioning: the check fails."""
    from diffusion_image_editing_tpu_torch.engine import denoise as D

    real = D.CfgEpsClosure._added

    def dropped(self, b):
        out = real(self, b)
        if out:
            cond = dict(out["added_cond"])
            cond[drop] = torch.zeros_like(cond[drop])
            out = {"added_cond": cond}
        return out

    monkeypatch.setattr(D.CfgEpsClosure, "_added", dropped)
    assert not _run(tiny_cell("sdxl-1024.seeds4"))["correct"]


@pytest.mark.parametrize("name", sorted(FLOPS_PER_CALL))
def test_full_size_flops_are_pinned(name):
    cell = C.load_cell(name)
    ctx = types.SimpleNamespace(cell=cell, seed=SEED, device=CPU,
                                params=cell.workload["params"], program=None)
    assert C.traffic(cell.workload["kind"]).Traffic(ctx).flops_per_call() == FLOPS_PER_CALL[name]
    if cell.config["family"] == "sdxl":
        f = drive.piece_flops(cell.config)
        assert {k: f[k] for k in SDXL_PIECES} == SDXL_PIECES


def test_transformer_ranges_open_only_under_a_profiler():
    from torch.profiler import ProfilerActivity, profile

    from benchmark.families.sdxl import XFMR

    cell = tiny_cell("sdxl-1024.seeds4")
    prog = models.build_program(cell.config, SEED, CPU, 2)
    w = prog.wrapper
    eps = w.eps_fn(w.prep_text(None))
    x = torch.randn(1, 4, 8, 8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eps(x, 10)
    names = [e.name for e in prof.events()]
    assert names.count(XFMR) == prog.wrapper.unet.config.num_transformers
    eps(x, 10)  # and nothing to record outside a profile
