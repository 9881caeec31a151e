"""`scripts/torch_trace_cell.py` around `run.py`'s `run_cell`, on the CPU at
TINY widths: a cell run with the port's tracer on reads its spans, and
leaves tracing off again. The script's readers are tested on synthetic spans
in `tests/test_torch_tracing.py`."""

import importlib.util
import time
from pathlib import Path

import torch

from benchmark.tests.bench_tiny import TINY_STEPS, tiny_cell

ROOT = Path(__file__).resolve().parents[2]


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_trace_cell", ROOT / "scripts" / "torch_trace_cell.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_a_traced_benchmark_run_on_a_tiny_cell_reads_its_spans():
    from diffusion_image_editing_tpu_torch.utils import logging as L

    r = _script().traced_run(tiny_cell("sd15-512.seeds8"), 2 ** 31 + 5, 0.01, True,
                             torch.device("cpu"), time.perf_counter())
    spans = r["spans"]
    assert r["correct"] and spans["steps"] == TINY_STEPS * r["attempted"]
    assert spans["spans_per_step"] > 1 and spans["step_p95_ms"] > 0
    assert set(spans["agree"]) == {"die.models.unet", "die.ops.attention", "die.ops.group_norm"}
    assert spans["idle_labelled"]["die_share"] is not None
    assert not L._ON and L.span_log() == []
