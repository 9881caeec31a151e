"""What the benchmark loads: the reference imports neither JAX nor the JAX
package nor the port; the guard compares top-level names whole; a checkout
that holds only the benchmark exits without a result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark.harness import guard

ROOT = Path(__file__).resolve().parents[2]
PORT = "diffusion_image_editing_tpu_torch"


def test_guard_compares_whole_top_level_names():
    names = ["jax.numpy", "jaxlib", "flax.linen", "diffusion_image_editing_tpu.ops",
             PORT, PORT + ".ops", "jaxtyping", "flaxen"]
    assert guard.forbidden(names) == ["diffusion_image_editing_tpu", "flax", "jax", "jaxlib"]
    assert guard.forbidden([PORT, PORT + ".models", "torch"]) == []


def test_reference_imports_nothing_of_jax_or_the_program():
    code = ("import sys; import benchmark.reference.models, benchmark.reference.diffusion, "
            "benchmark.reference.resnet, benchmark.reference.configs; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    top = set(json.loads(out.strip().replace("'", '"')))
    assert not top & (guard.FORBIDDEN | {PORT}), top & (guard.FORBIDDEN | {PORT})


def test_harness_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); import benchmark.run, benchmark.readings; "
            "from benchmark.harness import cell, drive, models, ranges, trace, window; "
            "import pathlib; [cell.traffic(p.stem) for p in pathlib.Path('benchmark/traffic')"
            ".glob('*.py')]; [cell.family(p.stem) for p in pathlib.Path('benchmark/families')"
            ".glob('*.py')]; "
            "from benchmark.harness.guard import loaded_forbidden; print(loaded_forbidden())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_run_without_the_program_or_a_card_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    import torch

    # the whole checkout fails only where there is no card
    for root in (tmp_path,) if torch.cuda.is_available() else (tmp_path, ROOT):
        r = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "sd15-512.edit",
                            "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=root,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0
        assert not r.stdout.strip()
