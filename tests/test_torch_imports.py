"""The port stands alone: no module of `diffusion_image_editing_tpu_torch`,
and not `chip_smoke.py`, imports JAX (or Flax) or anything of the JAX
package `diffusion_image_editing_tpu`, checked on the source (every import
statement) and at run time (what importing every module loads)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "diffusion_image_editing_tpu_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffusion_image_editing_tpu")


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    bad = [name for name in _imported(path) if _forbidden(name)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_importing_every_module_loads_no_jax():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
               for p in sorted(PORT.rglob("*.py"))]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}: importlib.import_module(m)\n"
        "importlib.import_module('chip_smoke')\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("package", ["pipeline", "engine", "models", "parallel", "ops", "cli"])
def test_each_package_imports_first(package):
    """A package imported first in a fresh interpreter, as a user's script
    does: no import cycle (the models read the spatial split from
    `ops.split`, below `parallel`, which imports the engine, which imports
    the models)."""
    res = subprocess.run([sys.executable, "-c", f"import {PORT.name}.{package}"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_parallel_is_checked_and_starts_no_group():
    """parallel/ is among the files checked above, and importing it (with
    the trainer and the CLI, which use it) starts no process group."""
    names = {p.relative_to(PORT).as_posix() for p in FILES if p.is_relative_to(PORT)}
    assert {"parallel/__init__.py", "parallel/mesh.py", "parallel/sweep.py",
            "parallel/edit_shard.py", "ops/split.py", "models/extra_blocks.py",
            "ops/native/__init__.py"} <= names
    code = ("import torch.distributed as dist\n"
            "import diffusion_image_editing_tpu_torch.parallel, "
            "diffusion_image_editing_tpu_torch.seg, diffusion_image_editing_tpu_torch.cli\n"
            "print(dist.is_initialized())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "False", res.stdout + res.stderr
