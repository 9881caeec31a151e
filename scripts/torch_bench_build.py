"""Builds for the port's kernel benches: a git revision's kernel sources,
nvcc with the port's flags into a loadable library, and ptxas's report.

Used by `torch_bench_attention.py` and `torch_bench_groupnorm.py` (their
`--parent REV` and `--variant DIR[:DEFINES]`); not a script of its own.
"""

from __future__ import annotations

import ctypes
import io
import re
import subprocess
import tarfile
from pathlib import Path

from diffusion_image_editing_tpu_torch.ops import _build

ROOT = Path(__file__).resolve().parent.parent
CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float, "long long": ctypes.c_longlong}


def parent_sources(rev: str, names) -> Path:
    """The sources `names` (kernel stems, `NAME.cu`) and every header of
    git revision `rev`, unpacked into the build directory (or found there,
    outside a git checkout)."""
    dst = _build.BUILD_DIR / f"parent-{rev}"
    csrc = _build.CSRC.relative_to(ROOT).as_posix()
    if (ROOT / ".git").exists():
        blob = subprocess.run(["git", "-C", str(ROOT), "archive", rev, csrc],
                              capture_output=True, check=True).stdout
        dst.mkdir(parents=True, exist_ok=True)
        with tarfile.open(fileobj=io.BytesIO(blob)) as tar:
            for member in tar.getmembers():
                name = Path(member.name).name
                if member.isfile() and (name.endswith(".cuh") or name[:-3] in names):
                    (dst / name).write_bytes(tar.extractfile(member).read())
    missing = [s for s in names if not (dst / f"{s}.cu").exists()]
    if missing:
        raise SystemExit(f"no {missing} of {rev} in {dst}: run once in the git checkout first")
    return dst


def print_ptxas(log: Path, tag: str) -> None:
    """Registers, shared memory and spills of each kernel, and any C75xx,
    warning or performance line, from an nvcc log."""
    entry, frame = "", ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = _build._kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            frame = line.strip()
        elif "ptxas info" in line and "Used" in line:
            print(f"[build] {tag} {entry}: {line.split(':', 1)[1].strip()}; {frame}")
        elif re.search(r"C75\d\d|arning|Performance", line):
            print(f"[build] {tag} {line.strip()}")


def c_params(src: Path, name: str):
    """The parameter names and ctypes of C entry point `name` in `src`."""
    decl = re.search(rf'extern "C" int {name}\((.*?)\)', src.read_text(), re.S).group(1)
    params, argtypes = [], []
    for param in decl.split(","):
        ctype, pname = param.strip().rsplit(" ", 1)
        params.append(pname.lstrip("*"))
        argtypes.append(ctypes.c_void_p if "*" in param else CTYPES[ctype.replace("const ", "")])
    return params, argtypes


def build_library(src: Path, name: str, defines=(), argtypes=None):
    """nvcc `src` with the port's flags (and `-D` defines) into its
    directory, print ptxas's report, load it and return C entry point
    `name`, typed by `argtypes` or else by its declaration in `src`."""
    tag = "".join(f"-{d}" for d in defines)
    out = src.parent / f"lib{name}{tag}.so"
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, *(f"-D{d}" for d in defines),
           "-o", str(out), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} {defines}:\n{proc.stdout}{proc.stderr}")
    log = out.with_suffix(".log")
    log.write_text(proc.stdout + proc.stderr)
    print_ptxas(log, f"{src.parent.name}/{name}{tag}")
    fn = getattr(ctypes.CDLL(str(out)), name)
    fn.argtypes = argtypes if argtypes is not None else c_params(src, name)[1]
    fn.restype = ctypes.c_int
    return fn
