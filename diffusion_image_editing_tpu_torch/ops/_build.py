"""Build the port's CUDA kernels with nvcc at first use and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `lib<name>-<digest>.so`, a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). `<digest>` hashes the sources and the flags, so an edited
source never loads a stale library. Builds land in `BUILD_DIR`, inside the
package and listed in `.gitignore`; `build()` starts one nvcc per missing
library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / ".build"
KERNELS = (
    "flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
    "group_norm_fused", "group_norm_stats", "group_norm_apply", "affine_silu_conv3x3",
    "abn_apply",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

_FNS: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    if name not in KERNELS:
        raise KeyError(f"unknown kernel {name!r}; have {KERNELS}")
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel whose library is missing, one nvcc each,
    in parallel. Returns the wall seconds per compiled kernel (0.0 for one
    already built). Raises RuntimeError with nvcc's output on failure."""
    names = list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    times = {n: 0.0 for n in names}
    if not todo:
        return times
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return times


def _kernel_name(mangled: str) -> str:
    """`_ZN2fa16flash_fwd_kernelILi48ELi1ELi4ELi64EEEv...` -> `flash_fwd_kernel<48,1,4,64>`,
    `_ZN2gn15gn_fused_kernelILb1EEEv...` -> `gn_fused_kernel<1>`."""
    if not mangled.startswith("_ZN"):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():  # <length><identifier> per scope
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    m = re.match(r"I((?:L[ib]\d+E)+)E", mangled[i:])
    return f"{name}<{','.join(re.findall(r'L[ib](\d+)E', m.group(1)))}>" if m else name


def ptxas_report(name: str) -> str:
    """One line per compiled kernel of the library's last build: registers,
    shared memory and barriers, then stack and spills, as ptxas reports them."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return ""
    lines, entry, frame = [], "", ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            frame = line.strip()
        elif "ptxas info" in line and "Used" in line:
            lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {frame}")
    return "\n".join(lines)


def load(name: str, argtypes: Sequence, restype=ctypes.c_int):
    """The C entry point `name` of its kernel library, built and loaded at
    the first call."""
    fn = _FNS.get(name)
    if fn is None:
        build([name])
        fn = getattr(ctypes.CDLL(str(library_path(name))), name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _FNS[name] = fn
    return fn


def launch(name: str, argtypes: Sequence, device: torch.device, *args) -> None:
    """Call kernel `name`'s C entry point on `device` and PyTorch's current
    stream: `fn(device index, *args, stream)`. Raises when it returns an
    error (a refused shape, or a launch the device refused)."""
    fn = load(name, argtypes)
    stream = torch.cuda.current_stream(device).cuda_stream
    rc = fn(device.index, *args, stream)
    if rc != 0:
        try:
            reason = str(torch.cuda.CudaError(rc))
        except (TypeError, ValueError):
            reason = f"cudaError_t {rc}"
        raise RuntimeError(f"{name} launch failed: {reason}")
