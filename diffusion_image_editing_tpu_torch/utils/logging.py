"""Logging and profiling helpers: the port of the JAX package's
`utils/logging.py`. A file + stream logger (processes other than rank 0
log errors only), a `torch.profiler` trace around a region, and per-phase
wall-clock timers that wait for the device."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Optional

import torch


def _rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def setup_logger(
    logpth: Optional[str] = None, name: str = "die_tpu", level=logging.INFO
) -> logging.Logger:
    """File + stream logger; processes of rank > 0 are demoted to ERROR. The
    file is `logpth/<name>.log`."""
    logger = logging.getLogger(name)
    logger.handlers.clear()
    if _rank() > 0:
        level = logging.ERROR
    logger.setLevel(level)
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(sh)
    if logpth:
        os.makedirs(logpth, exist_ok=True)
        fh = logging.FileHandler(os.path.join(logpth, f"{name}.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger


@contextlib.contextmanager
def profile_trace(log_dir: str = "die_tpu_trace"):
    """A `torch.profiler` trace (CPU, and CUDA when it is available) around
    the region, written as a Chrome/Perfetto trace into `log_dir`; yields the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Wall-clock per-phase step timing. On a CUDA `device` each phase
    synchronises the device at its start and its end, so that it times the
    device's work and not only its launch; None or the CPU does not."""

    def __init__(self, device=None):
        self.device = None if device is None else torch.device(device)
        self.totals = {}
        self.counts = {}

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {
            k: {"total_s": v, "mean_s": v / self.counts[k], "count": self.counts[k]}
            for k, v in self.totals.items()
        }
