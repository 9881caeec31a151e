"""Logging, profiling and tracing: the port of the JAX package's
`utils/logging.py`, with the port's tracer. A file + stream logger
(processes other than rank 0 log errors only), a `torch.profiler` trace
around a region, and spans and counters at the program's layer boundaries.

Counters (`COUNTERS`, one registry by name) are plain integer adds, counted
always: the kernel wrappers' launches (`ops.launches.<kernel>`), the conv
dispatches by path (`ops.conv3x3.<path>`), `engine.steps`, the samples
whose guidance loss took one call for their chunk or one of their own
(`guidance.loss_samples.batched`, `.looped`), and the nanoseconds
`ops._build.build` spent hashing the kernels' sources (`ops.build_ns`) and
compiling them (`ops.compile_ns`).

Spans are off by default: `span(...)` then checks one module-level flag and
returns a shared do-nothing context manager; it reads no clock, opens no
profiler range and allocates nothing. With tracing on (`enable_tracing`,
`tracing()`, or inside `profile_trace`) each span records in memory its
name, start and end (`time.perf_counter_ns`), its parent, the request id
that `set_request` last set, and its attributes (an int as `index`, such as
a step's; tensors' shapes and element size). While a profiler records, each
span is also a `torch.profiler.record_function` named `die.<name>`, so that
a profiled run holds the spans and the device's operations on one clock
(outside a profile the range would record nothing, and it costs as much as
the rest of a span). A span opened on
a thread with none of its own open (autograd's backward thread) takes as
parent the newest innermost span of the other threads: the one whose
thread waits in the backward (`guidance.vjp`).

While on, the tracer also counts host-device synchronisations: PyTorch's
CUDA sync-debug mode is set to warn, and each such warning is counted
(`host_syncs`, `host_syncs.<directory>/<file>:<line>` of the Python line
that made it, and on the innermost span open on the thread it reaches)
instead of shown. A backward's synchronisations reach the thread that
started it when the backward ends. The tracer itself never synchronises
the device and makes no CUDA call.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
import warnings
from collections.abc import Mapping
from typing import Dict, Iterable, Iterator, List, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function


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


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

COUNTERS: Dict[str, int] = collections.Counter()


class CounterView(Mapping):
    """The counters `prefix + key` of a fixed set of keys, read by key (a
    missing counter reads 0)."""

    def __init__(self, prefix: str, keys: Iterable[str]):
        self.prefix = prefix
        self.keys_ = tuple(keys)

    def __getitem__(self, key: str) -> int:
        if key not in self.keys_:
            raise KeyError(key)
        return COUNTERS[self.prefix + key]

    def __iter__(self) -> Iterator[str]:
        return iter(self.keys_)

    def __len__(self) -> int:
        return len(self.keys_)

    def reset(self) -> None:
        for key in self.keys_:
            COUNTERS[self.prefix + key] = 0


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

PREFIX = "die."  # the profiler range of span `name` is `die.<name>`
SYNC_WARNING = "called a synchronizing CUDA operation"  # PyTorch's sync-debug warning

_ON = False
_REQUEST = None
_LOG: List["Span"] = []
_IDS = itertools.count()
_LOCAL = threading.local()
_STACKS: Dict[int, list] = {}  # each thread's open spans, innermost last
_STACKS_LOCK = threading.Lock()
_SAVED: dict = {}  # what `enable_tracing` added and replaced, for `disable_tracing`


class _Off:
    """The span of tracing off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
        with _STACKS_LOCK:
            _STACKS[threading.get_ident()] = stack
    return stack


def _adoptive_parent() -> Optional["Span"]:
    """For a thread with no open span: the innermost open span, of any
    other thread, opened last."""
    with _STACKS_LOCK:
        tops = [s[-1] for s in _STACKS.values() if s]
    return max(tops, key=lambda sp: sp.start_ns, default=None)


def _innermost() -> Optional["Span"]:
    stack = _stack()
    return stack[-1] if stack else _adoptive_parent()


class Span:
    """One span's record, and the context manager that times it."""

    __slots__ = ("id", "name", "parent", "request", "thread", "start_ns", "end_ns", "attrs",
                 "host_syncs", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_IDS)
        self.parent = self.request = self.thread = self.end_ns = None
        self.start_ns = 0
        self.host_syncs = 0

    def __enter__(self) -> "Span":
        stack = _stack()
        parent = stack[-1] if stack else _adoptive_parent()
        self.parent = None if parent is None else parent.id
        self.request, self.thread = _REQUEST, threading.get_ident()
        if _profiler_enabled():
            self._range = record_function(PREFIX + self.name)
            self._range.__enter__()
        else:
            self._range = None
        self.start_ns = time.perf_counter_ns()
        stack.append(self)
        return self

    def __exit__(self, typ, value, tb):
        self.end_ns = time.perf_counter_ns()
        _stack().pop()
        if self._range is not None:
            self._range.__exit__(typ, value, tb)
            self._range = None
        _LOG.append(self)
        return False

    def as_dict(self) -> dict:
        return {"id": self.id, "name": self.name, "parent": self.parent,
                "request": self.request, "thread": self.thread, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "host_syncs": self.host_syncs, **self.attrs}


def _attrs(a, b) -> dict:
    attrs = {}
    for v in (a, b):
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            attrs.setdefault("shapes", []).append(list(v.shape))
            attrs["elem_bytes"] = v.element_size()
        else:
            attrs["index"] = int(v)
    return attrs


def span(name: str, a=None, b=None):
    """`with span("engine.step", i): ...`: a span named `name` around the
    block while tracing is on (see the module's docstring); `a` and `b` are
    its attributes, each an int (recorded as `index`) or a tensor (its shape
    in `shapes`, and `elem_bytes`). Off, the shared do-nothing one."""
    if not _ON:
        return _OFF
    return Span(name, _attrs(a, b))


def set_request(request) -> None:
    """The request id that every span opened from now on records (one edit
    or one pass)."""
    global _REQUEST
    _REQUEST = request


def _sync_site(filename: str, lineno: int) -> str:
    """`<directory>/<file>:<line>` of a synchronising call."""
    return f"{os.path.basename(os.path.dirname(filename))}/{os.path.basename(filename)}:{lineno}"


def _show_warning(message, category, filename, lineno, file=None, line=None):
    if _ON and SYNC_WARNING in str(message):
        COUNTERS["host_syncs"] += 1
        COUNTERS["host_syncs." + _sync_site(filename, lineno)] += 1
        owner = _innermost()
        if owner is not None:
            owner.host_syncs += 1
        return
    _SAVED["shown_by"](message, category, filename, lineno, file, line)


def _sync_debug_mode(mode: Optional[int]) -> Optional[int]:
    """Sets PyTorch's CUDA sync-debug mode where the build has CUDA (host
    state only: no CUDA call); returns the previous mode."""
    get = getattr(torch._C, "_cuda_get_sync_debug_mode", None)
    if get is None or mode is None:
        return None
    prev = get()
    torch._C._cuda_set_sync_debug_mode(mode)
    return prev


def enable_tracing() -> None:
    """Spans on, and host-device synchronisations counted: one warnings
    filter and the `warnings.showwarning` hook are added, and nothing else of
    the warnings' state is touched."""
    global _ON
    if _ON:
        return
    warnings.filterwarnings("always", message=SYNC_WARNING)
    _SAVED.update(filter=warnings.filters[0], shown_by=warnings.showwarning,
                  sync_mode=_sync_debug_mode(1))
    warnings.showwarning = _show_warning
    _ON = True


def disable_tracing() -> None:
    """Spans off; what `enable_tracing` added is taken out again (the filter,
    where it is still there, and the hook), and the sync-debug mode is put
    back. The recorded spans stay (`span_log`, `clear_spans`)."""
    global _ON
    if not _ON:
        return
    _ON = False
    _sync_debug_mode(_SAVED.pop("sync_mode"))
    if warnings.showwarning is _show_warning:
        warnings.showwarning = _SAVED["shown_by"]  # kept: a copy of the hook may outlive this
    with contextlib.suppress(ValueError):
        warnings.filters.remove(_SAVED.pop("filter"))


@contextlib.contextmanager
def tracing():
    """Tracing on inside the block; yields a list that holds, once the block
    ends, the dicts of the spans that closed in it. Where the block turned
    tracing on, it turns it off again and takes its spans out of the log."""
    was_on, first, spans = _ON, len(_LOG), []
    enable_tracing()
    try:
        yield spans
    finally:
        spans.extend(span_log(first))
        if not was_on:
            disable_tracing()
            del _LOG[first:]


def span_log(first: int = 0) -> List[dict]:
    """The recorded spans from the `first`-th on, each a dict, in the order
    they closed."""
    return [s.as_dict() for s in _LOG[first:]]


def clear_spans() -> None:
    _LOG.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str = "die_tpu_trace"):
    """A `torch.profiler` trace (CPU, and CUDA when it is available) around
    the region, with tracing on; yields the profiler. Writes into `log_dir`
    the Chrome/Perfetto trace `trace.json` (the spans are its `die.`
    ranges), `spans.json` (the region's spans, `span_log`'s dicts) and
    `counters.json` (what each counter counted in the region)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    before = dict(COUNTERS)
    with tracing() as spans, profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(spans, f)
    counted = {k: v - before.get(k, 0) for k, v in COUNTERS.items() if v != before.get(k, 0)}
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump(counted, f, indent=1, sort_keys=True)
