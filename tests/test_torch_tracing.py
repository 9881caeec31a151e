"""The port's tracer (`utils/logging.py`): spans, their parents across
threads, request ids, counters, the off state, host-device synchronisations
counted, the `die.` profiler ranges, `profile_trace`'s files, and the spans
of a TINY guided edit through `EditPipeline` at every layer boundary.

On the CPU the autograd backward runs on the calling thread; the flash
backward's span (`ops.attention.bwd`) is reached there by routing the
attention that needs a gradient through `_FlashAttention` with the three
kernel wrappers replaced by their plain versions. The test marked `cuda`
runs on the card:

    python -m pytest --noconftest -m cuda tests/test_torch_tracing.py -q
"""

import json
import threading
import warnings

import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu_torch import ops as OPS
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.models import (TINY_SD_UNET, TINY_VAE, AutoencoderKL,
                                                      UNet2DCondition)
from diffusion_image_editing_tpu_torch.ops import attention as A
from diffusion_image_editing_tpu_torch.ops import conv as C
from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline
from diffusion_image_editing_tpu_torch.utils import logging as L

STEPS = 3


@pytest.fixture(autouse=True)
def fresh_tracer():
    """Every test starts and ends with tracing off and an empty log."""
    L.disable_tracing()
    L.clear_spans()
    L.set_request(None)
    yield
    L.disable_tracing()
    L.clear_spans()
    L.set_request(None)


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _ancestors(s, by_id):
    chain = []
    while s["parent"] is not None:
        s = by_id[s["parent"]]
        chain.append(s["name"])
    return chain


def test_spans_nest_with_parents_times_and_attributes():
    x = torch.zeros(2, 3, dtype=torch.bfloat16)
    with L.tracing() as spans:
        with L.span("outer", 7):
            with L.span("inner", x, torch.zeros(4)):
                pass
            with L.span("inner"):
                pass
    outer = _by_name(spans)["outer"][0]
    inner = _by_name(spans)["inner"]
    assert [s["name"] for s in spans] == ["inner", "inner", "outer"]  # the order they closed
    assert outer["parent"] is None and outer["index"] == 7
    assert all(s["parent"] == outer["id"] for s in inner)
    assert inner[0]["shapes"] == [[2, 3], [4]] and inner[0]["elem_bytes"] == 4
    assert "shapes" not in inner[1] and "index" not in inner[1]
    assert outer["start_ns"] <= inner[0]["start_ns"] <= inner[0]["end_ns"] <= outer["end_ns"]
    assert L.span_log() == []  # `tracing()` turned tracing on, so it takes its spans away


def test_a_thread_with_no_open_span_takes_the_waiting_span_as_parent():
    """As autograd's thread does while the caller waits in `guidance.vjp`."""
    with L.tracing() as spans:
        with L.span("guidance.vjp"):
            worker = threading.Thread(target=lambda: L.span("ops.attention.bwd").__enter__()
                                      .__exit__(None, None, None))
            worker.start()
            worker.join(timeout=30)
            assert not worker.is_alive()
    by = _by_name(spans)
    bwd, vjp = by["ops.attention.bwd"][0], by["guidance.vjp"][0]
    assert bwd["parent"] == vjp["id"] and bwd["thread"] != vjp["thread"]


def test_a_backward_s_spans_sit_under_the_span_that_started_it():
    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            with L.span("ops.attention.bwd"):
                return 2 * g

    x = torch.ones(3, requires_grad=True)
    with L.tracing() as spans:
        y = Twice.apply(x).sum()
        with L.span("guidance.vjp"):
            (g,) = torch.autograd.grad(y, x)
    by = _by_name(spans)
    assert by["ops.attention.bwd"][0]["parent"] == by["guidance.vjp"][0]["id"]
    assert torch.equal(g, torch.full((3,), 2.0))


def test_request_ids_mark_every_span_until_changed():
    with L.tracing() as spans:
        L.set_request(4)
        with L.span("a"):
            with L.span("b"):
                pass
        L.set_request("warm-up")
        with L.span("c"):
            pass
    assert [(s["name"], s["request"]) for s in spans] == [("b", 4), ("a", 4), ("c", "warm-up")]


def test_counters_are_one_registry_that_the_old_reads_go_through():
    OPS.reset_launch_counts()
    assert OPS.launch_counts() == {k: 0 for k in OPS.LAUNCHES}
    L.COUNTERS["ops.launches.flash_attn_fwd"] += 2
    assert OPS.launch_counts()["flash_attn_fwd"] == 2
    OPS.reset_launch_counts()
    assert OPS.launch_counts()["flash_attn_fwd"] == 0
    before = dict(C.CALL_COUNTS)
    assert set(before) == {"xla", "shift9", "int8"}
    C.conv3x3(torch.zeros(1, 2, 4, 4), torch.zeros(3, 2, 3, 3))
    assert C.CALL_COUNTS["xla"] == before["xla"] + 1 == L.COUNTERS["ops.conv3x3.xla"]
    with pytest.raises(KeyError):
        C.CALL_COUNTS["nope"]
    steps = L.COUNTERS["engine.steps"]
    _tiny_pipe().edit_image(torch.zeros(1, 4, 16, 16), attr_func=SingleColorAttrFunc(t2=STEPS),
                            collect=False)  # tracing off: counters count all the same
    assert L.COUNTERS["engine.steps"] == steps + STEPS


def test_off_records_nothing_reads_no_clock_and_opens_no_range(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("called while tracing is off")

    monkeypatch.setattr(L.time, "perf_counter_ns", boom)
    monkeypatch.setattr(L, "record_function", boom)
    monkeypatch.setattr(L, "Span", boom)
    off = L.span("a", 3, torch.zeros(2))
    assert off is L.span("b") and not L._ON
    with off:
        with L.span("c"):
            pass
    _tiny_pipe().edit_image(torch.zeros(1, 4, 16, 16), attr_func=SingleColorAttrFunc(t2=STEPS),
                            collect=False)
    assert L.span_log() == [] and L.COUNTERS["host_syncs"] == 0


def test_the_tracer_never_synchronises_or_initialises_cuda(monkeypatch, tmp_path):
    def boom(*args, **kwargs):
        raise AssertionError("the tracer called CUDA")

    for name in ("synchronize", "_lazy_init", "init", "current_stream"):
        monkeypatch.setattr(torch.cuda, name, boom)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with L.profile_trace(str(tmp_path)):
        _traced_edit_spans_in_place()


def test_sync_warnings_are_counted_on_the_innermost_span_and_not_shown(recwarn):
    syncs, site = L.COUNTERS["host_syncs"], None
    with L.tracing() as spans:
        with L.span("outer"):
            with L.span("inner"):
                for _ in range(2):
                    warnings.warn(L.SYNC_WARNING)
            warnings.warn("another warning")
        site = [k for k in L.COUNTERS if k.startswith("host_syncs.tests/")]
    warnings.warn(L.SYNC_WARNING)  # tracing off: shown, not counted
    by = _by_name(spans)
    assert by["inner"][0]["host_syncs"] == 2 and by["outer"][0]["host_syncs"] == 0
    assert L.COUNTERS["host_syncs"] == syncs + 2
    assert len(site) == 1 and site[0].startswith("host_syncs.tests/test_torch_tracing.py:")
    assert [str(w.message) for w in recwarn] == ["another warning", L.SYNC_WARNING]


def test_die_ranges_appear_and_nest_under_the_profiler():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with L.tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        with L.span("outer"):
            with L.span("inner"):
                torch.ones(8).sum()
    found = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name().startswith(L.PREFIX):
            found[ev.name()] = (ev.start_ns(), ev.end_ns())
    assert set(found) == {"die.outer", "die.inner"}
    assert found["die.outer"][0] <= found["die.inner"][0] <= found["die.inner"][1] \
        <= found["die.outer"][1]


def test_outside_a_profile_a_span_opens_no_profiler_range(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError("a profiler range outside a profile")

    monkeypatch.setattr(L, "record_function", boom)
    with L.tracing() as spans:
        with L.span("a"):
            pass
    assert [s["name"] for s in spans] == ["a"]


def test_profile_trace_writes_the_spans_and_counters(tmp_path):
    with L.profile_trace(str(tmp_path)):
        with L.span("a", 2):
            L.COUNTERS["engine.steps"] += 1
    assert json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (span,) = json.loads((tmp_path / "spans.json").read_text())
    assert span["name"] == "a" and span["index"] == 2 and span["end_ns"] >= span["start_ns"]
    assert json.loads((tmp_path / "counters.json").read_text()) == {"engine.steps": 1}
    assert not L._ON and L.span_log() == []


def test_turning_tracing_off_leaves_the_warnings_state_as_others_left_it():
    shown_by, filters = warnings.showwarning, list(warnings.filters)
    L.enable_tracing()
    assert warnings.showwarning is L._show_warning and len(warnings.filters) == len(filters) + 1
    warnings.filterwarnings("ignore", message="added while tracing was on")
    L.disable_tracing()
    assert warnings.showwarning is shown_by
    assert warnings.filters[0][1].pattern == "added while tracing was on"
    assert warnings.filters[1:] == filters  # the tracer's own filter went, the other stayed
    warnings.filters.pop(0)


def test_build_counts_hashing_and_compiling_apart(monkeypatch, tmp_path):
    from diffusion_image_editing_tpu_torch.ops import _build

    compiled = []

    def fake_compile(todo):
        compiled.extend(todo)
        return {n: 1.5 for n in todo}

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    before = dict(L.COUNTERS)
    name = _build.KERNELS[0]
    assert _build.build([name]) == {name: 1.5} and compiled == [name]
    hashed = L.COUNTERS["ops.build_ns"] - before.get("ops.build_ns", 0)
    compiling = L.COUNTERS["ops.compile_ns"] - before.get("ops.compile_ns", 0)
    assert hashed > 0 and compiling > 0
    _build.library_path(name).touch()  # built: hashing only
    assert _build.build([name]) == {name: 0.0} and compiled == [name]
    assert L.COUNTERS["ops.compile_ns"] - before.get("ops.compile_ns", 0) == compiling
    assert L.COUNTERS["ops.build_ns"] - before.get("ops.build_ns", 0) > hashed


# ---- a TINY guided edit ---------------------------------------------------


class _FixedTextSD(SD):
    def __init__(self, *args, text_emb, **kwargs):
        super().__init__(*args, **kwargs)
        self.fixed_text_emb = text_emb.to(self.device)

    def prep_text(self, prompt_ids=None):
        return self.fixed_text_emb


def _tiny_pipe():
    torch.manual_seed(0)
    sd = _FixedTextSD(UNet2DCondition(TINY_SD_UNET, device="cpu"),
                      AutoencoderKL(TINY_VAE, device="cpu"), schedule_for_model("sd", STEPS),
                      text_emb=torch.randn(2, 7, 32), device="cpu")
    return EditPipeline(sd)


def _plain_kernels(monkeypatch):
    """Attention that needs a gradient runs `_FlashAttention` on the CPU,
    its three kernel wrappers replaced by their plain versions."""
    plain = A.attention_reference

    def fwd(q, k, v, scale, with_lse):
        b, s_q, h, _ = q.shape
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
        return plain(q, k, v, scale), torch.logsumexp(logits, -1).reshape(b * h, s_q)

    def routed(q, k, v, scale=None, causal=False):
        if not causal and torch.is_grad_enabled() and q.requires_grad:
            return A._FlashAttention.apply(q, k, v, float(scale))
        return plain(q, k, v, scale, causal=causal)

    monkeypatch.setattr(A, "attention_reference", routed)
    monkeypatch.setattr(A, "flash_attn_fwd", fwd)
    monkeypatch.setattr(A, "flash_attn_bwd_dq", A.attention_bwd_dq_reference)
    monkeypatch.setattr(A, "flash_attn_bwd_dkv", A.attention_bwd_dkv_reference)


def _traced_edit_spans_in_place():
    pipe = _tiny_pipe()
    img = torch.rand(1, 3, 32, 32, generator=torch.Generator().manual_seed(1)) * 2 - 1
    L.set_request(5)
    xt, _, _, _, _ = pipe.prepare_real_image_edit(img)
    pipe.edit_image(xt, attr_func=SingleColorAttrFunc(t2=STEPS, loss_scale=5.0), mode="split",
                    collect=False)


def test_a_traced_edit_has_a_span_at_every_layer_boundary(monkeypatch):
    _plain_kernels(monkeypatch)
    before = dict(L.COUNTERS)
    with L.tracing() as spans:
        _traced_edit_spans_in_place()
    by, by_id = _by_name(spans), {s["id"]: s for s in spans}
    assert {s["request"] for s in spans} == {5}
    steps = by["engine.step"]
    assert sorted(s["index"] for s in steps) == list(range(STEPS))
    assert all(s["parent"] is None for s in steps + by["engine.invert"])
    for name in ("engine.update", "guidance.nudge"):
        assert len(by[name]) == STEPS and all(_ancestors(s, by_id)[0] == "engine.step"
                                              for s in by[name])
    for nudge in by["guidance.nudge"]:
        kids = [s["name"] for s in spans if s["parent"] == nudge["id"]]
        assert kids == ["guidance.decode", "guidance.loss", "guidance.vjp"]
    unets = by["models.unet"]
    assert len(unets) == 2 * STEPS  # the inversion's and the edit's, one CFG call a step
    assert sum("engine.invert" in _ancestors(s, by_id) for s in unets) == STEPS
    assert {_ancestors(s, by_id)[0] for s in by["models.encode"]} == {"engine.invert"}
    assert [_ancestors(s, by_id) for s in by["models.decode"]] == [[]]  # the final decode
    under_unet = {s["name"] for s in spans if "models.unet" in _ancestors(s, by_id)}
    assert under_unet == {"ops.attention", "ops.group_norm", "ops.conv3x3"}
    for s in by["ops.attention"]:
        assert len(s["shapes"]) == 2 and s["elem_bytes"] == 4
    bwd = by["ops.attention.bwd"]
    assert bwd and all(_ancestors(s, by_id)[:2] == ["guidance.vjp", "guidance.nudge"]
                       for s in bwd)
    assert L.COUNTERS["engine.steps"] - before.get("engine.steps", 0) == STEPS


def test_a_batch_s_nudge_is_one_span_with_a_loss_a_sample():
    pipe = _tiny_pipe()
    xt = torch.randn(2, 4, 16, 16, generator=torch.Generator().manual_seed(2))
    with L.tracing() as spans:
        pipe.edit_image(xt, attr_func=SingleColorAttrFunc(t2=STEPS, vjp_chunk=2), collect=False)
    by, by_id = _by_name(spans), {s["id"]: s for s in spans}
    assert len(by["guidance.nudge"]) == STEPS and len(by["guidance.loss"]) == 2 * STEPS
    assert {_ancestors(s, by_id)[0] for s in by["guidance.loss"]} == {"guidance.nudge"}


def test_a_generation_pass_counts_its_steps():
    from diffusion_image_editing_tpu_torch.parallel import seed_sweep_generate

    w = _tiny_pipe().diffusion_wrapper
    with L.tracing() as spans:
        seed_sweep_generate(w.schedule, w.eps_fn(w.prep_text(None)), (1, 4, 16, 16), [3, 4],
                            device="cpu")
    by = _by_name(spans)
    assert sorted(s["index"] for s in by["engine.step"]) == list(range(STEPS))
    assert len(by["models.unet"]) == STEPS and "guidance.nudge" not in by


@pytest.mark.cuda
def test_a_blocking_copy_to_the_card_counts_one_sync_on_its_span():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with L.tracing() as spans:
        with L.span("outer"):
            with L.span("copy"):
                torch.as_tensor(np.int64(3), device="cuda")
    by = _by_name(spans)
    assert by["copy"][0]["host_syncs"] == 1 and by["outer"][0]["host_syncs"] == 0


# ---- the readings of the span log -----------------------------------------


def _trace_cell_script():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "scripts" / "torch_trace_cell.py"
    spec = importlib.util.spec_from_file_location("torch_trace_cell", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _span(i, name, request, start_ms, end_ms, parent=None, **attrs):
    return dict(id=i, name=name, parent=parent, request=request, thread=1,
                start_ns=int(start_ms * 1e6), end_ns=int(end_ms * 1e6), host_syncs=0, **attrs)


def test_p95_and_the_flash_backward_s_work():
    S = _trace_cell_script()
    assert S.p95([1.0]) is None
    assert S.p95([float(v) for v in range(1, 102)]) == pytest.approx(96.0)
    (f2, b2), (f3, b3) = S.flash_bwd_work([1, 4096, 1, 512], [1, 4096, 1, 512], 2)
    assert f2 == 6 * 4096 * 4096 * 512 and f3 == 8 * 4096 * 4096 * 512
    assert b2 == 2 * 512 * 5 * 4096 + 8 * 4096 and b3 == 2 * 512 * 6 * 4096 + 8 * 4096


class _Trace:
    """What `read_spans` reads of a trace, from fixed numbers: device seconds
    by range and the idle gaps by label."""

    def __init__(self, device_s, gaps):
        self.device_s, self.gaps = device_s, gaps

    def range_device_s(self, name):
        return self.device_s.get(name, 0.0)

    def range_count(self, name):
        return int(name in self.device_s)

    def idle_gaps(self, n=10):
        return self.gaps[:n]


def _bound_s(flops, nbytes):
    return flops / 1e15 + nbytes / 1e12


def test_span_readings_divide_by_the_steps_and_read_the_device_time():
    S = _trace_cell_script()
    window = [_span(10 * r + k, "engine.step", r, 100 * k, 100 * k + 10 + r)
              for r in range(2) for k in range(10)]
    q, kv = [1, 64, 1, 512], [1, 64, 1, 512]
    traced = [_span(100, "engine.step", 2, 0, 5), _span(101, "engine.step", 2, 6, 11),
              _span(102, "ops.attention.bwd", 2, 1, 2, parent=100, shapes=[q, kv],
                    elem_bytes=2), _span(103, "models.encode", 2, 0, 1)]
    traced[0]["host_syncs"], traced[2]["host_syncs"], traced[3]["host_syncs"] = 4, 3, 5
    trace = _Trace({"bench.nudge": 0.005, "die.guidance.nudge": 0.005,
                    "die.guidance.loss": 0.002, "die.guidance.vjp": 0.003,
                    "die.ops.attention.bwd": 0.001},
                   [["die.guidance.loss", 0.003], ["bench.nudge", 0.001]])
    counts = {"engine.steps": 2, "host_syncs": 12, "host_syncs.core/schedule.py:145": 8,
              "host_syncs.engine/denoise.py:56": 4}
    out = S.read_spans(window + traced, 2, {"engine.steps": 20, "host_syncs": 100}, counts,
                       {"ops.build_ns": 30_000_000, "ops.compile_ns": 3_000_000_000},
                       trace, _bound_s)
    durations = [10.0] * 10 + [11.0] * 10
    assert out["steps"] == 20 and out["step_p95_ms"] == pytest.approx(S.p95(durations))
    assert out["spans_per_step"] == 1.0
    assert out["build_s"] == 0.03 and out["compile_s"] == 3.0
    assert out["host_syncs_per_step"] == 6.0 and out["window_host_syncs_per_step"] == 5.0
    assert out["sync_sites"] == {"core/schedule.py:145": 4.0, "engine/denoise.py:56": 2.0}
    assert out["step_host_syncs_per_step"] == 3.5  # the encode's syncs lie outside the steps
    assert out["loss_ms"] == pytest.approx(2.0 / 2) and out["vjp_ms"] == pytest.approx(3.0 / 2)
    assert out["nudge_ms"] == pytest.approx(5.0 / 2) and out["unet_ms"] is None
    bound = sum(_bound_s(f, b) for f, b in S.flash_bwd_work(q, kv, 2))
    assert out["attn_bwd_roofline"] == pytest.approx(100.0 * bound / 0.001)
    assert out["agree"] == {"die.guidance.nudge": {"die_ms": 5.0, "bench_ms": 5.0,
                                                   "ratio": 1.0}}
    assert out["idle_labelled"]["die_share"] == pytest.approx(0.75)


def test_span_readings_are_none_without_a_tracer():
    S = _trace_cell_script()
    out = S.read_spans([], 3, {}, {}, {})
    assert out["steps"] == 0 and out["sync_sites"] == {}
    assert all(out[k] is None for k in ("step_p95_ms", "step_mean_ms", "spans_per_step",
                                        "build_s", "compile_s", "host_syncs_per_step",
                                        "window_host_syncs_per_step",
                                        "step_host_syncs_per_step"))
    assert S.read_spans([], 3, {}, {}, {"ops.build_ns": 5})["compile_s"] == 0.0


def test_the_build_seconds_reader_reads_the_counter(monkeypatch):
    import types

    from benchmark.metrics import build_s

    monkeypatch.setitem(L.COUNTERS, "ops.build_ns", 40_000_000)
    monkeypatch.setitem(L.COUNTERS, "ops.compile_ns", 2_500_000_000)
    assert build_s.read(types.SimpleNamespace()) == 2.5
    monkeypatch.setitem(L.COUNTERS, "ops.compile_ns", 0)  # every library built already
    assert build_s.read(types.SimpleNamespace()) == 0.0
    monkeypatch.delattr(L, "COUNTERS")  # a program without the tracer
    assert build_s.read(types.SimpleNamespace()) is None
