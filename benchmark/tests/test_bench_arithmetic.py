"""The benchmark's arithmetic on the CPU: FLOPs counted against hand counts,
the roofline formulas, the idle share's interval union, the whole-call
window rule, the comparison, the seeded weights, and every file of the
benchmark found by its name."""

import math

import pytest
import torch
import torch.nn.functional as F

from benchmark.harness import cell as C
from benchmark.harness import compare, flops, trace, weights
from benchmark.harness.models import reference_modules
from benchmark.harness.window import Window, seconds_per_unit, units_per_second


def test_conv_and_matmul_flops_match_hand_counts():
    x, w = torch.zeros(2, 3, 8, 8), torch.zeros(4, 3, 3, 3)
    # 2 FLOPs a multiply-add: N Cout H W x Cin 3 3
    assert flops.count_flops(lambda: F.conv2d(x, w, padding=1)) == 2 * 2 * 4 * 8 * 8 * 3 * 9
    a, b = torch.zeros(5, 7), torch.zeros(7, 3)
    assert flops.count_flops(lambda: a @ b) == 2 * 5 * 7 * 3
    xg = torch.zeros(2, 3, 8, 8, requires_grad=True)
    # forward, then the input gradient alone (a transposed conv of the same size)
    fwd_bwd = flops.count_flops(lambda: torch.autograd.grad(F.conv2d(xg * 1.0, w, padding=1)
                                                            .sum(), xg))
    assert fwd_bwd == 2 * (2 * 2 * 4 * 8 * 8 * 3 * 9)


def test_attention_and_group_norm_work():
    f, b = flops.attention_work((2, 64, 8, 40), (2, 77, 8, 40), 2)
    assert f == 4 * 2 * 8 * 64 * 77 * 40
    assert b == 2 * (2 * 2 * 64 * 8 * 40 + 2 * 2 * 77 * 8 * 40)
    f, b = flops.group_norm_work((1, 128, 16, 16), 2, 128)
    n = 128 * 16 * 16
    assert (f, b) == (flops.GN_OPS_PER_ELEMENT * n, 2 * 2 * n + 8 * 128)
    assert flops.bound_s(989e12, 0.0) == pytest.approx(1.0)
    assert flops.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(989e12, 2 * 3.35e12) == pytest.approx(2.0)


def test_union_of_overlapping_intervals():
    spans = [(0.0, 2.0), (1.0, 3.0), (2.5, 2.7), (5.0, 6.0), (5.5, 5.6)]
    assert trace.merge(spans) == [(0.0, 3.0), (5.0, 6.0)]
    assert trace.union_seconds(spans) == pytest.approx(4.0)
    assert trace.clip(spans, 1.5, 5.2) == [(1.5, 2.0), (1.5, 3.0), (2.5, 2.7), (5.0, 5.2)]
    assert trace.gaps(trace.merge(spans), -1.0, 7.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 7.0)]


def test_trace_attributes_device_time_by_launch():
    # ops: (name, start, end, launch); "a" launched inside bench.unet runs after it closes,
    # "b" launched from another thread while bench.nudge is open, "c" outside every range
    ops = [("a", 1.5, 2.5, 0.9), ("b", 3.0, 3.5, 2.8), ("c", 6.0, 6.2, 5.9)]
    t = trace.Trace((0.0, 8.0), ops, {"bench.window": [(0.0, 8.0)],
                                      "bench.unet": [(0.5, 1.0)],
                                      "bench.nudge": [(2.6, 4.0), (4.5, 5.0)]})
    assert t.range_device_s("bench.unet") == pytest.approx(1.0)
    assert t.range_device_s("bench.nudge") == pytest.approx(0.5)
    assert t.range_count("bench.nudge") == 2
    assert t.busy_s() == pytest.approx(1.7)
    assert t.window_s == 8.0
    assert t.device_ops(2) == [["a", pytest.approx(1.0)], ["b", pytest.approx(0.5)]]
    # gaps (0, 1.5), (2.5, 3.0), (3.5, 6.0), (6.2, 8.0), labelled at their middles
    assert dict(t.idle_gaps()) == {"bench.nudge": pytest.approx(3.0),
                                   "host outside ranges": pytest.approx(1.8),
                                   "bench.unet": pytest.approx(1.5)}


def test_window_runs_whole_calls_past_its_length():
    now = [0.0]

    def call(i):
        now[0] += 3.0

    w = Window(10.0, clock=lambda: now[0])
    w.run(call)
    assert w.calls == 4  # 0-3, 3-6, 6-9, then 9-12: the call in flight at 10 s finishes
    assert w.elapsed == 12.0
    assert seconds_per_unit(w.elapsed, w.calls) == 3.0
    assert units_per_second(w.elapsed, w.calls * 400) == pytest.approx(400 / 3)
    with pytest.raises(ValueError):
        Window(0)


def test_rel_err_and_judge():
    want = torch.tensor([[3.0, 4.0], [1.0, 0.0]])
    got = torch.tensor([[3.0, 4.5], [1.0, 0.0]])
    assert compare.rel_err(got, want) == pytest.approx(0.1)
    assert math.isnan(compare.rel_err(got * float("nan"), want))
    checks = compare.judge({"a": 0.01, "b": float("nan"), "c": 9.0}, {"a": 0.02, "b": 1.0})
    assert checks["a"]["ok"] and not checks["b"]["ok"] and "c" not in checks
    assert not compare.all_ok(checks)
    with pytest.raises(ValueError):
        compare.judge({}, {"a": 1.0})


def test_seeded_weights_agree_across_dtypes_and_differ_across_seeds():
    def module(dtype):
        torch.manual_seed(0)
        m = torch.nn.Sequential(torch.nn.Conv2d(3, 8, 3), torch.nn.GroupNorm(2, 8),
                                torch.nn.Linear(8, 5), torch.nn.BatchNorm1d(5))
        return m.to(dtype)

    served, ref, other = module(torch.bfloat16), module(torch.float32), module(torch.bfloat16)
    weights.fill_seeded(served, 5, "m", torch.bfloat16, "cpu")
    weights.fill_seeded(ref, 5, "m", torch.bfloat16, "cpu")
    weights.fill_seeded(other, 6, "m", torch.bfloat16, "cpu")
    for (k, a), b, c in zip(served.state_dict().items(), ref.state_dict().values(),
                            other.state_dict().values()):
        assert torch.equal(a.float(), b.float()), k
        if k.endswith("num_batches_tracked"):
            assert int(a) == 0
        elif a.numel() > 1:
            assert not torch.equal(a, c), k
    conv = served.state_dict()["0.weight"].float()
    assert conv.std().item() == pytest.approx((3 * 27) ** -0.5, rel=0.3)
    assert served.state_dict()["1.weight"].float().mean().item() == pytest.approx(1.0, abs=0.1)
    assert (served.state_dict()["3.running_var"] > 0).all()


def test_every_cell_config_traffic_and_metric_loads_by_name():
    spec = C.load_spec()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for w in spec["workloads"]:
        cell = C.load_cell(w["name"], spec)
        assert cell.chips == w["chips"] == cell.workload["chips"]
        assert cell.config["name"] == w["config"]
        assert hasattr(C.traffic(cell.workload["kind"]), "Traffic")
        assert "setup_s" in [m["name"] for m in cell.end_to_end]
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.workload["limits"]), w["name"]
        for m in cell.end_to_end + cell.per_layer:
            assert callable(C.reader(m["name"]))
    for c in spec["configs"]:
        cfg = C.load_json("configs", c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        ref = reference_modules(cfg, "meta")
        assert sum(p.numel() for p in ref.unet.parameters()) > 1e8
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in [x["name"] for x in C.load_cell(w, spec).end_to_end]


def test_which_cells_report_a_metric():
    assert C.reports({"name": "setup_s"}, "x", [])
    assert C.reports({"name": "a", "workloads": ["x"]}, "x", [])
    assert not C.reports({"name": "a", "workloads": ["y"]}, "x", [])
    assert C.reports({"name": "p", "moves": "image_s"}, "x", ["image_s"])
    assert not C.reports({"name": "p", "moves": "image_s"}, "x", ["setup_s"])
