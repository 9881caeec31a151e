"""Each cell's control, the float32 reference in the program's place with
every matrix product and convolution, forward and backward, on float8
operands, comes out not correct: at the cell's own size on the card (one
seed; `readings.py` reads more), and through a whole run of the harness
at TINY widths on the CPU. The control rounds the backward's products
too."""

import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import run
from benchmark.harness import cell as C
from benchmark.readings import control_run
from benchmark.reference.precision import FP8Products
from benchmark.tests.bench_tiny import tiny_cell

CELLS = [w["name"] for w in C.load_spec()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = control_run(C.load_cell(name), 2027, torch.device("cuda", 0))
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_control_fails_the_check(name):
    cell = tiny_cell(name)
    assert run.run_cell(cell, 11, 0.01, False, torch.device("cpu"),
                        time.perf_counter())["correct"]
    assert not control_run(cell, 11, torch.device("cpu"))["correct"]


def test_control_rounds_backward_products():
    torch.manual_seed(0)
    x = torch.randn(2, 4, 8, 8, requires_grad=True)
    w, m = torch.randn(4, 4, 3, 3), torch.randn(64, 16)

    def grad():
        y = F.conv2d(x, w, padding=1).flatten(2) @ m
        return torch.autograd.grad((y ** 2).sum(), x)[0]

    plain = grad()
    mode = FP8Products()
    with mode:
        rounded = grad()
    assert mode.calls["convolution_backward"] == 1 and mode.calls["convolution"] == 1
    assert mode.calls["mm"] >= 2  # the product and its input gradient
    assert 1e-3 < float((rounded - plain).norm() / plain.norm()) < 0.5
