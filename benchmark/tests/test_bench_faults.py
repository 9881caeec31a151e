"""The correctness check drives a whole run of each cell on the CPU (TINY
widths, float32 on both sides, the card's check skipped) and reads
`correct`: true for the program as it is, false with the timed path broken
underneath in each way the cell can be: a denoising step that returns its
state unchanged, half of the batch left out and the mean of the rest put
in its place, the answer altered where it is produced, and in the guided
cells the guidance gradient computed and then not applied, or taken
without its loss scale."""

import dataclasses
import time

import pytest
import torch

from benchmark import run
from benchmark.harness import cell as C
from benchmark.tests.bench_tiny import tiny_cell

CELLS = [w["name"] for w in C.load_spec()["workloads"]]
BATCHED = [c for c in CELLS if "edit8" in c or "sweep" in c or "seeds" in c]
GUIDED = [w["name"] for w in C.load_spec()["workloads"]
          if "attr" in C.load_json("workloads", w["name"])["params"]]
# the cells whose check holds the nudge as applied to the state (see PERF.md: in the
# others it lies below the float32 resolution of the state at the cell's size)
APPLIED = [c for c in GUIDED
           if any(k.startswith("applied") for k in C.load_json("workloads", c)["limits"])]


def _run(name):
    return run.run_cell(tiny_cell(name), 11, 0.01, False, torch.device("cpu"),
                        time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_step_returning_its_state_fails(name, monkeypatch):
    from diffusion_image_editing_tpu_torch.core import schedule as S

    for fn in ("ddim_step", "reverse_step"):
        real = getattr(S, fn)
        monkeypatch.setattr(S, fn, lambda s, x, *a, _real=real, **k: (x, _real(s, x, *a, **k)[1]))
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", BATCHED)
def test_half_batch_left_out_fails(name, monkeypatch):
    """Both in the denoiser and in the guidance, the second half of the
    batch takes the mean of the first half's result."""
    from diffusion_image_editing_tpu_torch.engine import denoise as D
    from diffusion_image_editing_tpu_torch.guidance import AttrFunc

    for cls in (D.EpsClosure, D.CfgEpsClosure):
        def half_eps(self, x, t, _real=cls.__call__):
            h = x.shape[0] // 2
            t = torch.as_tensor(t)
            eps = _real(self, x[:h], t[:h] if t.dim() else t)
            return torch.cat([eps, eps.mean(0, keepdim=True).expand((x.shape[0] - h,)
                                                                     + eps.shape[1:])])

        monkeypatch.setattr(cls, "__call__", half_eps)
    real_apply = AttrFunc.apply_batched

    def half_nudge(self, xt, zt, eps, t, step_idx, sched, decode_fn, mask=None, x0=None):
        b, h = xt.shape[0], xt.shape[0] // 2
        first = dataclasses.replace(self, **{f: getattr(self, f)[:h]
                                             for f in self.swept_fields(b)})
        x1, _ = real_apply(first, xt[:h], None, eps[:h], t, step_idx, sched, decode_fn)
        return torch.cat([x1, xt[h:] + (x1 - xt[:h]).mean(0, keepdim=True)]), zt

    monkeypatch.setattr(AttrFunc, "apply_batched", half_nudge)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_altered_answer_fails(name, monkeypatch):
    from diffusion_image_editing_tpu_torch.engine import edit as E
    from diffusion_image_editing_tpu_torch.parallel import sweep

    real = E.edit_split

    def altered(*args, **kwargs):
        res = real(*args, **kwargs)
        noise = torch.randn(res.x0.shape, generator=torch.Generator().manual_seed(0))
        return res._replace(x0=res.x0 + noise * res.x0.std())

    monkeypatch.setattr(E, "edit_split", altered)
    monkeypatch.setattr(sweep, "edit_split", altered)
    assert not _run(name)["correct"]


def _patch_nudge(monkeypatch, nudge):
    """The attribute functions' nudge replaced by `nudge(real, self, xt, zt, ...)`."""
    from diffusion_image_editing_tpu_torch.guidance import AttrFunc

    real = AttrFunc._nudge
    monkeypatch.setattr(AttrFunc, "_nudge", lambda self, xt, zt, *a, **k:
                        nudge(real, self, xt, zt, *a, **k))


@pytest.mark.parametrize("name", APPLIED)
def test_dropped_nudge_fails(name, monkeypatch):
    """The gradient is computed (decode, loss, backward) and then not applied."""
    def dropped(real, self, xt, zt, *args, **kwargs):
        real(self, xt, zt, *args, **kwargs)
        return xt, zt

    _patch_nudge(monkeypatch, dropped)
    assert not _run(name)["correct"]


@pytest.mark.parametrize("name", GUIDED)
def test_ignored_loss_scale_fails(name, monkeypatch):
    def unscaled(real, self, *args, **kwargs):
        return real(dataclasses.replace(self, loss_scale=1.0), *args, **kwargs)

    _patch_nudge(monkeypatch, unscaled)
    assert not _run(name)["correct"]
