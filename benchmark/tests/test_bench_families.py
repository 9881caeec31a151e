"""Model families as modules found by name: every cell keeps the FLOPs and
the seeded weights it had when the families were branches of the harness,
a family that the harness does not name runs as one module, and a family
with no module fails when its cell is loaded."""

import copy
import dataclasses
import hashlib
import sys
import time
import types

import pytest
import torch

from benchmark import run
from benchmark.harness import cell as C
from benchmark.harness import drive, models
from benchmark.harness.weights import fill_seeded, program_module
from benchmark.reference import configs as RC
from benchmark.reference import diffusion as R
from benchmark.reference import models as RM
from benchmark.tests.bench_tiny import tiny_cell

SEED = 2 ** 33 + 7

# Read from the harness before the families became modules: FLOPs of one
# sample through each piece at published widths, of a whole call of each cell
# (`flops_per_call`, which `mfu.*` divides), and sha256 of the TINY cells'
# seeded state dicts at SEED (see `_digest`).
PIECES = {
    "sd15-512": {"unet": 803273441280, "encode": 1116658466816, "decode": 2514518933504,
                 "decode_vjp": 5063397605376},
    "ldm-celebahq-256": {"unet": 202400063488, "encode": 345237430272,
                         "decode": 670782529536, "decode_vjp": 1375723470848,
                         "clf_vjp": 21353857024},
}
PINNED = {
    "sd15-512.edit": (334690832220160,
                      "a02e10a67fcee2ed992431b66272e397a739657ea81b33bdcc9c1ad3fc9d9e1e",
                      "512856bbd05123f1ecd44f5201606bb8c2fcd1d18775f27e0e61ccfe27b0dccb"),
    "ldm-celebahq-256.clf-edit8": (
        728879141617664, "02ef50a84dd70e33cf7b495f2f515fbcd0ce9b755094f02aded5758463cce53f",
        "1c05da6744a65ded150e428fb38d1628fa35b615f07782051712594d770dfbc1"),
    "sd15-512.seeds8": (662734904492032,
                        "a02e10a67fcee2ed992431b66272e397a739657ea81b33bdcc9c1ad3fc9d9e1e",
                        "512856bbd05123f1ecd44f5201606bb8c2fcd1d18775f27e0e61ccfe27b0dccb"),
}
CPU = torch.device("cpu")


def _digest(named) -> str:
    """sha256 over (name, dtype, shape, bytes) of each tensor in order."""
    h = hashlib.sha256()
    for name, t in named:
        t = t.detach().cpu().contiguous()
        h.update(f"{name}|{t.dtype}|{tuple(t.shape)}|".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _state(prefix: str, m: torch.nn.Module) -> list:
    return [(f"{prefix}.{k}", v) for k, v in sorted(m.state_dict().items())]


def _program_state(prog: models.Program) -> list:
    named = []
    for k, v in sorted(vars(prog.wrapper).items()):
        if isinstance(v, torch.nn.Module):
            named += _state(k, v)
    text = prog.wrapper.prep_text(None)
    if text is not None:
        named.append(("text", text))
    if prog.classifier is not None:
        named += _state("classifier", prog.classifier)
    return named


def _reference_state(ref: models.Reference) -> list:
    named = []
    for k in ("unet", "codec", "classifier"):
        if getattr(ref, k) is not None:
            named += _state(k, getattr(ref, k))
    if getattr(ref, "text", None) is not None:
        named.append(("text", ref.text))
    return named


@pytest.mark.parametrize("name", sorted(PINNED))
def test_a_cell_keeps_its_flops_and_seeded_weights(name, monkeypatch):
    cell = C.load_cell(name)
    pieces = []

    def recorded(cfg):
        pieces.append(drive.piece_flops(cfg))
        return pieces[-1]

    traffic = C.traffic(cell.workload["kind"])
    monkeypatch.setattr(traffic, "piece_flops", recorded)
    ctx = types.SimpleNamespace(cell=cell, seed=SEED, device=CPU,
                                params=cell.workload["params"], program=None)
    flops, program, reference = PINNED[name]
    assert traffic.Traffic(ctx).flops_per_call() == flops
    assert pieces == [PIECES[cell.config["name"]]]

    tiny = tiny_cell(name)
    prog = models.build_program(tiny.config, SEED, CPU, tiny.workload["params"]["steps"])
    assert _digest(_program_state(prog)) == program
    assert _digest(_reference_state(models.build_reference(tiny.config, SEED, CPU))) == reference


# ---- a family the harness does not name: pixel-space DDPM, one module -----

TOY = "toy_pixel"


@dataclasses.dataclass
class PixelReference(models.Reference):
    def encode(self, img):
        return img

    def decode(self, z):
        return z

    def eps_fn(self):
        return R.plain_eps(self.unet)

    def unet_once(self, x, t):
        return self.unet(x, t)


def _toy_family() -> types.ModuleType:
    from diffusion_image_editing_tpu_torch import models as M
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import DDPM

    def build_program(cfg, seed, device, steps):
        ucfg = M.UNet2DConfig(**models.tuples(cfg["unet"]))
        unet = program_module(lambda d: M.UNet2D(ucfg, device=d, dtype=models.serve_dtype(cfg)),
                              device)
        fill_seeded(unet, seed, "unet", models.serve_dtype(cfg), device)
        return models.Program(DDPM(unet, schedule_for_model("ddpm", steps, clip_sample=False),
                                   device=device))

    def reference_modules(cfg, device):
        with torch.device(device):
            unet = RM.TorchUNet2D(RC.UNet2DConfig.from_dict(cfg["unet"]), attn_naming="modern")
        return PixelReference(unet, None, 1.0)

    mod = types.ModuleType(f"benchmark.families.{TOY}")
    mod.__dict__.update(ROWS=1, image_size=lambda cfg: cfg["unet"]["sample_size"],
                        build_program=build_program, reference_modules=reference_modules,
                        tiny=lambda: dict(unet=models.config_dict(M.TINY_UNET2D)))
    return mod


def test_a_family_is_one_module(monkeypatch):
    """A pixel-space family (the port's DDPM wrapper over the TINY UNet2D,
    the identity codec, plain eps) registered as `benchmark.families.<name>`
    runs a TINY edit cell correctly, with no harness file naming it."""
    from diffusion_image_editing_tpu_torch.core.presets import SCHEDULE_PRESETS

    monkeypatch.setitem(sys.modules, f"benchmark.families.{TOY}", _toy_family())
    cell = tiny_cell("sd15-512.edit")
    schedule = {k: v for k, v in SCHEDULE_PRESETS["ddpm"].items() if k != "clip_sample"}
    cell.config = dict(name="toy-pixel-16", family=TOY, dtype="float32",
                       unet=C.family(TOY).tiny()["unet"], schedule=schedule)
    r = run.run_cell(cell, 11, 0.01, False, CPU, time.perf_counter())
    assert r["correct"], r["checks"]
    assert set(r["checks"]) == set(cell.workload["limits"])
    f = drive.piece_flops(cell.config)
    assert f["unet"] > 0 and f["encode"] == f["decode"] == f["decode_vjp"] == 0


def test_a_family_without_a_module_fails_at_load(monkeypatch):
    real = C.load_json

    def load_json(kind, name):
        out = copy.deepcopy(real(kind, name))
        if kind == "configs":
            out["family"] = "no_such_family"
        return out

    monkeypatch.setattr(C, "load_json", load_json)
    with pytest.raises(ValueError, match="benchmark/families/no_such_family.py"):
        C.load_cell("sd15-512.edit")
