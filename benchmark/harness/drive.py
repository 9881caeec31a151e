"""What the traffic modules share: a request's seeded inputs, the call kept
for the check, the samples the check draws, the recording of the
program's guidance decodes, the device's synchronisation, and the FLOPs
of the reference modules' pieces at one sample."""

from __future__ import annotations

import numpy as np
import torch

from . import cell as C
from .flops import count_flops
from .models import reference_modules
from .weights import mix_seed


def latent_shape(cfg: dict, batch: int) -> tuple:
    u = cfg["unet"]
    return (batch, u["in_channels"], u["sample_size"], u["sample_size"])


def image_shape(cfg: dict, batch: int) -> tuple:
    """The shape of `batch` RGB images of the configuration's family."""
    size = C.family(cfg["family"]).image_size(cfg)
    return (batch, 3, size, size)


def check_sample(seed: int, tag: str, n: int, k: int) -> list:
    """k of range(n), sorted, drawn from the run's seed (all when k >= n)."""
    if k >= n:
        return list(range(n))
    rng = np.random.default_rng(mix_seed(seed, tag))
    return sorted(rng.choice(n, size=k, replace=False).tolist())


def per_step(entries: list, steps: int, rows: int):
    """Tensors recorded over `steps` steps, each step's calls concatenated
    along the batch; None unless they split into `steps` equal groups of
    `rows` rows each (a step that skipped or repeated a call)."""
    if not steps or not entries or len(entries) % steps or any(e is None for e in entries):
        return None
    calls = len(entries) // steps
    out = [torch.cat(entries[i * calls:(i + 1) * calls]) for i in range(steps)]
    return out if all(t.shape[0] == rows for t in out) else None


def record_with_grad(t: torch.Tensor, inputs: list, grads: list) -> None:
    """Keeps t and, when the backward reaches it, its gradient in the same
    position of `grads` (hooks of one backward fire in any order)."""
    inputs.append(t.detach())
    grads.append(None)
    k = len(grads) - 1
    t.register_hook(lambda g: grads.__setitem__(k, g))


class DecodeRecorder:
    """Wraps the decode closures the program's guidance calls: each call
    with a gradient keeps its input z and, when the backward reaches it,
    dL/dz; with `images`, also its output image and dL/dimage."""

    def __init__(self, images: bool = False):
        self.images = images
        self.dec_in, self.dec_grad, self.img, self.img_grad = [], [], [], []

    def wrap(self, decode):
        def recorded(z):
            if not z.requires_grad:
                return decode(z)
            record_with_grad(z, self.dec_in, self.dec_grad)
            out = decode(z)
            if self.images:
                record_with_grad(out, self.img, self.img_grad)
            return out
        return recorded


def request_generator(seed: int, call: int, device) -> torch.Generator:
    """The generator of request `call`'s inputs: the same seed and call give
    the same inputs on both sides."""
    return torch.Generator(device=device).manual_seed(mix_seed(seed, f"request-{call}"))


def sub_seeds(seed: int, call: int, n: int) -> list:
    """n seeds (each under 2**63) for request `call`."""
    return [mix_seed(seed, f"request-{call}-seed-{j}") for j in range(n)]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """Draws the one call whose outputs the check reads: before call i runs,
    `draw(i)` says whether it replaces the kept call, with probability
    1 / (i + 1), so that the kept call is drawn uniformly from the window's
    calls by a generator seeded from the run's seed, whatever their count.
    Only the calls drawn record what the check needs."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(mix_seed(seed, "reservoir"))
        self.kept = None

    def draw(self, call: int) -> bool:
        return bool(self.rng.random() * (call + 1) < 1.0)

    def keep(self, call: int, outputs) -> None:
        self.kept = (call, outputs)


class NudgeRecorder:
    """Keeps the state that each call of an attribute function's
    `apply_batched` (the guidance nudge, once a guided step) received and
    the state it returned."""

    def __init__(self):
        self.x_in, self.x_out = [], []

    def around(self, apply_batched, attr_func, xt, *args, **kwargs):
        x, z = apply_batched(attr_func, xt, *args, **kwargs)
        self.x_in.append(xt.detach())
        self.x_out.append(x.detach())
        return x, z


class EpsRecorder:
    """Keeps each call's state x and timestep t of a denoiser closure."""

    def __init__(self):
        self.x, self.t = [], []

    def wrap(self, eps_fn):
        def recorded(x, t):
            self.x.append(x.detach())
            self.t.append(t)
            return eps_fn(x, t)
        return recorded


def piece_flops(cfg: dict) -> dict:
    """FLOPs of one sample through each piece of the reference modules, on
    the meta device: `unet` (one denoiser call, no CFG pair), `encode`,
    `decode`, `decode_vjp` (decode and the gradient to its input) and, with a
    classifier, `clf_vjp` (its forward and the gradient to the image)."""
    ref = reference_modules(cfg, "meta")
    for m in ref.modules():
        m.eval().requires_grad_(False)
    meta = torch.device("meta")
    lat, img = latent_shape(cfg, 1), image_shape(cfg, 1)

    def vjp(fn, shape):
        def run():
            x = torch.zeros(shape, device=meta, requires_grad=True)
            # the module hooks of the FLOP counter take no leaf as a module's input
            torch.autograd.grad(fn(x * 1.0).float().sum(), x)
        return run

    out = {"unet": count_flops(lambda: ref.unet_once(torch.zeros(lat, device=meta),
                                                     torch.zeros(1, device=meta))),
           "encode": count_flops(lambda: ref.encode(torch.zeros(img, device=meta))),
           "decode": count_flops(lambda: ref.decode(torch.zeros(lat, device=meta))),
           "decode_vjp": count_flops(vjp(ref.decode, lat))}
    if ref.classifier is not None:
        out["clf_vjp"] = count_flops(vjp(ref.classifier, img))
    return out
