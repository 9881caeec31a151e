"""Seed traffic: one client generates a batch of images of one prompt at
several seeds, each call one `parallel.sweep.seed_sweep_generate` (every
seed's x_T drawn from its own generator on the device, all seeds as one
batch, DDIM at eta 0 with classifier-free guidance, no nudge) and the
decode of the batch's latents. The seeds come from the run's seed and the
call's index.

Parameters: steps, seeds (per call).

The check regenerates every seed's x_T, runs the float32 reference's DDIM
and decode over all of them, and compares the latents and the images.
"""

from __future__ import annotations

import torch

from ..harness import cell as C
from ..harness import compare
from ..harness.drive import Reservoir, latent_shape, piece_flops, sub_seeds, sync
from ..harness.models import build_reference
from ..harness.ranges import RangedEps
from ..reference import diffusion as R
from ..reference.precision import FP8Products


class Traffic:
    unit = "sample-step"

    def __init__(self, ctx):
        self.ctx, self.p = ctx, ctx.params
        self.latent = latent_shape(ctx.cell.config, 1)
        self.reservoir = Reservoir(ctx.seed)

    @property
    def units_per_call(self) -> int:
        return self.p["seeds"] * self.p["steps"]

    def _run(self, i: int, sched, ranged: bool):
        from diffusion_image_editing_tpu_torch.parallel import seed_sweep_generate

        w = self.ctx.program.wrapper
        eps_fn = w.eps_fn(w.prep_text(None))
        if ranged:
            eps_fn = RangedEps(eps_fn)
        lat = seed_sweep_generate(sched, eps_fn, self.latent,
                                  sub_seeds(self.ctx.seed, i, self.p["seeds"]),
                                  device=self.ctx.device).reshape((-1,) + self.latent[1:])
        return lat, w.decode(lat)

    def call(self, i: int, ranged: bool = False, timings=None, keep=None) -> None:
        """One call; `keep` (by default the reservoir's draw) keeps its
        outputs for the check."""
        keep = self.reservoir.draw(i) if keep is None else keep
        lat, imgs = self._run(i, self.ctx.program.wrapper.schedule, ranged)
        sync(self.ctx.device)
        if timings is not None:
            timings["guided_steps"] += self.p["steps"]
        if keep:
            self.reservoir.keep(i, (lat, imgs))

    def warm_up(self) -> None:
        """Two steps and the decode at the call's shapes."""
        self._run(0, self.ctx.program.wrapper.schedule.with_num_inference_steps(2), False)
        sync(self.ctx.device)

    def drop_program(self) -> None:
        pass

    def flops_per_call(self) -> float:
        cfg = self.ctx.cell.config
        f = piece_flops(cfg)
        rows = C.family(cfg["family"]).ROWS
        return self.p["seeds"] * (self.p["steps"] * rows * f["unet"] + f["decode"])

    def reference_run(self, ref, call: int):
        """The reference's DDIM from every seed's x_T, and the decode."""
        ctx, p = self.ctx, self.p
        s = R.make_schedule(ctx.cell.config["schedule"], p["steps"], ctx.device)
        xt = torch.cat([torch.randn(self.latent, device=ctx.device,
                                    generator=torch.Generator(device=ctx.device).manual_seed(n))
                        for n in sub_seeds(ctx.seed, call, p["seeds"])])

        def step(i, x, eps, t):
            return R.ddim_step(s, x, eps, t)

        lat = R.guided_loop(s, ref.eps_fn(), xt, s.timesteps, step, None, None, [0.0], range(0))
        with torch.no_grad():
            return lat, ref.decode(lat)

    def control_outputs(self, ref, call: int):
        """The control in the program's place: the reference with its
        products on float8 operands."""
        with FP8Products():
            return self.reference_run(ref, call)

    def check(self, call: int, out, ref=None) -> dict:
        ctx = self.ctx
        ref = ref or build_reference(ctx.cell.config, ctx.seed, ctx.device)
        lat, imgs = self.reference_run(ref, call)
        return {"latent": compare.rel_err(out[0], lat), "image": compare.rel_err(out[1], imgs)}
