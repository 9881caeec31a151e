"""Sweep traffic: one client runs a grid of guidance scales over one seeded
latent as one batch, each call one `parallel.sweep.guided_edit_sweep` (the
latent repeated once a grid point, DDIM at eta 0 with classifier-free
guidance, each step's nudge taken per sample at its own scale through the
decoder's VJP) and the decode of every point's final latent. The latent
comes from the run's seed and the call's index; a user picks an edit's
strength from the grid.

Parameters: steps, loss_scales (the grid, one point a sample), "attr" (the
colour attribute function: target, color_idx, t1, t2, and vjp_chunk, the
samples whose decoder VJP runs as one), check_points, check_steps.

The check takes one call of the window, drawn from the seed before the
window, at `check_points` grid points of non-zero scale drawn from the seed,
and the float32 reference:
- `move`: at the last step and `check_steps` - 1 others drawn from the
  seed, the program's move from the state its denoiser received to the
  next (after the last, the final latent) against the reference's one step
  from the same state (its UNet, CFG included, its update and its nudge at
  the point's scale), per point over those steps;
- `image`: each point's decoded image against the reference's decode of
  the same final latent;
- `applied`: at those steps, the nudge the program applied (the state its
  attribute function returned minus the state it received) against the
  reference's -dL/dx a^2 at the same state and eps, per point, over the
  elements where the reference's nudge reaches `RESOLVE` float32 steps of
  the state (`applied_share`: their share).
Every number follows the program from its own state, a step at a time.
"""

from __future__ import annotations

import math

import torch

from ..harness import cell as C
from ..harness import compare
from ..harness.drive import (NudgeRecorder, Reservoir, check_sample, latent_shape, piece_flops,
                             request_generator, sync)
from ..harness.models import build_reference
from ..harness.ranges import RangedEps, ranged_attr, wrapped_attr
from ..reference import diffusion as R
from ..reference.precision import FP8Products
from .edit import RESOLVE


class EpsIO:
    """Keeps each call's state x and its eps of a denoiser closure."""

    def __init__(self):
        self.x, self.eps = [], []

    def wrap(self, eps_fn):
        def recorded(x, t):
            eps = eps_fn(x, t)
            self.x.append(x.detach())
            self.eps.append(eps.detach())
            return eps
        return recorded


class Traffic:
    unit = "sample-step"

    def __init__(self, ctx):
        self.ctx, self.p = ctx, ctx.params
        self.scales = [float(s) for s in self.p["loss_scales"]]
        self.latent = latent_shape(ctx.cell.config, 1)
        self.reservoir = Reservoir(ctx.seed)
        if ctx.program is not None:
            from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
            from diffusion_image_editing_tpu_torch.parallel import sweep_attr_func

            a = dict(self.p["attr"])
            if a.pop("kind") != "colour":
                raise ValueError("the sweep traffic takes the colour attribute function")
            self.attr = sweep_attr_func(SingleColorAttrFunc(**a), loss_scale=self.scales)

    @property
    def units_per_call(self) -> int:
        return len(self.scales) * self.p["steps"]

    def inputs(self, call: int) -> torch.Tensor:
        dev = self.ctx.device
        return torch.randn(self.latent, generator=request_generator(self.ctx.seed, call, dev),
                           device=dev)

    def _run(self, call: int, sched, eps_wrap=None, attr=None):
        from diffusion_image_editing_tpu_torch.parallel import guided_edit_sweep

        w = self.ctx.program.wrapper
        eps_fn = w.eps_fn(w.prep_text(None))
        if eps_wrap is not None:
            eps_fn = eps_wrap(eps_fn)
        lat = guided_edit_sweep(sched, eps_fn, self.inputs(call), attr or self.attr,
                                decode_fn=w.decode_fn())
        lat = lat.reshape((-1,) + self.latent[1:])
        return lat, w.decode(lat)

    def call(self, i: int, ranged: bool = False, timings=None, keep=None) -> None:
        """One call; `keep` (by default the reservoir's draw) records what
        the check reads and keeps it."""
        keep = self.reservoir.draw(i) if keep is None else keep
        attr = ranged_attr(self.attr) if ranged else self.attr
        io, nudges = EpsIO(), NudgeRecorder()
        if keep:
            attr = wrapped_attr(attr, nudges.around)

        def eps_wrap(fn):
            fn = io.wrap(fn) if keep else fn
            return RangedEps(fn) if ranged else fn

        lat, imgs = self._run(i, self.ctx.program.wrapper.schedule, eps_wrap, attr)
        sync(self.ctx.device)
        if timings is not None:
            timings["guided_steps"] += self.p["steps"]
        if keep:
            self.reservoir.keep(i, dict(x=io.x, eps=io.eps, x_in=nudges.x_in,
                                        x_out=nudges.x_out, lat=lat, imgs=imgs))

    def warm_up(self) -> None:
        """Two guided steps and the decodes at the call's shapes."""
        self._run(0, self.ctx.program.wrapper.schedule.with_num_inference_steps(2))
        sync(self.ctx.device)

    def drop_program(self) -> None:
        self.attr = None

    def flops_per_call(self) -> float:
        cfg, p = self.ctx.cell.config, self.p
        f = piece_flops(cfg)
        rows = C.family(cfg["family"]).ROWS
        a = p["attr"]
        nudged = len(range(p["steps"])[a["t1"]:a["t2"]])
        guided = sum(1 for s in self.scales if s)
        return (len(self.scales) * (p["steps"] * rows * f["unet"] + f["decode"])
                + guided * nudged * f["decode_vjp"])

    # ---- the check --------------------------------------------------------

    def points(self) -> list:
        """The grid points the check reads: `check_points` of those with a
        non-zero scale, drawn from the seed."""
        guided = [j for j, s in enumerate(self.scales) if s]
        return [guided[k] for k in check_sample(self.ctx.seed, "check-points", len(guided),
                                                self.p.get("check_points", 4))]

    def _reference(self, ref):
        s = R.make_schedule(self.ctx.cell.config["schedule"], self.p["steps"], self.ctx.device)
        a = self.p["attr"]

        def loss(d):
            return R.colour_loss(d, a["target"], a["color_idx"])

        return s, ref.eps_fn(), loss, range(a["t1"], a["t2"])

    def control_outputs(self, ref, call: int) -> dict:
        """The control in the program's place: the reference's guided loop at
        every grid point, its products, forward and backward, on float8
        operands, in the form of a kept call's outputs (the points the check
        does not read are the program's own scales too, so they are run)."""
        rec = {k: [] for k in ("eps", "px0", "x_in", "x_out", "dec_in", "dec_grad")}
        with FP8Products() as mode:
            s, eps_fn, loss, window = self._reference(ref)
            io = EpsIO()
            x = self.inputs(call).repeat(len(self.scales), 1, 1, 1)
            lat = R.guided_loop(s, io.wrap(eps_fn), x, s.timesteps,
                                lambda i, x, e, t: R.ddim_step(s, x, e, t), ref.decode, loss,
                                self.scales, window, rec)
            with torch.no_grad():
                imgs = ref.decode(lat)
        return dict(x=io.x, eps=io.eps, x_in=rec["x_in"], x_out=rec["x_out"], lat=lat,
                    imgs=imgs, fp8_calls=dict(mode.calls))

    def check(self, call: int, out: dict, ref=None) -> dict:
        """The numbers compared, for call `call`'s outputs `out`."""
        ctx, p = self.ctx, self.p
        ref = ref or build_reference(ctx.cell.config, ctx.seed, ctx.device)
        s, eps_fn, loss, window = self._reference(ref)
        ts, n = s.timesteps, p["steps"]
        rows = self.points()
        scales = [self.scales[j] for j in rows]
        if len(out["x"]) != n or len(out["eps"]) != n:
            return {"move": math.inf, "image": math.inf, "applied": math.inf,
                    "applied_share": 0.0}
        last = n - 1
        steps = check_sample(ctx.seed, "check-steps", last, p.get("check_steps", 10) - 1) + [last]

        def state(i):
            return (out["x"][i + 1] if i < last else out["lat"])[rows].float()

        got, exp = [], []
        for i in steps:
            x = out["x"][i][rows].float()
            with torch.no_grad():
                e = eps_fn(x, ts[i])
            x1 = R.ddim_step(s, x, e, ts[i])
            if i in window:
                a = R.alpha_bar(s, ts[i], x1)
                g = R.loss_grad(ref.decode, loss, R.pred_x0(s, x1, e, ts[i]), scales)
                x1 = x1 - g / torch.sqrt(a) * a ** 2
            got.append(state(i) - x)
            exp.append(x1 - x)
        nums = {"move": compare.rel_err(torch.stack(got, 1), torch.stack(exp, 1))}
        with torch.no_grad():
            nums["image"] = compare.rel_err(out["imgs"][rows], ref.decode(out["lat"][rows].float()))
        nums.update(self._applied(ref, s, ts, out, loss, scales, rows,
                                  [i for i in steps if i in window]))
        return nums

    def _applied(self, ref, s, ts, out: dict, loss, scales, rows, nudged) -> dict:
        """`applied` and `applied_share` (see the module's docstring) at the
        steps `nudged`; infinite when the attribute function was not called
        once a step."""
        n = self.p["steps"]
        if len(out["x_in"]) != n or len(out["x_out"]) != n or not nudged:
            return {"applied": math.inf, "applied_share": 0.0}
        got, want, counted = [], [], []
        for i in nudged:
            x, y = out["x_in"][i][rows], out["x_out"][i][rows]
            a = R.alpha_bar(s, ts[i], x)
            z = R.pred_x0(s, x.float(), out["eps"][i][rows].float(), ts[i])
            step = RESOLVE * (torch.nextafter(y.abs(), torch.full_like(y, math.inf))
                              - y.abs()).float()
            got.append(y.double() - x.double())
            nudge = -R.loss_grad(ref.decode, loss, z, scales) / torch.sqrt(a) * a ** 2
            want.append(nudge)
            counted.append(nudge.abs() >= step)
        mask = torch.stack(counted, 1)
        return {"applied": compare.rel_err(torch.stack(got, 1), torch.stack(want, 1), mask=mask),
                "applied_share": float(mask.float().mean())}
