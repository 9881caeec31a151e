"""Edit traffic: one client edits seeded real images back to back, each call
one `EditPipeline.prepare_real_image_edit` (encode, then DDIM or
edit-friendly DDPM inversion) and one `EditPipeline.edit_image` (the
guided loop, a gradient through the decoder each step, then the final
decode). A call's batch of images comes from the run's seed and the call's
index; uniform noise in [-1, 1] stands in for photographs.

Parameters (the workload file's "params"): batch, steps, inversion ("ddim"
| "ddpm"), eta, inversion_mode, chunk, t_skip, edit_mode, check_steps, and
"attr": the attribute function ("colour": target, color_idx;
"classifier": idx_for_class, idx_of_interest) with loss_scale, t1, t2 and
vjp_chunk.

The check takes one call of the window, drawn from the seed before the
window (only that call records what the check reads), and the float32
reference from the same inputs:
- `zs`: edit-friendly inversion's noise maps from t_skip on, per sample
  over all steps; for DDIM inversion, `invert`: at the last inversion
  step and `check_steps` - 1 others drawn from the seed, the program's move
  from the state a step starts from (as its denoiser received it) to the
  next, against the reference's one step from the same state, per sample;
  and `xt`, the reference's whole inversion's x_T against the program's,
  per sample;
- `move`: at the last guided step and `check_steps` - 1 others drawn from
  the seed, the program's move from its own state to its next (the state
  before step i is sqrt(a) pred_x0_i + sqrt(1 - a) eps_i, from what
  `edit_image` returns; after the last, the latent of the final decode,
  which the benchmark's wrapper keeps) against the reference's one step
  from the same state (its UNet, CFG included, its update and its nudge),
  per sample over those steps;
- `image`: the edited image against the reference's decode of the same
  final latent;
- `applied`: at those of the steps that nudge, the nudge the program
  applied (the state its attribute function returned minus the state it
  received) against the reference's -dL/dx a^2 at the same state and eps
  (decode, loss with its target, channel and scale, the gradient back
  through the decoder), per sample; only the elements where the
  reference's nudge is at least RESOLVE float32 steps of the state count,
  since the program adds a nudge to a float32 state that rounds it
  (`applied_share`: the share of the elements that count);
  `applied_staged`, the same against the reference's stages taken at the
  program's own intermediate points: the loss's gradient at the decoded
  image the program made, back through the reference's decoder at the
  same state (a random classifier's gradient changes much with a small
  change of its input image, which `applied` would read);
- `decoder_vjp`, the decoder's VJP at the program's decoder input z of the
  program's own dL/dimage (the decoder alone); `loss_grad`, dL/dimage at
  the program's decoded image (the loss alone: the classifier in a
  classifier cell). These four are infinite when a step skipped or
  repeated a decode. A cell's limits name the numbers it compares; the rest are
  reported beside them.

Every number but `zs` and `xt` follows the program from its own state, a
step or a stage at a time: with random weights, rounding grows along a
whole edit until free runs of two precisions part by as much as the
control.
"""

from __future__ import annotations

import collections
import contextlib
import math
import time

import torch

from ..harness import cell as C
from ..harness import compare
from ..harness.drive import (DecodeRecorder, EpsRecorder, NudgeRecorder, Reservoir,
                             check_sample, image_shape, latent_shape, per_step, piece_flops,
                             request_generator, sync)
from ..harness.models import build_reference
from ..harness.ranges import ranged_attr, ranged_eps, wrapped_attr, wrapped_eps
from ..reference import diffusion as R
from ..reference.precision import FP8Products
from ..reference.resnet import classifier_input

RESOLVE = 32  # float32 steps of the state that a nudge element must reach to count in `applied`
STAGED = ("applied", "applied_staged", "decoder_vjp", "loss_grad")  # read from the decodes


@contextlib.contextmanager
def recorded_decodes(wrapper, recorder: DecodeRecorder, finals: list):
    """Inside the block, the guidance's decode closures record (see
    `DecodeRecorder`) and the final decode keeps its latent in `finals`."""
    decode_fn, decode = wrapper.decode_fn, wrapper.decode

    def final_decode(latent):
        finals.append(latent.detach())
        return decode(latent)

    wrapper.decode_fn = lambda *args, **kwargs: recorder.wrap(decode_fn(*args, **kwargs))
    wrapper.decode = final_decode
    try:
        yield
    finally:
        del wrapper.decode_fn, wrapper.decode


class Traffic:
    unit = "image"

    def __init__(self, ctx):
        self.ctx, self.p = ctx, ctx.params
        p, cfg = self.p, ctx.cell.config
        self.guided = p["steps"] - (p.get("t_skip") or 0)
        self.latent = latent_shape(cfg, p["batch"])
        self.image = image_shape(cfg, p["batch"])
        self.reservoir = Reservoir(ctx.seed)
        if ctx.program is not None:
            from diffusion_image_editing_tpu_torch.guidance import (ClassifierAttrFunc,
                                                                    SingleColorAttrFunc)
            from diffusion_image_editing_tpu_torch.pipeline import EditPipeline

            self.pipe = EditPipeline(ctx.program.wrapper)
            a = dict(p["attr"])
            kind = a.pop("kind")
            if kind == "colour":
                self.attr = SingleColorAttrFunc(**a)
            elif kind == "classifier":
                self.attr = ClassifierAttrFunc(clf_apply_fn=ctx.program.clf_apply_fn, **a)
            else:
                raise ValueError(f"unknown attribute function {kind!r}")

    @property
    def units_per_call(self) -> int:
        return self.p["batch"]

    def inputs(self, call: int):
        p, dev = self.p, self.ctx.device
        gen = request_generator(self.ctx.seed, call, dev)
        img = torch.rand(self.image, generator=gen, device=dev) * 2 - 1
        noise = None
        if p["inversion"] == "ddpm":
            noise = torch.randn((p["steps"],) + self.latent, generator=gen, device=dev)
        return img, noise

    def call(self, i: int, ranged: bool = False, timings=None, keep=None) -> None:
        """One call; `keep` (by default the reservoir's draw) records what
        the check reads and keeps it."""
        keep = self.reservoir.draw(i) if keep is None else keep
        p, dev = self.p, self.ctx.device
        img, noise = self.inputs(i)
        attr = ranged_attr(self.attr) if ranged else self.attr
        w = self.pipe.diffusion_wrapper
        with contextlib.ExitStack() as scope:
            if keep:
                rec, finals = DecodeRecorder(images=True), []
                nudges, inv = NudgeRecorder(), EpsRecorder()
                attr = wrapped_attr(attr, nudges.around)
                scope.enter_context(recorded_decodes(w, rec, finals))
            if ranged:
                scope.enter_context(ranged_eps(w))
            t0 = time.perf_counter()
            with wrapped_eps(w, inv.wrap) if keep else contextlib.nullcontext():
                xt, zs, xts, _, _ = self.pipe.prepare_real_image_edit(
                    img, eta=p["eta"], inversion_method=p["inversion"],
                    mode=p.get("inversion_mode"), t_skip=p.get("t_skip"),
                    chunk=p.get("chunk", 10), noise=noise)
            if timings is not None:
                sync(dev)
                t1 = time.perf_counter()
                timings["invert_s"].append(t1 - t0)
            out = self.pipe.edit_image(
                xt, eta=p["eta"], zs=zs, xts=xts, attr_func=attr, inversion_method=p["inversion"],
                t_skip=p.get("t_skip"), mode=p["edit_mode"])
            sync(dev)
        if timings is not None:
            timings["edit_s"].append(time.perf_counter() - t1)
            timings["guided_steps"] += self.guided
        if keep:
            self.reservoir.keep(i, dict(xt=xt, zs=zs, imgs=out.imgs, x0=finals,
                                        px0=out.pred_original_samples, eps=out.model_outputs,
                                        x_in=nudges.x_in, x_out=nudges.x_out, inv_x=inv.x,
                                        dec_in=rec.dec_in, dec_grad=rec.dec_grad, img=rec.img,
                                        img_grad=rec.img_grad))

    def warm_up(self) -> None:
        self.call(0, keep=False)

    def drop_program(self) -> None:
        self.pipe = self.attr = None

    def flops_per_call(self) -> float:
        cfg, p = self.ctx.cell.config, self.p
        f = piece_flops(cfg)
        pair = C.family(cfg["family"]).ROWS
        inverted = self.guided if p["inversion"] == "ddpm" else p["steps"]
        per_step = pair * f["unet"] + f["decode_vjp"] + f.get("clf_vjp", 0.0)
        return p["batch"] * (f["encode"] + inverted * pair * f["unet"] + self.guided * per_step
                             + f["decode"])

    # ---- the check --------------------------------------------------------

    def _reference(self, ref):
        """(schedule, eps_fn, loss, scales, window) of the reference."""
        s = R.make_schedule(self.ctx.cell.config["schedule"], self.p["steps"], self.ctx.device)
        eps_fn = ref.eps_fn()
        a = self.p["attr"]
        if a["kind"] == "colour":
            def loss(d):
                return R.colour_loss(d, a["target"], a["color_idx"])
        else:
            def loss(d):
                logits = ref.classifier(classifier_input(d)).float().reshape(-1, 40, 2)
                return logits[:, a["idx_for_class"], a["idx_of_interest"]]
        return s, eps_fn, loss, [float(a["loss_scale"])] * self.p["batch"], range(a["t1"], a["t2"])

    def _invert(self, ref, s, eps_fn, call: int, record: list = None) -> dict:
        """The reference's inversion of call `call`'s images: "zs" (noise maps,
        zero before t_skip) and the trajectory "xts", or "xt" (`record`
        keeps the state each DDIM inversion step starts from)."""
        p = self.p
        img, noise = self.inputs(call)
        t_skip = p.get("t_skip") or 0
        with torch.no_grad():
            lat = ref.encode(img)
            if p["inversion"] == "ddpm":
                xts = R.sample_xts(s, lat, noise)
                zs = R.ddpm_extract(s, eps_fn, xts, t_skip, p["eta"], p.get("chunk", 10))
                return {"zs": torch.cat([zs.new_zeros((t_skip,) + tuple(zs.shape[1:])), zs]),
                        "xts": xts}
            return {"xt": R.ddim_invert(s, eps_fn, lat, record)}

    def _step(self, s, zs):
        p, t_skip = self.p, self.p.get("t_skip") or 0
        if p["inversion"] == "ddpm" and p.get("t_skip") is not None:
            return lambda i, x, eps, t: R.reverse_step(s, x, eps, t, p["eta"], zs[t_skip + i])
        return lambda i, x, eps, t: R.ddim_step(s, x, eps, t)

    def control_outputs(self, ref, call: int) -> dict:
        """The control in the program's place: the reference's whole pipeline
        with its products, forward and backward, on float8 operands, its
        outputs in the form of a kept call's."""
        rec, dec, inv = collections.defaultdict(list), DecodeRecorder(images=True), []
        with FP8Products() as mode:
            s, eps_fn, loss, scales, window = self._reference(ref)
            out = self._invert(ref, s, eps_fn, call, inv)
            x = out["xt"] if "xt" in out else out["xts"][self.p.get("t_skip") or 0]
            x0 = R.guided_loop(s, eps_fn, x, s.timesteps[-self.guided:],
                               self._step(s, out.get("zs")), dec.wrap(ref.decode), loss, scales,
                               window, rec)
            with torch.no_grad():
                out["imgs"] = ref.decode(x0)
        out.update(x0=[x0.detach()], eps=torch.stack(rec["eps"]), px0=torch.stack(rec["px0"]),
                   x_in=rec["x_in"], x_out=rec["x_out"], inv_x=inv, dec_in=dec.dec_in,
                   dec_grad=dec.dec_grad, img=dec.img, img_grad=dec.img_grad,
                   fp8_calls=dict(mode.calls))
        return out

    def check(self, call: int, out: dict, ref=None) -> dict:
        """The numbers compared, for call `call`'s outputs `out`."""
        ctx, p = self.ctx, self.p
        ref = ref or build_reference(ctx.cell.config, ctx.seed, ctx.device)
        s, eps_fn, loss, scales, window = self._reference(ref)
        want = self._invert(ref, s, eps_fn, call)
        nums = {}
        t_skip = p.get("t_skip") or 0
        if "zs" in want:
            nums["zs"] = compare.rel_err(out["zs"][t_skip:].transpose(0, 1),
                                         want["zs"][t_skip:].transpose(0, 1))
        else:
            nums["xt"] = compare.rel_err(out["xt"], want["xt"])
            nums["invert"] = self._invert_moves(s, eps_fn, out)
        ts = s.timesteps[-self.guided:]
        step = self._step(s, out.get("zs"))

        def state(i):
            a = R.alpha_bar(s, ts[i], out["px0"][i])
            return torch.sqrt(a) * out["px0"][i] + torch.sqrt(1.0 - a) * out["eps"][i]

        def one_step(i, x):
            """The reference's step i from state x: eps, the update, the nudge."""
            with torch.no_grad():
                e = eps_fn(x, ts[i])
            x1 = step(i, x, e, ts[i])
            if i in window:
                a = R.alpha_bar(s, ts[i], x1)
                g = R.loss_grad(ref.decode, loss, R.pred_x0(s, x1, e, ts[i]), scales)
                x1 = x1 - g / torch.sqrt(a) * a ** 2
            return x1

        if len(out["x0"]) != 1:
            return dict(nums, move=math.inf, image=math.inf)  # no single final decode
        last = self.guided - 1
        steps = check_sample(ctx.seed, "check-steps", last, p.get("check_steps", 10) - 1) + [last]
        got, exp = [], []
        for i in steps:
            x = state(i)
            got.append((state(i + 1) if i < last else out["x0"][0]) - x)
            exp.append(one_step(i, x) - x)
        nums["move"] = compare.rel_err(torch.stack(got, 1), torch.stack(exp, 1))
        with torch.no_grad():
            nums["image"] = compare.rel_err(out["imgs"], ref.decode(out["x0"][0]))
        nudged = [i for i in steps if i in window]
        if nudged:
            order = [i for i in range(self.guided) if i in window]  # the steps that decode
            rec = {k: per_step(out[k], len(order), p["batch"])
                   for k in ("dec_in", "dec_grad", "img", "img_grad")}
            if any(v is None for v in rec.values()):  # a step skipped or repeated a decode
                return dict(nums, **dict.fromkeys(STAGED, math.inf))
            nums.update(self._applied(ref, s, ts, out, loss, scales, nudged,
                                      [rec["img"][order.index(i)] for i in nudged]))
            nums.update(self._stages(ref, rec, loss, scales, [order.index(i) for i in nudged]))
        return nums

    def _invert_moves(self, s, eps_fn, out: dict) -> float:
        """`invert`: the program's DDIM inversion steps from the states its
        denoiser received, against the reference's steps from the same
        states; infinite when the program ran another number of steps."""
        ts, xs = s.timesteps[::-1], out["inv_x"]
        n = len(ts)
        if len(xs) != n:
            return math.inf
        ks = check_sample(self.ctx.seed, "invert-steps", n - 1,
                          self.p.get("check_steps", 10) - 1) + [n - 1]
        got, exp = [], []
        for k in ks:
            x = xs[k].float()
            with torch.no_grad():
                e = eps_fn(x, ts[k])
            got.append((xs[k + 1] if k < n - 1 else out["xt"]).float() - x)
            exp.append(R.next_step(s, x, e, ts[k]) - x)
        return compare.rel_err(torch.stack(got, 1), torch.stack(exp, 1))

    def _applied(self, ref, s, ts, out: dict, loss, scales, nudged: list, imgs: list) -> dict:
        """`applied`, `applied_staged` and `applied_share` (see the module's
        docstring) at the steps `nudged`, whose decoded images the program
        made are `imgs`; the numbers are infinite when the attribute
        function was not called once a guided step."""
        if len(out["x_in"]) != self.guided or len(out["x_out"]) != self.guided:
            return {"applied": math.inf, "applied_staged": math.inf, "applied_share": 0.0}
        got, whole, staged, counted, counted_staged = [], [], [], [], []
        for i, img in zip(nudged, imgs):
            x, y = out["x_in"][i], out["x_out"][i]
            a = R.alpha_bar(s, ts[i], x)
            z = R.pred_x0(s, x.float(), out["eps"][i].float(), ts[i])
            step = RESOLVE * (torch.nextafter(y.abs(), torch.full_like(y, math.inf))
                              - y.abs()).float()
            got.append(y.double() - x.double())
            n = -R.loss_grad(ref.decode, loss, z, scales) / torch.sqrt(a) * a ** 2
            whole.append(n)
            counted.append(n.abs() >= step)
            g = R.loss_grad(lambda d: d, loss, img.float(), scales)
            n = -R.vjp(ref.decode, z, g) / torch.sqrt(a) * a ** 2
            staged.append(n)
            counted_staged.append(n.abs() >= step)
        got = torch.stack(got, 1)
        mask, mask_staged = torch.stack(counted, 1), torch.stack(counted_staged, 1)
        return {"applied": compare.rel_err(got, torch.stack(whole, 1), mask=mask),
                "applied_staged": compare.rel_err(got, torch.stack(staged, 1), mask=mask_staged),
                "applied_share": float(mask.float().mean())}

    def _stages(self, ref, rec: dict, loss, scales, nudged: list) -> dict:
        """At the program's own decoder inputs z and decoded images (`rec`,
        by decode): `decoder_vjp`, the decoder's VJP at z of the program's
        own dL/dimage (the decoder alone); `loss_grad`, dL/dimage (the loss
        alone, the classifier in a classifier cell)."""
        z, g, img, gi = (rec[k] for k in ("dec_in", "dec_grad", "img", "img_grad"))

        def err(got, exp):
            return compare.rel_err(torch.stack(got, 1), torch.stack(exp, 1))

        return {
            "decoder_vjp": err([g[k] for k in nudged],
                               [R.vjp(ref.decode, z[k].float(), gi[k].float()) for k in nudged]),
            "loss_grad": err([gi[k] for k in nudged],
                             [R.loss_grad(lambda d: d, loss, img[k].float(), scales)
                              for k in nudged]),
        }
