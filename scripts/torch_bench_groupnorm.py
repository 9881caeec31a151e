"""Time the GroupNorm kernels (K4, or K5 + K6) at every GroupNorm shape of one
`chip_smoke.py` `[main]` run, weighted by its launches.

    python3 scripts/torch_bench_groupnorm.py [--parent REV] [--only 1x128x512x512]
                                             [--variant DIR[:DEFINE+DEFINE]] [--cluster 1,2,4,8]
                                             [--fused-limit BYTES]

Needs one CUDA GPU and nvcc. Builds chip_smoke.py's SD-1.5 UNet and SD VAE
(bf16, seeded random weights), runs one CFG UNet call at batch 2 (the
guided steps'), one at batch 20 (the batched inversion's, chunk
`chip_smoke.CHUNK`), one decode with its latent gradient and one encode
with the port's `group_norm` wrapped to record each call's (shape, groups,
eps, activation), and weighs each piece by its calls in a `[main]` run
(`chip_smoke.GUIDED` guided UNet calls, the inversion's UNET_CALLS - GUIDED,
`chip_smoke.DECODES` decodes, `chip_smoke.ENCODES` encodes; the decode's
gradient runs GroupNorm's backward in torch ops, no kernel). At each
distinct call it holds the kernels the route takes
(`ops.groupnorm.uses_fused_kernel`: K4 alone, or K5 then K6) against their
plain versions (`chip_smoke.GN_TOL`, `MEAN_TOL`, `RSTD_TOL`), checks that a
second call gives the same bits, and times each kernel alone with
`chip_smoke.time_ms` (CUDA events over 10 calls queued behind a sleep
kernel), and K5 then K6 as the path runs them. Each time is printed beside
the bytes bound (x read once, the output written once; K5 reads x alone)
and the launch floor, the time of one empty kernel (`torch.cuda._sleep(0)`)
measured the same way. The `[sum]` lines are each kernel's launch-weighted
sums of ms and of bound ms for one `[main]` run; the `[library]` lines, at
the VAE's (1, 128, 512, 512) and at the largest K5 shape, the time of
`torch.var_mean` over the groups, the one PyTorch call that computes K5's
statistics.

`--parent REV` also builds the GroupNorm sources (`group_norm_*.cu` and
the headers) of git revision REV into the ignored build directory
(`ops/.build/parent-REV/`) and times that revision's kernels in the same
call, in turns (parent, kernel, kernel, parent), after the same checks, on
that revision's route (K4 up to 96 KiB slabs: where K4 now takes a larger
slab, the parent's K5 and K6 are timed there instead); the last `[sum]`
line adds every kernel of each route.
Outside a git checkout (a copy made for the card) the sources are taken
from where an earlier run in the git checkout put them: run it once here
first. A library's C entry point is called by the parameter names of its
`extern "C"` declaration, so the parent's K5 (a scratch buffer, no cluster
size) and this one take the same inputs.

`--variant DIR[:DEFINES]` (repeatable) builds `DIR/group_norm_stats.cu`
and `DIR/group_norm_fused.cu` (those that exist) with the `+`-separated
`-D` defines and times each beside its kernel at each shape, unchecked:
for knock-out copies of the source, which compute something else by
design; each is also checked, and its errors printed beside its time
(not failed). `--only S[,S...]` keeps the shapes whose label (`NxCxHxW`,
and a batch tag such as `b20`) holds one of the S. `--cluster K[,K...]`
also times K4 and K5 with the cluster size that
`ops/groupnorm.py::stats_cluster_blocks` or `fused_cluster_blocks` would
choose forced to each K (where no piece is left empty, nor a K4 piece
above `FUSED_MAX_PIECE_BYTES`). `--fused-limit B`
also times K4 (checked) at each K5 + K6 shape whose slab has at most B
bytes, as if `ops/groupnorm.py::FUSED_MAX_SLAB_BYTES` were B, and sums
both routes over those shapes: the reading for the route limit.

Prints the card's name and power limit first; exits non-zero if a kernel
disagrees with its plain version or a rerun differs.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffusion_image_editing_tpu_torch.models import layers  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import _build  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import groupnorm as GN  # noqa: E402
from torch_bench_build import build_library, c_params, parent_sources  # noqa: E402

SOURCES = ("group_norm_fused", "group_norm_stats", "group_norm_apply")
VARIANT_SOURCES = ("group_norm_fused", "group_norm_stats")
PARENT_STATS_CHUNK = 16384  # the scratch of K5's first design: (mean, M2) per 16384 elements
PARENT_FUSED_MAX_SLAB_BYTES = 96 * 1024  # the first design's route: K4 up to 96 KiB slabs
# Calls of each piece in one [main] run (chip_smoke.path_launches).
INVERSION_CALLS = chip_smoke.UNET_CALLS - chip_smoke.GUIDED
WEIGHTS = {"eps": chip_smoke.GUIDED, "eps_b20": INVERSION_CALLS, "decode": chip_smoke.DECODES,
           "encode": chip_smoke.ENCODES}


def pieces(sd, dev) -> dict:
    """chip_smoke.forward_pieces, and one UNet call of the batched inversion
    (CHUNK latents, CFG: batch 2 * CHUNK)."""
    out = chip_smoke.forward_pieces(sd, dev)
    cfg = sd.vae.config
    lat = cfg.sample_size // 2 ** (len(cfg.block_out_channels) - 1)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((chip_smoke.CHUNK, 4, lat, lat),
                                             dtype=np.float32)).to(dev)
    t = np.full(chip_smoke.CHUNK, 501)
    out["eps_b20"] = lambda: sd.eps_fn(sd.prep_text(None))(x, t)
    return out


def record_calls(fns) -> Counter:
    """(shape, groups, eps, act) -> calls in one [main] run."""
    calls: Counter = Counter()
    original = layers.group_norm
    piece = ""

    def recording(x, scale, bias, num_groups=32, eps=1e-6, act="silu"):
        calls[(tuple(x.shape), int(num_groups), float(eps), act)] += WEIGHTS[piece]
        return original(x, scale, bias, num_groups, eps, act)

    layers.group_norm = recording
    try:
        for piece, fn in fns.items():
            fn()
        torch.cuda.synchronize()
    finally:
        layers.group_norm = original
    return calls


class Library:
    """One kernel source built with the port's flags (and `-D` defines),
    called by the parameter names of its C entry point."""

    def __init__(self, src: Path, name: str, defines=()):
        self.params = c_params(src, name)[0]
        self.fn = build_library(src, name, defines)

    def __call__(self, values: dict) -> None:
        rc = self.fn(*(values[p] for p in self.params))
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError_t {rc}")


RULES = {"group_norm_stats": ("stats_cluster_blocks", "stats_atom"),
         "group_norm_fused": ("fused_cluster_blocks", "fused_atom")}


def cluster_of(name: str, shape, groups) -> int:
    return getattr(GN, RULES[name][0])(shape, groups) if name in RULES else 1


def time_forced(name: str, kernel, shape, groups, sizes) -> dict:
    """{k: ms} of `kernel` with `name`'s cluster size forced to each k of
    `sizes` that leaves no piece empty (nor, for K4, above its most)."""
    rule, atom_of = RULES[name]
    chosen, out = getattr(GN, rule), {}
    atom = getattr(GN, atom_of)(shape, groups)
    atoms = GN.slab_bytes(shape, groups) // 2 // atom
    most = GN.FUSED_MAX_PIECE_BYTES if name == "group_norm_fused" else float("inf")
    try:
        for k in sizes:
            if k <= atoms and -(-atoms // k) * atom * 2 <= most:
                setattr(GN, rule, lambda *_, k=k: k)
                out[k] = chip_smoke.time_ms(kernel)
    finally:
        setattr(GN, rule, chosen)
    return out


class Case:
    """One GroupNorm call's inputs and the outputs of a kernel call, as the
    C entry points name them."""

    def __init__(self, shape, groups, eps, act, gen, dev):
        self.shape, self.groups, self.eps, self.act = shape, groups, eps, act
        n, c, h, w = shape
        self.x = chip_smoke._randn(shape, gen, dev)
        self.scale = (1 + 0.2 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        self.bias = (0.2 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        self.out = torch.empty_like(self.x)
        self.mean = torch.empty((n, groups), dtype=torch.float32, device=dev)
        self.rstd = torch.empty_like(self.mean)
        chunks = -(-(c // groups * h * w) // PARENT_STATS_CHUNK)
        self.partial = torch.empty(2 * n * groups * chunks, dtype=torch.float32, device=dev)

    def values(self, name: str) -> dict:
        n, c, h, w = self.shape
        return {"device": self.x.device.index, "x": self.x.data_ptr(),
                "scale": self.scale.data_ptr(), "bias": self.bias.data_ptr(), "affine_f32": 0,
                "out": self.out.data_ptr(), "mean": self.mean.data_ptr(),
                "rstd": self.rstd.data_ptr(), "partial": self.partial.data_ptr(),
                "scratch_floats": self.partial.numel(), "N": n, "C": c, "HW": h * w,
                "G": self.groups, "eps": self.eps, "act": GN.ACTS.index(self.act), "out_m2": 0,
                "cluster": cluster_of(name, self.shape, self.groups),
                "stream": torch.cuda.current_stream(self.x.device).cuda_stream}

    def run(self, lib: Library, name: str):
        """One launch; returns copies of its outputs."""
        lib(self.values(name))
        if name == "group_norm_stats":
            return self.mean.clone(), self.rstd.clone()
        return self.out.clone(), self.mean.clone(), self.rstd.clone()


def check(got, ref_mean, ref_rstd, ref_out) -> tuple:
    """(ok, description) of a kernel's outputs against the plain version's."""
    *out, mean, rstd = got
    mean_err = ((mean - ref_mean).abs() / (ref_mean.abs() + 1)).max().item()
    rstd_err = ((rstd - ref_rstd).abs() / ref_rstd).max().item()
    ok = mean_err <= chip_smoke.MEAN_TOL and rstd_err <= chip_smoke.RSTD_TOL
    text = f"mean {mean_err:.1e} rstd {rstd_err:.1e}"
    if out:
        rel = ((out[0].float() - ref_out.float()).abs().max() / ref_out.float().abs().max()).item()
        ok = ok and rel <= chip_smoke.GN_TOL and math.isfinite(rel)
        text += f" out {rel:.1e}"
    return ok, text


def in_turns(kernel, parent) -> tuple:
    """(kernel ms, parent ms): parent, kernel, kernel, parent, averaged."""
    if parent is None:
        return chip_smoke.time_ms(kernel), None
    p = [chip_smoke.time_ms(parent)]
    k = [chip_smoke.time_ms(kernel), chip_smoke.time_ms(kernel)]
    p.append(chip_smoke.time_ms(parent))
    return sum(k) / 2, sum(p) / 2


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", help="also build and time the kernels of this git revision")
    parser.add_argument("--only", default="",
                        help="time only the shapes whose label holds one of these (comma-separated)")
    parser.add_argument("--variant", action="append", default=[],
                        help="DIR[:DEFINE+DEFINE]: also time this unchecked build of K4 and K5")
    parser.add_argument("--fused-limit", type=int, default=0,
                        help="also time K4 at K5 + K6 shapes whose slab has at most these bytes")
    parser.add_argument("--cluster", default="",
                        help="K[,K...]: also time K4 and K5 with their cluster size forced to each K")
    opts = parser.parse_args()
    sizes = [int(k) for k in opts.cluster.split(",") if k]
    parent_dir = parent_sources(opts.parent, SOURCES) if opts.parent else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}", flush=True)
    dev = torch.device("cuda")
    _build.build()  # all eight: the models' forwards run the attention kernels too
    for name in SOURCES:
        for line in _build.ptxas_report(name).splitlines():
            print(f"[build] kernel/{name} {line}")
    parent = ({s: Library(parent_dir / f"{s}.cu", s) for s in SOURCES} if parent_dir else None)
    variants = {}
    for spec in opts.variant:
        src, _, defines = spec.partition(":")
        defines = defines.split("+") if defines else []
        variants[spec] = {s: Library((ROOT / src).resolve() / f"{s}.cu", s, defines)
                          for s in VARIANT_SOURCES if ((ROOT / src) / f"{s}.cu").exists()}

    unet, vae = chip_smoke.build_models(dev)
    sd, _, _ = chip_smoke.make_pipeline(unet, vae, dev)
    calls = record_calls(pieces(sd, dev))
    del sd, unet, vae
    torch.cuda.empty_cache()
    floor = chip_smoke.time_ms(lambda: torch.cuda._sleep(0))
    print(f"[floor] one empty kernel (torch.cuda._sleep(0)) {floor:.4f} ms; on {smi}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    sums = {name: {"launches": 0, "ms": 0.0, "bound": 0.0, "parent_launches": 0, "parent": 0.0}
            for name in SOURCES}
    pair = {"ms": 0.0, "parent": 0.0}  # K5 then K6, as the path runs them
    moved = {"k4": 0.0, "pair": 0.0}  # the shapes --fused-limit would move to K4
    failed, largest = [], None
    for (shape, groups, eps, act), n in sorted(calls.items(), key=lambda kv: -kv[1]):
        label = "x".join(map(str, shape)) + f" b{shape[0]}"
        if not any(only in label for only in opts.only.split(",")):
            continue
        case = Case(shape, groups, eps, act, gen, dev)
        x, scale, bias = case.x, case.scale, case.bias
        nx = 2.0 * x.numel()  # bytes of x
        stats = 8.0 * shape[0] * groups  # the (N, G) f32 mean and rstd
        fused = GN.uses_fused_kernel(shape, groups)
        parent_fused = GN.slab_bytes(shape, groups) <= PARENT_FUSED_MAX_SLAB_BYTES
        lines = []
        with torch.no_grad():
            ref_mean, ref_rstd = GN.group_norm_moments(x, groups, eps)
            ref_out = GN.group_norm_reference(x, scale, bias, groups, eps, act)
            if fused:
                kernels = {"group_norm_fused": (
                    lambda: GN.group_norm_fused(x, scale, bias, groups, eps, act),
                    chip_smoke.bound_ms(10.0 * x.numel(), 2 * nx + 4 * shape[1] + stats,
                                        chip_smoke.PEAK_F32_FLOPS)[0])}
            else:
                mean, rstd = GN.group_norm_stats(x, groups, eps)
                kernels = {
                    "group_norm_stats": (lambda: GN.group_norm_stats(x, groups, eps),
                                         chip_smoke.bound_ms(3.0 * x.numel(), nx + stats,
                                                             chip_smoke.PEAK_F32_FLOPS)[0]),
                    "group_norm_apply": (
                        lambda: GN.group_norm_apply(x, mean, rstd, scale, bias, act),
                        chip_smoke.bound_ms(7.0 * x.numel(), 2 * nx + 4 * shape[1] + stats,
                                            chip_smoke.PEAK_F32_FLOPS)[0])}
                if largest is None or x.numel() > largest.numel():
                    largest = x
            for name, (kernel, bound) in kernels.items():
                got, again = kernel(), kernel()
                got = got if isinstance(got, tuple) else (got, mean, rstd)
                again = again if isinstance(again, tuple) else (again, mean, rstd)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                ok, text = check(got, ref_mean, ref_rstd, ref_out)
                par = None
                if parent is not None and (name == "group_norm_fused") == parent_fused:
                    if name == "group_norm_apply":  # the parent's K6 on this K5's statistics
                        def par(name=name):
                            values = case.values(name)
                            values.update(mean=mean.data_ptr(), rstd=rstd.data_ptr())
                            parent[name](values)
                    else:
                        p_ok, p_text = check(case.run(parent[name], name), ref_mean, ref_rstd,
                                             ref_out)
                        ok, text = ok and p_ok, f"{text} (parent {p_text})"
                        par = lambda name=name: parent[name](case.values(name))  # noqa: E731
                ms, p_ms = in_turns(kernel, par)
                v_ms = {}
                for spec, libs in variants.items():
                    if name in libs:
                        _, v_text = check(case.run(libs[name], name), ref_mean, ref_rstd, ref_out)
                        v_ms[f"{spec} ({v_text})"] = chip_smoke.time_ms(
                            lambda lib=libs[name]: lib(case.values(name)))
                forced = (time_forced(name, kernel, shape, groups, sizes)
                          if name in RULES else {})
                s = sums[name]
                s["launches"] += n
                s["ms"] += n * ms
                s["bound"] += n * bound
                if p_ms is not None:
                    s["parent_launches"] += n
                    s["parent"] += n * p_ms
                lines.append(f"{name} {ms:.4f} ms" + (f" (parent {p_ms:.4f})" if p_ms else "")
                             + f", bound {bound:.4f}, k {cluster_of(name, shape, groups)}, "
                             f"{text}, rerun bit-equal {same} {'ok' if ok and same else 'FAIL'}"
                             + "".join(f"; k={k} {t:.4f}" for k, t in forced.items())
                             + "".join(f"; variant {spec} {t:.4f}" for spec, t in v_ms.items()))
                if not (ok and same):
                    failed.append(f"{label} {name}")
            if parent is not None and fused and not parent_fused:  # a slab K4 took from K5 + K6
                p_ok, p_text = check(case.run(parent["group_norm_stats"], "group_norm_stats"),
                                     ref_mean, ref_rstd, ref_out)
                p_ms = {name: chip_smoke.time_ms(lambda name=name: parent[name](case.values(name)))
                        for name in ("group_norm_stats", "group_norm_apply")}
                for name, t in p_ms.items():
                    sums[name]["parent_launches"] += n
                    sums[name]["parent"] += n * t
                lines.append(f"the parent's route: K5 {p_ms['group_norm_stats']:.4f} ms ({p_text}"
                             f"{'' if p_ok else ' FAIL'}), K6 {p_ms['group_norm_apply']:.4f} ms")
                if not p_ok:
                    failed.append(f"{label} parent K5")
            if not fused:
                two = lambda: GN.group_norm_apply(  # noqa: E731
                    x, *GN.group_norm_stats(x, groups, eps), scale, bias, act)
                p_two = None
                if parent is not None:
                    def p_two():
                        values = case.values("group_norm_stats")
                        parent["group_norm_stats"](values)
                        parent["group_norm_apply"](values)
                ms, p_ms = in_turns(two, p_two)
                pair["ms"] += n * ms
                pair["parent"] += n * (p_ms or 0.0)
                lines.append(f"K5 then K6 {ms:.4f} ms" + (f" (parent {p_ms:.4f})" if p_ms else ""))
                if GN.slab_bytes(shape, groups) <= opts.fused_limit:
                    limit, GN.FUSED_MAX_SLAB_BYTES = GN.FUSED_MAX_SLAB_BYTES, opts.fused_limit
                    try:
                        k4 = lambda: GN.group_norm_fused(x, scale, bias, groups, eps, act)  # noqa
                        k4_ok, k4_text = check(k4(), ref_mean, ref_rstd, ref_out)
                        k4_ms = chip_smoke.time_ms(k4)
                    finally:
                        GN.FUSED_MAX_SLAB_BYTES = limit
                    moved["k4"] += n * k4_ms
                    moved["pair"] += n * ms
                    lines.append(f"K4 here {k4_ms:.4f} ms (k {GN.fused_cluster_blocks(shape, groups)}"
                                 f", {k4_text} {'ok' if k4_ok else 'FAIL'})")
                    if not k4_ok:
                        failed.append(f"{label} K4 here")
        print(f"[shape] {label} groups {groups} act {act}: {n} launches a run, floor "
              f"{floor:.4f} ms; " + "; ".join(lines), flush=True)
        del case, x, ref_out
        torch.cuda.empty_cache()
    for name, s in sums.items():
        print(f"[sum] {name}: {s['launches']} launches a [main] run, {s['ms']:.2f} ms, bound "
              f"{s['bound']:.2f} ms, gap {s['ms'] - s['bound']:.2f} ms"
              + (f"; parent {s['parent_launches']} launches, {s['parent']:.2f} ms" if parent
                 else "") + f"; on {smi}", flush=True)
    if parent:
        print(f"[sum] every GroupNorm forward of a [main] run: "
              f"{sum(s['ms'] for s in sums.values()):.2f} ms, parent "
              f"{sum(s['parent'] for s in sums.values()):.2f} ms; on {smi}", flush=True)
    print(f"[sum] K5 then K6 as the path runs them: {pair['ms']:.2f} ms"
          + (f" (parent {pair['parent']:.2f})" if parent else "") + f"; on {smi}", flush=True)
    if opts.fused_limit > GN.FUSED_MAX_SLAB_BYTES:
        print(f"[sum] slabs of {GN.FUSED_MAX_SLAB_BYTES} to {opts.fused_limit} bytes: K4 "
              f"{moved['k4']:.2f} ms against K5 then K6 {moved['pair']:.2f} ms; on {smi}", flush=True)
    vae_shape = dict(chip_smoke.GN_CASES)["vae 512x512x128 b1"]
    if any(only in "x".join(map(str, vae_shape)) + " b1" for only in opts.only.split(",")):
        for x in [chip_smoke._randn(vae_shape, gen, dev)] + ([largest] if largest is not None
                                                             else []):
            view = x.view(x.shape[0], chip_smoke.GN_GROUPS, -1)
            with torch.no_grad():
                lib_ms = chip_smoke.time_ms(lambda: torch.var_mean(view, dim=-1, correction=0))
                st_ms = chip_smoke.time_ms(lambda: GN.group_norm_stats(
                    x, chip_smoke.GN_GROUPS, chip_smoke.GN_EPS))
            print(f"[library] {tuple(x.shape)}: torch.var_mean over the groups {lib_ms:.4f} ms, "
                  f"K5 {st_ms:.4f} ms; on {smi}", flush=True)
    if failed:
        print(f"[FAIL] {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
