"""Build and time K1 (flash-attention forward), or K3 (`--bwd`) or K2 (`--dq`) of the backward.

    python3 scripts/torch_bench_attention.py [--bwd | --dq] [--parent REV [--e2e]]
                                             [--only "self 64x64"] [--variant DIR[:DEFINE+DEFINE]]

Needs one CUDA GPU and nvcc. Builds `ops/csrc/flash_attn_fwd.cu` only
(seconds), prints what ptxas used for each design (registers, spills, shared
memory) and any C75xx line (ptxas serializing wgmma, or ignoring
`setmaxnreg`), then at every forward
attention shape of the SD-1.5 512 px path (UNet self-attention at 4096,
1024, 256 and 64 tokens with head dims 40, 80, 160 at batch 2, the 77-token
cross-attention at each width, all of them again at the batched
inversion's batch 20, and the VAE's single 512-wide head) holds the kernel
against its plain version (`chip_smoke.FWD_TOL`, and the log-sum-exp within
`chip_smoke.LSE_TOL` of `torch.logsumexp`) and prints its milliseconds
beside `scaled_dot_product_attention`'s and three bounds: tensor-core
operations, bytes, and exponentials at 16 a clock an SM at the card's
highest SM clock. The same at the LDM UNet's heads of 32 (1024, 256 and
64 tokens), at every self- and cross-attention of `[sweep]`'s batch-16 CFG
UNet, and at the split shapes of `chip_smoke.FWD_CASES`. Times are
`chip_smoke.time_ms`'s (CUDA events over 10 calls queued behind a sleep
kernel). The `[path]` lines weigh each shape by its launches in one run of
`chip_smoke.py`'s `[main]`, one of its `[ldm_clf]` and one pass of its
`[sweep]`.

`--parent REV` also builds `flash_attn_fwd.cu` and the headers of git
revision REV into the ignored build directory and times that kernel in the
same call, in turns (parent, kernel, kernel, parent). Where the checkout is
no git repository (a copy made for the card), the sources are taken from
where an earlier run in the git checkout put them
(`ops/.build/parent-REV/`). With `--e2e` it then builds chip_smoke.py's
SD-1.5 models and times its `[main]` path (inversion, 40 guided steps,
decode) with the parent's K1 and with this one, in turns, on the host
clock around work that ends in a synchronise.

`--variant DIR[:DEFINES]` (repeatable) builds `DIR/flash_attn_fwd.cu` with
the `+`-separated `-D` defines and times it beside the kernel at each
shape, printing its errors but failing nothing: for copies of the source
that try another design, and knock-out copies (an exponential made an
FMA, a product dropped), which compute something else by design.

`--bwd` builds `flash_attn_bwd_dkv.cu` (K3) and `flash_attn_bwd_dq.cu`
(K2) instead, and takes K1 from its own build for the forward's lse. At
each backward shape (the VAE's 512-wide head at 4096 tokens, 40 launches
a `[main]` run; the DDPM UNet's at 256 tokens; a ragged 512-wide shape
whose query and key counts differ and fill no tile; the narrow
`chip_smoke.BWD_CASES` shape at head dim 80) it holds K3 (and the
parent's) against `attention_bwd_dkv_reference` on the same lse and delta
within `chip_smoke.GRAD_TOL` (max |kernel - plain| / max |plain|, dK and
dV each), checks that a second call is bit-equal, and prints K3's
milliseconds beside the parent's, the operations bound (8 * Sq * Sk * D a
head) and the SDPA backward (dQ, dK and dV). `--parent`, `--variant` and
`--e2e` act on K3 as they do on K1.

`--dq` does the same for K2 (`flash_attn_bwd_dq.cu`): it builds K2 and K1
(and K3, for `--e2e`), holds K2 (and the parent's) against
`attention_bwd_dq_reference` at the same four shapes, checks that a second
call is bit-equal, and prints K2's milliseconds beside the parent's, the
operations bound (6 * Sq * Sk * D a head) and the SDPA backward.
`--parent`, `--variant` and `--e2e` act on K2.

Prints the card's name and power limit first; exits non-zero if a shape
disagrees.
"""

from __future__ import annotations

import argparse
import math
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import _build  # noqa: E402
from diffusion_image_editing_tpu_torch.ops import attention as A  # noqa: E402
from torch_bench_build import build_library, parent_sources, print_ptxas  # noqa: E402

KERNEL = "flash_attn_fwd"  # the kernel under test: K3 with --bwd, K2 with --dq
SMS, EXP_PER_CLOCK = 132, 16  # H100 SXM: SMs, and the special-function unit's ex2 an SM a clock
# The workloads whose K1 launches the [path] lines weigh: chip_smoke's [main]
# run, its [ldm_clf] run and one pass of its [sweep].
PATHS = ("main", "ldm_clf", "sweep")
# (label, q shape, kv shape, {workload: launches in one run}). An SD UNet
# call runs 5 transformers at 64, 32 and 16 px and 1 at 8 px, each one self-
# and one cross-attention: [main] makes 4 inversion calls at batch 20 and 40
# guided-step calls at batch 2, a [sweep] pass 50 calls at batch 16. An LDM
# UNet call runs 5 attentions at 32 px, 5 at 16 px and 6 at 8 px (heads of
# 32), [ldm_clf] 100 calls. The VAE's (or the VQ's) mid-block attention runs
# 42 / 52 / 400 times. The split shapes of chip_smoke.FWD_CASES ([spatial]'s
# ranks) are timed too, weighed by none of these.
SHAPES = []
for _b, _calls, _path in ((2, 40, "main"), (20, 4, "main"), (16, 50, "sweep")):
    for _px, _d, _n in ((64, 40, 5), (32, 80, 5), (16, 160, 5), (8, 160, 1)):
        _s = _px * _px
        SHAPES.append((f"self {_px}x{_px} b{_b}", (_b, _s, 8, _d), (_b, _s, 8, _d),
                       {_path: _calls * _n}))
        SHAPES.append((f"cross {_px}x{_px} b{_b}", (_b, _s, 8, _d), (_b, 77, 8, _d),
                       {_path: _calls * _n}))
for _px, _h, _n in ((32, 14, 5), (16, 21, 5), (8, 28, 6)):
    SHAPES.append((f"ldm self {_px}x{_px} b1", (1, _px * _px, _h, 32), (1, _px * _px, _h, 32),
                   {"ldm_clf": 100 * _n}))
SHAPES.append(("vae mid 64x64 b1", (1, 4096, 1, 512), (1, 4096, 1, 512),
               {"main": 42, "ldm_clf": 52, "sweep": 400}))
SHAPES += [(_label, _qs, _ks, {}) for _label, _qs, _ks in chip_smoke.FWD_CASES
           if _label.startswith("split")]
# K2's and K3's shapes: (label, q shape, kv shape, launches in one run of [main]).
BWD_SHAPES = [
    ("vae mid 64x64", (1, 4096, 1, 512), (1, 4096, 1, 512), 40),
    ("ddpm 16x16", (1, 256, 1, 512), (1, 256, 1, 512), 0),
    ("ragged 512", (1, 1000, 2, 512), (1, 777, 2, 512), 0),
    ("unet self 32x32", (2, 1024, 8, 80), (2, 1024, 8, 80), 0),
]


def build_kernel(src_dir: Path, defines=()):
    """`src_dir/KERNEL.cu` built with the port's flags, ptxas's report printed."""
    return build_library(src_dir / f"{KERNEL}.cu", KERNEL, defines, A._ARGTYPES[KERNEL])


def call_library(fn, q, k, v, scale, with_lse=False):
    """One launch of a built K1 library on q's device and current stream."""
    b, s_q, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b * h, s_q), dtype=torch.float32, device=q.device) if with_lse else None
    rc = fn(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, b, h, s_q, k.shape[1], d, float(scale),
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError_t {rc}")
    return out, lse


def reference(q, k, v, scale):
    """The plain version's output and the f32 log-sum-exp, one batch
    element at a time so the f32 logits stay a few GB."""
    outs, lses = [], []
    for i in range(q.shape[0]):
        qi, ki, vi = q[i:i + 1], k[i:i + 1], v[i:i + 1]
        outs.append(A.attention_reference(qi, ki, vi, scale))
        logits = torch.einsum("bqhd,bkhd->bhqk", qi.float(), ki.float()) * scale
        lses.append(torch.logsumexp(logits, dim=-1).reshape(qi.shape[2], qi.shape[1]))
        del logits
    return torch.cat(outs), torch.cat(lses)


def max_sm_clock_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    try:
        return float(smi.stdout.split()[0])
    except (IndexError, ValueError):
        return 1980.0  # the H100 SXM's highest boost clock


def bounds(qs, ks, clock_mhz):
    """(operations, bytes, exponentials) bounds in ms."""
    b, s_q, h, d = qs
    s_k = ks[1]
    ops = 4.0 * b * h * s_q * s_k * d / chip_smoke.PEAK_BF16_FLOPS
    nbytes = 2.0 * (2 * b * s_q * h * d + 2 * b * s_k * h * d) / chip_smoke.PEAK_BYTES
    exps = b * h * s_q * s_k / (SMS * EXP_PER_CLOCK * clock_mhz * 1e6)
    return ops * 1e3, nbytes * 1e3, exps * 1e3


def check(out, lse, ref, ref_lse):
    err = ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
    lse_err = (lse - ref_lse).abs().max().item()
    ok = err <= chip_smoke.FWD_TOL and lse_err <= chip_smoke.LSE_TOL and math.isfinite(err)
    return err, lse_err, ok


# The backward kernels: (name, tag of the output lines, wrapper, plain
# version, operations a head in units of Sq * Sk * D, names of the outputs).
BWD_KERNELS = {
    "flash_attn_bwd_dkv": ("K3", "[bwd]", A.flash_attn_bwd_dkv, A.attention_bwd_dkv_reference,
                           8, ("dk", "dv")),
    "flash_attn_bwd_dq": ("K2", "[dq]", A.flash_attn_bwd_dq, A.attention_bwd_dq_reference, 6,
                          ("dq",)),
}


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def call_bwd(fn, q, k, v, dout, lse, delta, scale):
    """One launch of a built K2 or K3 library on q's device and current
    stream; returns its outputs as a tuple."""
    b, s_q, h, d = q.shape
    outs = ((torch.empty_like(q),) if KERNEL == "flash_attn_bwd_dq"
            else (torch.empty_like(k), torch.empty_like(v)))
    rc = fn(q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), *(o.data_ptr() for o in outs), b, h, s_q,
            k.shape[1], d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: cudaError_t {rc}")
    return outs


def bwd_shapes(opts, parent, variants, smi) -> list:
    """K2 or K3 (and the parent's) at every BWD_SHAPES shape; returns the
    labels that failed their check."""
    name, tag, wrapper, plain, ops_factor, out_names = BWD_KERNELS[KERNEL]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed, total = [], {"kernel": 0.0, "parent": 0.0}
    for label, qs, ks, launches in BWD_SHAPES:
        if opts.only not in label:
            continue
        q, dout = chip_smoke._randn(qs, gen, dev), chip_smoke._randn(qs, gen, dev)
        k, v = chip_smoke._randn(ks, gen, dev), chip_smoke._randn(ks, gen, dev)
        scale = qs[3] ** -0.5
        with torch.no_grad():
            out, lse = A.flash_attn_fwd(q, k, v, scale, with_lse=True)
            delta = A.attention_delta(dout, out)
            args = (q, k, v, dout, lse, delta, scale)
            want = _as_tuple(plain(*args))

            def rel_errs(got):
                return " ".join(f"{n} {_rel(g, w):.3e}" for n, g, w in zip(out_names, got, want))

            def within(got):
                errs = [_rel(g, w) for g, w in zip(got, want)]
                return all(e <= chip_smoke.GRAD_TOL and math.isfinite(e) for e in errs)

            got = _as_tuple(wrapper(*args))
            same = all(torch.equal(a, b) for a, b in zip(got, _as_tuple(wrapper(*args))))
            ok = same and within(got)
            line = (f"{tag} {label} q{qs} kv{ks}: rel err {rel_errs(got)} "
                    f"(tol {chip_smoke.GRAD_TOL}), rerun bit-equal {same} "
                    f"{'ok' if ok else 'FAIL'}")
            if parent is not None:
                p_got = call_bwd(parent, *args)
                line += f" (parent {rel_errs(p_got)})"
                ok = ok and within(p_got)
                del p_got
            del want, got
            kernel = lambda: wrapper(*args)  # noqa: E731
            if parent is not None:
                par = lambda: call_bwd(parent, *args)  # noqa: E731
                p_ms = [chip_smoke.time_ms(par)]
                ms = [chip_smoke.time_ms(kernel), chip_smoke.time_ms(kernel)]
                p_ms.append(chip_smoke.time_ms(par))
                ms, p_ms = sum(ms) / 2, sum(p_ms) / 2
            else:
                ms, p_ms = chip_smoke.time_ms(kernel), None
            v_ms = {spec: chip_smoke.time_ms(lambda: call_bwd(fn, *args))
                    for spec, fn in variants.items()}
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves),
                                                 scale=scale)
        lib_dout = dout.transpose(1, 2)
        sdpa_ms = chip_smoke.time_ms(
            lambda: torch.autograd.grad(lib_out, leaves, lib_dout, retain_graph=True))
        b, s_q, h, d = qs
        b_ops = ops_factor * b * h * s_q * ks[1] * d / chip_smoke.PEAK_BF16_FLOPS * 1e3
        line += (f" | kernel {ms:.4f} ms"
                 + (f", parent {p_ms:.4f} ms (x{p_ms / ms:.2f})" if p_ms else "")
                 + f", sdpa backward (dq+dk+dv) {sdpa_ms:.4f} ms; bound ops {b_ops:.4f} ms; "
                 f"{launches} launches a run")
        print(line, flush=True)
        for spec, t in v_ms.items():
            print(f"[variant] {label} {spec}: {t:.4f} ms (kernel {ms:.4f})", flush=True)
        total["kernel"] += launches * ms
        total["parent"] += launches * (p_ms or 0.0)
        if not ok:
            failed.append(label)
        del q, k, v, dout, out, lse, delta, args, leaves, lib_out
        torch.cuda.empty_cache()
    print(f"[path] launch-weighted {name} device time of one [main] run: kernel "
          f"{total['kernel']:.2f} ms" + (f", parent {total['parent']:.2f} ms" if parent else "")
          + f"; on {smi}")
    return failed


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def e2e(parent, smi) -> None:
    """chip_smoke's [main] path with the parent's kernel and with this one,
    in turns (parent, kernel, kernel, parent) after a warm-up of each."""
    unet, vae = chip_smoke.build_models(torch.device("cuda"))
    _, pipe, img = chip_smoke.make_pipeline(unet, vae, torch.device("cuda"))
    kernel = _build.load(KERNEL, A._ARGTYPES[KERNEL])
    runs = {"parent": [], "kernel": []}
    for name in ("parent", "kernel", "parent", "kernel", "kernel", "parent"):
        _build._FNS[KERNEL] = parent if name == "parent" else kernel
        _, inv_s, edit_s = chip_smoke.run_path(pipe, img, torch.device("cuda"))
        runs[name].append((inv_s, edit_s))
    _build._FNS[KERNEL] = kernel
    for name, times in runs.items():
        for inv_s, edit_s in times[1:]:  # the first of each is its warm-up
            print(f"[e2e] {name}: e2e {inv_s + edit_s:.3f} s (inversion {inv_s:.3f} s, "
                  f"{chip_smoke.GUIDED} guided steps {edit_s:.3f} s); on {smi}", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    kind = parser.add_mutually_exclusive_group()
    kind.add_argument("--bwd", action="store_true",
                      help="K3 (the backward for dK and dV) in place of K1")
    kind.add_argument("--dq", action="store_true",
                      help="K2 (the backward for dQ) in place of K1")
    parser.add_argument("--parent", help="also build and time the kernel of this git revision")
    parser.add_argument("--e2e", action="store_true",
                        help="then time chip_smoke's [main] path with either kernel")
    parser.add_argument("--only", default="", help="time only the shapes whose label holds this")
    parser.add_argument("--variant", action="append", default=[],
                        help="DIR[:DEFINE+DEFINE]: also time this unchecked build of the kernel")
    opts = parser.parse_args()
    if opts.e2e and not opts.parent:
        parser.error("--e2e needs --parent")
    global KERNEL
    if opts.bwd:
        KERNEL = "flash_attn_bwd_dkv"
    elif opts.dq:
        KERNEL = "flash_attn_bwd_dq"
    parent_dir = parent_sources(opts.parent, [KERNEL]) if opts.parent else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    clock = max_sm_clock_mhz()
    print(f"[device] {smi}; highest SM clock {clock:.0f} MHz", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False

    t0 = time.perf_counter()
    built = ([KERNEL] + [n for n in ("flash_attn_fwd", *BWD_KERNELS) if n != KERNEL]
             if opts.bwd or opts.dq else [KERNEL])
    _build.build(built)
    print(f"[build] {', '.join(built)} in {time.perf_counter() - t0:.1f} s")
    print_ptxas(_build.library_path(KERNEL).with_suffix(".log"), "kernel")
    parent = build_kernel(parent_dir) if parent_dir else None
    variants = {}
    for spec in opts.variant:
        src, _, defines = spec.partition(":")
        defines = defines.split("+") if defines else []
        variants[spec] = build_kernel((ROOT / src).resolve(), defines)

    if opts.bwd or opts.dq:
        failed = bwd_shapes(opts, parent, variants, smi)
        if opts.e2e:
            e2e(parent, smi)
        if failed:
            print(f"[FAIL] {failed}")
            return 1
        return 0

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    failed = []
    total = {path: {"kernel": 0.0, "parent": 0.0, "sdpa": 0.0} for path in PATHS}
    for label, qs, ks, launches in SHAPES:
        if opts.only not in label:
            continue
        q, k, v = chip_smoke._randn(qs, gen, dev), chip_smoke._randn(ks, gen, dev), \
            chip_smoke._randn(ks, gen, dev)
        scale = qs[3] ** -0.5
        with torch.no_grad():
            ref, ref_lse = reference(q, k, v, scale)
            out, lse = A.flash_attn_fwd(q, k, v, scale, with_lse=True)
            err, lse_err, ok = check(out, lse, ref, ref_lse)
            line = (f"[fwd] {label} q{qs} kv{ks}: rel err {err:.3e} lse err {lse_err:.3e} "
                    f"{'ok' if ok else 'FAIL'}")
            if parent is not None:
                p_err, p_lse_err, p_ok = check(*call_library(parent, q, k, v, scale, True),
                                               ref, ref_lse)
                line += f" (parent {p_err:.3e} / {p_lse_err:.3e})"
                ok = ok and p_ok
            v_err = {spec: check(*call_library(fn, q, k, v, scale, True), ref, ref_lse)[:2]
                     for spec, fn in variants.items()}
            del ref, ref_lse
            kernel = lambda: A.flash_attn_fwd(q, k, v, scale, with_lse=False)  # noqa: E731
            if parent is not None:
                par = lambda: call_library(parent, q, k, v, scale)  # noqa: E731
                p_ms = [chip_smoke.time_ms(par)]
                ms = [chip_smoke.time_ms(kernel), chip_smoke.time_ms(kernel)]
                p_ms.append(chip_smoke.time_ms(par))
                ms, p_ms = sum(ms) / 2, sum(p_ms) / 2
            else:
                ms, p_ms = chip_smoke.time_ms(kernel), None
            lse_ms = chip_smoke.time_ms(lambda: A.flash_attn_fwd(q, k, v, scale, with_lse=True))
            v_ms = {spec: chip_smoke.time_ms(lambda: call_library(fn, q, k, v, scale))
                    for spec, fn in variants.items()}
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            sdpa_ms = chip_smoke.time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                                scale=scale))
        b_ops, b_bytes, b_exp = bounds(qs, ks, clock)
        line += (f" | kernel {ms:.4f} ms (with lse {lse_ms:.4f})"
                 + (f", parent {p_ms:.4f} ms (x{p_ms / ms:.2f})" if p_ms else "")
                 + f", sdpa {sdpa_ms:.4f} ms; bound ops {b_ops:.4f}, bytes {b_bytes:.4f}, "
                 f"exp {b_exp:.4f} ms; launches a run "
                 + (", ".join(f"{p} {n}" for p, n in launches.items()) or "none"))
        print(line, flush=True)
        for spec, t in v_ms.items():
            print(f"[variant] {label} {spec}: {t:.4f} ms (kernel {ms:.4f}); rel err "
                  f"{v_err[spec][0]:.3e} lse err {v_err[spec][1]:.3e}", flush=True)
        for path, n in launches.items():
            total[path]["kernel"] += n * ms
            total[path]["sdpa"] += n * sdpa_ms
            total[path]["parent"] += n * (p_ms or 0.0)
        if not ok:
            failed.append(label)
        del q, k, v, out, lse
        torch.cuda.empty_cache()
    for path, t in total.items():
        print(f"[path] launch-weighted K1 device time of one [{path}] "
              f"{'pass' if path == 'sweep' else 'run'} (the shapes timed): kernel "
              f"{t['kernel']:.2f} ms" + (f", parent {t['parent']:.2f} ms" if parent else "")
              + f", sdpa {t['sdpa']:.2f} ms; on {smi}")
    if opts.e2e:
        e2e(parent, smi)
    if failed:
        print(f"[FAIL] {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
