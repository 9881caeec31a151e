"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, drive.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  - needs CUDA; prints the card's name and power limit.
2. build   - compiles the CUDA kernels from the checkout (one nvcc per
             source, in parallel) and prints the seconds and ptxas usage.
3. kernels - at the main path's shapes on the card, holds each kernel
             against its plain torch version on the same inputs (the
             forward through the public `attention()`, the backward kernels
             on the forward's lse and delta, then the whole gradient through
             `attention()`'s autograd; tolerances below), then times the
             kernel, the plain version and `scaled_dot_product_attention`
             (a yardstick only; the port never calls it).
4. tiny    - the model-level pieces of the path at the TINY configs (CFG
             eps, encode, decode, the decode's gradient), bf16 on the card
             against f32 on the CPU with the same weights and inputs.
5. main    - SD-1.5 UNet + SD VAE at full width with seeded random weights,
             bf16: 512 px image -> VAE encode -> edit-friendly DDPM inversion
             (batched, chunk 10, t_skip 10) -> 40 colour-guided steps, each
             with a gradient through the full VAE decoder -> decode. Checks
             each kernel's launch count against what the path implies and
             that the image is finite.

The last two lines are the `kernels` JSON object and the result JSON object.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bandwidth
# Forward, dQ, dK and dV: max |kernel - plain| / max |plain|, a few times the
# readings at these shapes (PERF.md). The kernels round P (and dS) to bf16 for
# their products and write bf16; the plain versions keep P and dS in f32.
FWD_TOL = 2e-2
GRAD_TOL = 2e-2
LSE_TOL = 1e-3  # max |kernel - plain|: f32 log-sum-exp of bf16 inputs, sums in another order
# Tiny models, bf16 on the card against f32 on the CPU, max |card - cpu| / max |cpu|.
# About twice the bf16-vs-f32 spread of the same computations with plain ops
# on the CPU (eps 0.049, latent 0.014, decode 0.024, decode VJP 0.019): eps
# is looser because CFG scales a difference of two UNet outputs by 3.5.
TINY_TOL = {"eps": 0.1, "latent": 0.05, "decode": 0.05, "decode_vjp": 0.05}

FWD_CASES = [  # (label, q shape, kv shape)
    ("unet self 64x64", (2, 4096, 8, 40), (2, 4096, 8, 40)),
    ("unet self 32x32", (2, 1024, 8, 80), (2, 1024, 8, 80)),
    ("unet self 16x16", (2, 256, 8, 160), (2, 256, 8, 160)),
    ("unet self 8x8", (2, 64, 8, 160), (2, 64, 8, 160)),
    ("unet cross 64x64", (2, 4096, 8, 40), (2, 77, 8, 40)),
    ("vae mid 64x64", (1, 4096, 1, 512), (1, 4096, 1, 512)),
]
BWD_CASES = [
    ("vae mid 64x64", (1, 4096, 1, 512)),
    ("unet self 32x32", (2, 1024, 8, 80)),
]
REPLACES = {
    "flash_attn_fwd": "diffusion_image_editing_tpu/ops/attention.py:157 _resident_kernel, "
                      ":197 _streaming_kernel",
    "flash_attn_bwd_dq": "diffusion_image_editing_tpu/ops/attention.py:321 _bwd_dq_kernel",
    "flash_attn_bwd_dkv": "diffusion_image_editing_tpu/ops/attention.py:359 _bwd_dkv_kernel",
}
SOURCES = {
    name: f"diffusion_image_editing_tpu_torch/ops/csrc/{name}.cu" for name in REPLACES
}


def log(*parts) -> None:
    print(*parts, flush=True)


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around `reps`
    back-to-back calls after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# ---------------------------------------------------------------------------
# 1. device
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()} ({torch.cuda.get_device_name(0)})")
    # Plain f32 versions compare in full f32 on the card, never TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] allow_tf32: matmul False, cudnn False")
    return smi


# ---------------------------------------------------------------------------
# 2. build
# ---------------------------------------------------------------------------


def phase_build() -> None:
    from diffusion_image_editing_tpu_torch.ops import _build

    t0 = time.perf_counter()
    times = _build.build()
    log(f"[build] {len(times)} kernels in {time.perf_counter() - t0:.1f} s (nvcc in parallel: "
        + ", ".join(f"{n} {s:.1f} s" for n, s in times.items()) + ")")
    for name in _build.KERNELS:
        lines = _build.ptxas_report(name).splitlines()
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", "\n".join(lines))]
        clean = "; 0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads"
        spilling = [l for l in lines if clean not in l]
        log(f"[build] {name}: {len(lines)} instantiations, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {len(spilling)} with spills or stack")
        for line in spilling:
            log(f"[build] {name}: {line}")


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------


def _randn(shape, gen, dev):
    return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)


def _entry(name, shape, err, ms, plain_ms, flops, nbytes, library_ms):
    b_ms, by = bound_ms(flops, nbytes)
    return {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "shape": shape, "launches": None, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms}


def phase_kernels() -> dict:
    """Returns {kernel name: JSON entry} at the kernel's main-path shape."""
    from diffusion_image_editing_tpu_torch.ops.attention import (
        attention,
        attention_bwd_dkv_reference,
        attention_bwd_dq_reference,
        attention_delta,
        attention_reference,
        flash_attn_bwd_dkv,
        flash_attn_bwd_dq,
        flash_attn_fwd,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    entries = {}
    failures = []

    for label, qs, ks in FWD_CASES:
        q, k, v = _randn(qs, gen, dev), _randn(ks, gen, dev), _randn(ks, gen, dev)
        b, sq, h, d = qs
        sk = ks[1]
        scale = d ** -0.5
        with torch.no_grad():
            out = attention(q, k, v, scale)
            ref = attention_reference(q, k, v, scale)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ms = time_ms(lambda: attention(q, k, v, scale))
            plain_ms = time_ms(lambda: attention_reference(q, k, v, scale), reps=5)
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale))
        flops = 4.0 * b * h * sq * sk * d
        nbytes = 2.0 * (2 * q.numel() + k.numel() + v.numel())
        e = _entry("flash_attn_fwd", list(qs), err, ms, plain_ms, flops, nbytes, lib_ms)
        ok = rel <= FWD_TOL and math.isfinite(rel)
        log(f"[kernels] fwd {label} q{qs} kv{ks}: max_abs_err {err:.3e}, relative {rel:.3e} "
            f"(tol {FWD_TOL}) {'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']})")
        if not ok:
            failures.append(f"fwd {label}")
        if label == "unet self 64x64":
            entries["flash_attn_fwd"] = e

    for label, shape in BWD_CASES:
        b, s, h, d = shape
        scale = d ** -0.5
        q, k, v, dout = (_randn(shape, gen, dev) for _ in range(4))
        with torch.no_grad():
            out, lse = flash_attn_fwd(q, k, v, scale, with_lse=True)
            logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
            lse_err = (lse - torch.logsumexp(logits, dim=-1).reshape(b * h, s)).abs().max().item()
            del logits
            # Each backward kernel against its plain version, on the same inputs.
            delta = attention_delta(dout, out)
            args = (q, k, v, dout, lse, delta, scale)
            got = (flash_attn_bwd_dq(*args),) + flash_attn_bwd_dkv(*args)
            want = (attention_bwd_dq_reference(*args),) + attention_bwd_dkv_reference(*args)
            abs_errs = [(g.float() - w.float()).abs().max().item() for g, w in zip(got, want)]
            errs = [e / w.float().abs().max().item() for e, w in zip(abs_errs, want)]
            dq_ms = time_ms(lambda: flash_attn_bwd_dq(*args))
            dkv_ms = time_ms(lambda: flash_attn_bwd_dkv(*args))
            plain_dq_ms = time_ms(lambda: attention_bwd_dq_reference(*args), reps=5)
            plain_dkv_ms = time_ms(lambda: attention_bwd_dkv_reference(*args), reps=5)
            del got, want
        # The whole gradient as the path takes it: autograd through attention()
        # (K1 with lse, K2, K3) against autograd through attention_reference.
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        grads = torch.autograd.grad(attention(*leaves, scale), leaves, dout)
        ref_grads = torch.autograd.grad(attention_reference(*leaves, scale), leaves, dout)
        path_errs = [((g.float() - r.float()).abs().max() / r.float().abs().max()).item()
                     for g, r in zip(grads, ref_grads)]
        lib_out = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves), scale=scale)
        lib_dout = dout.transpose(1, 2)
        lib_bwd_ms = time_ms(
            lambda: torch.autograd.grad(lib_out, leaves, lib_dout, retain_graph=True))
        ok = (lse_err <= LSE_TOL and all(e <= GRAD_TOL for e in errs)
              and all(e <= GRAD_TOL for e in path_errs))
        n = float(b * h * s * s * d)
        io = 2.0 * q.numel()  # bytes of one (B, S, H, D) bf16 tensor
        stats = 4.0 * b * h * s  # bytes of one (B*H, S) f32 row statistic
        e_dq = _entry("flash_attn_bwd_dq", list(shape), abs_errs[0], dq_ms, plain_dq_ms,
                      6 * n, 5 * io + 2 * stats, None)
        e_dkv = _entry("flash_attn_bwd_dkv", list(shape), max(abs_errs[1:]), dkv_ms,
                       plain_dkv_ms, 8 * n, 6 * io + 2 * stats, None)
        log(f"[kernels] bwd {label} {shape}: lse_err {lse_err:.3e} (tol {LSE_TOL}); kernels vs "
            f"plain on the same lse and delta: max_abs_err dq {abs_errs[0]:.3e} dk "
            f"{abs_errs[1]:.3e} dv {abs_errs[2]:.3e}, relative dq {errs[0]:.3e} dk {errs[1]:.3e} "
            f"dv {errs[2]:.3e}; autograd through attention() vs the plain autograd, relative "
            f"dq {path_errs[0]:.3e} dk {path_errs[1]:.3e} dv {path_errs[2]:.3e} (tol {GRAD_TOL}) "
            f"{'ok' if ok else 'FAIL'} | dq {dq_ms:.4f} ms (plain {plain_dq_ms:.4f}, bound "
            f"{e_dq['bound_ms']:.4f}), dkv {dkv_ms:.4f} ms (plain {plain_dkv_ms:.4f}, bound "
            f"{e_dkv['bound_ms']:.4f}), sdpa backward (dq+dk+dv) {lib_bwd_ms:.4f} ms")
        if not ok:
            failures.append(f"bwd {label}")
        if label == "vae mid 64x64":
            entries["flash_attn_bwd_dq"] = e_dq
            entries["flash_attn_bwd_dkv"] = e_dkv
        del q, k, v, dout, args, leaves, grads, ref_grads, lib_out
        torch.cuda.empty_cache()

    if failures:
        raise RuntimeError(f"kernels disagree with the plain version: {failures}")
    return entries


# ---------------------------------------------------------------------------
# 4. tiny
# ---------------------------------------------------------------------------


def phase_tiny() -> None:
    import copy

    from diffusion_image_editing_tpu_torch.models import (
        TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition)
    from diffusion_image_editing_tpu_torch.engine import CfgEpsClosure

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    unet = UNet2DCondition(TINY_SD_UNET, device="cpu")
    vae = AutoencoderKL(TINY_VAE, device="cpu")
    text = torch.from_numpy(rng.standard_normal((2, 77, 32), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16), dtype=np.float32))
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32))
    z0 = torch.from_numpy(rng.standard_normal((1, 4, 16, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 3, 32, 32), dtype=np.float32))
    t = np.array([801, 41])

    def pieces(dev, dtype):
        u = copy.deepcopy(unet).to(dev, dtype)
        v = copy.deepcopy(vae).to(dev, dtype)
        eps = CfgEpsClosure(u, text.to(dev, dtype), 3.5)(x.to(dev), t)
        with torch.no_grad():
            latent = v.encode(img.to(dev))
        z = z0.to(dev).requires_grad_(True)
        decoded = v.decode(z)
        (vjp,) = torch.autograd.grad((decoded.float() * w.to(dev)).sum(), z)
        return {"eps": eps, "latent": latent, "decode": decoded.detach(), "decode_vjp": vjp}

    cpu = pieces(torch.device("cpu"), torch.float32)
    card = pieces(torch.device("cuda"), torch.bfloat16)
    failed = []
    for name, tol in TINY_TOL.items():
        ref = cpu[name].float()
        err = ((card[name].float().cpu() - ref).abs().max() / ref.abs().max()).item()
        ok = err <= tol
        log(f"[tiny] {name}: max|card bf16 - cpu f32| / max|cpu| {err:.3e} (tol {tol}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"tiny models on the card disagree with the CPU: {failed}")


# ---------------------------------------------------------------------------
# 5. main path
# ---------------------------------------------------------------------------

STEPS, T_SKIP, CHUNK = 50, 10, 10


def phase_main_path(smi: str) -> dict:
    """Returns each kernel's launch count from one counted run."""
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.models import (
        SD15_UNET, SD_VAE, AutoencoderKL, UNet2DCondition)
    from diffusion_image_editing_tpu_torch.ops.attention import (
        launch_counts, reset_launch_counts)
    from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    torch.manual_seed(0)
    unet = UNet2DCondition(SD15_UNET, device=dev, dtype=torch.bfloat16)
    vae = AutoencoderKL(SD_VAE, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    text_emb = torch.from_numpy(
        rng.standard_normal((2, 77, SD15_UNET.cross_attention_dim), dtype=np.float32))
    img = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (1, 3, SD_VAE.sample_size, SD_VAE.sample_size)).astype(np.float32))
    sd = SD(unet, vae, schedule_for_model("sd", STEPS), text_emb=text_emb.to(torch.bfloat16),
            device=dev)
    pipe = EditPipeline(sd)
    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)
    n_params = sum(p.numel() for m in (unet, vae) for p in m.parameters())
    log(f"[main] SD-1.5 UNet + SD VAE, {n_params / 1e6:.1f} M parameters, bf16, seeded random "
        f"weights; set-up {time.perf_counter() - t0:.1f} s")

    def run():
        gen = torch.Generator(device=dev).manual_seed(5)
        t_start = time.perf_counter()
        xt, zs, xts, _, _ = pipe.prepare_real_image_edit(
            img, eta=1.0, inversion_method="ddpm", mode="batched", t_skip=T_SKIP, chunk=CHUNK,
            generator=gen)
        torch.cuda.synchronize()
        t_inv = time.perf_counter()
        out = pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, attr_func=attr,
                              inversion_method="ddpm", t_skip=T_SKIP, mode="split")
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        return out, t_inv - t_start, t_end - t_inv

    run()  # warm-up: first-call library set-up stays out of the timed, counted run
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    out, inv_s, edit_s = run()
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    guided = STEPS - T_SKIP
    unet_calls = math.ceil((STEPS - T_SKIP) / CHUNK) + guided
    expected = {
        "flash_attn_fwd": 2 * SD15_UNET.num_transformers * unet_calls + 2 + guided,
        "flash_attn_bwd_dq": guided,
        "flash_attn_bwd_dkv": guided,
    }
    log(f"[main] e2e {inv_s + edit_s:.3f} s (inversion {inv_s:.3f} s, {guided} guided steps "
        f"{edit_s:.3f} s = {guided / edit_s:.3f} steps/s), peak memory "
        f"{peak / 2**30:.2f} GiB, on {smi}")
    log(f"[main] launches {counts}, expected {expected} ({unet_calls} UNet calls x "
        f"{2 * SD15_UNET.num_transformers} attentions, encode + final decode, "
        f"1 fwd + 1 dq + 1 dkv per guided step)")
    imgs = out.imgs
    finite = bool(torch.isfinite(imgs).all())
    log(f"[main] image {tuple(imgs.shape)} {imgs.dtype}, finite {finite}, "
        f"range [{imgs.min().item():.3f}, {imgs.max().item():.3f}], "
        f"red mean {imgs[:, 0].float().mean().item():.4f}")
    if counts != expected:
        raise RuntimeError(f"launch counts {counts} differ from the path's {expected}")
    if not finite or tuple(imgs.shape) != (1, 3, SD_VAE.sample_size, SD_VAE.sample_size):
        raise RuntimeError("main path output is not a finite (1, 3, 512, 512) image")
    return counts


def main() -> int:
    smi = phase_device()
    phase_build()
    entries = phase_kernels()
    phase_tiny()
    counts = phase_main_path(smi)
    for name, e in entries.items():
        e["launches"] = counts[name]
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
