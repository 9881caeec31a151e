"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): build, check, drive.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device  - needs CUDA; prints the card's name and power limit.
2. build   - compiles the CUDA kernels from the checkout (one nvcc per
             source, in parallel) and prints the seconds and ptxas usage.
3. kernels - at the main path's shapes on the card, holds each kernel
             against its plain torch version on the same inputs, then times
             the kernel, the plain version and a library call that computes
             the same function (a yardstick only; the port never calls it):
             * attention (K1-K3): the forward through the public
               `attention()` at every width of the path and the batched
               inversion's batch 20, the forward with lse at the UNet's
               64 x 64 width and at the VAE's 512-wide head against
               `torch.logsumexp` (O bit-equal without it), the backward
               kernels on the forward's lse and delta, then the whole
               gradient through `attention()`'s autograd; yardstick
               `scaled_dot_product_attention`;
             * GroupNorm (K4, or K5 + K6 by slab size) at the UNet's
               64 x 64 x 320, 8 x 8 x 1280 and 64 x 64 x 640 (batch 2) and
               the VAE's 512 x 512 x 128 (batch 1), each activation, a
               second call bit-equal to the first, and K5 alone at K4's
               shapes; yardstick `F.group_norm` on bf16 (+ `F.silu`);
             * the fused GroupNorm+SiLU -> conv3x3 (K7) at the UNet's
               64 x 64 320 -> 320, 32 x 32 1920 -> 640, 16 x 16 2560 -> 1280
               and 8 x 8 1280 -> 1280 (batch 2), the VAE's 64 x 64 512 -> 512
               (batch 1) and a 4 x 4 map of 8 channels; yardstick `F.conv2d`
               (cuDNN) on the pre-activated input;
             * activated batch norm (K8) at the segmentation trainer's
               shapes (batch 16 at 448 px): the stem's 224 x 224 x 64, layer4's
               14 x 14 x 512, the 1 x 1 x 128 norms, one bf16 and one ELU
               case; yardstick `F.batch_norm` (+ the activation).
4. tiny    - the model-level pieces of the path at the TINY configs (CFG
             eps, encode, decode, the decode's gradient), bf16 on the card
             against f32 on the CPU with the same weights and inputs, in the
             default and the fused-conv configuration; then the TINY CLIP
             text encoder and a 3-step TINY `generate_image` under a prompt,
             the same way; segmentation guidance: the TINY BiSeNet's f32
             logits and the gradient of NetAttrFunc's loss at one image, card
             against CPU, one NetAttrFunc nudge through the TINY decode, bf16
             on both, and class masks made on the card and on the CPU from
             one parsing map, which must be bit-equal.
   seg-tiny - two BiSeNet train steps with norm="abn" at width 8, 64 px,
             batch 2, f32 on the card (TF32 off) against the same on the CPU
             from the same weights and batches: losses, weights, running
             statistics.
5. main    - SD-1.5 UNet + SD VAE at full width with seeded random weights,
             bf16: 512 px image -> VAE encode -> edit-friendly DDPM inversion
             (batched, chunk 10, t_skip 10) -> 40 colour-guided steps, each
             with a gradient through the full VAE decoder -> decode. Checks
             each kernel's launch count against what the path implies (every
             GroupNorm of the path through K4 or K5 + K6, and no plain
             GroupNorm on the card) and that the image is finite.
6. fused   - the same weights in the fused-conv configuration
             (`fused_conv=True` on the UNet's and the VAE's configs): one
             CFG UNet call, one decode and its latent gradient against the
             default configuration, then the whole path, with the fused conv's
             and the remaining GroupNorms' launch counts checked and a finite
             image.
7. seg_edit - segmentation guidance (bench.py's e2e_seg, face alignment
             left out) on the [main] models: a face-parsing BiSeNet (width
             64, 19 classes, norm bn, f32, seeded random weights with class
             17's logit raised so that the hair mask covers part of the
             latent) written as a checkpoint, loaded by
             `create_segmentation_model` and checked bit-equal; a random
             512 px image -> BiSeNet parsing -> hair mask (class 17) ->
             encode -> DDPM inversion as [main] -> the masked, resynthesized
             edit with 40 steps guided by NetAttrFunc(loss_scale=200), each
             with a gradient through the VAE decoder and the BiSeNet ->
             decode. Checks the launch counts ([main]'s: BiSeNet runs no
             kernel), no plain attention, GroupNorm or ABN on the card, the
             mask's shape and coverage (1-99 % of the latent), a finite image
             that differs from the unguided edit; prints the segment + mask +
             encode, inversion, edit and whole seconds and the peak memory.
8. prompt  - the SD path as a user starts it, at full width, after the [main]
             models are freed: an HF-layout SD-1.5 checkpoint directory
             (UNet, VAE under the legacy attention names, CLIP ViT-L/14
             text encoder, bf16 `torch.save` files from seeded random
             weights, and a synthetic byte-level tokenizer) written to a
             temporary directory, loaded by `create_diffusion_model("sd",
             checkpoint_dir=...)` on the card and checked bit-equal to what
             was written; a tokenized prompt; `generate_images` (50 steps,
             CFG 3.5, 512 px); DDIM inversion of a random 512 px image under
             the prompt; the fused edit with resynthesis inside a latent box
             and 40 colour-guided steps; a rerun check over 5 guided steps
             (the split mode beside the fused one, which run one loop), held
             within RERUN_TOL with bit-equality printed. Checks every kernel's launch
             count against what each part implies, that no plain attention
             (but CLIP's causal one) and no plain GroupNorm ran on the card,
             and finite images; prints the load, generation, inversion and
             edit seconds and the peak memory.
9. ldm_clf - bench.py's `ldm` workload in the port: an HF-layout LDM
             CelebA-HQ-256 directory (UNet 274 M parameters under the current
             attention names, VQ model 55 M under the legacy ones, bf16, seeded
             random weights) and an anyGAN attribute predictor (ResNet-50,
             fc -> 80, f32) saved under torchvision's keys, loaded by
             `create_diffusion_model("ldm", sample_clipping=False)` and
             `get_pretrained_anygan` and checked bit-equal; a random 256 px
             image -> VQ encode -> 50-step DDIM inversion
             (`prepare_real_image_edit`) -> `edit_image`, bench.py's guided
             loop: 50 DDIM steps at eta 0, each a UNet call and
             ClassifierAttrFunc(loss_scale=50, [20][1]).apply_batched through
             the quantizing VQ decode (straight-through) and the ResNet-50 on
             the ImageNet-normalised image -> decode. Checks the launch counts
             against what the pieces imply, no plain attention, GroupNorm or
             ABN on the card, a finite image that differs from the unguided
             edit's, and (`check_guidance`, on a rerun) that every step's
             nudge is finite and the largest one reached the f32 latent;
             prints the guided loop's steps/s (bench.py's metric, the final
             decode timed alone and taken off), the inversion's and the
             load's seconds, the peak memory, each step's nudge and the anyGAN
             logit of the guided and the unguided image.
10. ddpm_edit - the DDPM CelebA-HQ-256 family: an HF-layout directory (UNet
             114 M, legacy attention names, bf16) loaded by
             `create_diffusion_model("ddpm", sample_clipping=True)` and checked
             bit-equal; a 50-step 256 px generation with pred-x0 clipped (the
             CLI's `generate --family ddpm`); on an unclipped wrapper of the
             same modules, a random 256 px image -> edit-friendly DDPM
             inversion (eta 1, batched, chunk 10, t_skip 10) -> 40 steps
             guided by the same ClassifierAttrFunc, the gradient through the
             ResNet-50 alone (the codec is the identity). Checks as
             [ldm_clf], and with no quantizer between the nudge and the
             classifier, the guided image's logit must be below the
             unguided one's.
   [tiny] also holds TINY_UNET2D (its 64-wide head), a TINY VQ model (encode,
             codes as an agreement rate, decode and its gradient), a width-8
             ResNet-50's logits and one ClassifierAttrFunc nudge through the
             TINY LDM decode, card against CPU; [kernels] holds K1 at the LDM
             and DDPM UNets' heads and at 64, K2/K3 at 64, and K4-K6 at the
             LDM UNet's odd channels a group, the 512 KiB slabs of the VQ
             decoder and the DDPM UNet and their 1 MiB slabs.
11. seg    - the segmentation trainer's path after the SD models are freed:
             `seg.train_loop` (the `seg-train` CLI's entry point) at the
             reference recipe (BiSeNet, ResNet-18, width 64, 19 classes,
             448 px, batch 16, OHEM 3-head loss, warmup -> poly SGD) with
             norm="abn", seeded random weights and a uint8 SyntheticFaceMask
             feed, in f32 and in bf16 compute: a warm-up run that saves a
             checkpoint, a counted run that resumes from it (ms/step and
             img/s from CUDA events, peak memory, every ABN through K8 and no
             plain ABN on the card, finite losses, weights and running
             statistics changed), a second resume, and one eval-mode forward.

`[pace]` lines (after the build, before [main], [ldm_clf] and [ddpm_edit])
read the host's and the card's pace: a fixed Python loop, one small
launch, the objects the garbage collector tracks, a bf16 matmul's rate.

The last two lines are the `kernels` JSON object and the result JSON object.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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
# The same for CLIP's states and a 3-step CFG generation's image: the CPU
# spread of the same computations was 0.0061-0.0068 and 0.009-0.016.
TINY_PROMPT_TOL = {"clip": 0.02, "generate": 0.05}
# Segmentation guidance at the TINY sizes, card against CPU from the same
# weights and inputs, max |card - cpu| / max |cpu|: the f32 BiSeNet's logits
# (width 8, 64 px) and the gradient of NetAttrFunc's loss at one f32 image
# (TF32 is off, so only the order of the sums differs); one NetAttrFunc
# nudge through the TINY decode, the VAE bf16 on the card and f32 on the
# CPU, as TINY_TOL's decode_vjp. For the nudge the CPU's decode takes the
# card's decoded image as its value (and keeps its own gradient): BiSeNet's
# input gradient is not smooth (ReLU and max-pool routing, the [0, 1] clamp),
# and at two decodes 1.5 % apart it differs by 0.2-0.28 (CPU bf16 against
# f32; 0.18 card bf16 against CPU bf16), which no tolerance here would pass.
TINY_SEG_TOL = {"logits": 1e-4, "seg_grad": 1e-3, "nudge": 0.05}
# The DDPM / LDM pieces at the TINY sizes, card bf16 against CPU f32 (the
# ResNet-50 f32 on both, TF32 off), max |card - cpu| / max |cpu| (codes: the
# least share of the latent quantized to the same code). Three to five times
# the CPU's own bf16-vs-f32 spread of the same computations (eps 0.0095,
# latent 0.013, decode 0.011, decode VJP 0.014, nudge 0.017; codes agreeing
# at 0.994, a miss rate of 0.6 % against the 5 % allowed); logits as
# TINY_SEG_TOL's.
TINY_FAMILY_TOL = {"eps": 0.05, "latent": 0.05, "codes": 0.95, "decode": 0.05,
                   "decode_vjp": 0.05, "logits": 1e-4, "nudge": 0.05}

FWD_CASES = [  # (label, q shape, kv shape)
    ("unet self 64x64", (2, 4096, 8, 40), (2, 4096, 8, 40)),
    ("unet self 32x32", (2, 1024, 8, 80), (2, 1024, 8, 80)),
    ("unet self 16x16", (2, 256, 8, 160), (2, 256, 8, 160)),
    ("unet self 8x8", (2, 64, 8, 160), (2, 64, 8, 160)),
    ("unet cross 64x64", (2, 4096, 8, 40), (2, 77, 8, 40)),
    ("unet self 64x64 b20", (20, 4096, 8, 40), (20, 4096, 8, 40)),  # the batched inversion
    ("vae mid 64x64", (1, 4096, 1, 512), (1, 4096, 1, 512)),
    # The LDM UNet's heads of dim 32, the DDPM UNet's one 512-wide head (batch 1
    # and the batched inversion's chunk of 10: 64 keys leave each rank of K1's
    # wide cluster one 32-key tile), and TINY_UNET2D's 64-wide head.
    ("ldm unet 32x32", (1, 1024, 14, 32), (1, 1024, 14, 32)),
    ("ldm unet 16x16", (1, 256, 21, 32), (1, 256, 21, 32)),
    ("ldm unet 8x8", (1, 64, 28, 32), (1, 64, 28, 32)),
    ("ddpm unet 16x16", (1, 256, 1, 512), (1, 256, 1, 512)),
    ("ddpm unet 8x8", (1, 64, 1, 512), (1, 64, 1, 512)),
    ("ddpm unet 16x16 b10", (10, 256, 1, 512), (10, 256, 1, 512)),
    ("ddpm unet 8x8 b10", (10, 64, 1, 512), (10, 64, 1, 512)),
    ("tiny unet2d 8x8", (2, 64, 1, 64), (2, 64, 1, 64)),
]
LSE_CASES = [  # the forward with lse: the UNet's width, and the VAE's (40 launches a run)
    ("unet self 64x64", (2, 4096, 8, 40)),
    ("vae mid 64x64", (1, 4096, 1, 512)),
]
BWD_CASES = [  # queries and keys of one length; the ragged case fills no block or tile
    ("vae mid 64x64", (1, 4096, 1, 512)),  # also the VQ decoder's, in [ldm_clf]'s gradient
    ("unet self 32x32", (2, 1024, 8, 80)),
    ("vae ragged", (1, 1000, 2, 512)),
    ("tiny unet2d 8x8", (2, 64, 1, 64)),  # the narrow design at head dim 64
]
# GroupNorm: max |kernel - plain| / max |plain|; both round the same f32 value
# to bf16, so they differ by at most one bf16 step (2^-7 relative) where the
# f32 values straddle a rounding boundary. Statistics in f32: mean within
# 1e-5 * (|mean| + 1), rstd within 1e-4 relative (sums in another order).
GN_TOL, MEAN_TOL, RSTD_TOL = 1e-2, 1e-5, 1e-4
GN_GROUPS, GN_EPS = 32, 1e-6
GN_CASES = [  # (label, (N, C, H, W)); a kernel's table entry is its first shape on its route
    ("unet 64x64x320 b2", (2, 320, 64, 64)),
    ("unet 8x8x1280 b2", (2, 1280, 8, 8)),
    ("vae 512x512x128 b1", (1, 128, 512, 512)),
    ("unet 64x64x640 b2", (2, 640, 64, 64)),  # 160 KiB slabs: K4 at a cluster of two
    # The LDM UNet's odd channel counts a group (7, 21, 35, 49), the VQ
    # decoder's and the DDPM UNet's slabs of exactly K4's 512 KiB limit, and
    # their 1 MiB slabs (K5 + K6), the DDPM one at the inversion's batch 10.
    ("ldm unet 64x64x224 b1", (1, 224, 64, 64)),
    ("ldm unet 64x64x672 b1", (1, 672, 64, 64)),
    ("ldm unet 32x32x1120 b1", (1, 1120, 32, 32)),
    ("ldm unet 16x16x1568 b1", (1, 1568, 16, 16)),
    ("vq 128x128x512 b1", (1, 512, 128, 128)),
    ("ddpm 256x256x128 b1", (1, 128, 256, 256)),
    ("vq 256x256x256 b1", (1, 256, 256, 256)),
    ("ddpm 256x256x256 b10", (10, 256, 256, 256)),
]
# Fused conv: max |kernel - plain| / max |plain|. f32 accumulation in another
# order; the kernel rounds conv + bias once, the plain version rounds the
# conv and then the bias add.
CONV_TOL = 2e-2
CONV_CASES = [  # (label, N, Cin, Cout, H, W)
    ("unet 64x64 320->320 b2", 2, 320, 320, 64, 64),
    ("unet 16x16 2560->1280 b2", 2, 2560, 1280, 16, 16),
    ("vae 64x64 512->512 b1", 1, 512, 512, 64, 64),
    ("unet 8x8 1280->1280 b2", 2, 1280, 1280, 8, 8),
    ("unet 32x32 1920->640 b2", 2, 1920, 640, 32, 32),
    ("4x4 8->24 b2", 2, 8, 24, 4, 4),
]
# The same full-width computations in the default and the fused-conv
# configuration, both bf16, max |fused - default| / max |default|: about the
# bf16-vs-f32 spread of the tiny phase (TINY_TOL), since the two differ only
# in where and in what order they round.
FUSED_TOL = {"eps": 0.1, "decode": 0.05, "decode_vjp": 0.1}
PEAK_F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
REPLACES = {
    "flash_attn_fwd": "diffusion_image_editing_tpu/ops/attention.py:157 _resident_kernel, "
                      ":197 _streaming_kernel",
    "flash_attn_bwd_dq": "diffusion_image_editing_tpu/ops/attention.py:321 _bwd_dq_kernel",
    "flash_attn_bwd_dkv": "diffusion_image_editing_tpu/ops/attention.py:359 _bwd_dkv_kernel",
    "group_norm_fused": "diffusion_image_editing_tpu/ops/groupnorm.py:98 _single_block_kernel",
    "group_norm_stats": "diffusion_image_editing_tpu/ops/groupnorm.py:64 _stats_kernel",
    "group_norm_apply": "diffusion_image_editing_tpu/ops/groupnorm.py:86 _apply_kernel",
    "affine_silu_conv3x3": "diffusion_image_editing_tpu/ops/fused_conv.py:171 _fused_kernel",
    "abn_apply": "diffusion_image_editing_tpu/ops/abn.py:105 _abn_apply_kernel",
}
SOURCES = {
    name: f"diffusion_image_editing_tpu_torch/ops/csrc/{name}.cu" for name in REPLACES
}
# ABN (K8): max |kernel - plain| / max |plain|. The kernel does the plain
# version's f32 operations in its order, each rounded (no FMA contraction),
# so f32 identity and leaky_relu agree to the bit and ELU to an ulp of
# expm1; bf16 output may differ by one bf16 step (2^-7 relative) where the
# f32 values straddle a rounding boundary.
ABN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ABN_EPS, ABN_OPS = 1e-5, 6.0  # f32 operations an element: sub, 2 mul, add, activation
ABN_CASES = [  # (label, (N, C, H, W), dtype, activation)
    ("stem 224x224", (16, 64, 224, 224), torch.float32, "leaky_relu"),
    ("layer4 14x14", (16, 512, 14, 14), torch.float32, "identity"),
    ("1x1 norms", (16, 128, 1, 1), torch.float32, "identity"),
    ("ffm 56x56", (16, 256, 56, 56), torch.bfloat16, "leaky_relu"),
    ("conv_head16 56x56", (16, 128, 56, 56), torch.float32, "elu"),
]
# The tiny trainer on the card (f32, TF32 off) against the CPU, the same
# weights and batches, two steps at a learning rate of 1e-2 (warmup starting
# at lr0), so each step moves the weights by about 1e-4 to 1e-2: losses
# |card - cpu| / |cpu| <= 1e-4 (convolutions summed in another order);
# weights max |card - cpu| <= 2e-2 of the largest update max |cpu - start|
# (f32 rounding of the weights alone is about 1e-3 of an update, and the
# 1 x 1 norms over N = 2 values amplify the rest); running statistics
# max |card - cpu| / max |cpu| <= 1e-3 per tensor.
SEG_TINY = dict(image_size=64, batch_size_per_device=2, width=8, norm="abn", lr0=1e-2,
                warmup_start_lr=1e-2)
SEG_TINY_TOL = {"loss": 1e-4, "weights": 2e-2, "stats": 1e-3}
SEG_NORMS = 31  # NormAct layers of a BiSeNet forward
SEG_WARMUP, SEG_STEPS, SEG_RESUME = 3, 12, 2  # steps of the warm-up, counted and resumed runs


def log(*parts) -> None:
    print(*parts, flush=True)


SLEEP_CYCLES = 20_000_000  # about 11 ms at the H100's 1.755 GHz boost clock


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device milliseconds per call, from CUDA events around `reps`
    back-to-back calls after `warmup` calls. The timed calls queue up behind
    a sleep kernel while the host launches them, so that a call whose launch
    takes longer on the host than its kernels take on the card is timed by
    its kernels, not by the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
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


def pace_probe(label: str) -> None:
    """The host's and the card's pace at this point of the script, for
    comparing the guided loops' steps/s across the script and across calls
    (each step launches thousands of kernels): a fixed pure-Python loop,
    2000 launches of a one-element add on the card timed to a
    synchronisation, the objects the garbage collector tracks, and the rate
    of ten bf16 8192^3 matmuls (CUDA events, after one warm-up)."""
    t0 = time.perf_counter()
    acc = 0
    for i in range(200_000):
        acc += i & 7
    py_ms = (time.perf_counter() - t0) * 1e3
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(2000):
        x.add_(1.0)
    torch.cuda.synchronize()
    launch_us = (time.perf_counter() - t0) / 2000 * 1e6
    n = 8192
    a = torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
    b = a @ a
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        b = a @ a
    end.record()
    torch.cuda.synchronize()
    tflops = 10 * 2 * n**3 / (start.elapsed_time(end) * 1e-3) / 1e12
    del a, b
    log(f"[pace] {label}: a 200000-step Python loop {py_ms:.2f} ms; a small launch "
        f"{launch_us:.2f} us; {len(gc.get_objects())} objects tracked by the collector; "
        f"bf16 matmul {tflops:.1f} TFLOP/s")


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


def _entry(name, shape, err, ms, plain_ms, flops, nbytes, library_ms,
           peak_flops=PEAK_BF16_FLOPS):
    b_ms, by = bound_ms(flops, nbytes, peak_flops)
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

    for label, shape in LSE_CASES:
        q, k, v = (_randn(shape, gen, dev) for _ in range(3))
        b, s, h, d = shape
        scale = d ** -0.5
        with torch.no_grad():
            out, lse = flash_attn_fwd(q, k, v, scale, with_lse=True)
            primal, _ = flash_attn_fwd(q, k, v, scale, with_lse=False)
            lse_err = 0.0
            for i in range(b):  # one batch element at a time: the f32 logits stay 0.5 GB
                logits = torch.einsum("bqhd,bkhd->bhqk", q[i:i + 1].float(), k[i:i + 1].float())
                ref_lse = torch.logsumexp(logits * scale, dim=-1).reshape(h, s)
                lse_err = max(lse_err, (lse[i * h:(i + 1) * h] - ref_lse).abs().max().item())
                del logits
            lse_ms = time_ms(lambda: flash_attn_fwd(q, k, v, scale, with_lse=True))
        same = torch.equal(out, primal)
        ok = lse_err <= LSE_TOL and same
        log(f"[kernels] fwd with lse {label} {shape}: lse_err {lse_err:.3e} (tol {LSE_TOL}), "
            f"output bit-equal to the call without lse: {same} {'ok' if ok else 'FAIL'} | "
            f"kernel with lse {lse_ms:.4f} ms")
        if not ok:
            failures.append(f"fwd with lse {label}")
        del q, k, v, out, primal, lse

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

    _groupnorm_kernels(gen, dev, entries, failures)
    _conv_kernels(gen, dev, entries, failures)
    _abn_kernels(gen, dev, entries, failures)
    if failures:
        raise RuntimeError(f"kernels disagree with the plain version: {failures}")
    return entries


def _groupnorm_kernels(gen, dev, entries, failures) -> None:
    """K4, K5 and K6 at the path's GroupNorm shapes, each activation. Bound:
    bytes (x read once, the output written once; K5 reads x alone), against
    f32 operations counted as 10 an element for K4, 3 for K5 and 7 for K6."""
    from diffusion_image_editing_tpu_torch.ops import groupnorm as GN

    for label, shape in GN_CASES:
        n, c = shape[:2]
        x = _randn(shape, gen, dev)
        scale = (1 + 0.2 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        bias = (0.2 * torch.randn(c, generator=gen, device=dev)).to(torch.bfloat16)
        fused = GN.uses_fused_kernel(shape, GN_GROUPS)
        route = "K4" if fused else "K5+K6"
        args = (x, scale, bias, GN_GROUPS, GN_EPS)
        with torch.no_grad():
            ref_mean, ref_rstd = GN.group_norm_moments(x, GN_GROUPS, GN_EPS)
            if fused:  # K5 alone at K4's slabs, the small slabs K5 takes below the route
                mean, rstd = GN.group_norm_stats(x, GN_GROUPS, GN_EPS)
                again = GN.group_norm_stats(x, GN_GROUPS, GN_EPS)
                mean_err = ((mean - ref_mean).abs() / (ref_mean.abs() + 1)).max().item()
                rstd_err = ((rstd - ref_rstd).abs() / ref_rstd).max().item()
                same = torch.equal(mean, again[0]) and torch.equal(rstd, again[1])
                ok = mean_err <= MEAN_TOL and rstd_err <= RSTD_TOL and same
                log(f"[kernels] group_norm {label} {shape} K5 alone (cluster "
                    f"{GN.stats_cluster_blocks(shape, GN_GROUPS)}): mean {mean_err:.2e} (tol "
                    f"{MEAN_TOL}), rstd {rstd_err:.2e} (tol {RSTD_TOL}), rerun bit-equal {same} "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"group_norm {label} K5 alone")
            for act in GN.ACTS:
                out, mean, rstd = GN.group_norm_kernels(*args, act)
                again = GN.group_norm_kernels(*args, act)
                ref = GN.group_norm_reference(*args, act)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip((out, mean, rstd), again))
                err = (out.float() - ref.float()).abs().max().item()
                rel = err / ref.float().abs().max().item()
                mean_err = ((mean - ref_mean).abs() / (ref_mean.abs() + 1)).max().item()
                rstd_err = ((rstd - ref_rstd).abs() / ref_rstd).max().item()
                ok = (rel <= GN_TOL and mean_err <= MEAN_TOL and rstd_err <= RSTD_TOL
                      and math.isfinite(rel) and same)
                line = (f"[kernels] group_norm {label} {shape} act={act} ({route}): "
                        f"max_abs_err {err:.3e}, relative {rel:.3e} (tol {GN_TOL}), mean "
                        f"{mean_err:.2e} (tol {MEAN_TOL}), rstd {rstd_err:.2e} (tol {RSTD_TOL}), "
                        f"rerun bit-equal {same} {'ok' if ok else 'FAIL'}")
                if not ok:
                    failures.append(f"group_norm {label} act={act}")
                if act not in ("silu", None):
                    log(line)
                    continue
                ms = time_ms(lambda: GN.group_norm_kernels(*args, act))
                plain_ms = time_ms(lambda: GN.group_norm_reference(*args, act), reps=5)
                if act == "silu":
                    lib_ms = time_ms(lambda: F.silu(F.group_norm(x, GN_GROUPS, scale, bias,
                                                                 GN_EPS)))
                else:
                    lib_ms = time_ms(lambda: F.group_norm(x, GN_GROUPS, scale, bias, GN_EPS))
                nx = 2.0 * x.numel()
                b_ms, by = bound_ms(10.0 * x.numel(), 2 * nx, PEAK_F32_FLOPS)
                line += (f" | kernels {ms:.4f} ms, plain {plain_ms:.4f} ms, F.group_norm"
                         f"{'+silu' if act else ''} {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
                if fused:
                    two_pass_ms = time_ms(lambda: GN.group_norm_apply(
                        x, *GN.group_norm_stats(x, GN_GROUPS, GN_EPS), scale, bias, act))
                    line += f"; K5+K6 at this shape {two_pass_ms:.4f} ms"
                log(line)
                if act != "silu":
                    continue
                stats = 8.0 * n * GN_GROUPS  # the (N, G) f32 mean and rstd
                if fused:
                    entries.setdefault("group_norm_fused", _entry(
                        "group_norm_fused", list(shape), err, ms, plain_ms, 10.0 * x.numel(),
                        2 * nx + 4 * c + stats, lib_ms, PEAK_F32_FLOPS))
                else:
                    st_ms = time_ms(lambda: GN.group_norm_stats(x, GN_GROUPS, GN_EPS))
                    st_plain = time_ms(lambda: GN.group_norm_moments(x, GN_GROUPS, GN_EPS),
                                       reps=5)
                    ap_ms = time_ms(lambda: GN.group_norm_apply(x, mean, rstd, scale, bias, act))
                    ap_plain = time_ms(lambda: GN.group_norm_apply_reference(
                        x, mean, rstd, scale, bias, act), reps=5)
                    stat_abs = max((mean - ref_mean).abs().max().item(),
                                   (rstd - ref_rstd).abs().max().item())
                    view = x.view(n, GN_GROUPS, -1)  # K5's statistics in one PyTorch call
                    st_lib = time_ms(lambda: torch.var_mean(view, dim=-1, correction=0))
                    e5 = _entry("group_norm_stats", list(shape), stat_abs, st_ms, st_plain,
                                3.0 * x.numel(), nx + stats, st_lib, PEAK_F32_FLOPS)
                    e6 = _entry("group_norm_apply", list(shape), err, ap_ms, ap_plain,
                                7.0 * x.numel(), 2 * nx + 4 * c + stats, None, PEAK_F32_FLOPS)
                    log(f"[kernels] group_norm {label} act=silu: K5 {st_ms:.4f} ms (plain "
                        f"{st_plain:.4f}, torch.var_mean {st_lib:.4f}, bound "
                        f"{e5['bound_ms']:.4f}), K6 {ap_ms:.4f} ms (plain "
                        f"{ap_plain:.4f}, bound {e6['bound_ms']:.4f})")
                    entries.setdefault("group_norm_stats", e5)
                    entries.setdefault("group_norm_apply", e6)
        del x, ref_mean, ref_rstd
        torch.cuda.empty_cache()


def conv_case(label, n, cin, cout, h, w, gen, dev):
    """K7 at one shape against its plain version on the same inputs, then
    the kernel's, the plain version's and cuDNN's time (`F.conv2d` on the
    pre-activated input). Bound: 2 * N * H * W * Cout * 9 * Cin tensor-core
    operations against x, w and y read or written once. Returns the JSON
    entry and whether the kernel is within CONV_TOL."""
    from diffusion_image_editing_tpu_torch.ops import fused_conv as FC

    x = _randn((n, cin, h, w), gen, dev)
    a = 1 + 0.2 * torch.randn((n, cin), generator=gen, device=dev)
    b = 0.5 * torch.randn((n, cin), generator=gen, device=dev)
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev) / (9 * cin) ** 0.5)
    wt = wt.to(torch.bfloat16)
    bias = (0.1 * torch.randn(cout, generator=gen, device=dev)).to(torch.bfloat16)
    args = (x, a, b, wt, bias)
    with torch.no_grad():
        y = FC.affine_silu_conv3x3_kernel(*args)
        ref = FC.affine_silu_conv3x3_reference(*args)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        ms = time_ms(lambda: FC.affine_silu_conv3x3_kernel(*args))
        plain_ms = time_ms(lambda: FC.affine_silu_conv3x3_reference(*args), reps=5)
        act = F.silu(x.float() * a[:, :, None, None] + b[:, :, None, None]).to(x.dtype)
        lib_ms = time_ms(lambda: F.conv2d(act, wt, bias, padding=1))
    flops = 2.0 * n * h * w * cout * 9 * cin
    nbytes = 2.0 * (x.numel() + wt.numel() + y.numel()) + 8.0 * n * cin + 2.0 * cout
    e = _entry("affine_silu_conv3x3", [n, cin, cout, h, w], err, ms, plain_ms, flops,
               nbytes, lib_ms)
    ok = rel <= CONV_TOL and math.isfinite(rel)
    log(f"[kernels] fused conv {label} x{(n, cin, h, w)} w{(cout, cin, 3, 3)}: max_abs_err "
        f"{err:.3e}, relative {rel:.3e} (tol {CONV_TOL}) {'ok' if ok else 'FAIL'} | kernel "
        f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, cuDNN conv "
        f"on the activated input {lib_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
        f"({e['bound_by']})")
    return e, ok


def _conv_kernels(gen, dev, entries, failures) -> None:
    """K7 at the path's fused-conv shapes (`conv_case`)."""
    for label, n, cin, cout, h, w in CONV_CASES:
        e, ok = conv_case(label, n, cin, cout, h, w, gen, dev)
        if not ok:
            failures.append(f"fused conv {label}")
        entries.setdefault("affine_silu_conv3x3", e)
        torch.cuda.empty_cache()


def _abn_kernels(gen, dev, entries, failures) -> None:
    """K8 at the trainer's ABN shapes, against `abn_apply_reference` on the
    same inputs. Bound: bytes (x read once, y written once, the four (C,)
    f32 vectors), against ABN_OPS f32 operations an element."""
    from diffusion_image_editing_tpu_torch.ops import abn as ABN

    acts = {"identity": lambda t: t, "leaky_relu": lambda t: F.leaky_relu(t, 0.01),
            "elu": F.elu}
    for label, shape, dtype, act in ABN_CASES:
        c = shape[1]
        x = (2.0 * torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
        mean, var = ABN.mean_var(x)
        rstd = torch.rsqrt(var + ABN_EPS)
        w = 1.0 + 0.3 * torch.randn(c, generator=gen, device=dev)
        w[::7] *= -1.0
        b = 0.2 * torch.randn(c, generator=gen, device=dev)
        args = (x, mean, rstd, w, b, act, 0.01)
        with torch.no_grad():
            y = ABN.abn_apply(*args)
            ref = ABN.abn_apply_reference(*args)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            rel = err / ref.float().abs().max().item()
            ms = time_ms(lambda: ABN.abn_apply(*args))
            plain_ms = time_ms(lambda: ABN.abn_apply_reference(*args), reps=5)
            run_var, wabs = 1.0 / (rstd * rstd) - ABN_EPS, w.abs()
            lib_ms = time_ms(lambda: acts[act](F.batch_norm(x, mean, run_var, wabs, b,
                                                            training=False, eps=ABN_EPS)))
        nbytes = 2.0 * x.numel() * x.element_size() + 16.0 * c
        e = _entry("abn_apply", list(shape), err, ms, plain_ms, ABN_OPS * x.numel(), nbytes,
                   lib_ms, PEAK_F32_FLOPS)
        tol = ABN_TOL[dtype]
        ok = rel <= tol and math.isfinite(rel)
        log(f"[kernels] abn {label} {shape} {str(dtype).removeprefix('torch.')} act={act}: "
            f"max_abs_err {err:.3e}, relative {rel:.3e} (tol {tol}) {'ok' if ok else 'FAIL'} | "
            f"kernel {ms:.4f} ms ({nbytes / ms / 1e6:.0f} GB/s), plain {plain_ms:.4f} ms, "
            f"F.batch_norm{'' if act == 'identity' else '+' + act} {lib_ms:.4f} ms, bound "
            f"{e['bound_ms']:.6f} ms ({e['bound_by']})")
        if not ok:
            failures.append(f"abn {label}")
        entries.setdefault("abn_apply", e)
        del x, y, ref
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 4. tiny
# ---------------------------------------------------------------------------


def phase_tiny() -> None:
    import copy
    import dataclasses

    from diffusion_image_editing_tpu_torch.models import (
        TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition)
    from diffusion_image_editing_tpu_torch.engine import CfgEpsClosure

    torch.manual_seed(0)
    rng = np.random.default_rng(0)
    weights = (UNet2DCondition(TINY_SD_UNET, device="cpu").state_dict(),
               AutoencoderKL(TINY_VAE, device="cpu").state_dict())
    text = torch.from_numpy(rng.standard_normal((2, 77, 32), dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 4, 16, 16), dtype=np.float32))
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32))
    z0 = torch.from_numpy(rng.standard_normal((1, 4, 16, 16), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((1, 3, 32, 32), dtype=np.float32))
    t = np.array([801, 41])
    failed = []
    for fused in (False, True):
        unet = UNet2DCondition(dataclasses.replace(TINY_SD_UNET, fused_conv=fused), device="cpu")
        vae = AutoencoderKL(dataclasses.replace(TINY_VAE, fused_conv=fused), device="cpu")
        unet.load_state_dict(weights[0])
        vae.load_state_dict(weights[1])

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
        config = "fused_conv" if fused else "default"
        for name, tol in TINY_TOL.items():
            ref = cpu[name].float()
            err = ((card[name].float().cpu() - ref).abs().max() / ref.abs().max()).item()
            ok = err <= tol
            log(f"[tiny] {config} {name}: max|card bf16 - cpu f32| / max|cpu| {err:.3e} "
                f"(tol {tol}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failed.append(f"{config} {name}")
    failed += _tiny_prompt()
    failed += _tiny_seg()
    failed += _tiny_masks()
    failed += _tiny_families()
    if failed:
        raise RuntimeError(f"tiny models on the card disagree with the CPU: {failed}")


def _tiny_prompt() -> list:
    """The TINY CLIP text encoder and a 3-step CFG generation under its
    prompt embedding, bf16 on the card against f32 on the CPU from the same
    weights, ids and x_T. Returns the names that disagree."""
    import copy

    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.models import (
        TINY_CLIP_TEXT, TINY_SD_UNET, TINY_VAE, AutoencoderKL, CLIPTextEncoder, UNet2DCondition)
    from diffusion_image_editing_tpu_torch.pipeline import SD

    torch.manual_seed(1)
    rng = np.random.default_rng(1)
    modules = (UNet2DCondition(TINY_SD_UNET, device="cpu"), AutoencoderKL(TINY_VAE, device="cpu"),
               CLIPTextEncoder(TINY_CLIP_TEXT, device="cpu"))
    ids = rng.integers(0, TINY_CLIP_TEXT.vocab_size, (2, TINY_CLIP_TEXT.max_position_embeddings))
    xt = torch.from_numpy(rng.standard_normal((1, 4, 8, 8), dtype=np.float32))
    runs = {}
    for dev, dtype in (("cpu", torch.float32), ("cuda", torch.bfloat16)):
        unet, vae, clip = (copy.deepcopy(m).to(dtype=dtype) for m in modules)
        sd = SD(unet, vae, schedule_for_model("sd", 3), clip, device=dev)
        img, _ = sd.generate_image(xt, prompt_ids=ids, num_inference_steps=3)
        runs[dev] = {"clip": sd.encode_text_ids(ids), "generate": img}
    failed = []
    for name, tol in TINY_PROMPT_TOL.items():
        ref = runs["cpu"][name].float()
        err = ((runs["cuda"][name].float().cpu() - ref).abs().max() / ref.abs().max()).item()
        ok = err <= tol and math.isfinite(err)
        log(f"[tiny] prompt {name} {tuple(ref.shape)}: max|card bf16 - cpu f32| / max|cpu| "
            f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"prompt {name}")
    return failed


class _Pinned(torch.autograd.Function):
    """Forward: the given value; backward: the gradient passed to x."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _tiny_seg(devices=(("cuda", torch.bfloat16), ("cpu", torch.float32))) -> list:
    """Segmentation guidance at the TINY sizes, the first device (the card,
    the VAE bf16) against the second (the CPU, f32), from the same weights
    and inputs: the f32 BiSeNet's first-head logits, the gradient of
    NetAttrFunc's loss at one f32 image, and one NetAttrFunc nudge through
    the TINY SD decode. The second device's decode gives the first's decoded
    image as its value and its own f32 gradient (`_Pinned`), so that both
    differentiate the BiSeNet at one image. Returns the names that
    disagree."""
    import copy

    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.guidance import NetAttrFunc
    from diffusion_image_editing_tpu_torch.models import (
        TINY_SD_UNET, TINY_VAE, AutoencoderKL, BiSeNet, SegmentationModel, UNet2DCondition)
    from diffusion_image_editing_tpu_torch.ops.resize import (
        imagenet_normalize, resize_bilinear, to_unit_range)
    from diffusion_image_editing_tpu_torch.pipeline import SD

    torch.manual_seed(2)
    rng = np.random.default_rng(2)
    modules = (BiSeNet(n_classes=19, norm="bn", width=8, device="cpu"),
               UNet2DCondition(TINY_SD_UNET, device="cpu"), AutoencoderKL(TINY_VAE, device="cpu"))
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64), dtype=np.float32))
    img = torch.from_numpy(rng.uniform(-0.9, 0.9, (1, 3, 32, 32)).astype(np.float32))
    xt, eps = (torch.from_numpy(rng.standard_normal((1, 4, 16, 16), dtype=np.float32))
               for _ in range(2))
    sched = schedule_for_model("sd", 4)
    runs, decoded = [], []
    for dev, dtype in devices:
        seg = SegmentationModel(copy.deepcopy(modules[0]).to(dev), image_size=64)
        sd = SD(*(copy.deepcopy(m).to(dtype=dtype) for m in modules[1:]), sched, device=dev)

        def seg_apply(image, seg=seg):  # the 32 px decode, resized to the BiSeNet's 64 px
            image = resize_bilinear(image.float(), 64, 64)
            return seg.logits_fn(imagenet_normalize(to_unit_range(image)))

        def decode(z, dev=dev, decode_fn=sd.decode_fn()):
            out = decode_fn(z)
            if decoded:  # the second device: the first's value, its own gradient
                return _Pinned.apply(out, decoded[0].to(dev, out.dtype))
            decoded.append(out.detach())
            return out

        attr = NetAttrFunc(loss_scale=200.0, t1=0, t2=4, seg_apply_fn=seg_apply,
                           idx_for_class=(17,))
        image = img.to(dev).requires_grad_(True)
        (seg_grad,) = torch.autograd.grad(attr.loss(image), image)
        nudged, _ = attr.apply(xt.to(dev), None, eps.to(dev), int(sd.schedule.timesteps[1]), 1,
                               sd.schedule, decode)
        runs.append({"logits": seg.logits_fn(x.to(dev)), "seg_grad": seg_grad,
                     "nudge": nudged - xt.to(dev)})
    got, ref = runs
    failed = []
    (d0, t0), (d1, t1) = ((d, str(t).removeprefix("torch.")) for d, t in devices)
    for name, tol in TINY_SEG_TOL.items():
        want = ref[name].float().cpu()
        err = ((got[name].float().cpu() - want).abs().max() / want.abs().max()).item()
        ok = err <= tol and math.isfinite(err)
        log(f"[tiny] seg {name} {tuple(want.shape)}: max|{d0} {t0} - {d1} {t1}| / max|{d1}| "
            f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"seg {name}")
    return failed


def parsing_map(size: int, seed: int) -> np.ndarray:
    """A face-parsing-like (size, size) map of the 19 classes: random
    classes in 8-pixel cells, a disc of class 17 (hair) reaching the top
    border, a smaller disc of class 1."""
    rng = np.random.default_rng(seed)
    cells = rng.integers(0, 19, (size // 8 + 1, size // 8 + 1))
    out = np.kron(cells, np.ones((8, 8), np.int64))[:size, :size]
    yy, xx = np.mgrid[:size, :size]
    out[(yy - 0.1 * size) ** 2 + (xx - 0.6 * size) ** 2 < (0.35 * size) ** 2] = 17
    out[(yy - 0.7 * size) ** 2 + (xx - 0.3 * size) ** 2 < (0.15 * size) ** 2] = 1
    return out


def _tiny_masks(dev=torch.device("cuda")) -> list:
    """Class masks made on the card and on the CPU from the same parsing
    map must be bit-equal: at the path's 512 -> 64 and at a factor that is
    not a power of two, with and without dilation, one class and three."""
    from diffusion_image_editing_tpu_torch.pipeline import MaskCreator

    failed = []
    for size, out in ((512, 64), (100, 37)):
        parsing = torch.from_numpy(parsing_map(size, size))
        for dilate, classes in itertools.product((False, True), ((17,), (17, 1, 4))):
            creator = MaskCreator(dilate_mask=dilate, resize_size=(out, out))
            cpu = creator.create_mask(parsing, classes)
            card = creator.create_mask(parsing.to(dev), classes).cpu()
            same = torch.equal(card, cpu)
            log(f"[tiny] mask {size} -> {out} classes {classes} dilate {dilate}: coverage "
                f"{cpu[0, 0].mean().item():.4f}, {dev.type} and cpu bit-equal {same} "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                failed.append(f"mask {size}->{out} {classes} dilate {dilate}")
    return failed


def _tiny_families(devices=(("cuda", torch.bfloat16), ("cpu", torch.float32))) -> list:
    """The DDPM / LDM pieces at the TINY sizes, the first device (the card,
    bf16 models) against the second (the CPU, f32), from the same weights and
    inputs: TINY_UNET2D's eps (its single 64-wide head on K1-K3's narrow
    design), the TINY VQ model's encode, its codes (an agreement rate: an
    argmin near a tie may go either way between bf16 and f32 latents), its
    quantizing decode and that decode's gradient, the width-8 ResNet-50's f32
    logits, and one ClassifierAttrFunc nudge through the TINY LDM's decode,
    the second device's decode pinned to the first's decoded image
    (`_Pinned`, as `_tiny_seg`). The codebook holds bf16 values, so that
    both devices quantize one latent to the same codes. Returns the names
    that disagree."""
    import copy

    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.guidance import ClassifierAttrFunc
    from diffusion_image_editing_tpu_torch.models import (
        TINY_UNET2D, TINY_VQVAE, ResNet50, UNet2D, VQModel)
    from diffusion_image_editing_tpu_torch.pipeline import LDM

    torch.manual_seed(3)
    rng = np.random.default_rng(3)
    unet = UNet2D(TINY_UNET2D, device="cpu")
    vq = VQModel(TINY_VQVAE, device="cpu")
    codebook = vq.quantize.embedding.weight
    with torch.no_grad():
        codebook.copy_(codebook.to(torch.bfloat16).float())
    clf = ResNet50(width=8, device="cpu").eval()
    x = torch.from_numpy(rng.standard_normal((2, 3, 16, 16), dtype=np.float32))
    t = np.array([801, 41])
    img = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
    z0 = codebook.detach()[torch.from_numpy(rng.integers(0, 64, (1, 16, 16)))].permute(0, 3, 1, 2)
    wgt = torch.from_numpy(rng.standard_normal((1, 3, 32, 32), dtype=np.float32))
    xt, eps = (torch.from_numpy(rng.standard_normal((1, 3, 16, 16), dtype=np.float32))
               for _ in range(2))
    sched = schedule_for_model("ldm", 4, clip_sample=False)
    runs, decoded = [], []
    for dev, dtype in devices:
        ldm = LDM(copy.deepcopy(unet).to(dtype=dtype), sched,
                  copy.deepcopy(vq).to(dtype=dtype), device=dev)
        net = copy.deepcopy(clf).to(dev)
        with torch.no_grad():
            eps_out = ldm.eps_fn()(x.to(dev), t)
            latent = ldm.encode(img)
            codes = ldm.vqvae.quantize.indices(latent)
            logits = net(img.to(dev))
        z = z0.to(dev).requires_grad_(True)
        dec = ldm.decode_fn()(z)
        (vjp,) = torch.autograd.grad((dec.float() * wgt.to(dev)).sum(), z)

        def decode(zz, dev=dev, decode_fn=ldm.decode_fn()):
            out = decode_fn(zz)
            if decoded:  # the second device: the first's value, its own gradient
                return _Pinned.apply(out, decoded[0].to(dev, out.dtype))
            decoded.append(out.detach())
            return out

        attr = ClassifierAttrFunc(loss_scale=50.0, t1=0, t2=4, clf_apply_fn=clf_logits_fn(net),
                                  idx_for_class=20, idx_of_interest=1)
        nudged, _ = attr.apply(xt.to(dev), None, eps.to(dev), int(sched.timesteps[1]), 1, sched,
                               decode)
        runs.append({"eps": eps_out, "latent": latent, "codes": codes, "decode": dec.detach(),
                     "decode_vjp": vjp, "logits": logits, "nudge": nudged - xt.to(dev)})
    got, ref = runs
    failed = []
    (d0, t0), (d1, t1) = ((d, str(t).removeprefix("torch.")) for d, t in devices)
    for name, tol in TINY_FAMILY_TOL.items():
        want = ref[name].cpu()
        if name == "codes":
            agree = (got[name].cpu() == want).float().mean().item()
            ok = agree >= tol
            log(f"[tiny] families codes {tuple(want.shape)}: {d0} {t0} and {d1} {t1} pick the "
                f"same code at {agree:.4f} of the latent (at least {tol}) "
                f"{'ok' if ok else 'FAIL'}")
        else:
            want = want.float()
            err = ((got[name].float().cpu() - want).abs().max() / want.abs().max()).item()
            ok = err <= tol and math.isfinite(err)
            log(f"[tiny] families {name} {tuple(want.shape)}: max|{d0} {t0} - {d1} {t1}| / "
                f"max|{d1}| {err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"families {name}")
    return failed


def phase_seg_tiny(devices=("cpu", "cuda")) -> None:
    """Two train steps of a tiny BiSeNet with norm="abn" on each device, from
    the same weights (drawn on the CPU) and the same uint8 batches."""
    from diffusion_image_editing_tpu_torch.seg import (
        SyntheticFaceMask, TrainConfig, batch_iterator, create_train_state, make_train_step)

    cfg = TrainConfig(**SEG_TINY)
    feed = batch_iterator(SyntheticFaceMask(n=8, size=cfg.image_size, raw=True),
                          cfg.batch_size_per_device, seed=0)
    batches = list(itertools.islice(feed, 2))
    runs = []
    for dev in devices:
        model, state = create_train_state(cfg, 0, dev)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        step = make_train_step(model, cfg)
        losses = [float(step(state, *batch)[1]) for batch in batches]
        runs.append((losses, {k: v.detach().cpu() for k, v in model.state_dict().items()}))
    (ref_losses, ref), (losses, got) = runs
    weights = [k for k in ref if k.rsplit(".", 1)[1] in ("weight", "bias")]
    stats = [k for k in ref if k.rsplit(".", 1)[1] in ("running_mean", "running_var")]
    update = max((ref[k] - start[k]).abs().max().item() for k in weights)
    errs = {
        "loss": max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)),
        "weights": max((got[k] - ref[k]).abs().max().item() for k in weights) / update,
        "stats": max(((got[k] - ref[k]).abs().max() / ref[k].abs().max()).item()
                     for k in stats),
    }
    ok = all(errs[k] <= SEG_TINY_TOL[k] for k in errs) and len(stats) == 2 * SEG_NORMS
    log(f"[seg-tiny] BiSeNet abn width {cfg.width}, {cfg.image_size} px, batch "
        f"{cfg.batch_size_per_device}, 2 steps, {devices[1]} vs {devices[0]}: losses "
        f"{losses} vs {ref_losses}, max relative {errs['loss']:.2e} (tol {SEG_TINY_TOL['loss']}); "
        f"weights max |diff| {errs['weights']:.2e} of the largest update {update:.3e} (tol "
        f"{SEG_TINY_TOL['weights']}); running stats {errs['stats']:.2e} (tol "
        f"{SEG_TINY_TOL['stats']}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError(f"the tiny trainer on {devices[1]} disagrees with {devices[0]}: {errs}")


# ---------------------------------------------------------------------------
# 5. main path and 6. fused
# ---------------------------------------------------------------------------

STEPS, T_SKIP, CHUNK = 50, 10, 10
GUIDED = STEPS - T_SKIP
UNET_CALLS = math.ceil((STEPS - T_SKIP) / CHUNK) + GUIDED  # inversion groups + guided steps
DECODES, ENCODES = GUIDED + 1, 1  # one decode per guided step's gradient, the final decode


def build_models(dev, fused: bool = False, weights=None):
    """SD-1.5 UNet + SD VAE, bf16, seeded random weights (or the given state
    dicts), in the default or the fused-conv configuration."""
    import dataclasses

    from diffusion_image_editing_tpu_torch.models import (
        SD15_UNET, SD_VAE, AutoencoderKL, UNet2DCondition)

    torch.manual_seed(0)
    unet = UNet2DCondition(dataclasses.replace(SD15_UNET, fused_conv=fused), device=dev,
                           dtype=torch.bfloat16)
    vae = AutoencoderKL(dataclasses.replace(SD_VAE, fused_conv=fused), device=dev,
                        dtype=torch.bfloat16)
    if weights is not None:
        unet.load_state_dict(weights[0])
        vae.load_state_dict(weights[1])
    return unet, vae


def fixed_text_sd(unet, vae, sched, text_emb, dev):
    """The port's `SD` with a fixed [uncond; cond] embedding in place of CLIP
    (no text weights here), as bench.py's wrapper: every `prep_text` call,
    `prep_text(None)` included, returns it, so the UNet runs CFG at batch 2."""
    from diffusion_image_editing_tpu_torch.pipeline import SD

    class FixedTextSD(SD):
        def prep_text(self, prompt_ids=None):
            return fixed

    sd = FixedTextSD(unet, vae, sched, device=dev)
    fixed = text_emb.to(sd.device)
    return sd


def make_pipeline(unet, vae, dev):
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline

    rng = np.random.default_rng(0)
    text_emb = torch.from_numpy(
        rng.standard_normal((2, 77, unet.config.cross_attention_dim), dtype=np.float32))
    size = vae.config.sample_size
    img = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, 3, size, size)).astype(np.float32))
    sd = fixed_text_sd(unet, vae, schedule_for_model("sd", STEPS), text_emb.to(torch.bfloat16),
                       dev)
    return sd, EditPipeline(sd), img


def forward_pieces(sd, dev):
    """One CFG UNet call, one decode and its latent gradient, one encode, on
    fixed inputs; each returns its output."""
    cfg = sd.vae.config
    size, lat = cfg.sample_size, cfg.sample_size // 2 ** (len(cfg.block_out_channels) - 1)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 4, lat, lat), dtype=np.float32)).to(dev)
    z = torch.from_numpy(rng.standard_normal((1, 4, lat, lat), dtype=np.float32)).to(dev)
    wgt = torch.from_numpy(rng.standard_normal((1, 3, size, size), dtype=np.float32)).to(dev)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 3, size, size)).astype(np.float32)).to(dev)

    def eps():
        return sd.eps_fn(sd.prep_text(None))(x, np.array([501]))

    def decode():
        zz = z.clone().requires_grad_(True)
        decoded = sd.decode_fn()(zz)
        (vjp,) = torch.autograd.grad((decoded.float() * wgt).sum(), zz)
        return decoded.detach(), vjp

    def encode():
        return sd.encode(img)

    return {"eps": eps, "decode": decode, "encode": encode}


def per_forward_launches(pieces) -> dict:
    """Kernel launches of one UNet call, one decode (with its gradient) and
    one encode, each counted alone."""
    from diffusion_image_editing_tpu_torch import ops

    out = {}
    for name, fn in pieces.items():
        ops.reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        out[name] = ops.launch_counts()
    return out


def implied_launches(per: dict, unet_calls: int, grad_decodes: int, decodes: int,
                     encodes: int) -> dict:
    """What a run implies from the per-forward launches: `unet_calls` UNet
    calls, `decodes` decodes (`grad_decodes` of them with a gradient),
    `encodes` encodes. A decode without a gradient launches the same forward
    kernels; its backward kernels are taken off."""
    total = {k: unet_calls * per["eps"][k] + decodes * per["decode"][k]
             + encodes * per["encode"][k] for k in per["eps"]}
    for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        total[k] -= (decodes - grad_decodes) * per["decode"][k]
    return total


def path_launches(per: dict) -> dict:
    """The [main] and [fused] runs: UNET_CALLS UNet calls, DECODES decodes
    (GUIDED of them with a gradient; the final decode has none), ENCODES
    encodes."""
    return implied_launches(per, UNET_CALLS, GUIDED, DECODES, ENCODES)


def count_modules(module, cls) -> int:
    return sum(isinstance(m, cls) for m in module.modules())


def plain_groupnorm_watch():
    """Counts calls of `F.group_norm` and of the port's plain GroupNorm
    functions on CUDA tensors while the block runs."""
    from diffusion_image_editing_tpu_torch.ops import groupnorm as GN

    return plain_watch([(F, "group_norm"), (GN, "group_norm_reference"),
                        (GN, "group_norm_moments"), (GN, "group_norm_apply_reference")])


def plain_abn_watch():
    """Counts calls of K8's plain version and of `F.batch_norm` on CUDA
    tensors while the block runs."""
    from diffusion_image_editing_tpu_torch.ops import abn as ABN

    return plain_watch([(ABN, "abn_apply_reference"), (F, "batch_norm")])


def plain_attention_watch():
    """Counts calls of the plain attention and of SDPA on CUDA tensors while
    the block runs; causal calls (CLIP's, plain by design) apart."""
    from diffusion_image_editing_tpu_torch.ops import attention as A

    return plain_watch([(A, "attention_reference"), (F, "scaled_dot_product_attention")])


@contextlib.contextmanager
def plain_watch(targets):
    """Counts the calls of each (module, function name) whose first argument
    is a CUDA tensor while the block runs; calls with `causal=True` count
    under "<name> causal"."""
    calls = {name: 0 for _, name in targets}
    originals = [getattr(mod, name) for mod, name in targets]

    def counting(name, fn):
        def wrapper(x, *args, **kwargs):
            if x.is_cuda:
                key = f"{name} causal" if kwargs.get("causal") else name
                calls[key] = calls.get(key, 0) + 1
            return fn(x, *args, **kwargs)
        return wrapper

    for (mod, name), fn in zip(targets, originals):
        setattr(mod, name, counting(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(targets, originals):
            setattr(mod, name, fn)


def run_path(pipe, img, dev):
    """Inversion + GUIDED colour-guided steps + final decode; returns the
    output and the inversion's and the edit's seconds."""
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)
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
    return out, t_inv - t_start, time.perf_counter() - t_inv


def counted_run(tag, pipe, img, dev, smi):
    """A warm-up run, then one run with every launch count set to 0 just
    before it and read just after; checks the image. Returns the counts and
    the plain GroupNorm calls on the card during the counted run."""
    from diffusion_image_editing_tpu_torch import ops

    run_path(pipe, img, dev)  # warm-up: first-call library set-up stays out of the timed run
    torch.cuda.reset_peak_memory_stats()
    with plain_groupnorm_watch() as plain_calls:
        ops.reset_launch_counts()
        out, inv_s, edit_s = run_path(pipe, img, dev)
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] e2e {inv_s + edit_s:.3f} s (inversion {inv_s:.3f} s, {GUIDED} guided steps "
        f"{edit_s:.3f} s = {GUIDED / edit_s:.3f} steps/s), peak memory "
        f"{peak / 2**30:.2f} GiB, on {smi}")
    imgs = out.imgs
    finite = bool(torch.isfinite(imgs).all())
    log(f"[{tag}] image {tuple(imgs.shape)} {imgs.dtype}, finite {finite}, "
        f"range [{imgs.min().item():.3f}, {imgs.max().item():.3f}], "
        f"red mean {imgs[:, 0].float().mean().item():.4f}")
    size = pipe.diffusion_wrapper.vae.config.sample_size
    if not finite or tuple(imgs.shape) != (1, 3, size, size):
        raise RuntimeError(f"{tag} path output is not a finite (1, 3, {size}, {size}) image")
    return counts, dict(plain_calls)


def check_counts(tag, counts, expected, plain_calls) -> None:
    log(f"[{tag}] launches {counts}")
    log(f"[{tag}] expected {expected}; plain GroupNorm calls on the card {plain_calls}")
    if counts != expected:
        raise RuntimeError(f"{tag}: launch counts {counts} differ from the path's {expected}")
    if any(plain_calls.values()):
        raise RuntimeError(f"{tag}: a plain GroupNorm ran on the card: {plain_calls}")


def phase_main_path(smi: str, unet, vae) -> dict:
    """Returns each kernel's launch count from one counted run."""
    from diffusion_image_editing_tpu_torch.models.layers import GroupNormLayer

    dev = next(unet.parameters()).device
    sd, pipe, img = make_pipeline(unet, vae, dev)
    n_params = sum(p.numel() for m in (unet, vae) for p in m.parameters())
    log(f"[main] SD-1.5 UNet + SD VAE, {n_params / 1e6:.1f} M parameters, bf16, seeded random "
        f"weights, default configuration")

    per = per_forward_launches(forward_pieces(sd, dev))
    expected = path_launches(per)
    gn = {"eps": count_modules(unet, GroupNormLayer),
          "decode": count_modules(vae.decoder, GroupNormLayer),
          "encode": count_modules(vae.encoder, GroupNormLayer)}
    gn_calls = UNET_CALLS * gn["eps"] + DECODES * gn["decode"] + ENCODES * gn["encode"]
    log(f"[main] GroupNorm layers: UNet {gn['eps']}, decoder {gn['decode']}, encoder "
        f"{gn['encode']}; the path calls them {UNET_CALLS} x {gn['eps']} + {DECODES} x "
        f"{gn['decode']} + {ENCODES} x {gn['encode']} = {gn_calls} times")
    for piece, n_gn in gn.items():
        c = per[piece]
        log(f"[main] one {piece}: {c}")
        if c["group_norm_fused"] + c["group_norm_stats"] != n_gn or (
                c["group_norm_stats"] != c["group_norm_apply"]):
            raise RuntimeError(f"one {piece} ran {c} GroupNorm kernels for {n_gn} layers")
    attn = {"flash_attn_fwd": 2 * unet.config.num_transformers * UNET_CALLS + 2 + GUIDED,
            "flash_attn_bwd_dq": GUIDED, "flash_attn_bwd_dkv": GUIDED}
    if any(expected[k] != v for k, v in attn.items()) or expected["affine_silu_conv3x3"]:
        raise RuntimeError(f"per-forward launches {expected} do not give the attention "
                           f"counts {attn} and no fused conv")

    counts, plain_calls = counted_run("main", pipe, img, dev, smi)
    check_counts("main", counts, expected, plain_calls)
    log(f"[main] GroupNorm forwards through the kernels: K4 {counts['group_norm_fused']} + "
        f"K5/K6 {counts['group_norm_stats']} = "
        f"{counts['group_norm_fused'] + counts['group_norm_stats']} (path: {gn_calls})")
    return counts


def phase_fused(smi: str, unet, vae) -> dict:
    """The fused-conv configuration with the default models' weights."""
    from diffusion_image_editing_tpu_torch.models.layers import GroupNormLayer, ResnetBlock2D

    dev = next(unet.parameters()).device
    funet, fvae = build_models(dev, fused=True, weights=(unet.state_dict(), vae.state_dict()))
    sd, _, _ = make_pipeline(unet, vae, dev)
    fsd, fpipe, img = make_pipeline(funet, fvae, dev)

    pieces, fpieces = forward_pieces(sd, dev), forward_pieces(fsd, dev)
    eps, feps = pieces["eps"](), fpieces["eps"]()
    (dec, vjp), (fdec, fvjp) = pieces["decode"](), fpieces["decode"]()
    failed = []
    for name, ref, got in (("eps", eps, feps), ("decode", dec, fdec),
                           ("decode_vjp", vjp, fvjp)):
        err = ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()
        ok = err <= FUSED_TOL[name] and math.isfinite(err)
        log(f"[fused] {name}: max|fused - default| / max|default| {err:.3e} "
            f"(tol {FUSED_TOL[name]}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(name)
    if failed:
        raise RuntimeError(f"fused-conv configuration disagrees with the default: {failed}")
    del eps, feps, dec, vjp, fdec, fvjp, sd, pieces

    per = per_forward_launches(fpieces)
    expected = path_launches(per)
    blocks = {"eps": count_modules(funet, ResnetBlock2D),
              "decode": count_modules(fvae.decoder, ResnetBlock2D),
              "encode": count_modules(fvae.encoder, ResnetBlock2D)}
    gn = {"eps": count_modules(funet, GroupNormLayer),
          "decode": count_modules(fvae.decoder, GroupNormLayer),
          "encode": count_modules(fvae.encoder, GroupNormLayer)}
    for piece, c in per.items():
        n_gn = c["group_norm_fused"] + c["group_norm_stats"]
        log(f"[fused] one {piece}: {c['affine_silu_conv3x3']} fused convs (of "
            f"{2 * blocks[piece]} ResnetBlock convs), {n_gn} GroupNorms (of {gn[piece]} layers)")
        if n_gn + c["affine_silu_conv3x3"] != gn[piece]:
            raise RuntimeError(f"one {piece}: fused convs and GroupNorms do not cover the "
                               f"{gn[piece]} GroupNorm layers: {c}")
    log(f"[fused] the path implies {UNET_CALLS} x {per['eps']['affine_silu_conv3x3']} + "
        f"{DECODES} x {per['decode']['affine_silu_conv3x3']} + {ENCODES} x "
        f"{per['encode']['affine_silu_conv3x3']} = {expected['affine_silu_conv3x3']} fused convs "
        f"and {expected['group_norm_fused'] + expected['group_norm_stats']} GroupNorms")
    if expected["affine_silu_conv3x3"] == 0:
        raise RuntimeError("the fused-conv configuration fuses no conv")

    counts, plain_calls = counted_run("fused", fpipe, img, dev, smi)
    check_counts("fused", counts, expected, plain_calls)
    # K7 reads packed copies of the frozen weights: each is packed once, in
    # the warm-up run, and served from the cache from then on.
    from diffusion_image_editing_tpu_torch.ops import fused_conv as FC

    packed = FC.packed_weight
    log(f"[fused] packed weights: {len(FC._PACKED)} tensors, "
        f"{FC.packed_weight_bytes() / 2**20:.1f} MiB beside the models' own, packed "
        f"{packed.misses} times and served {packed.hits} times since the program began")
    misses = packed.misses
    fpieces["eps"]()
    if packed.misses != misses:
        raise RuntimeError("a frozen weight was packed again after the warm-up run")
    return counts


# ---------------------------------------------------------------------------
# 7. seg_edit
# ---------------------------------------------------------------------------

SEG_CLASS = 17  # hair, bench.py's e2e_seg class
SEG_LOSS_SCALE = 200.0
SEG_COVERAGE = (0.01, 0.99)  # bounds on the mask's share of the latent


def write_seg_checkpoint(path: str, image, lat: int, dev) -> tuple:
    """A face-parsing BiSeNet (ResNet-18, width 64, 19 classes, norm="bn",
    f32) from seeded random weights, saved as the published checkpoint is
    (`{"state_dict": {"module." + key: tensor}}`). One stated choice of the
    weights: channel 0 of the main head's hidden layer is made the constant
    1 (its norm's weight 0, bias 1), read by class 17 alone, so that its
    weight there raises class 17's logit by a constant. The raise is the
    quantile of class 17's margin on `image` (at the BiSeNet's 512 px) whose
    hair mask at the latent's `lat` x `lat` covers nearest half the latent:
    random weights alone may leave class 17 nowhere. Returns (the state dict written, on the CPU; the raise;
    the coverage it was chosen for)."""
    from diffusion_image_editing_tpu_torch.models import BiSeNet
    from diffusion_image_editing_tpu_torch.ops.resize import (
        imagenet_normalize, resize_bilinear, to_unit_range)
    from diffusion_image_editing_tpu_torch.pipeline import MaskCreator

    torch.manual_seed(11)
    model = BiSeNet(n_classes=19, norm="bn", width=64, device=dev).eval()
    head = model.conv_out
    with torch.no_grad():
        head.conv.bn.weight[0] = 0.0
        head.conv.bn.bias[0] = 1.0
        head.conv_out.weight[:, 0] = 0.0
        x = resize_bilinear(image.to(dev), 512, 512)
        logits = model(imagenet_normalize(to_unit_range(x)))[0][0]
        others = torch.cat([logits[:SEG_CLASS], logits[SEG_CLASS + 1:]]).amax(dim=0)
        margin = (others - logits[SEG_CLASS]).flatten()
        creator = MaskCreator(dilate_mask=False, resize_size=(lat, lat))
        choices = []
        for q in (0.5, 0.6, 0.7, 0.8, 0.9, 0.95, 0.97, 0.99):
            raise_ = torch.quantile(margin, q).item()
            parsing = torch.where(margin.view(logits.shape[1:]) < raise_, SEG_CLASS, 0)
            cover = creator.create_mask(parsing, [SEG_CLASS])[0, 0].mean().item()
            choices.append((abs(cover - 0.5), raise_, cover))
        _, raise_, cover = min(choices)
        head.conv_out.weight[SEG_CLASS, 0] = raise_
    written = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({"state_dict": {"module." + k: v for k, v in written.items()}}, path)
    return written, raise_, cover


def phase_seg_edit(smi: str, unet, vae) -> dict:
    """bench.py's e2e_seg workload on the [main] models, face alignment
    left out: BiSeNet parsing of a random 512 px image -> hair mask ->
    encode -> edit-friendly DDPM inversion (batched, chunk 10, t_skip 10)
    -> the masked, resynthesized edit with 40 NetAttrFunc-guided steps, each
    with a gradient through the full VAE decoder and the BiSeNet -> decode.
    Returns the launch counts of the run."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.guidance import NetAttrFunc
    from diffusion_image_editing_tpu_torch.ops.resize import imagenet_normalize, to_unit_range
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline, create_segmentation_model

    dev = next(unet.parameters()).device
    sd, _, img = make_pipeline(unet, vae, dev)
    with tempfile.TemporaryDirectory(prefix="seg_ckpt_") as root:
        path = os.path.join(root, "79999_iter.pth")
        written, raise_, cover = write_seg_checkpoint(path, img, sd.data_dimensionality, dev)
        t0 = time.perf_counter()
        seg = create_segmentation_model(path, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    state = seg.module.state_dict()
    if set(state) != set(written) or not all(
            v.dtype == written[k].dtype and torch.equal(v.cpu(), written[k])
            for k, v in state.items()):
        raise RuntimeError("[seg_edit] the loaded BiSeNet is not the checkpoint written")
    n_params = sum(p.numel() for p in seg.module.parameters())
    log(f"[seg_edit] BiSeNet width 64, 19 classes, norm bn, f32, {n_params / 1e6:.1f} M "
        f"parameters, seeded random weights with class {SEG_CLASS}'s logit raised by "
        f"{raise_:.4f} (chosen for a coverage of {cover:.4f}); written as a face-parsing "
        f"checkpoint and loaded by create_segmentation_model in {load_s:.3f} s, {len(state)} "
        f"tensors bit-equal to those written")

    def seg_apply(image):  # bench.py:350-354
        return seg.logits_fn(imagenet_normalize(to_unit_range(image.float())))

    attr = NetAttrFunc(loss_scale=SEG_LOSS_SCALE, t1=0, t2=STEPS, seg_apply_fn=seg_apply,
                       idx_for_class=(SEG_CLASS,))
    pipe = EditPipeline(sd, segmentation_fn=seg)
    prepare = pipe.prepare_for_edit
    prep_s = []

    def timed_prepare(*args, **kwargs):  # segment + mask + encode, inside the inversion call
        t = time.perf_counter()
        out = prepare(*args, **kwargs)
        torch.cuda.synchronize()
        prep_s.append(time.perf_counter() - t)
        return out

    pipe.prepare_for_edit = timed_prepare
    expected = path_launches(per_forward_launches(forward_pieces(sd, dev)))

    def edit(attr_func):
        return pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, mask=mask, attr_func=attr_func,
                               inversion_method="ddpm", t_skip=T_SKIP, resynthesize=True,
                               generator=torch.Generator(device=dev).manual_seed(9),
                               collect=False, mode="split")

    torch.cuda.reset_peak_memory_stats()
    with plain_groupnorm_watch() as gn_calls, plain_attention_watch() as attn_calls, \
            plain_abn_watch() as abn_calls:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        xt, zs, xts, mask, parsing = pipe.prepare_real_image_edit(
            img, eta=1.0, inversion_method="ddpm", classes=[SEG_CLASS], mode="batched",
            t_skip=T_SKIP, chunk=CHUNK, generator=torch.Generator(device=dev).manual_seed(5))
        torch.cuda.synchronize()
        t_inv = time.perf_counter()
        out = edit(attr)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    inv_s, edit_s = t_inv - t0 - prep_s[0], t_end - t_inv
    log(f"[seg_edit] segment + mask + encode {prep_s[0]:.3f} s, inversion {inv_s:.3f} s, "
        f"{GUIDED} NetAttrFunc-guided steps {edit_s:.3f} s = {GUIDED / edit_s:.3f} steps/s, whole "
        f"run {t_end - t0:.3f} s, peak memory {peak / 2**30:.2f} GiB, on {smi}")
    plain = {k: v for k, v in {**gn_calls, **attn_calls, **abn_calls}.items()
             if not k.endswith("causal")}
    log(f"[seg_edit] launches {counts}")
    log(f"[seg_edit] expected {expected} (the [main] path's: BiSeNet runs no kernel); plain "
        f"attention, GroupNorm and ABN calls on the card {plain}")
    if counts != expected:
        raise RuntimeError(f"[seg_edit] launch counts {counts} differ from the path's {expected}")
    if any(plain.values()):
        raise RuntimeError(f"[seg_edit] a plain attention, GroupNorm or ABN ran on the card: "
                           f"{plain}")

    lat = sd.data_dimensionality
    coverage = mask[:, 0].float().mean().item()
    hair = (parsing == SEG_CLASS).float().mean().item()
    log(f"[seg_edit] parsing map {tuple(parsing.shape)}: class {SEG_CLASS} on {hair:.4f} of it; "
        f"mask {tuple(mask.shape)} covers {coverage:.4f} of the latent (bounds {SEG_COVERAGE}), "
        f"alpha channel all ones {bool((mask[:, 3] == 1).all())}")
    if tuple(mask.shape) != (1, 4, lat, lat) or not bool((mask[:, 3] == 1).all()) or not (
            SEG_COVERAGE[0] <= coverage <= SEG_COVERAGE[1]):
        raise RuntimeError(f"[seg_edit] the mask {tuple(mask.shape)} covers {coverage:.4f}")
    imgs = out.imgs
    size = vae.config.sample_size
    finite = bool(torch.isfinite(imgs).all())
    unguided = edit(None).imgs
    moved = (imgs.float() - unguided.float()).abs().max().item()
    with torch.no_grad():
        mass = [attr.loss(x).item() for x in (imgs, unguided)]
    log(f"[seg_edit] image {tuple(imgs.shape)} {imgs.dtype}, finite {finite}, range "
        f"[{imgs.min().item():.3f}, {imgs.max().item():.3f}]; max |guided - unguided| {moved:.4f} "
        f"(the same inversion, mask and noise); class {SEG_CLASS} mass guided {mass[0]:.5f}, "
        f"unguided {mass[1]:.5f}")
    if not finite or tuple(imgs.shape) != (1, 3, size, size) or not moved > 0:
        raise RuntimeError("[seg_edit] the edit is not a finite image that the guidance moved")
    return counts


# ---------------------------------------------------------------------------
# 8. prompt
# ---------------------------------------------------------------------------

PROMPT = "a photo of the red cat"
CFG = 3.5
MODE_STEPS = 5  # guided steps of the rerun check
# Both edit modes run one loop (`engine.edit.edit`), so a "split" run beside
# the "fused" one from the same inputs and noise is a rerun of that loop.
# Its bound, max|rerun - run| / max|run| of the image, the eps and the pred-x0
# traces: cuDNN may pick a non-deterministic algorithm (the decoder's
# gradient runs convolution backwards), and then the reruns differ in the
# last bits of each step, compounded over the steps. Bit-equality is printed
# beside it.
RERUN_TOL = 2e-2
# A synthetic CLIP vocabulary: every byte, every byte ending a word, the
# merges below and the two special tokens (no real vocabulary is in the repo).
MERGES = [("p", "h"), ("ph", "o"), ("pho", "to</w>"), ("t", "o</w>"), ("t", "h"),
          ("th", "e</w>"), ("r", "e"), ("re", "d</w>"), ("c", "a"), ("ca", "t</w>"),
          ("o", "f</w>")]


def write_tokenizer(path: str) -> int:
    """An HF tokenizer directory (vocab.json + merges.txt); returns its size."""
    from diffusion_image_editing_tpu_torch.host.tokenizer import bytes_to_unicode

    byte_vocab = list(bytes_to_unicode().values())
    tokens = byte_vocab + [v + "</w>" for v in byte_vocab]
    tokens += ["".join(m) for m in MERGES] + ["<|startoftext|>", "<|endoftext|>"]
    os.makedirs(path)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump({t: i for i, t in enumerate(tokens)}, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES) + "\n")
    return len(tokens)


def write_components(root: str, parts, seed: int, dev) -> tuple:
    """HF-layout component directories under `root` from seeded random bf16
    weights, one for each (subdirectory, module class, config, legacy
    attention names) of `parts`. Returns ({subdirectory: the state dict
    written, on the CPU}, bytes of weights)."""
    from diffusion_image_editing_tpu_torch.models.port import save_checkpoint_dir

    torch.manual_seed(seed)
    written, nbytes = {}, 0
    for sub, cls, cfg, legacy in parts:
        module = cls(cfg, device=dev, dtype=torch.bfloat16)
        nbytes += save_checkpoint_dir(module, os.path.join(root, sub),
                                      legacy_attention_names=legacy)
        written[sub] = {k: v.cpu() for k, v in module.state_dict().items()}
        del module
    torch.cuda.empty_cache()
    return written, nbytes


def write_sd_checkpoint(root: str, dev) -> tuple:
    """An HF-layout SD-1.5 directory: unet/, vae/ (attention under the legacy
    names), text_encoder/ (CLIP ViT-L/14), tokenizer/ (`write_components`)."""
    from diffusion_image_editing_tpu_torch.models import (
        CLIP_VIT_L_14_TEXT, SD15_UNET, SD_VAE, AutoencoderKL, CLIPTextEncoder, UNet2DCondition)

    out = write_components(root, (("unet", UNet2DCondition, SD15_UNET, False),
                                  ("vae", AutoencoderKL, SD_VAE, True),
                                  ("text_encoder", CLIPTextEncoder, CLIP_VIT_L_14_TEXT, False)),
                           7, dev)
    write_tokenizer(os.path.join(root, "tokenizer"))
    return out


def check_loaded(tag: str, modules: dict, written: dict) -> int:
    """Every tensor of each loaded module against the one written; returns
    the number of tensors."""
    n = 0
    for sub, module in modules.items():
        state = module.state_dict()
        if set(state) != set(written[sub]):
            raise RuntimeError(f"[{tag}] {sub}: loaded keys differ from the written ones")
        for k, v in state.items():
            want = written[sub][k]
            if v.dtype != want.dtype or not torch.equal(v.cpu(), want):
                raise RuntimeError(f"[{tag}] {sub}.{k} is not the tensor written")
            n += 1
    return n


@contextlib.contextmanager
def counted_block(label: str, expected: dict):
    """Every launch count set to 0 just before the block and read just
    after, while plain attention (CLIP's causal one apart), GroupNorm and ABN
    are watched on the card; checks the counts against `expected` and that no
    plain version ran. Yields a dict that holds "seconds" and "counts" once
    the block has ended."""
    from diffusion_image_editing_tpu_torch import ops

    run = {}
    with plain_groupnorm_watch() as gn_calls, plain_attention_watch() as attn_calls, \
            plain_abn_watch() as abn_calls:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        yield run
        torch.cuda.synchronize()
        run["seconds"] = time.perf_counter() - t0
        run["counts"] = counts = ops.launch_counts()
    plain = {k: v for k, v in {**gn_calls, **attn_calls, **abn_calls}.items()
             if not k.endswith("causal")}
    log(f"{label} {run['seconds']:.3f} s; launches {counts}")
    log(f"{label} expected {expected}; plain attention, GroupNorm and ABN calls on the card "
        f"{plain}, causal attentions {attn_calls.get('attention_reference causal', 0)}")
    if counts != expected:
        raise RuntimeError(f"{label}: launch counts {counts} differ from {expected}")
    if any(plain.values()):
        raise RuntimeError(f"{label}: a plain attention, GroupNorm or ABN ran on the card: {plain}")


def counted(tag: str, fn, expected: dict):
    """`fn` inside `counted_block`; returns (fn's result, seconds, the counts)."""
    with counted_block(f"[prompt] {tag}:", expected) as run:
        out = fn()
    return out, run["seconds"], run["counts"]


def check_image(label: str, imgs, size: int, other=None) -> float:
    """A finite (1, 3, size, size) image; with `other` (the unguided run's),
    one that differs from it. Returns max |imgs - other| (0 without it)."""
    finite = bool(torch.isfinite(imgs).all())
    moved = (imgs.float() - other.float()).abs().max().item() if other is not None else 0.0
    log(f"{label} image {tuple(imgs.shape)} {imgs.dtype}, finite {finite}, range "
        f"[{imgs.min().item():.3f}, {imgs.max().item():.3f}], red mean "
        f"{imgs[:, 0].float().mean().item():.4f}"
        + (f"; max |guided - unguided| {moved:.4f}" if other is not None else ""))
    if not finite or tuple(imgs.shape) != (1, 3, size, size) or (
            other is not None and not moved > 0):
        raise RuntimeError(f"{label}: not a finite (1, 3, {size}, {size}) image"
                           + (" that the guidance moved" if other is not None else ""))
    return moved


def phase_prompt(smi: str, dev=torch.device("cuda")) -> dict:
    """The SD path from a checkpoint directory and a prompt; returns the
    launch counts of the generation, the inversion and the edit."""
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline, create_diffusion_model

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="sd_ckpt_") as root:
        t0 = time.perf_counter()
        written, nbytes = write_sd_checkpoint(root, dev)
        on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(root)
                      for f in fs)
        log(f"[prompt] wrote an SD-1.5 checkpoint directory: {nbytes / 1e9:.3f} GB of bf16 "
            f"weights, {on_disk} bytes on disk, in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        sd = create_diffusion_model("sd", checkpoint_dir=root, num_inference_steps=STEPS,
                                    device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    n_tensors = check_loaded("prompt", {"unet": sd.unet, "vae": sd.vae,
                                        "text_encoder": sd.text_encoder}, written)
    del written
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", sd.unet), ("vae", sd.vae), ("clip", sd.text_encoder))}
    log(f"[prompt] loaded by create_diffusion_model('sd', checkpoint_dir=...) in {load_s:.3f} s: "
        f"{n_tensors} tensors bit-equal to those written; parameters "
        + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in n_params.items()))
    ids = sd.tokenizer.encode(PROMPT)
    log(f"[prompt] {PROMPT!r} -> {ids[:ids.index(sd.tokenizer.eos) + 1]} (padded to {len(ids)})")
    size = sd.vae.config.sample_size
    per = per_forward_launches(forward_pieces(
        fixed_text_sd(sd.unet, sd.vae, sd.schedule, sd.prep_text(ids), dev), dev))

    # Generation: STEPS CFG UNet calls and one decode.
    (img, _, _, _), gen_s, gen_counts = counted(
        f"generate ({STEPS} steps, CFG {CFG}, {size} px)",
        lambda: sd.generate_images(num_images=1, num_inference_steps=STEPS, prompt_ids=ids,
                                   cfg_scale=CFG),
        implied_launches(per, STEPS, 0, 1, 0))
    check_image("[prompt] generate", img, size)

    # DDIM inversion of a random image, then the fused resynthesized edit.
    pipe = EditPipeline(sd)
    rng = np.random.default_rng(3)
    photo = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, 3, size, size)).astype(np.float32))
    lat = size // 2 ** (len(sd.vae.config.block_out_channels) - 1)
    box = torch.zeros(1, 4, lat, lat, device=dev)
    box[..., lat // 4:3 * lat // 4, lat // 4:3 * lat // 4] = 1.0
    (xt, zs, xts, _, _), inv_s, inv_counts = counted(
        f"DDIM inversion ({STEPS} steps)",
        lambda: pipe.prepare_real_image_edit(photo, inversion_method="ddim", prompt_ids=ids,
                                             cfg_scale=CFG),
        implied_launches(per, STEPS, 0, 0, 1))
    if zs is not None or xts is not None or not bool(torch.isfinite(xt).all()):
        raise RuntimeError("[prompt] the DDIM inversion gave noise maps or a non-finite x_T")

    def edit(pipeline, steps, mode, t1):
        attr = SingleColorAttrFunc(target=0.9, color_idx=0, loss_scale=20.0, t1=t1, t2=steps)
        return pipeline.edit_image(
            xt, mask=box, attr_func=attr, prompt_ids=ids, cfg_scale=CFG, resynthesize=True,
            generator=torch.Generator(device=dev).manual_seed(9), mode=mode)

    out, edit_s, edit_counts = counted(
        f"fused edit ({GUIDED} guided of {STEPS} steps, resynthesis in a latent box)",
        lambda: edit(pipe, STEPS, "fused", STEPS - GUIDED),
        implied_launches(per, STEPS, GUIDED, GUIDED + 1, 0))
    check_image("[prompt] fused edit", out.imgs, size)
    peak = torch.cuda.max_memory_allocated()
    log(f"[prompt] load {load_s:.3f} s, generate {gen_s:.3f} s, DDIM inversion {inv_s:.3f} s, "
        f"fused edit {edit_s:.3f} s, peak memory {peak / 2**30:.2f} GiB, on {smi}")

    # The rerun check: the "split" mode beside the "fused" one, MODE_STEPS
    # guided steps from the same inputs and noise (RERUN_TOL).
    sd5 = SD(sd.unet, sd.vae, sd.schedule.with_num_inference_steps(MODE_STEPS),
             sd.text_encoder, sd.tokenizer, device=dev)
    runs = {mode: edit(EditPipeline(sd5), MODE_STEPS, mode, 0) for mode in ("fused", "split")}
    errs, same = {}, {}
    for k in ("imgs", "model_outputs", "pred_original_samples"):
        a, b = getattr(runs["fused"], k).float(), getattr(runs["split"], k).float()
        errs[k] = ((b - a).abs().max() / a.abs().max()).item()
        same[k] = torch.equal(a, b)
    ok = all(e <= RERUN_TOL for e in errs.values())
    log(f"[prompt] rerun of the guided loop ({MODE_STEPS} steps, mode 'split' after 'fused', "
        f"one loop): max|rerun - run| / max|run| "
        + ", ".join(f"{k} {e:.3e}" for k, e in errs.items())
        + f" (tol {RERUN_TOL}); bit-equal {same} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("[prompt] a rerun of the guided loop differs beyond RERUN_TOL")
    return {"generate": gen_counts, "invert": inv_counts, "edit": edit_counts}


# ---------------------------------------------------------------------------
# 9. ldm_clf and 10. ddpm_edit
# ---------------------------------------------------------------------------

# ClassifierAttrFunc as bench.py's ldm phase sets it (bench.py:651-654): the
# logit [20][1] of the anyGAN attributes, at loss scale 50.
CLF = dict(loss_scale=50.0, idx_for_class=20, idx_of_interest=1)
ANYGAN_WIDTH = 64


def clf_logits_fn(clf):
    """The decoded image in [-1, 1] -> anyGAN logits (bench.py's `clf_logits`)."""
    from diffusion_image_editing_tpu_torch.ops.resize import imagenet_normalize, to_unit_range

    def apply(img):
        return clf(imagenet_normalize(to_unit_range(img.float())))

    return apply


def write_anygan(path: str, dev) -> dict:
    """The anyGAN attribute predictor (a ResNet-50 with fc -> 80, f32) from
    seeded random weights with non-trivial running statistics, saved under
    torchvision's keys in "state_dict", as the published `.pth`; returns the
    state dict written, on the CPU."""
    from diffusion_image_editing_tpu_torch.models import ResNet50
    from diffusion_image_editing_tpu_torch.models.resnet import norm_layers

    torch.manual_seed(13)
    model = ResNet50(num_outputs=80, width=ANYGAN_WIDTH, device=dev)
    with torch.no_grad():
        for m in norm_layers(model):
            m.running_mean.normal_(0.0, 0.1)
            m.running_var.uniform_(0.8, 1.2)
    written = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    torch.save({"state_dict": written}, path)
    return written


def write_family_checkpoint(root: str, family: str, dev) -> tuple:
    """An HF-layout DDPM (`unet/`) or LDM (`unet/`, `vqvae/`) directory
    (`write_components`): the DDPM UNet and the LDM VQ model under the
    legacy attention names, the LDM UNet under the current ones, so that both
    namings load at full size."""
    from diffusion_image_editing_tpu_torch.models import (
        DDPM_CELEBAHQ_256, LDM_CELEBAHQ_256_UNET, LDM_CELEBAHQ_VQVAE, UNet2D, VQModel)

    parts = ([("unet", UNet2D, DDPM_CELEBAHQ_256, True)] if family == "ddpm" else
             [("unet", UNet2D, LDM_CELEBAHQ_256_UNET, False),
              ("vqvae", VQModel, LDM_CELEBAHQ_VQVAE, True)])
    return write_components(root, parts, 17, dev)


def family_pieces(w, dev):
    """One UNet call, one decode with its latent gradient, one encode of a
    DDPM or LDM wrapper, on fixed inputs (the pieces `per_forward_launches`
    counts); DDPM's identity codec launches nothing."""
    size = w.vqvae.config.sample_size if w.family == "ldm" else w.data_dimensionality
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(w.latent_shape(1), dtype=np.float32)).to(dev)
    wgt = torch.from_numpy(rng.standard_normal((1, 3, size, size), dtype=np.float32)).to(dev)
    img = torch.from_numpy(rng.uniform(-1, 1, (1, 3, size, size)).astype(np.float32)).to(dev)

    def eps():
        return w.eps_fn()(x, np.array([501]))

    def decode():
        z = x.clone().requires_grad_(True)
        (vjp,) = torch.autograd.grad((w.decode_fn()(z).float() * wgt).sum(), z)
        return vjp

    def encode():
        return w.encode(img)

    return {"eps": eps, "decode": decode, "encode": encode}


def check_family_pieces(tag: str, w, per: dict) -> None:
    """Every GroupNorm layer of a piece ran K4 or K5 + K6, and K1-K3 as its
    attention blocks imply: one K1 an attention block (with the lse where a
    gradient follows), one K2 and one K3 for the decoder's attention in the
    decode's gradient."""
    from diffusion_image_editing_tpu_torch.models.layers import AttentionBlock2D, GroupNormLayer

    codec = getattr(w, "vqvae", None)
    parts = {"eps": w.unet, "decode": codec and codec.decoder, "encode": codec and codec.encoder}
    for piece, module in parts.items():
        n_gn = count_modules(module, GroupNormLayer) if module is not None else 0
        n_attn = count_modules(module, AttentionBlock2D) if module is not None else 0
        c = per[piece]
        log(f"[{tag}] one {piece}: {n_gn} GroupNorm layers, {n_attn} attention blocks; {c}")
        grad = n_attn if piece == "decode" else 0
        if (c["group_norm_fused"] + c["group_norm_stats"] != n_gn
                or c["group_norm_stats"] != c["group_norm_apply"]
                or (c["flash_attn_fwd"], c["flash_attn_bwd_dq"], c["flash_attn_bwd_dkv"])
                != (n_attn, grad, grad) or c["affine_silu_conv3x3"] or c["abn_apply"]):
            raise RuntimeError(f"[{tag}] one {piece} ran {c} for {n_gn} GroupNorm layers and "
                               f"{n_attn} attention blocks")


# A nudge below f32's relative spacing leaves the latent as it was: the
# largest nudge of a guided edit must reach at least this share of the
# latent's RMS.
NUDGE_FLOOR = 2.0 ** -24


class NudgeProbe:
    """Stands in for an attribute function in `edit_image`: runs its
    `apply_batched` and keeps, for each step inside its window, the nudge's
    RMS over the latent's and the share of latent elements whose bfloat16
    value (what the UNet reads) the nudge changed, as tensors on the latent's
    device (no synchronisation in the loop)."""

    def __init__(self, attr):
        self.attr, self.rel, self.bf16_moved = attr, [], []

    def apply_batched(self, x, z, eps, t, step_idx, *args, **kwargs):
        out, z = self.attr.apply_batched(x, z, eps, t, step_idx, *args, **kwargs)
        if self.attr.in_window(int(step_idx)):
            d = (out - x).float()
            self.rel.append(d.pow(2).mean().sqrt() / x.float().pow(2).mean().sqrt())
            self.bf16_moved.append((out.to(torch.bfloat16) != x.to(torch.bfloat16)).float().mean())
        return out, z


def check_guidance(label: str, run_edit, attr, guided, unguided, must_lower: bool) -> None:
    """Classifier guidance changed what it acts on. `run_edit(attr_func)` runs
    the phase's edit and returns its images; it is run once more through a
    `NudgeProbe`: every step's nudge must be finite and the largest at least
    NUDGE_FLOOR of the latent's RMS. Prints the anyGAN logit of the `guided`
    and `unguided` images; with `must_lower` (no quantizer between the nudge
    and the classifier, so each nudge descends the logit itself) the guided
    one must be the lower. Through the VQ decode the logit is piecewise
    constant in the latent and the straight-through gradient is not its
    gradient, so there it is printed only."""
    probe = NudgeProbe(attr)
    rerun = run_edit(probe)
    rel = torch.stack(probe.rel).cpu()
    moved = torch.stack(probe.bf16_moved).cpu()
    with torch.no_grad():
        score = [float(attr.loss(im)) for im in (guided, unguided)]
    log(f"{label} nudge RMS / latent RMS over {len(rel)} guided steps: first {rel[0]:.3e}, "
        f"median {rel.median():.3e}, largest {rel.max():.3e} (floor {NUDGE_FLOOR:.3e}); share "
        f"of latent elements whose bf16 value a nudge changed: first {moved[0]:.4f}, largest "
        f"{moved.max():.4f}; rerun through the probe max |rerun - guided| "
        f"{(rerun.float() - guided.float()).abs().max().item():.4g}")
    log(f"{label} anyGAN logit [{CLF['idx_for_class']}][{CLF['idx_of_interest']}]: guided "
        f"{score[0]:.6g}, unguided {score[1]:.6g}, guided - unguided {score[0] - score[1]:.4g}"
        + (" (must be below 0)" if must_lower else " (printed only: the VQ decode quantizes)"))
    if not bool(torch.isfinite(rel).all()) or not rel.max() >= NUDGE_FLOOR:
        raise RuntimeError(f"{label}: the guidance nudges are not finite or all below "
                           f"{NUDGE_FLOOR:.3e} of the latent")
    if must_lower and not score[0] < score[1]:
        raise RuntimeError(f"{label}: the guided image's logit {score[0]:.6g} is not below the "
                           f"unguided one's {score[1]:.6g}")


def phase_ldm_clf(smi: str, dev=torch.device("cuda")) -> dict:
    """bench.py's `ldm` workload in the port: LDM CelebA-HQ-256 from a
    checkpoint directory, DDIM inversion of a random 256 px image, STEPS
    anyGAN-guided DDIM steps through the VQ decoder, decode. Returns the
    counted run's launch counts."""
    from diffusion_image_editing_tpu_torch.guidance import ClassifierAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import (
        EditPipeline, create_diffusion_model, get_pretrained_anygan)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="ldm_ckpt_") as root:
        t0 = time.perf_counter()
        written, nbytes = write_family_checkpoint(root, "ldm", dev)
        clf_path = os.path.join(root, "anygan.pth")
        written["anygan"] = write_anygan(clf_path, dev)
        log(f"[ldm_clf] wrote an LDM CelebA-HQ-256 checkpoint directory ({nbytes / 1e9:.3f} GB "
            f"of bf16 weights) and an anyGAN .pth in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        w = create_diffusion_model("ldm", sample_clipping=False, checkpoint_dir=root,
                                   num_inference_steps=STEPS, device=dev)
        clf_fn, clf = get_pretrained_anygan(clf_path, width=ANYGAN_WIDTH, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    n_tensors = check_loaded("ldm_clf", {"unet": w.unet, "vqvae": w.vqvae, "anygan": clf},
                                written)
    del written
    n_params = {name: sum(p.numel() for p in m.parameters())
                for name, m in (("unet", w.unet), ("vqvae", w.vqvae), ("anygan", clf))}
    log(f"[ldm_clf] loaded by create_diffusion_model('ldm', sample_clipping=False, "
        f"checkpoint_dir=...) and get_pretrained_anygan in {load_s:.3f} s: {n_tensors} tensors "
        f"bit-equal to those written; parameters "
        + ", ".join(f"{k} {v / 1e6:.1f} M" for k, v in n_params.items())
        + " (UNet and VQ bf16, anyGAN f32)")

    per = per_forward_launches(family_pieces(w, dev))
    check_family_pieces("ldm_clf", w, per)
    attr = ClassifierAttrFunc(t1=0, t2=STEPS, clf_apply_fn=clf_logits_fn(clf), **CLF)
    pipe = EditPipeline(w)
    size = w.vqvae.config.sample_size
    rng = np.random.default_rng(21)
    img = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, 3, size, size)).astype(np.float32))
    expected = implied_launches(per, 2 * STEPS, STEPS, STEPS + 1, 1)

    def run_edit(attr_func):
        return pipe.edit_image(xt, attr_func=attr_func, inversion_method="ddim",
                               collect=False).imgs

    with counted_block("[ldm_clf]", expected) as run:
        t_start = time.perf_counter()
        xt, _, _, _, _ = pipe.prepare_real_image_edit(img, inversion_method="ddim")
        torch.cuda.synchronize()
        t_inv = time.perf_counter()
        out = run_edit(attr)
        torch.cuda.synchronize()
        t_edit = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    w.decode(xt)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    inv_s, edit_s = t_inv - t_start, t_edit - t_inv
    log(f"[ldm_clf] VQ encode + DDIM inversion ({STEPS} steps) {inv_s:.3f} s; edit_image "
        f"({STEPS} guided steps + decode) {edit_s:.3f} s; the decode alone {dec_s:.3f} s; guided "
        f"loop {STEPS / (edit_s - dec_s):.3f} steps/s (bench.py's metric); whole run "
        f"{run['seconds']:.3f} s; peak memory {peak / 2**30:.2f} GiB, on {smi}")
    log(f"[ldm_clf] latent RMS: x_T {xt.float().pow(2).mean().sqrt().item():.4g} after the "
        f"inversion (no renormalisation)")
    unguided = run_edit(ClassifierAttrFunc(t1=STEPS, t2=STEPS, **CLF))
    check_image("[ldm_clf]", out, size, unguided)
    check_guidance("[ldm_clf]", run_edit, attr, out, unguided, must_lower=False)
    return run["counts"]


def phase_ddpm_edit(smi: str, dev=torch.device("cuda")) -> dict:
    """The DDPM CelebA-HQ-256 family from a checkpoint directory: a STEPS-step
    generation with clipping (the CLI's `generate --family ddpm`), then a
    real-image edit on an unclipped wrapper of the same modules:
    edit-friendly DDPM inversion (eta 1, batched, chunk CHUNK, t_skip
    T_SKIP) and GUIDED ClassifierAttrFunc-guided steps, the gradient through
    the anyGAN ResNet-50 alone (the codec is the identity). Returns the
    edit's launch counts."""
    from diffusion_image_editing_tpu_torch.guidance import ClassifierAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import (
        DDPM, EditPipeline, create_diffusion_model, get_pretrained_anygan)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="ddpm_ckpt_") as root:
        t0 = time.perf_counter()
        written, nbytes = write_family_checkpoint(root, "ddpm", dev)
        clf_path = os.path.join(root, "anygan.pth")
        written["anygan"] = write_anygan(clf_path, dev)
        log(f"[ddpm_edit] wrote a DDPM CelebA-HQ-256 checkpoint directory ({nbytes / 1e9:.3f} "
            f"GB of bf16 weights) and an anyGAN .pth in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        w = create_diffusion_model("ddpm", sample_clipping=True, checkpoint_dir=root,
                                   num_inference_steps=STEPS, device=dev)
        clf_fn, clf = get_pretrained_anygan(clf_path, width=ANYGAN_WIDTH, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    n_tensors = check_loaded("ddpm_edit", {"unet": w.unet, "anygan": clf}, written)
    del written
    n_params = sum(p.numel() for p in w.unet.parameters())
    log(f"[ddpm_edit] loaded by create_diffusion_model('ddpm', sample_clipping=True, "
        f"checkpoint_dir=...) and get_pretrained_anygan in {load_s:.3f} s: {n_tensors} tensors "
        f"bit-equal to those written; UNet {n_params / 1e6:.1f} M parameters, bf16")
    per = per_forward_launches(family_pieces(w, dev))
    check_family_pieces("ddpm_edit", w, per)
    size = w.data_dimensionality

    with counted_block("[ddpm_edit] generation", implied_launches(per, STEPS, 0, 0, 0)) as gen:
        img, traj, _, _ = w.generate_images(num_images=1, num_inference_steps=STEPS, seed=0,
                                            collect=True)
    check_image("[ddpm_edit] generation", img, size)
    clipped = traj.pred_original_samples.abs().max().item()
    log(f"[ddpm_edit] generation ({STEPS} steps, {size} px, clip_sample on) {gen['seconds']:.3f} "
        f"s = {STEPS / gen['seconds']:.3f} steps/s; max |pred-x0| {clipped:.4f}")
    if clipped > 1.0:
        raise RuntimeError("[ddpm_edit] the clipping schedule left pred-x0 outside [-1, 1]")
    del traj

    edit_w = DDPM(w.unet, w.schedule.with_clip_sample(False), device=dev)
    pipe = EditPipeline(edit_w)
    attr = ClassifierAttrFunc(t1=0, t2=STEPS, clf_apply_fn=clf_logits_fn(clf), **CLF)
    rng = np.random.default_rng(23)
    photo = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, 3, size, size)).astype(np.float32))
    calls = math.ceil((STEPS - T_SKIP) / CHUNK) + GUIDED
    torch.cuda.reset_peak_memory_stats()
    expected = implied_launches(per, calls, 0, 0, 0)

    def run_edit(attr_func):
        return pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, attr_func=attr_func,
                               inversion_method="ddpm", t_skip=T_SKIP, collect=False).imgs

    with counted_block("[ddpm_edit] inversion + edit", expected) as run:
        t_start = time.perf_counter()
        xt, zs, xts, _, _ = pipe.prepare_real_image_edit(
            photo, eta=1.0, inversion_method="ddpm", mode="batched", chunk=CHUNK, t_skip=T_SKIP,
            generator=torch.Generator(device=dev).manual_seed(5))
        torch.cuda.synchronize()
        t_inv = time.perf_counter()
        out = run_edit(attr)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    peak = torch.cuda.max_memory_allocated()
    inv_s, edit_s = t_inv - t_start, t_end - t_inv
    log(f"[ddpm_edit] DDPM inversion (batched, chunk {CHUNK}, t_skip {T_SKIP}) {inv_s:.3f} s; "
        f"{GUIDED} ClassifierAttrFunc-guided steps + identity decode {edit_s:.3f} s = "
        f"{GUIDED / edit_s:.3f} steps/s; whole edit {run['seconds']:.3f} s; peak memory "
        f"{peak / 2**30:.2f} GiB, on {smi}")
    unguided = run_edit(ClassifierAttrFunc(t1=STEPS, t2=STEPS, **CLF))
    check_image("[ddpm_edit] edit", out, size, unguided)
    check_guidance("[ddpm_edit]", run_edit, attr, out, unguided, must_lower=True)
    return run["counts"]


# ---------------------------------------------------------------------------
# 11. seg
# ---------------------------------------------------------------------------


class TimedFeed:
    """Cycles the given batches and records a CUDA event each time the loop
    asks for one; as the loop asks for batch k after it has launched step
    k - 1, event k fires when the device has finished step k - 1."""

    def __init__(self, batches):
        self.batches, self.events = batches, []

    def __iter__(self):
        return self

    def __next__(self):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)
        return self.batches[len(self.events) % len(self.batches)]

    def ms_per_step(self):
        """Device ms per step over the steps between the second event and
        the last (the first step waits for nothing before it)."""
        return self.events[1].elapsed_time(self.events[-1]) / (len(self.events) - 2)


def seg_run(dtype: str, batches, smi: str, dev) -> dict:
    """The trainer's path in one compute dtype; returns the counted run's
    launch counts."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.models.resnet import norm_layers
    from diffusion_image_editing_tpu_torch.seg import TrainConfig, train_loop
    from diffusion_image_editing_tpu_torch.seg.train import _prep_batch

    cfg = TrainConfig(norm="abn", compute_dtype=dtype)
    tag = f"[seg] {dtype}:"
    with tempfile.TemporaryDirectory(prefix="seg_ckpt_") as ckpt:
        _, warm, warm_losses = train_loop(cfg, itertools.cycle(batches), ckpt_dir=ckpt,
                                          num_steps=SEG_WARMUP, device=dev)
        before = {k: v.detach().clone() for k, v in warm.model.state_dict().items()}
        del warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        feed = TimedFeed(batches)
        with plain_abn_watch() as plain_calls:
            ops.reset_launch_counts()
            model, state, losses = train_loop(cfg, feed, ckpt_dir=ckpt,
                                              num_steps=SEG_WARMUP + SEG_STEPS, device=dev)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        ms = feed.ms_per_step()
        n_norms = len(norm_layers(model, "abn"))
        after = model.state_dict()
        kinds = {"conv kernels": [k for k in before if before[k].dim() > 1],
                 "norm weights and biases": [k for k in before if before[k].dim() == 1 and
                                             k.rsplit(".", 1)[1] in ("weight", "bias")],
                 "running stats": [k for k in before if k.rsplit(".", 1)[1] in
                                   ("running_mean", "running_var")]}
        changed = {kind: sum(not torch.equal(after[k], before[k]) for k in keys)
                   for kind, keys in kinds.items()}
        log(f"{tag} {ms:.3f} ms/step = {cfg.batch_size_per_device / ms * 1e3:.1f} img/s from "
            f"CUDA events over {len(feed.events) - 2} steps, peak memory {peak / 2**30:.2f} GiB, "
            f"on {smi}")
        log(f"{tag} losses {[round(l, 4) for l in warm_losses + losses]}; steps {state.step}; "
            f"tensors changed by the counted run: {changed} of "
            f"{ {k: len(v) for k, v in kinds.items()} }")
        log(f"{tag} launches {counts}; plain ABN calls on the card {plain_calls}")
        expected = {k: (SEG_STEPS * SEG_NORMS if k == "abn_apply" else 0) for k in counts}
        if n_norms != SEG_NORMS or counts != expected:
            raise RuntimeError(f"{tag} launches {counts} differ from {SEG_STEPS} steps x "
                               f"{n_norms} ABN layers")
        if any(plain_calls.values()):
            raise RuntimeError(f"{tag} a plain ABN ran on the card: {plain_calls}")
        if not all(math.isfinite(l) for l in warm_losses + losses) or len(losses) != SEG_STEPS:
            raise RuntimeError(f"{tag} losses {losses} are not {SEG_STEPS} finite values")
        # At the warmup's learning rate (about 1e-5) a norm weight of 1 may
        # move by less than its f32 step; every kernel and statistic moves.
        if (changed["conv kernels"] != len(kinds["conv kernels"]) or not
                changed["norm weights and biases"] or changed["running stats"] != 2 * SEG_NORMS):
            raise RuntimeError(f"{tag} the counted run left tensors unchanged: {changed} of "
                               f"{ {k: len(v) for k, v in kinds.items()} }")

        _, resumed, more = train_loop(cfg, itertools.cycle(batches), ckpt_dir=ckpt,
                                      num_steps=SEG_WARMUP + SEG_STEPS + SEG_RESUME, device=dev)
        log(f"{tag} resumed at step {SEG_WARMUP + SEG_STEPS} for {len(more)} steps -> step "
            f"{resumed.step}, losses {[round(l, 4) for l in more]}")
        if resumed.step != SEG_WARMUP + SEG_STEPS + SEG_RESUME or len(more) != SEG_RESUME or not \
                all(math.isfinite(l) for l in more):
            raise RuntimeError(f"{tag} the resumed run did not continue from the checkpoint")
        del resumed

    model.eval()
    x, _ = _prep_batch(*batches[0], dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        outs = model(x)
    torch.cuda.synchronize()
    eval_counts = ops.launch_counts()
    shape = (cfg.batch_size_per_device, cfg.n_classes, cfg.image_size, cfg.image_size)
    finite = all(bool(torch.isfinite(o).all()) and tuple(o.shape) == shape for o in outs)
    log(f"{tag} eval forward: {len(outs)} heads {shape}, finite {finite}, K8 launches "
        f"{eval_counts['abn_apply']}")
    if not finite or eval_counts["abn_apply"] != SEG_NORMS:
        raise RuntimeError(f"{tag} the eval forward gave {eval_counts} or non-finite heads")
    return counts


def phase_seg(smi: str) -> dict:
    """The trainer in f32 and in bf16 compute; returns the f32 counted run's
    launch counts."""
    from diffusion_image_editing_tpu_torch.seg import SyntheticFaceMask, TrainConfig
    from diffusion_image_editing_tpu_torch.seg import batch_iterator

    cfg = TrainConfig()
    feed = batch_iterator(SyntheticFaceMask(n=64, size=cfg.image_size, raw=True),
                          cfg.batch_size_per_device, seed=0)
    batches = list(itertools.islice(feed, 2))
    log(f"[seg] BiSeNet (ResNet-18) width {cfg.width}, {cfg.n_classes} classes, "
        f"{cfg.image_size} px, batch {cfg.batch_size_per_device}, norm abn, seeded random "
        f"weights, uint8 SyntheticFaceMask feed ({len(batches)} batches, cycled)")
    dev = torch.device("cuda")
    counts = {dtype: seg_run(dtype, batches, smi, dev) for dtype in ("float32", "bfloat16")}
    return counts["float32"]


def main() -> int:
    smi = phase_device()
    phase_build()
    pace_probe("after the build")
    entries = phase_kernels()
    phase_tiny()
    phase_seg_tiny()
    t0 = time.perf_counter()
    unet, vae = build_models(torch.device("cuda"))
    log(f"[main] models built in {time.perf_counter() - t0:.1f} s")
    pace_probe("before [main]")
    counts = phase_main_path(smi, unet, vae)
    fused_counts = phase_fused(smi, unet, vae)
    phase_seg_edit(smi, unet, vae)
    del unet, vae
    gc.collect()
    torch.cuda.empty_cache()
    phase_prompt(smi)
    gc.collect()
    torch.cuda.empty_cache()
    pace_probe("before [ldm_clf]")
    phase_ldm_clf(smi)
    gc.collect()
    torch.cuda.empty_cache()
    pace_probe("before [ddpm_edit]")
    phase_ddpm_edit(smi)
    gc.collect()
    torch.cuda.empty_cache()
    seg_counts = phase_seg(smi)
    for name, e in entries.items():
        # K7 runs only in the fused-conv configuration, K8 only on the
        # trainer's path; the rest are read from the default path's run.
        e["launches"] = {"affine_silu_conv3x3": fused_counts,
                         "abn_apply": seg_counts}.get(name, counts)[name]
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
