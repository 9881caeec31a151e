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
               `attention()` at every width of the path, the batched
               inversion's batch 20 and [sweep]'s batch 16 (each level's
               self-attention and the 64 x 64 cross-attention, with the
               launch grid's y = B * H checked against 65535), the forward with lse at the UNet's
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
               (cuDNN) on the pre-activated input; then its halo form at a
               rank's rows of the spatial split (SPLIT_CONV_CASES): the
               UNet's 32 of 64 rows as the first, a middle and the last
               rank, and 2 and 1 rows of the 8 x 8 x 1280 stage, each time
               printed beside the whole map's;
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
7b. remat - the decoder's block checkpointing and chunked guidance VJPs on the
             [main] models: two random 512 px images, [main]'s DDPM inversion
             (the last 10 steps' noise maps), then 10 steps guided by
             SingleColorAttrFunc with the LPIPS background term (a full-width
             seeded f32 LPIPS, a box mask on the image, x0_ref the inputs)
             three ways from the same inputs and noise, under cuDNN's
             deterministic algorithms: decode_remat="none", "blocks" one
             sample a VJP, "blocks" two samples a VJP. Prints each way's
             seconds, peak memory and largest difference from the first;
             the second within RERUN_TOL (bit-equality printed), the third
             (whose batch-2 decode rounds otherwise, which the bf16 UNet
             steps carry on) held step by step: its nudge on the first way's
             latent within CHUNK_NUDGE_TOL of the first way's. Checks that
             one checkpointed decode runs its blocks' kernels twice and the
             launch counts each way implies.
7c. sweep - bench.py's `sweep` workload (BASELINE config 5) on the [main]
             models: a random 512 px latent edited at 8 loss scales
             (linspace(0, 20, 8), SingleColorAttrFunc, vjp_chunk 1) in one
             batch through `parallel.guided_edit_sweep`: 50 DDIM steps, each
             a CFG UNet call at batch 16 and 8 batch-1 decodes with their
             gradient. The UNet's attention shapes at batch 16 are read and
             must be [kernels]'s. A 5-step check first: points 0 and 7 within
             SWEEP_TOL of batch-1 edits at their scales (point 0: also of the
             unguided edit) and bit-equal to edits at the sweep's batch;
             point 0's nudges 0, point 7's largest above point 1's. Then a
             warm and a timed pass: aggregate sample-steps/s (bench.py's
             metric), seconds, peak memory, launch counts checked.
7d. dist  - a real NCCL process group of world size 1 (a FileStore) and
             DeviceMeshes over it: (a) the BiSeNet trainer at [seg]'s recipe
             (f32, TF32 off) with norm="abn_sync" for 5 steps through
             `make_sharded_train_step` against norm="abn"'s single-process
             `train_loop` (run before the group is up) from the same seed
             and batches, within DIST_TOL; ms/step of both, K8's count (31 a
             step); (b) `ShardedCfgEpsClosure` on a cfg axis of 1 bit-equal
             to `CfgEpsClosure` on the [main] UNet. Prints the device count:
             a 2-rank group needs two GPUs (the 2-rank split is held on the
             CPU by gloo).
7e. item 16 - the opt-in accelerations on the [main] models, each against
             its exact form in the same call:
             [proxy]: bench.py's `proxy`: the affine proxy fitted
             (`guidance_decode_proxy`, seconds), its per-pixel error against
             the real decode of a fresh latent, then [main]'s path with
             `edit_image(guidance_codec="proxy")`: steps/s beside [main]'s,
             peak memory, launch counts (no decode gradient: K2/K3 0; K1 at
             512 and K5/K6 only in the encode and the final decode);
             [encprop]: bench.py's `encprop`: k = 1 through CfgEpsFeatClosure
             bit-equal to the plain loop (5 guided steps, deterministic
             cuDNN), then 50 colour-guided DDIM steps at k = 3 and the plain
             loop timed beside it, launch counts = ceil(50 / 3) full + the
             rest `reuse` forwards + 50 decode VJPs;
             [int8]: bench.py's `int8`: the same 50-step loop under
             `conv_mode("int8_large", min_h=128)` forward-only and with
             `int8_bwd` (fails when no int8 conv ran), steps/s beside the
             plain loop, peak memory; the full-size decode's relative error
             against cuDNN's, dx's cosine against the exact dgrad and dw
             bit-equal at (1, 128, 512, 512), and the int8 conv alone
             against cuDNN's bf16 conv at the decode's three int8 shapes;
             [seg_fast] (after [int8]): bench.py's `e2e_seg_fast`: [seg_edit]'s flow
             with `guidance_codec="proxy", encoder_reuse=3`, seconds beside
             [seg_edit]'s, launch counts.
             [tiny] also holds a TINY int8 conv (the s32 product of the
             same int8 operands exactly equal; forward and int8_bwd dx), a
             TINY UNet's `reuse` forward and a proxy fitted and one nudge
             through it, card against CPU, and that conv mode "int8" runs
             no cuDNN 3x3 conv.
7f. spatial - the spatial split of one edit (ROADMAP item 18b): four
             processes spawned on the one GPU (a gloo group over a
             FileStore; NCCL refuses two ranks on one device, so each
             collective goes through a host copy), each launching the
             kernels on its own rows. The SD edit on cfg2xsp2 with the [main]
             models (a 512 px image, 10-step DDIM inversion, 10 colour-guided
             steps) and the DDPM 256 px edit on sp4, against the same runs
             whole in this process, each within SPATIAL_TOL: one UNet call,
             one decode and its gradient, one encode; every inversion step
             and every guided step, each from the whole run's own latent
             (the counted edit's guided steps are its own, each restarted
             from the whole run's latent); the final image. Each check's
             control, the split with zeros in place of the neighbours' halo
             rows, must exceed its tolerance. The four ranks' latents,
             steps and images bit-equal, each rank's K1, K5 and K6
             (and for SD K2, K3) launches non-zero, no plain attention or
             GroupNorm on the card; ms per step printed, four processes
             sharing one card. [kernels] holds K1-K3 at the split's
             S_q != S_k shapes and K5's (mean, M2) output. Then each
             family's opt-in accelerations on its mesh (SPATIAL_VARIANTS):
             `fused_conv` on every ResnetBlock2D (K7's halo form) and
             `conv_mode("int8_large", min_h=INT8_MIN_H, int8_bwd=True)`:
             the pieces and two guided steps against the whole run with the
             same setting, within SPATIAL_TOL's "<variant> <check>", each
             control (zero halo rows) beyond it, ranks bit-equal, K7
             launched on every rank of the fused run, int8 convs and no
             cuDNN 3x3 conv at INT8_MIN_H rows or more of the whole map in
             the int8 run, no plain K7, GroupNorm or attention on the card.
7g. extra  - item 19's blocks: DeeplabV3Head (ASPP, 19 classes) and an
             IdentityResidualBlock at width 256 on a (4, 256, 64, 64) bf16
             map, eval and training mode, every ABN through K8, against the
             same blocks with K8's plain version (EXTRA_TOL), K8's launches
             counted; after [seg].
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
10b. metrics - the CLI's `metrics` flow on the DDPM family (loaded as
             [ddpm_edit]): `run_attribute_evaluation` of 4 generated 256 px
             images, eta 1, edit-friendly DDPM re-inversion and 14
             ClassifierAttrFunc-guided steps, the anyGAN ResNet-50 as guidance
             and as predictor (40 consistency entries in [0, 100], 40 finite
             sorted deltas), then the round trip without `--attr-func` (DDPM
             inversion and re-generation) scored by PSNR and a full-width
             LPIPS (LPIPS(a, a) = 0, symmetric, card against CPU within
             LPIPS_TOL); launch counts checked, per-part seconds printed.
   [tiny] also holds TINY_UNET2D (its 64-wide head), a TINY VQ model (encode,
             codes as an agreement rate, decode and its gradient), a width-8
             ResNet-50's logits and one ClassifierAttrFunc nudge through the
             TINY LDM decode, card against CPU; [kernels] holds K1 at the LDM
             and DDPM UNets' heads and at 64, K2/K3 at 64, and K4-K6 at the
             LDM UNet's odd channels a group, the 512 KiB slabs of the VQ
             decoder and the DDPM UNet and their 1 MiB slabs; and the TINY
             LPIPS with its input gradient and the TINY decode with
             remat=True, card against CPU.
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

`[pace]` lines (after the build, before [main], [sweep], [proxy], [ldm_clf] and
[ddpm_edit])
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
PEAK_INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate
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
# The evaluation path at the TINY sizes, card against CPU: LPIPS and its
# input gradient in f32 on both (cuDNN's f32 convolutions, TF32 off, sum in
# another order than the CPU's), max |card - cpu| / max |cpu|; the
# block-checkpointed TINY decode and its gradient bf16 on the card against
# f32 on the CPU, as TINY_TOL's decode.
TINY_EVAL_TOL = {"lpips": 1e-4, "lpips_grad": 1e-3, "remat_decode": 0.05,
                 "remat_decode_vjp": 0.05}
# Full-width LPIPS (f32) on the card against the same call on the CPU:
# max |card - cpu| / max |cpu| over near and far pairs of 256 px images.
LPIPS_TOL = 1e-3

FWD_CASES = [  # (label, q shape, kv shape)
    ("unet self 64x64", (2, 4096, 8, 40), (2, 4096, 8, 40)),
    ("unet self 32x32", (2, 1024, 8, 80), (2, 1024, 8, 80)),
    ("unet self 16x16", (2, 256, 8, 160), (2, 256, 8, 160)),
    ("unet self 8x8", (2, 64, 8, 160), (2, 64, 8, 160)),
    ("unet cross 64x64", (2, 4096, 8, 40), (2, 77, 8, 40)),
    ("unet self 64x64 b20", (20, 4096, 8, 40), (20, 4096, 8, 40)),  # the batched inversion
    # The 160-wide 77-key cross-attention (K1's warpgroup design): the edit's
    # batch 2, [sweep]'s 16 and the batched inversion's 20.
    ("unet cross 16x16", (2, 256, 8, 160), (2, 77, 8, 160)),
    ("unet cross 16x16 b16", (16, 256, 8, 160), (16, 77, 8, 160)),
    ("unet cross 16x16 b20", (20, 256, 8, 160), (20, 77, 8, 160)),
    # [sweep]'s CFG UNet at batch 16 (a grid of 8): every level's self-attention
    # (SWEEP_ATTN, read from the model there) and the 64 x 64 cross-attention.
    ("unet self 64x64 b16", (16, 4096, 8, 40), (16, 4096, 8, 40)),
    ("unet self 32x32 b16", (16, 1024, 8, 80), (16, 1024, 8, 80)),
    ("unet self 16x16 b16", (16, 256, 8, 160), (16, 256, 8, 160)),
    ("unet self 8x8 b16", (16, 64, 8, 160), (16, 64, 8, 160)),
    ("unet cross 64x64 b16", (16, 4096, 8, 40), (16, 77, 8, 40)),
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
    # The spatial split ([spatial]): a rank's queries against every rank's keys.
    # cfg2xsp2's UNet (one branch a rank, its rows over sp = 2) at each level,
    # the VAE's mid-block with the decode's rows over all four ranks, and the
    # DDPM UNet's 512-wide head on sp4.
    ("split unet self 64x64 sp2", (1, 2048, 8, 40), (1, 4096, 8, 40)),
    ("split unet self 32x32 sp2", (1, 512, 8, 80), (1, 1024, 8, 80)),
    ("split unet self 16x16 sp2", (1, 128, 8, 160), (1, 256, 8, 160)),
    ("split unet self 8x8 sp2", (1, 32, 8, 160), (1, 64, 8, 160)),
    ("split vae mid 64x64 over 4", (1, 1024, 1, 512), (1, 4096, 1, 512)),
    ("split ddpm unet 16x16 sp4", (1, 64, 1, 512), (1, 256, 1, 512)),
    ("split ddpm unet 8x8 sp4", (1, 16, 1, 512), (1, 64, 1, 512)),
]
LSE_CASES = [  # the forward with lse: the UNet's width, and the VAE's (40 launches a run)
    ("unet self 64x64", (2, 4096, 8, 40)),
    ("vae mid 64x64", (1, 4096, 1, 512)),
]
BWD_CASES = [  # (label, q shape, kv shape); the ragged case fills no block or tile
    ("vae mid 64x64", (1, 4096, 1, 512), (1, 4096, 1, 512)),  # also [ldm_clf]'s VQ decoder's
    ("unet self 32x32", (2, 1024, 8, 80), (2, 1024, 8, 80)),
    ("vae ragged", (1, 1000, 2, 512), (1, 1000, 2, 512)),
    ("tiny unet2d 8x8", (2, 64, 1, 64), (2, 64, 1, 64)),  # the narrow design at head dim 64
    # [spatial]'s decode gradient: a quarter of the VAE mid-block's queries
    # against all 4096 keys (dK and dV are this rank's partial sums).
    ("split vae mid 64x64 over 4", (1, 1024, 1, 512), (1, 4096, 1, 512)),
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
# K5's (mean, M2) output at [spatial]'s local slabs (a rank's rows): mean as
# MEAN_TOL, M2 within M2_TOL relative (twice RSTD_TOL: M2 goes as rstd^-2).
M2_TOL = 2e-4
GN_M2_CASES = [
    ("split unet 64x64x320 sp2", (1, 320, 32, 64)),
    ("split vae 512x512x128 over 4", (1, 128, 128, 512)),
    ("split ddpm 256x256x128 sp4", (1, 128, 64, 256)),
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
# K7's halo form at a rank's rows of the spatial split: (label, N, Cin, Cout,
# the rank's rows, W, (top_real, bottom_real)); x holds the rows and a
# neighbour's row above and below, zero where not real (the image's edge).
SPLIT_CONV_CASES = [
    ("split unet 64x64 320->320 b2, first of 2 ranks", 2, 320, 320, 32, 64, (False, True)),
    ("split unet 64x64 320->320 b2, a middle rank", 2, 320, 320, 32, 64, (True, True)),
    ("split unet 64x64 320->320 b2, last of 2 ranks", 2, 320, 320, 32, 64, (True, False)),
    ("split unet 8x8 1280->1280 b2, 2 rows a rank (sp4)", 2, 1280, 1280, 2, 8, (True, True)),
    ("split unet 8x8 1280->1280 b2, 1 row a rank (sp8)", 2, 1280, 1280, 1, 8, (True, False)),
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
        GRID_Y_MAX,
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
        ok = rel <= FWD_TOL and math.isfinite(rel) and b * h <= GRID_Y_MAX
        log(f"[kernels] fwd {label} q{qs} kv{ks}: max_abs_err {err:.3e}, relative {rel:.3e} "
            f"(tol {FWD_TOL}) {'ok' if ok else 'FAIL'} | kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {e['bound_ms']:.4f} ms "
            f"({e['bound_by']}); launch grid y = B * H = {b * h} of {GRID_Y_MAX}")
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

    for label, shape, kv_shape in BWD_CASES:
        b, s, h, d = shape
        s_k = kv_shape[1]
        scale = d ** -0.5
        q, dout = _randn(shape, gen, dev), _randn(shape, gen, dev)
        k, v = _randn(kv_shape, gen, dev), _randn(kv_shape, gen, dev)
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
        n = float(b * h * s * s_k * d)
        io_q, io_k = 2.0 * q.numel(), 2.0 * k.numel()  # bytes of one bf16 q-like, kv-like tensor
        stats = 4.0 * b * h * s  # bytes of one (B*H, S_q) f32 row statistic
        # dQ reads q, k, v, dO and writes dQ; dK/dV reads q, k, v, dO and writes dK, dV.
        e_dq = _entry("flash_attn_bwd_dq", list(shape), abs_errs[0], dq_ms, plain_dq_ms,
                      6 * n, 3 * io_q + 2 * io_k + 2 * stats, None)
        e_dkv = _entry("flash_attn_bwd_dkv", list(shape), max(abs_errs[1:]), dkv_ms,
                       plain_dkv_ms, 8 * n, 2 * io_q + 4 * io_k + 2 * stats, None)
        log(f"[kernels] bwd {label} q{shape} kv{kv_shape}: lse_err {lse_err:.3e} (tol {LSE_TOL}); kernels vs "
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

    for label, shape in GN_M2_CASES:  # K5's (mean, M2) output, as [spatial] takes it
        x = _randn(shape, gen, dev)
        with torch.no_grad():
            ref_mean, ref_m2 = GN.group_norm_mean_m2(x, GN_GROUPS)
            mean, m2 = GN.group_norm_stats(x, GN_GROUPS, m2=True)
            again = GN.group_norm_stats(x, GN_GROUPS, m2=True)
            torch.cuda.synchronize()
            mean_err = ((mean - ref_mean).abs() / (ref_mean.abs() + 1)).max().item()
            m2_err = ((m2 - ref_m2).abs() / ref_m2).max().item()
            same = torch.equal(mean, again[0]) and torch.equal(m2, again[1])
            ms = time_ms(lambda: GN.group_norm_stats(x, GN_GROUPS, m2=True))
            plain_ms = time_ms(lambda: GN.group_norm_mean_m2(x, GN_GROUPS), reps=5)
            view = x.view(shape[0], GN_GROUPS, -1)
            lib_ms = time_ms(lambda: torch.var_mean(view, dim=-1, correction=0))
        b_ms, by = bound_ms(3.0 * x.numel(), 2.0 * x.numel() + 8.0 * shape[0] * GN_GROUPS,
                            PEAK_F32_FLOPS)
        ok = mean_err <= MEAN_TOL and m2_err <= M2_TOL and same
        log(f"[kernels] group_norm {label} {shape} K5 (mean, M2): mean {mean_err:.2e} (tol "
            f"{MEAN_TOL}), M2 {m2_err:.2e} (tol {M2_TOL}), rerun bit-equal {same} "
            f"{'ok' if ok else 'FAIL'} | K5 {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"torch.var_mean {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
        if not ok:
            failures.append(f"group_norm {label} K5 (mean, M2)")
        del x
        torch.cuda.empty_cache()


def conv_case(label, n, cin, cout, h, w, gen, dev, halo=None):
    """K7 at one shape against its plain version on the same inputs, then
    the kernel's, the plain version's and cuDNN's time (`F.conv2d` on the
    pre-activated input). Bound: 2 * N * H * W * Cout * 9 * Cin tensor-core
    operations against x, w and y read or written once. With `halo`
    (top_real, bottom_real), the halo form at a rank's h rows: x holds h + 2.
    Returns the JSON entry and whether the kernel is within CONV_TOL."""
    from diffusion_image_editing_tpu_torch.ops import fused_conv as FC

    x = _randn((n, cin, h + (0 if halo is None else 2), w), gen, dev)
    a = 1 + 0.2 * torch.randn((n, cin), generator=gen, device=dev)
    b = 0.5 * torch.randn((n, cin), generator=gen, device=dev)
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device=dev) / (9 * cin) ** 0.5)
    wt = wt.to(torch.bfloat16)
    bias = (0.1 * torch.randn(cout, generator=gen, device=dev)).to(torch.bfloat16)
    args = (x, a, b, wt, bias, halo)
    with torch.no_grad():
        y = FC.affine_silu_conv3x3_kernel(*args)
        ref = FC.affine_silu_conv3x3_reference(*args)
        torch.cuda.synchronize()
        err = (y.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        ms = time_ms(lambda: FC.affine_silu_conv3x3_kernel(*args))
        plain_ms = time_ms(lambda: FC.affine_silu_conv3x3_reference(*args), reps=5)
        act = FC.edges_zeroed(F.silu(x.float() * a[:, :, None, None]
                                      + b[:, :, None, None]).to(x.dtype), halo)
        lib_ms = time_ms(lambda: F.conv2d(act, wt, bias, padding=FC.conv_padding(halo)))
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
    """K7 at the path's fused-conv shapes (`conv_case`), then its halo form
    at SPLIT_CONV_CASES, each beside the whole map's time at its width."""
    whole = {}
    for label, n, cin, cout, h, w in CONV_CASES:
        e, ok = conv_case(label, n, cin, cout, h, w, gen, dev)
        if not ok:
            failures.append(f"fused conv {label}")
        entries.setdefault("affine_silu_conv3x3", e)
        whole[(n, cin, cout, w)] = (h, e["ms"])
        torch.cuda.empty_cache()
    for label, n, cin, cout, h, w, halo in SPLIT_CONV_CASES:
        e, ok = conv_case(label, n, cin, cout, h, w, gen, dev, halo)
        rows, ms = whole[(n, cin, cout, w)]
        log(f"[kernels] fused conv {label}: halo form {e['ms']:.4f} ms at {h} + 2 rows "
            f"{halo}, the whole {rows}-row map {ms:.4f} ms")
        if not ok:
            failures.append(f"fused conv {label}")
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
    failed += _tiny_evals()
    failed += _tiny_item16()
    if failed:
        raise RuntimeError(f"tiny models on the card disagree with the CPU: {failed}")


def _tiny_item16(devices=(("cuda", torch.bfloat16), ("cpu", torch.float32))) -> list:
    """The opt-in accelerations at TINY size, the first device against the
    second: (a) an int8 conv: the s8 x s8 -> s32 product of the same int8
    operands exactly equal, the forward and the int8_bwd dx within
    TINY_TOL (f32 on both: within 1e-6); (b) the TINY UNet's `reuse`
    forward on the features of its own `full` forward at another step, and
    (c) a proxy fitted from each device's TINY decode of the same latents and
    one SingleColorAttrFunc nudge through it. Returns the names that
    disagree."""
    import copy

    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.engine import CfgEpsFeatClosure, DecodeClosure
    from diffusion_image_editing_tpu_torch.guidance import (
        SingleColorAttrFunc, solve_decode_proxy)
    from diffusion_image_editing_tpu_torch.models import (
        TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition)
    from diffusion_image_editing_tpu_torch.ops import conv as C

    torch.manual_seed(2)
    rng = np.random.default_rng(2)
    arr = lambda *shape: torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))  # noqa
    x, w, g = arr(2, 12, 16, 16), arr(20, 12, 3, 3) * 0.1, arr(2, 20, 16, 16)
    xq, _ = C.quantize_int8(x, (0, 1, 2, 3))
    wq, _ = C.quantize_int8(w, (1, 2, 3))
    unet = UNet2DCondition(TINY_SD_UNET, device="cpu")
    vae = AutoencoderKL(TINY_VAE, device="cpu")
    text, lat, z = arr(2, 77, 32), arr(1, 4, 16, 16), arr(4, 4, 16, 16)
    sched = schedule_for_model("sd", 4)
    t = int(sched.timesteps[1])
    runs = {}
    for dev, dtype in devices:
        u, v = copy.deepcopy(unet).to(dev, dtype), copy.deepcopy(vae).to(dev, dtype)
        xd = x.to(dev, dtype).requires_grad_(True)
        y = C.conv3x3_int8(xd, w.to(dev, dtype), int8_bwd=True)
        (dx,) = torch.autograd.grad(y, xd, g.to(dev, dtype))
        eps_fn = CfgEpsFeatClosure(u, text.to(dev, dtype), 3.5)
        _, feats = eps_fn.full(lat.to(dev), np.array([801]))
        proxy = solve_decode_proxy(z.to(dev), DecodeClosure(v, 0.18215)(z.to(dev)).detach())
        nudged, _ = SingleColorAttrFunc(**dict(HEADLINE_GUIDE, t2=4)).apply(
            lat.to(dev), None, z[:1].to(dev), t, 1, sched.to(dev), proxy)
        runs[dev] = {"int8 s32": C.int8_conv3x3_s32(xq.to(dev), wq.to(dev)),
                     "int8 forward": y.detach(), "int8_bwd dx": dx,
                     "reuse": eps_fn.reuse(lat.to(dev) * 0.9, np.array([761]), feats),
                     "proxy w": proxy.w, "proxy nudge": nudged - lat.to(dev)}
    failed = []
    (a, dtype), (b, _) = devices
    tols = {"int8 s32": 0.0, "int8 forward": TINY_TOL["latent"], "int8_bwd dx": TINY_TOL["latent"],
            "reuse": TINY_TOL["eps"], "proxy w": TINY_TOL["decode"],
            "proxy nudge": TINY_TOL["decode_vjp"]}
    if dtype == torch.float32:
        tols.update({"int8 forward": 1e-6, "int8_bwd dx": 1e-6})
    for name, tol in tols.items():
        ref = runs[b][name].double().cpu()
        err = ((runs[a][name].double().cpu() - ref).abs().max() / ref.abs().max()).item()
        ok = err <= tol and math.isfinite(err)
        log(f"[tiny] item 16 {name} {tuple(ref.shape)}: max|{a} {dtype} - {b}| / max|{b}| "
            f"{err:.3e} (tol {tol}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"item 16 {name}")
    before = dict(C.CALL_COUNTS)
    with C.conv_mode("int8"), torch.no_grad():
        copy.deepcopy(vae).to(devices[0][0], dtype).decode(lat.to(devices[0][0], dtype))
    calls = {k: C.CALL_COUNTS[k] - before[k] for k in C.CALL_COUNTS}
    log(f"[tiny] item 16 a TINY decode under conv mode int8: conv calls {calls} (no cuDNN 3x3)")
    if calls["xla"] or not calls["int8"]:
        failed.append("item 16 int8 mode fell back to cuDNN")
    return failed


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


LPIPS_SEED = 31


def seeded_lpips(width: float = 1.0):
    """An f32 LPIPS from seeded random weights, built on the CPU (move it to
    the card with `.to`, so that both devices hold the same weights)."""
    from diffusion_image_editing_tpu_torch.evals import LPIPS

    torch.manual_seed(LPIPS_SEED)
    return LPIPS(width, device="cpu")


def _tiny_evals(devices=(("cuda", torch.bfloat16), ("cpu", torch.float32))) -> list:
    """The evaluation path's pieces at the TINY sizes, the first device (the
    card) against the second (the CPU), from the same weights and inputs:
    LPIPS at width 1/8 (f32 on both) and its input gradient; the TINY SD
    decode with `remat=True` and its latent gradient (the VAE bf16 on the
    card, f32 on the CPU). Prints whether the checkpointed decode and
    gradient equal the plain ones on the first device to the bit (they run
    the same kernels again), held within RERUN_TOL. Returns the names that
    disagree."""
    import copy

    from diffusion_image_editing_tpu_torch.models import TINY_VAE, AutoencoderKL

    lp = seeded_lpips(0.125)
    torch.manual_seed(4)
    vae = AutoencoderKL(TINY_VAE, device="cpu")
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32))
            for _ in range(2))
    z0 = torch.from_numpy(rng.standard_normal((2, 4, 16, 16), dtype=np.float32))
    wgt = torch.from_numpy(rng.standard_normal((2, 3, 32, 32), dtype=np.float32))
    runs = []
    failed = []
    for dev, dtype in devices:
        net = copy.deepcopy(lp).to(dev)
        x = a.to(dev).requires_grad_(True)
        dist = net(x, b.to(dev))
        (grad,) = torch.autograd.grad(dist.sum(), x)
        v = copy.deepcopy(vae).to(dev, dtype)
        out = {}
        for remat in (False, True):
            z = z0.to(dev).requires_grad_(True)
            dec = v.decode(z, remat=remat)
            (vjp,) = torch.autograd.grad((dec.float() * wgt.to(dev)).sum(), z)
            out[remat] = (dec.detach(), vjp)
        same = all(torch.equal(p, q) for p, q in zip(out[True], out[False]))
        err = max(((p.float() - q.float()).abs().max() / q.float().abs().max()).item()
                  for p, q in zip(out[True], out[False]))
        ok = err <= RERUN_TOL
        log(f"[tiny] evals {dev} {str(dtype).removeprefix('torch.')}: decode with remat=True "
            f"against without, output and gradient bit-equal {same}, max relative "
            f"{err:.3e} (tol {RERUN_TOL}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"evals remat rerun on {dev}")
        runs.append({"lpips": dist, "lpips_grad": grad, "remat_decode": out[True][0],
                     "remat_decode_vjp": out[True][1]})
    got, ref = runs
    (d0, t0), (d1, t1) = ((d, str(t).removeprefix("torch.")) for d, t in devices)
    for name, tol in TINY_EVAL_TOL.items():
        want = ref[name].float().cpu()
        err = ((got[name].float().cpu() - want).abs().max() / want.abs().max()).item()
        ok = err <= tol and math.isfinite(err)
        log(f"[tiny] evals {name} {tuple(want.shape)}: max|{d0} - {d1}| / max|{d1}| {err:.3e} "
            f"(tol {tol}; LPIPS f32 on both, the decode {t0} against {t1}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"evals {name}")
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


def forward_pieces(sd, dev, remat_blocks: bool = False):
    """One CFG UNet call, one decode and its latent gradient (through the
    block-checkpointed decoder with `remat_blocks`), one encode, on fixed
    inputs; each returns its output."""
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
        decoded = sd.decode_fn(remat_blocks=remat_blocks)(zz)
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


def run_path(pipe, img, dev, **edit_kw):
    """Inversion + GUIDED colour-guided steps + final decode (`edit_kw` go
    to `edit_image`); returns the output and the inversion's and the edit's
    seconds."""
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
                          inversion_method="ddpm", t_skip=T_SKIP, mode="split", **edit_kw)
    torch.cuda.synchronize()
    return out, t_inv - t_start, time.perf_counter() - t_inv


# Readings that later phases print beside their own, from this call: the
# guided steps/s of each counted run, by tag, and "headline", the plain
# 50-step colour-guided loop that [encprop] times.
STEPS_S = {}
SECONDS = {}  # whole-run seconds of [seg_edit] and [seg_fast]


def counted_run(tag, pipe, img, dev, smi, **edit_kw):
    """A warm-up run, then one run with every launch count set to 0 just
    before it and read just after; checks the image. Returns the counts and
    the plain GroupNorm calls on the card during the counted run."""
    from diffusion_image_editing_tpu_torch import ops

    run_path(pipe, img, dev, **edit_kw)  # warm-up: first-call set-up stays out of the timed run
    torch.cuda.reset_peak_memory_stats()
    with plain_groupnorm_watch() as plain_calls:
        ops.reset_launch_counts()
        out, inv_s, edit_s = run_path(pipe, img, dev, **edit_kw)
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    STEPS_S[tag] = GUIDED / edit_s
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
SEG_FAST_K = 3  # [seg_fast]'s encoder-propagation interval (bench.py:400)


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


def phase_seg_edit(smi: str, unet, vae, fast: bool = False) -> dict:
    """bench.py's e2e_seg workload on the [main] models, face alignment
    left out: BiSeNet parsing of a random 512 px image -> hair mask ->
    encode -> edit-friendly DDPM inversion (batched, chunk 10, t_skip 10)
    -> the masked, resynthesized edit with 40 NetAttrFunc-guided steps, each
    with a gradient through the full VAE decoder and the BiSeNet -> decode.
    With `fast` it is bench.py's e2e_seg_fast ([seg_fast]): the same flow
    with `guidance_codec="proxy"` (the gradient through the fitted affine
    proxy and the BiSeNet, the proxy fitted before the counted run) and
    `encoder_reuse=SEG_FAST_K`. Returns the launch counts of the run."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.guidance import NetAttrFunc
    from diffusion_image_editing_tpu_torch.ops.resize import imagenet_normalize, to_unit_range
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline, create_segmentation_model

    tag = "seg_fast" if fast else "seg_edit"
    fast_kw = dict(guidance_codec="proxy", encoder_reuse=SEG_FAST_K) if fast else {}
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
        raise RuntimeError(f"[{tag}] the loaded BiSeNet is not the checkpoint written")
    n_params = sum(p.numel() for p in seg.module.parameters())
    log(f"[{tag}] BiSeNet width 64, 19 classes, norm bn, f32, {n_params / 1e6:.1f} M "
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
    per = per_forward_launches(forward_pieces(sd, dev))
    expected = path_launches(per)
    if fast:
        reuse = GUIDED - math.ceil(GUIDED / SEG_FAST_K)
        expected = implied_with_reuse(per, reuse_launches(sd, dev), UNET_CALLS - reuse, reuse, 0,
                                      1, ENCODES)
        t0 = time.perf_counter()
        sd.guidance_decode_proxy(generator=torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        log(f"[{tag}] proxy fitted in {time.perf_counter() - t0:.3f} s (one batch-8 decode)")

    def edit(attr_func):
        return pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, mask=mask, attr_func=attr_func,
                               inversion_method="ddpm", t_skip=T_SKIP, resynthesize=True,
                               generator=torch.Generator(device=dev).manual_seed(9),
                               collect=False, mode="split", **fast_kw)

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
    STEPS_S[tag] = GUIDED / edit_s
    SECONDS[tag] = t_end - t0
    log(f"[{tag}] segment + mask + encode {prep_s[0]:.3f} s, inversion {inv_s:.3f} s, "
        f"{GUIDED} NetAttrFunc-guided steps {edit_s:.3f} s = {GUIDED / edit_s:.3f} steps/s, whole "
        f"run {t_end - t0:.3f} s, peak memory {peak / 2**30:.2f} GiB, on {smi}")
    if fast:
        log(f"[{tag}] beside [seg_edit] in this call: whole run {SECONDS['seg_edit']:.3f} s, "
            f"{STEPS_S['seg_edit']:.3f} steps/s; here {SECONDS[tag]:.3f} s "
            f"({SECONDS['seg_edit'] / SECONDS[tag]:.2f}x), {STEPS_S[tag]:.3f} steps/s "
            f"({STEPS_S[tag] / STEPS_S['seg_edit']:.2f}x)")
    plain = {k: v for k, v in {**gn_calls, **attn_calls, **abn_calls}.items()
             if not k.endswith("causal")}
    log(f"[{tag}] launches {counts}")
    log(f"[{tag}] expected {expected} (the [main] path's pieces: BiSeNet runs no kernel); plain "
        f"attention, GroupNorm and ABN calls on the card {plain}")
    if counts != expected:
        raise RuntimeError(f"[{tag}] launch counts {counts} differ from the path's {expected}")
    if any(plain.values()):
        raise RuntimeError(f"[{tag}] a plain attention, GroupNorm or ABN ran on the card: "
                           f"{plain}")

    lat = sd.data_dimensionality
    coverage = mask[:, 0].float().mean().item()
    hair = (parsing == SEG_CLASS).float().mean().item()
    log(f"[{tag}] parsing map {tuple(parsing.shape)}: class {SEG_CLASS} on {hair:.4f} of it; "
        f"mask {tuple(mask.shape)} covers {coverage:.4f} of the latent (bounds {SEG_COVERAGE}), "
        f"alpha channel all ones {bool((mask[:, 3] == 1).all())}")
    if tuple(mask.shape) != (1, 4, lat, lat) or not bool((mask[:, 3] == 1).all()) or not (
            SEG_COVERAGE[0] <= coverage <= SEG_COVERAGE[1]):
        raise RuntimeError(f"[{tag}] the mask {tuple(mask.shape)} covers {coverage:.4f}")
    imgs = out.imgs
    size = vae.config.sample_size
    finite = bool(torch.isfinite(imgs).all())
    unguided = edit(None).imgs
    moved = (imgs.float() - unguided.float()).abs().max().item()
    with torch.no_grad():
        mass = [attr.loss(x).item() for x in (imgs, unguided)]
    log(f"[{tag}] image {tuple(imgs.shape)} {imgs.dtype}, finite {finite}, range "
        f"[{imgs.min().item():.3f}, {imgs.max().item():.3f}]; max |guided - unguided| {moved:.4f} "
        f"(the same inversion, mask and noise); class {SEG_CLASS} mass guided {mass[0]:.5f}, "
        f"unguided {mass[1]:.5f}")
    if not finite or tuple(imgs.shape) != (1, 3, size, size) or not moved > 0:
        raise RuntimeError(f"[{tag}] the edit is not a finite image that the guidance moved")
    return counts


# ---------------------------------------------------------------------------
# 7b. remat
# ---------------------------------------------------------------------------

REMAT_BATCH, REMAT_GUIDED = 2, 10  # images, guided steps
# (decode_remat, vjp_chunk): the decode in the guidance gradient plain, then
# block-checkpointed one sample at a time, then two samples a VJP.
REMAT_WAYS = (("none", 1), ("blocks", 1), ("blocks", 2))
REMAT_GUIDE = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS, use_mask=True,
                   mask_pred_original_sample=True, metric="lpips", lambda_=0.01)
# A nudge through a bf16 decode whose convolutions ran other cuDNN
# algorithms (two samples a batch against one) moves where the decoded
# image's last bits flip the L1 loss's sign or an LPIPS ReLU: max |diff| /
# max |nudge|, as TINY_TOL's and TINY_SEG_TOL's nudges (bf16 card vs f32 CPU).
CHUNK_NUDGE_TOL = 0.05


class ChunkProbe:
    """Stands in for the attribute function of an edit: runs its
    `apply_batched` and, on the same latent, `other`'s through
    `other_decode`, keeping max |other's nudge - its nudge| / max |its nudge|
    for each step inside the window as a tensor (no synchronisation)."""

    def __init__(self, attr, other, other_decode):
        self.attr, self.other, self.other_decode, self.errs = attr, other, other_decode, []

    def apply_batched(self, x, z, eps, t, step_idx, sched, decode_fn, **kwargs):
        out, z = self.attr.apply_batched(x, z, eps, t, step_idx, sched, decode_fn, **kwargs)
        if self.attr.in_window(int(step_idx)):
            alt, _ = self.other.apply_batched(x, None, eps, t, step_idx, sched,
                                              self.other_decode, **kwargs)
            d = (out - x).float()
            self.errs.append(((alt - x).float() - d).abs().max() / d.abs().max())
        return out, z


def remat_way_launches(per: dict, remat: str, chunk: int) -> dict:
    """An edit of REMAT_GUIDED steps at batch REMAT_BATCH: a UNet call a step,
    REMAT_BATCH / chunk decodes with a gradient a step (each through the
    block-checkpointed decoder for "blocks"), and the final decode without
    one."""
    grad = per["decode_remat" if remat == "blocks" else "decode"]
    n = REMAT_GUIDED * REMAT_BATCH // chunk
    total = {k: REMAT_GUIDED * per["eps"][k] + n * grad[k] + per["decode"][k]
             for k in per["eps"]}
    for k in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
        total[k] -= per["decode"][k]
    return total


def check_remat_piece(vae, per: dict) -> None:
    """One decode with its gradient through the block-checkpointed decoder
    runs each ResnetBlock2D's and the mid attention's kernels twice (the
    backward recomputes the block) and the decoder's other GroupNorm
    (conv_norm_out) once: K1 (with the lse both times) twice an attention
    block, K2 and K3 once, and otherwise what the plain decode runs."""
    from diffusion_image_editing_tpu_torch.models.layers import (
        AttentionBlock2D, GroupNormLayer, ResnetBlock2D)

    blocks = [m for m in vae.decoder.modules() if isinstance(m, (ResnetBlock2D, AttentionBlock2D))]
    gn_blocks = sum(count_modules(b, GroupNormLayer) for b in blocks)
    gn = count_modules(vae.decoder, GroupNormLayer)
    n_attn = count_modules(vae.decoder, AttentionBlock2D)
    c, d = per["decode_remat"], per["decode"]
    log(f"[remat] one decode with its gradient: plain {d}; block-checkpointed {c} "
        f"({len(blocks)} blocks checkpointed holding {gn_blocks} of the decoder's {gn} GroupNorm "
        f"layers, {n_attn} attention)")
    if (c["group_norm_fused"] + c["group_norm_stats"] != gn + gn_blocks
            or c["group_norm_stats"] != c["group_norm_apply"]
            or d["group_norm_fused"] + d["group_norm_stats"] != gn
            or (c["flash_attn_fwd"], c["flash_attn_bwd_dq"], c["flash_attn_bwd_dkv"])
            != (2 * n_attn, n_attn, n_attn)
            or (d["flash_attn_fwd"], d["flash_attn_bwd_dq"], d["flash_attn_bwd_dkv"])
            != (n_attn, n_attn, n_attn)
            or c["affine_silu_conv3x3"] or c["abn_apply"]):
        raise RuntimeError(f"[remat] the checkpointed decode ran {c}, not the plain decode's "
                           f"{d} with {gn_blocks} GroupNorms and {n_attn} attention again")


def phase_remat(smi: str, unet, vae) -> dict:
    """The decoder's block checkpointing and chunked guidance VJPs on the
    [main] models: two random 512 px images, [main]'s edit-friendly DDPM
    inversion (the last REMAT_GUIDED steps' noise maps), then REMAT_GUIDED
    steps of SingleColorAttrFunc with the LPIPS background term
    (`metric="lpips"`, a full-width seeded f32 LPIPS, a box mask on the
    image, x0_ref the input images) three ways (REMAT_WAYS) from the same
    inputs and noise, with cuDNN's deterministic algorithms (LPIPS's f32
    convolution backward otherwise is not: a rerun of one way differs).
    Prints each way's seconds, peak memory and largest difference from the
    first way. The ways of one sample a VJP run the same operations, and
    their edits must agree within RERUN_TOL (bit-equality printed). Two
    samples a VJP run the decoder's convolutions at batch 2, where cuDNN
    picks other algorithms: the nudges differ in rounding, and the bf16
    UNet steps carry that through the trajectory, so that way is held
    step by step instead: on the first way's latent at every step, its
    nudge within CHUNK_NUDGE_TOL of the first way's (`ChunkProbe`). Checks
    the launch counts; returns those of the "blocks" way."""
    from diffusion_image_editing_tpu_torch.evals import make_lpips_fn
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    dev = next(unet.parameters()).device
    sd, pipe, _ = make_pipeline(unet, vae, dev)
    size = vae.config.sample_size
    rng = np.random.default_rng(41)
    imgs = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (REMAT_BATCH, 3, size, size)).astype(np.float32)).to(dev)
    mask = torch.zeros((1, 1, size, size), device=dev)
    mask[..., size // 4:3 * size // 4, size // 8:5 * size // 8] = 1.0
    lpips = seeded_lpips().to(dev)
    n_lpips = sum(p.numel() for p in lpips.parameters())
    t_skip = STEPS - REMAT_GUIDED
    t0 = time.perf_counter()
    xt, zs, xts, _, _ = pipe.prepare_real_image_edit(
        imgs, eta=1.0, inversion_method="ddpm", mode="batched", t_skip=t_skip, chunk=CHUNK,
        generator=torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    log(f"[remat] {REMAT_BATCH} random {size} px images, DDPM inversion (batched, chunk {CHUNK}, "
        f"t_skip {t_skip}) {time.perf_counter() - t0:.3f} s; guidance SingleColorAttrFunc "
        f"{REMAT_GUIDE} with a full-width LPIPS ({n_lpips / 1e6:.1f} M parameters, f32, seeded) "
        f"over a box of {mask.mean().item():.3f} of the image")

    per = per_forward_launches(forward_pieces(sd, dev))
    per["decode_remat"] = per_forward_launches(
        {"d": forward_pieces(sd, dev, remat_blocks=True)["decode"]})["d"]
    check_remat_piece(vae, per)

    def attr_of(chunk):
        return SingleColorAttrFunc(**REMAT_GUIDE, metric_fn=make_lpips_fn(lpips), vjp_chunk=chunk)

    def edit(remat, attr, skip=t_skip):
        return pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, mask=mask, x0_ref=imgs,
                               attr_func=attr, inversion_method="ddpm", t_skip=skip,
                               collect=False, mode="split", decode_remat=remat).imgs

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat, chunk in REMAT_WAYS:  # one guided step each: first-call set-up stays out
            edit(remat, attr_of(chunk), STEPS - 1)
        outs, counts = [], {}
        for remat, chunk in REMAT_WAYS:
            label = f"[remat] decode_remat={remat!r} vjp_chunk={chunk}:"
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with counted_block(label, remat_way_launches(per, remat, chunk)) as run:
                out = edit(remat, attr_of(chunk))
            peak = torch.cuda.max_memory_allocated()
            outs.append(out)
            ref = outs[0].float()
            err = ((out.float() - ref).abs().max() / ref.abs().max()).item()
            same = torch.equal(out, outs[0])
            finite = bool(torch.isfinite(out).all())
            held = chunk == REMAT_WAYS[0][1]
            ok = finite and tuple(out.shape) == (REMAT_BATCH, 3, size, size) and (
                err <= RERUN_TOL or not held)
            log(f"{label} {REMAT_GUIDED} guided steps + decode {run['seconds']:.3f} s = "
                f"{REMAT_GUIDED / run['seconds']:.3f} steps/s, peak memory "
                f"{peak / 2**30:.2f} GiB; image {tuple(out.shape)} finite {finite}; max |this - "
                f"first way| / max |first| {err:.3e} "
                + (f"(tol {RERUN_TOL}), " if held else "(held step by step below), ")
                + f"bit-equal {same}, on {smi} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"{label} the edit is not a finite batch within {RERUN_TOL} "
                                   f"of the first way's")
            if (remat, chunk) == ("blocks", 1):
                counts = run["counts"]
        for remat, chunk in REMAT_WAYS[1:]:
            if chunk == REMAT_WAYS[0][1]:
                continue
            probe = ChunkProbe(attr_of(REMAT_WAYS[0][1]), attr_of(chunk),
                               sd.decode_fn(remat_blocks=remat == "blocks"))
            edit(REMAT_WAYS[0][0], probe)
            errs = torch.stack(probe.errs).cpu()
            ok = bool(torch.isfinite(errs).all()) and errs.max().item() <= CHUNK_NUDGE_TOL
            log(f"[remat] decode_remat={remat!r} vjp_chunk={chunk} on the first way's latent at "
                f"each of {len(errs)} steps: max |nudge - first way's| / max |first way's| "
                f"{', '.join(f'{e:.2e}' for e in errs.tolist())} (tol {CHUNK_NUDGE_TOL}) "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise RuntimeError(f"[remat] vjp_chunk={chunk} nudges disagree with one sample "
                                   f"a VJP: {errs.tolist()}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    unguided = pipe.edit_image(xt, eta=1.0, zs=zs, xts=xts, inversion_method="ddpm",
                               t_skip=t_skip, mask=mask, collect=False).imgs
    moved = (outs[0].float() - unguided.float()).abs().max().item()
    log(f"[remat] max |guided - unguided| {moved:.4f}")
    if not moved > 0:
        raise RuntimeError("[remat] the guidance did not move the image")
    return counts


# ---------------------------------------------------------------------------
# 7c. sweep
# ---------------------------------------------------------------------------

SWEEP_GRID = 8
SWEEP_SCALES = np.linspace(0.0, 20.0, SWEEP_GRID)  # bench.py's phase_sweep grid
SWEEP_STEPS = STEPS  # DDIM steps of a timed pass (bench.py's 50)
SWEEP_CHECK_STEPS = 5
SWEEP_GUIDE = dict(target=0.9, color_idx=0, t1=0, t2=SWEEP_STEPS)  # bench.py's colour guidance
# Grid points 0 and 7 of a 5-step sweep against batch-1 edits at their
# scales, max |sweep - edit| / max |edit| of the final latent. The sweep's
# UNet runs at batch 16 and the edit's at 2: their convolutions and
# matmuls may round otherwise, and each bf16 UNet step carries a change of
# the latent's last bits on (PERF.md, PR 14: about 2 % of pred-x0 a step).
# Against edits at the sweep's own batch (every row at the point's scale;
# point 0's the unguided edit) the points are held bit-equal: a row's
# numbers do not depend on the other rows.
SWEEP_TOL = 5e-2
# The sweep's self-attention at batch 16 (the CFG pair of 8 points), one
# (B, S, H, D) a level of the SD-1.5 UNet: [kernels] holds K1 at each.
SWEEP_ATTN = [(16, 4096, 8, 40), (16, 1024, 8, 80), (16, 256, 8, 160), (16, 64, 8, 160)]


def row_nudge_attr(**kwargs):
    """SingleColorAttrFunc (SWEEP_GUIDE) that also records each step's
    largest |nudge| of each sample, a (B,) tensor on the card (no
    synchronisation in the loop)."""
    import dataclasses

    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    @dataclasses.dataclass(frozen=True)
    class RowNudges(SingleColorAttrFunc):
        rows: list = dataclasses.field(default_factory=list, compare=False)

        def apply_batched(self, x, z, eps, t, step_idx, *args, **kw):
            out, z = super().apply_batched(x, z, eps, t, step_idx, *args, **kw)
            self.rows.append((out - x).float().flatten(1).abs().amax(dim=1))
            return out, z

    return RowNudges(**SWEEP_GUIDE, **kwargs)


def sweep_attention_shapes(unet, eps_fn, x) -> set:
    """The (q, k) shapes of every attention call of one CFG UNet call on x."""
    from diffusion_image_editing_tpu_torch.models import unet2d_cond

    shapes, orig = set(), unet2d_cond.attention

    def record(q, k, v, *args, **kw):
        shapes.add((tuple(q.shape), tuple(k.shape)))
        return orig(q, k, v, *args, **kw)

    unet2d_cond.attention = record
    try:
        eps_fn(x, 501)
    finally:
        unet2d_cond.attention = orig
    return shapes


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def phase_sweep(smi: str, unet, vae) -> dict:
    """bench.py's `sweep` workload (BASELINE config 5) on the [main] models:
    a random 512 px latent edited at SWEEP_GRID loss scales at once through
    `parallel.guided_edit_sweep` (the grid on the batch axis: the CFG UNet
    at batch 16, one batch-1 decode and gradient a point a step, vjp_chunk
    1), SWEEP_STEPS DDIM steps at eta 0. First a SWEEP_CHECK_STEPS-step
    sweep against batch-1 edits at points 0 and 7 and the unguided edit
    (SWEEP_TOL), and bit-equal to edits at the sweep's batch at the same
    scale (point 0: unguided), each point's nudges recorded: point 0's are
    0, point 7's largest above point 1's. Then one warm and one timed pass; prints the
    aggregate sample-steps/s (bench.py's metric), the seconds of both
    passes and the peak memory; checks the launch counts against what the
    pieces imply. Returns the timed pass's launch counts."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.engine import edit_split
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
    from diffusion_image_editing_tpu_torch.parallel import guided_edit_sweep, sweep_attr_func

    dev = next(unet.parameters()).device
    sd, _, _ = make_pipeline(unet, vae, dev)
    g, lat = SWEEP_GRID, unet.config.sample_size
    gen = torch.Generator(device=dev).manual_seed(11)
    xt = torch.randn((1, unet.config.in_channels, lat, lat), generator=gen, device=dev)
    eps_fn, decode_fn = sd.eps_fn(sd.prep_text(None)), sd.decode_fn()
    log(f"[sweep] bench.py's sweep workload on the [main] models: a random "
        f"{vae.config.sample_size} px latent, grid {g} of loss_scale "
        f"{[round(float(s), 4) for s in SWEEP_SCALES]}, SingleColorAttrFunc(target 0.9, "
        f"channel 0), vjp_chunk 1, {SWEEP_STEPS} DDIM steps at eta 0, CFG 3.5")

    shapes = sweep_attention_shapes(unet, eps_fn, xt.repeat(g, 1, 1, 1))
    held = {(tuple(qs), tuple(ks)) for _, qs, ks in FWD_CASES}
    self_attn = sorted((q for q, k in shapes if q == k), reverse=True)
    log(f"[sweep] the CFG UNet's attention at batch {2 * g}: self {self_attn}; cross "
        f"{sorted({(q, k) for q, k in shapes if q != k}, reverse=True)}")
    if self_attn != SWEEP_ATTN or not all((q, q) in held for q in self_attn):
        raise RuntimeError(f"[sweep] the UNet's self-attention shapes {self_attn} are not "
                           f"SWEEP_ATTN {SWEEP_ATTN}, each held by [kernels]")

    # The check at SWEEP_CHECK_STEPS steps.
    sched = schedule_for_model("sd", SWEEP_CHECK_STEPS)
    probe = row_nudge_attr()
    t0 = time.perf_counter()
    swept = guided_edit_sweep(sched, eps_fn, xt, sweep_attr_func(probe, loss_scale=SWEEP_SCALES),
                              decode_fn=decode_fn)
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    single = {i: edit_split(sched, eps_fn, xt, decode_fn=decode_fn, attr_func=SingleColorAttrFunc(
        **SWEEP_GUIDE, loss_scale=float(SWEEP_SCALES[i]))).x0 for i in (0, g - 1)}
    unguided = edit_split(sched, eps_fn, xt).x0
    xg = xt.repeat(g, 1, 1, 1)
    same_batch = {0: edit_split(sched, eps_fn, xg).x0[:1],
                  g - 1: edit_split(sched, eps_fn, xg, decode_fn=decode_fn, attr_func=(
                      SingleColorAttrFunc(**SWEEP_GUIDE, loss_scale=float(SWEEP_SCALES[-1])))
                  ).x0[g - 1:]}
    errs = {"point 0 vs its batch-1 edit": rel_err(swept[0], single[0]),
            f"point {g - 1} vs its batch-1 edit": rel_err(swept[g - 1], single[g - 1]),
            "point 0 vs the batch-1 unguided edit": rel_err(swept[0], unguided)}
    equal = {i: torch.equal(swept[i], ref) for i, ref in same_batch.items()}
    nudges = torch.stack(probe.rows).cpu()  # (steps, g)
    log(f"[sweep] {SWEEP_CHECK_STEPS}-step check ({check_s:.3f} s for the sweep): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {SWEEP_TOL}); the batch "
        f"effect alone (batch-{g} unguided row 0 vs batch 1) "
        f"{rel_err(same_batch[0], unguided):.3e}; the guidance alone (batch-1 edits at scales "
        f"{SWEEP_SCALES[-1]:g} vs 0) {rel_err(single[g - 1], single[0]):.3e}; bit-equal to the "
        f"batch-{g} edit at its scale (point 0: the unguided edit): {equal}")
    log(f"[sweep] largest |nudge| of each point over the {len(nudges)} steps: "
        f"{[float(f'{v:.4g}') for v in nudges.max(dim=0).values]}")
    if not all(math.isfinite(v) and v <= SWEEP_TOL for v in errs.values()):
        raise RuntimeError(f"[sweep] the sweep's points disagree with single edits: {errs}")
    if not all(equal.values()):
        raise RuntimeError(f"[sweep] points differ from the edits at the sweep's batch: {equal}")
    if nudges[:, 0].abs().max() != 0 or not nudges[:, g - 1].max() > nudges[:, 1].max():
        raise RuntimeError(f"[sweep] the nudge does not grow with loss_scale: {nudges.tolist()}")
    del swept, single, unguided, same_batch, probe

    per = per_forward_launches(forward_pieces(sd, dev))
    expected = implied_launches(per, SWEEP_STEPS, SWEEP_STEPS * g, SWEEP_STEPS * g, 0)
    attr = sweep_attr_func(SingleColorAttrFunc(**SWEEP_GUIDE), loss_scale=SWEEP_SCALES)

    def run(x):
        out = guided_edit_sweep(sd.schedule, eps_fn, x, attr, decode_fn=decode_fn)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    run(xt + 1.0)  # warm, on another latent, as bench.py's _timed_pass
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with plain_groupnorm_watch() as plain_gn, plain_attention_watch() as plain_attn:
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run(xt)
        timed_s = time.perf_counter() - t0
        counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[sweep] {g} x {SWEEP_STEPS} sample-steps in {timed_s:.3f} s = "
        f"{g * SWEEP_STEPS / timed_s:.3f} sample-steps/s (warm pass {warm_s:.3f} s), peak memory "
        f"{peak / 2**30:.2f} GiB, on {smi}")
    log(f"[sweep] launches {counts}; implied by {SWEEP_STEPS} CFG UNet calls at batch {2 * g} "
        f"and {SWEEP_STEPS * g} batch-1 decodes with their gradient: {expected}; plain "
        f"GroupNorm {plain_gn}, plain attention {plain_attn} on the card")
    finite = bool(torch.isfinite(out).all())
    if tuple(out.shape) != (g,) + tuple(xt.shape) or not finite:
        raise RuntimeError(f"[sweep] the sweep gave {tuple(out.shape)}, finite {finite}")
    if counts != expected:
        raise RuntimeError(f"[sweep] launch counts {counts} differ from the pieces' {expected}")
    if any(plain_gn.values()) or any(plain_attn.values()):
        raise RuntimeError(f"[sweep] a plain op ran on the card: {plain_gn} {plain_attn}")
    return counts


# ---------------------------------------------------------------------------
# 7d. dist
# ---------------------------------------------------------------------------

DIST_STEPS = 5
# The synced trainer over one rank against the single-process trainer, the
# same weights and batches: the collectives sum one rank's values and divide
# by 1, so the two differ only where cuDNN's backward algorithms do not
# repeat their sums; held as [seg-tiny]'s card against CPU (SEG_TINY_TOL).
DIST_TOL = SEG_TINY_TOL


def dist_train(norm: str, batches, dev, mesh=None) -> dict:
    """DIST_STEPS steps of `seg.train_loop` at the reference recipe from seed
    0 (through `make_sharded_train_step` with a mesh), counted and timed."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.seg import TrainConfig, train_loop

    feed = TimedFeed(batches)
    torch.cuda.synchronize()
    with plain_abn_watch() as plain:
        ops.reset_launch_counts()
        model, state, losses = train_loop(TrainConfig(norm=norm), feed, num_steps=DIST_STEPS,
                                          device=dev, mesh=mesh)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    return {"losses": losses, "state": {k: v.detach().clone() for k, v in
                                        model.state_dict().items()},
            "ms": feed.ms_per_step(), "counts": counts, "plain": dict(plain)}


def phase_dist(smi: str, unet, vae, dev=torch.device("cuda")) -> dict:
    """A real NCCL process group of world size 1 on the card (a FileStore),
    then (a) the BiSeNet trainer with norm="abn_sync" through
    `make_sharded_train_step` over a 1-D `dp` DeviceMesh against
    norm="abn"'s single-process `train_loop` (run before the group is up)
    from the same seed and batches, and (b) `ShardedCfgEpsClosure` on a
    `cfg` axis of size 1 against `CfgEpsClosure` on the [main] UNet.
    Returns the synced run's launch counts."""
    import torch.distributed as dist

    from diffusion_image_editing_tpu_torch.engine import CfgEpsClosure
    from diffusion_image_editing_tpu_torch.parallel import (
        ShardedCfgEpsClosure, cfg_mesh, make_mesh)
    from diffusion_image_editing_tpu_torch.parallel.mesh import all_gather_into
    from diffusion_image_editing_tpu_torch.seg import (
        SyntheticFaceMask, TrainConfig, batch_iterator, create_train_state)

    log(f"[dist] torch.cuda.device_count() {torch.cuda.device_count()}: an NCCL group of world "
        f"size 1 (two ranks cannot share one GPU under NCCL; the 2-rank split is held on the "
        f"CPU by gloo, tests/test_torch_dist.py)")
    cfg = TrainConfig()
    feed = batch_iterator(SyntheticFaceMask(n=64, size=cfg.image_size, raw=True),
                          cfg.batch_size_per_device, seed=0)
    batches = list(itertools.islice(feed, 2))
    start = {k: v.detach().clone() for k, v in
             create_train_state(TrainConfig(norm="abn"), 0, dev)[0].state_dict().items()}
    dist_train("abn", batches, dev)  # warm-up: first-call library set-up stays out
    runs = {"abn": dist_train("abn", batches, dev)}  # before the group is up
    sd, _, _ = make_pipeline(unet, vae, dev)
    with tempfile.TemporaryDirectory(prefix="dist_store_") as root:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.FileStore(os.path.join(root, "store"), 1), rank=0,
                                world_size=1)
        try:
            log(f"[dist] process group: backend {dist.get_backend()}, world size "
                f"{dist.get_world_size()}, rank {dist.get_rank()}")
            t = torch.arange(8.0, device=dev)
            gathered, reduced = torch.empty_like(t), t.clone()
            all_gather_into(gathered, t, dist.group.WORLD)
            dist.all_reduce(reduced)
            torch.cuda.synchronize()
            if not (torch.equal(gathered, t) and torch.equal(reduced, t)):
                raise RuntimeError("[dist] an NCCL all-gather or all-reduce over one rank "
                                   "changed its input")
            mesh = cfg_mesh(cfg=1, sp=1)
            x = torch.from_numpy(np.random.default_rng(3).standard_normal(
                (1, unet.config.in_channels, unet.config.sample_size, unet.config.sample_size),
                dtype=np.float32)).to(dev)
            emb = sd.prep_text(None)
            sharded = ShardedCfgEpsClosure(unet, emb, CFG, mesh)(x, 501)
            plain = CfgEpsClosure(unet, emb, CFG)(x, 501)
            same = torch.equal(sharded, plain)
            axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
            log(f"[dist] (b) ShardedCfgEpsClosure on mesh {axes} vs CfgEpsClosure on the "
                f"[main] UNet: bit-equal {same}, max |diff| "
                f"{(sharded.float() - plain.float()).abs().max().item():.3e}")
            if not same:
                raise RuntimeError("[dist] the CFG closure on a cfg axis of 1 is not "
                                   "CfgEpsClosure's")
            runs["abn_sync"] = dist_train("abn_sync", batches, dev,
                                          mesh=make_mesh(axis_names=("dp",)))
        finally:
            dist.destroy_process_group()
    a, s = runs["abn"], runs["abn_sync"]
    weights = [k for k in start if k.rsplit(".", 1)[1] in ("weight", "bias")]
    stats = [k for k in start if k.rsplit(".", 1)[1] in ("running_mean", "running_var")]
    update = max((a["state"][k] - start[k]).abs().max().item() for k in weights)
    errs = {"loss": max(abs(x - y) / abs(y) for x, y in zip(s["losses"], a["losses"])),
            "weights": max((s["state"][k] - a["state"][k]).abs().max().item()
                           for k in weights) / update,
            "stats": max(rel_err(s["state"][k], a["state"][k]) for k in stats)}
    bit_equal = all(torch.equal(s["state"][k], a["state"][k]) for k in start)
    expected = {k: (DIST_STEPS * SEG_NORMS if k == "abn_apply" else 0) for k in s["counts"]}
    log(f"[dist] (a) BiSeNet at [seg]'s recipe, f32, {DIST_STEPS} steps from seed 0: abn "
        f"single-process {a['ms']:.3f} ms/step, abn_sync through make_sharded_train_step over "
        f"one NCCL rank {s['ms']:.3f} ms/step (CUDA events), on {smi}")
    log(f"[dist] (a) losses abn {[round(v, 5) for v in a['losses']]} abn_sync "
        f"{[round(v, 5) for v in s['losses']]}; max relative loss {errs['loss']:.2e} (tol "
        f"{DIST_TOL['loss']}), weights {errs['weights']:.2e} of the largest update "
        f"{update:.3e} (tol {DIST_TOL['weights']}), running stats {errs['stats']:.2e} (tol "
        f"{DIST_TOL['stats']}); every tensor bit-equal: {bit_equal}")
    log(f"[dist] (a) abn_sync launches {s['counts']} (K8 {SEG_NORMS} a step); plain ABN on the "
        f"card {s['plain']}")
    if not all(errs[k] <= DIST_TOL[k] for k in errs):
        raise RuntimeError(f"[dist] abn_sync over one rank disagrees with abn: {errs}")
    if s["counts"] != expected or any(s["plain"].values()) or any(a["plain"].values()):
        raise RuntimeError(f"[dist] abn_sync launched {s['counts']}, not {expected}, or a plain "
                           f"ABN ran on the card")
    return s["counts"]


# ---------------------------------------------------------------------------
# 7e. proxy, encprop, int8 (and seg_fast, in 7.): the opt-in accelerations
# ---------------------------------------------------------------------------

ENCPROP_K = 3  # bench.py's phase_encprop interval
ENCPROP_CHECK_STEPS = 5
INT8_MIN_H = 128  # the JAX package's default gate
# (label, N, C, H, W): the int8 convs of a 512 px decode under int8_large
# (C -> C, 3 x 3), timed alone against cuDNN's bf16 conv.
INT8_CONV_CASES = [("decode 512x512x128", 1, 128, 512, 512), ("decode 256x256x256", 1, 256, 256, 256),
                   ("decode 128x128x512", 1, 512, 128, 128)]
HEADLINE_GUIDE = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)  # bench.py


def reuse_launches(sd, dev) -> dict:
    """Kernel launches of one CFG UNet `reuse` forward (mid + up on the
    features of a full forward), counted alone."""
    from diffusion_image_editing_tpu_torch import ops

    lat = sd.data_dimensionality
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, sd.latent_channels, lat, lat), dtype=np.float32)).to(dev)
    eps_fn = sd.eps_fn(sd.prep_text(None), features=True)
    _, feats = eps_fn.full(x, np.array([501]))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    eps_fn.reuse(x, np.array([481]), feats)
    torch.cuda.synchronize()
    return ops.launch_counts()


def implied_with_reuse(per: dict, per_reuse: dict, full: int, reuse: int, grad_decodes: int,
                       decodes: int, encodes: int) -> dict:
    """`implied_launches` with `full` whole UNet calls and `reuse` calls that
    run mid + up only."""
    total = implied_launches(per, full, grad_decodes, decodes, encodes)
    return {k: v + reuse * per_reuse[k] for k, v in total.items()}


def headline_run(sd, eps_fn, decode_fn, x, k: int = 1, sched=None):
    """bench.py's headline loop: STEPS DDIM steps at eta 0 from x, each
    colour-guided through `decode_fn`; encoder propagation at interval k."""
    from diffusion_image_editing_tpu_torch.engine import edit_split
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    sched = sched or sd.schedule
    attr = SingleColorAttrFunc(**dict(HEADLINE_GUIDE, t2=sched.num_inference_steps))
    out = edit_split(sched, eps_fn, x, attr_func=attr, decode_fn=decode_fn, encoder_reuse=k).x0
    torch.cuda.synchronize()
    return out


def counted_headline(sd, eps_fn, decode_fn, xt, k: int = 1):
    """A warm pass on another latent and a timed pass with the launch counts
    set to 0 just before it (bench.py's _timed_pass); returns (seconds,
    counts, peak bytes, output)."""
    from diffusion_image_editing_tpu_torch import ops

    headline_run(sd, eps_fn, decode_fn, xt + 1.0, k)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = headline_run(sd, eps_fn, decode_fn, xt, k)
    seconds = time.perf_counter() - t0
    return seconds, ops.launch_counts(), torch.cuda.max_memory_allocated(), out


def headline_latent(sd, dev, seed: int = 13):
    lat = sd.data_dimensionality
    return torch.randn((1, sd.latent_channels, lat, lat),
                       generator=torch.Generator(device=dev).manual_seed(seed), device=dev)


def phase_proxy(smi: str, unet, vae) -> dict:
    """bench.py's `proxy` workload on the [main] models, through the entry
    point a user calls: the proxy fitted (`guidance_decode_proxy`, one
    batch-8 decode), its per-pixel error against the real decode of a fresh
    latent, then [main]'s path (DDPM inversion, GUIDED colour-guided steps,
    final decode) with `edit_image(guidance_codec="proxy")`: no decode
    gradient, so no K2/K3; K1 at the VAE's head and K5/K6 only in the final
    decode and the encode. Returns the counted run's launches."""
    dev = next(unet.parameters()).device
    sd, pipe, img = make_pipeline(unet, vae, dev)
    t0 = time.perf_counter()
    proxy = sd.guidance_decode_proxy(generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    z = headline_latent(sd, dev, seed=21)
    with torch.no_grad():
        real = sd.decode(z).float()
        approx = proxy(z).float()
    up = proxy.up
    pooled = real.reshape(real.shape[0], real.shape[1], -1, up, real.shape[3] // up, up).mean(
        dim=(3, 5))
    direct = torch.einsum("nchw,cd->ndhw", z, proxy.w) + proxy.b[:, None, None]
    rms = lambda t: t.pow(2).mean().sqrt().item()  # noqa: E731
    log(f"[proxy] fitted in {fit_s:.3f} s (batch-8 decode at {vae.config.sample_size} px + a "
        f"{proxy.w.shape[0] + 1}x{proxy.w.shape[0] + 1} solve): w {tuple(proxy.w.shape)}, up {up}; "
        f"on a fresh latent, per pixel: rms |proxy - decode| {rms(approx - real):.4f} against "
        f"rms |decode| {rms(real):.4f}, mean abs {(approx - real).abs().mean().item():.4f}; per "
        f"latent pixel (the decode mean-pooled): rms {rms(direct - pooled):.4f} against "
        f"{rms(pooled):.4f}")
    if not (torch.isfinite(approx).all() and approx.shape == real.shape):
        raise RuntimeError(f"[proxy] the proxy gives {tuple(approx.shape)}, not a finite "
                           f"{tuple(real.shape)}")
    per = per_forward_launches(forward_pieces(sd, dev))
    expected = implied_launches(per, UNET_CALLS, 0, 1, ENCODES)
    if expected["flash_attn_bwd_dq"] or expected["flash_attn_bwd_dkv"]:
        raise RuntimeError(f"[proxy] the pieces imply a decode gradient: {expected}")
    counts, plain_calls = counted_run("proxy", pipe, img, dev, smi, guidance_codec="proxy")
    check_counts("proxy", counts, expected, plain_calls)
    log(f"[proxy] beside [main] in this call: {STEPS_S['main']:.3f} steps/s; through the proxy "
        f"{STEPS_S['proxy']:.3f} ({STEPS_S['proxy'] / STEPS_S['main']:.2f}x), on {smi}")
    return counts


def phase_encprop(smi: str, unet, vae) -> dict:
    """bench.py's `encprop` workload (k = ENCPROP_K) on the [main] models:
    `edit_split` with the CFG feature closure, STEPS colour-guided DDIM steps
    through the full decode, the down path every k-th step. First, on the
    card, k = 1 through the feature closure bit-equal to the plain loop over
    ENCPROP_CHECK_STEPS guided steps (cuDNN deterministic for the check).
    Then a warm and a timed pass at k, and a timed pass of the plain loop
    (the headline); launch counts checked against ceil(STEPS / k) full and
    the rest `reuse` forwards. Returns the timed k pass's launches."""
    from diffusion_image_editing_tpu_torch.core import schedule_for_model

    dev = next(unet.parameters()).device
    sd, _, _ = make_pipeline(unet, vae, dev)
    emb = sd.prep_text(None)
    plain_fn, feat_fn, decode_fn = sd.eps_fn(emb), sd.eps_fn(emb, features=True), sd.decode_fn()
    xt = headline_latent(sd, dev)

    sched = schedule_for_model("sd", ENCPROP_CHECK_STEPS)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        a = headline_run(sd, plain_fn, decode_fn, xt, 1, sched)
        b = headline_run(sd, feat_fn, decode_fn, xt, 1, sched)
        c = headline_run(sd, feat_fn, decode_fn, xt, ENCPROP_K, sched)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"[encprop] {ENCPROP_CHECK_STEPS} guided steps: k = 1 through CfgEpsFeatClosure "
        f"bit-equal to the plain loop: {torch.equal(a, b)}; k = {ENCPROP_K} differs from it by "
        f"{rel_err(c, a):.3e} of max |latent|")
    if not torch.equal(a, b):
        raise RuntimeError(f"[encprop] k = 1 through the feature closure is not the plain loop: "
                           f"{rel_err(b, a):.3e}")

    per = per_forward_launches(forward_pieces(sd, dev))
    per_reuse = reuse_launches(sd, dev)
    full = math.ceil(STEPS / ENCPROP_K)
    expected = implied_with_reuse(per, per_reuse, full, STEPS - full, STEPS, STEPS, 0)
    log(f"[encprop] one reuse forward launches {per_reuse}; one full forward {per['eps']}")
    k_s, counts, peak, out = counted_headline(sd, feat_fn, decode_fn, xt, ENCPROP_K)
    base_s, _, base_peak, base = counted_headline(sd, plain_fn, decode_fn, xt, 1)
    STEPS_S["headline"] = STEPS / base_s
    log(f"[encprop] {STEPS} guided DDIM steps at k = {ENCPROP_K}: {k_s:.3f} s = "
        f"{STEPS / k_s:.3f} steps/s, peak {peak / 2**30:.2f} GiB; the plain loop {base_s:.3f} s "
        f"= {STEPS / base_s:.3f} steps/s, peak {base_peak / 2**30:.2f} GiB; {base_s / k_s:.2f}x; "
        f"k = {ENCPROP_K} against the plain loop's final latent {rel_err(out, base):.3e}; "
        f"[main] {STEPS_S['main']:.3f} steps/s in this call, on {smi}")
    log(f"[encprop] launches {counts}; implied by {full} full and {STEPS - full} reuse CFG "
        f"forwards and {STEPS} decodes with their gradient: {expected}")
    if counts != expected or not torch.isfinite(out).all():
        raise RuntimeError(f"[encprop] launch counts {counts} differ from {expected}, or the "
                           f"latent is not finite")
    return counts


def phase_int8(smi: str, unet, vae) -> dict:
    """bench.py's `int8` workload on the [main] models: the headline loop
    (STEPS colour-guided DDIM steps through the full decode) under
    `conv_mode("int8_large", min_h=INT8_MIN_H)`, forward-only and with
    `int8_bwd`, each a warm and a timed pass; fails if no int8 conv ran
    (bench.py: "traced no int8 convs -- invalid"). Then the full-size
    decode's relative error against the cuDNN decode, dx's cosine against
    the exact dgrad and dw bit-equal at the largest int8 shape, and the int8
    conv's time alone against cuDNN's at the decode's int8 shapes. Returns
    the int8_bwd pass's launches."""
    from diffusion_image_editing_tpu_torch.ops import conv as C

    dev = next(unet.parameters()).device
    sd, _, _ = make_pipeline(unet, vae, dev)
    plain_fn, decode_fn = sd.eps_fn(sd.prep_text(None)), sd.decode_fn()
    xt = headline_latent(sd, dev)
    per = per_forward_launches(forward_pieces(sd, dev))
    expected = implied_launches(per, STEPS, STEPS, STEPS, 0)
    base = STEPS_S.get("headline")
    counts = None
    for bwd in (False, True):
        before = dict(C.CALL_COUNTS)
        with C.conv_mode("int8_large", min_h=INT8_MIN_H, int8_bwd=bwd):
            secs, counts, peak, out = counted_headline(sd, plain_fn, decode_fn, xt)
        calls = {k: C.CALL_COUNTS[k] - before[k] for k in C.CALL_COUNTS}
        log(f"[int8] int8_large min_h {INT8_MIN_H}, int8_bwd {bwd}: {STEPS} guided DDIM steps "
            f"{secs:.3f} s = {STEPS / secs:.3f} steps/s (the plain loop "
            f"{base if base is None else round(base, 3)} steps/s, [main] {STEPS_S['main']:.3f}, "
            f"in this call), peak {peak / 2**30:.2f} GiB; conv calls over both passes {calls}, "
            f"on {smi}")
        if not calls["int8"]:
            raise RuntimeError("[int8] ran no int8 conv -- invalid")
        if counts != expected or not torch.isfinite(out).all():
            raise RuntimeError(f"[int8] launch counts {counts} differ from {expected}, or the "
                               f"latent is not finite")
    log(f"[int8] launches {counts}; implied by {STEPS} CFG UNet calls and {STEPS} decodes with "
        f"their gradient: {expected}")

    z = headline_latent(sd, dev, seed=21)
    with torch.no_grad():
        ref = sd.decode(z).float()
        with C.conv_mode("int8_large", min_h=INT8_MIN_H):
            q = sd.decode(z).float()
    dec_err = ((q - ref).norm() / ref.norm()).item()
    g = torch.Generator(device=dev).manual_seed(23)
    _, n, c, h, w = INT8_CONV_CASES[0]
    x = torch.randn((n, c, h, w), generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn((c, c, 3, 3), generator=g, device=dev) * 0.03).to(torch.bfloat16)
    cot = torch.randn((n, c, h, w), generator=g, device=dev).to(torch.bfloat16)
    grads = {}
    for bwd in (None, True):
        xx, ww = x.clone().requires_grad_(True), wt.clone().requires_grad_(True)
        y = F.conv2d(xx, ww, padding=1) if bwd is None else C.conv3x3_int8(xx, ww, int8_bwd=True)
        y.backward(cot)
        grads[bwd] = xx.grad.float(), ww.grad
    a, b = grads[None][0].flatten(), grads[True][0].flatten()
    cos = (a @ b / (a.norm() * b.norm())).item()
    dw_equal = torch.equal(grads[None][1], grads[True][1])
    log(f"[int8] full-size decode {tuple(ref.shape)} under int8_large: relative L2 error "
        f"{dec_err:.4e} against the cuDNN decode; at ({n}, {c}, {h}, {w}) -> {c}: int8_bwd dx "
        f"cosine {cos:.6f} against the exact dgrad, dw bit-equal {dw_equal}")
    if not (math.isfinite(dec_err) and dec_err < 0.15 and cos > 0.99 and dw_equal):
        raise RuntimeError(f"[int8] decode error {dec_err}, dx cosine {cos}, dw equal {dw_equal}")
    del x, wt, cot, grads, a, b
    for label, n, c, h, w in INT8_CONV_CASES:
        x = torch.randn((n, c, h, w), generator=g, device=dev).to(torch.bfloat16)
        wt = (torch.randn((c, c, 3, 3), generator=g, device=dev) * 0.03).to(torch.bfloat16)
        with torch.no_grad():
            torch.cuda.reset_peak_memory_stats()
            q_ms = time_ms(lambda: C.conv3x3_int8(x, wt), reps=5)
            q_peak = torch.cuda.max_memory_allocated()
            xq, _ = C.quantize_int8(x, (0, 1, 2, 3))
            wq, _ = C.quantize_int8(wt, (1, 2, 3))
            mm_ms = time_ms(lambda: C.int8_conv3x3_s32(xq, wq), reps=5)
            cols = torch.randint(-127, 128, (n * h * w, 9 * c), generator=g, device=dev,
                                 dtype=torch.int8)
            wmat = torch.randint(-127, 128, (9 * c, c), generator=g, device=dev,
                                 dtype=torch.int8)
            prod_ms = time_ms(lambda: torch._int_mm(cols, wmat), reps=5)
            bf_ms = time_ms(lambda: F.conv2d(x, wt, padding=1), reps=5)
        flops = 2 * n * h * w * 9 * c * c
        log(f"[int8] {label} -> {c}: int8 conv {q_ms:.4f} ms (of it the s8 product with its "
            f"column matrix {mm_ms:.4f}, the ({n * h * w}, {9 * c}) x ({9 * c}, {c}) _int_mm "
            f"alone {prod_ms:.4f}), cuDNN bf16 {bf_ms:.4f} ms; {flops / 1e12:.4f} T "
            f"operations a call: at the int8 peak {flops / PEAK_INT8_OPS * 1e3:.4f} ms, at the "
            f"bf16 peak {flops / PEAK_BF16_FLOPS * 1e3:.4f} ms; peak memory of the int8 call "
            f"{q_peak / 2**30:.2f} GiB, on {smi}")
    return counts


# ---------------------------------------------------------------------------
# 7f. spatial: one edit split over four processes sharing the card
# ---------------------------------------------------------------------------

SPATIAL_WORLD = 4
SPATIAL_STEPS = 10  # DDIM inversion steps, then as many colour-guided edit steps
SPATIAL_GUIDE = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=SPATIAL_STEPS)
SPATIAL_CFG = 3.5  # the pipeline's default CFG scale
SPATIAL_TIMEOUT_S = 600
# The split against the whole in the same call, both bf16; the two differ
# only in where and in what order they round (a rank's rows and halo,
# GroupNorm moments folded over the ranks, attention of a rank's queries).
# Pieces on fixed inputs, max |split - whole| / max |whole|: one UNet call
# (CFG for SD), one decode and its latent gradient, one encode; "image" is
# the edit's final decode of the whole run's last latent. Steps, each from
# the whole run's own latent x_i, so that no step inherits another's
# rounding: one DDIM inversion step and one guided step (the UNet, the DDIM
# update, the colour nudge through the decode's VJP), max |split - whole
# x_{i+1}| / max |whole x_{i+1} - x_i| (the step's move), the largest over
# the steps. A step's error is its eps's (and nudge's) times the step's
# coefficient, read against a move in which the x and eps terms can partly
# cancel, so it reads above the pieces: on an H100 the SD steps read
# 0.126 (inversion) and 0.121 (guided), the pieces 0.016-0.044, DDPM's
# 0.020 and 0.0096; the DDPM image, through the identity codec, is exact.
# Each tolerance is 2-3x its reading (PERF.md, [spatial]). Each check has a
# control that must exceed its tolerance: the same split with zeros in
# place of the neighbours' halo rows (`zero_halo`); on an H100 the
# controls read 0.57-1.26.
# The opt-in accelerations' entries ("<variant> <check>", SPATIAL_VARIANTS):
# fused_conv reads as the base run (the same roundings in other places), so
# it keeps the base run's values. Under int8_large a rounding difference
# upstream can move an activation across a quantization boundary, one step
# of max / 127, and the decoder stacks some 30 such convs: on an H100 the
# SD decode read 0.086 and its gradient 0.18, DDPM's eps (its 256 and 128
# rows quantized) 0.053 and its guided step 0.11, each 2-5x the exact
# run's, while one int8 conv split is the whole conv's bits
# (`int8_conv_exact`); the controls read 0.59-0.77. Those entries are 2-3x
# their readings; the rest, where no int8 conv runs or the exact pieces
# dominate, the base run's (PERF.md, "[spatial]").
SPATIAL_TOL = {"sd": {"eps": 0.1, "decode": 0.05, "decode_vjp": 0.1, "encode": 0.05,
                      "inversion_step": 0.3, "guided_step": 0.3, "image": 0.05,
                      "fused eps": 0.1, "fused decode": 0.05, "fused decode_vjp": 0.1,
                      "fused encode": 0.05, "fused guided_step": 0.3,
                      "int8 eps": 0.1, "int8 decode": 0.2, "int8 decode_vjp": 0.4,
                      "int8 encode": 0.05, "int8 guided_step": 0.3},
               "ddpm": {"eps": 0.025, "inversion_step": 0.05, "guided_step": 0.05,
                        "image": 0.0, "fused eps": 0.025, "fused guided_step": 0.05,
                        "int8 eps": 0.12, "int8 guided_step": 0.25}}
SPATIAL_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv",
                   "group_norm_stats", "group_norm_apply")
# family -> (mesh, the kernels every rank must launch in the counted edit).
# DDPM's codec is the identity, so its guidance gradient runs no attention
# backward.
SPATIAL_RUNS = {"sd": ("cfg2xsp2", SPATIAL_KERNELS),
                "ddpm": ("sp4", ("flash_attn_fwd", "group_norm_stats", "group_norm_apply"))}
# The opt-in accelerations under the split, each family on its mesh: the
# pieces (one UNet call; for SD one decode with its latent gradient and one
# encode) and the guided steps SPATIAL_VARIANT_STEPS, each from the whole
# run's latent, against the same whole with the same setting. "fused":
# every ResnetBlock2D with fused_conv (K7's halo form, launched on every
# rank); "int8": conv_mode("int8_large", min_h=INT8_MIN_H, int8_bwd=True),
# where no cuDNN 3x3 conv may run at a map of INT8_MIN_H rows or more; their
# tolerances are SPATIAL_TOL's "<variant> <check>" entries.
SPATIAL_VARIANTS = ("fused", "int8")
SPATIAL_VARIANT_STEPS = (0, SPATIAL_STEPS // 2)


@contextlib.contextmanager
def spatial_variant(variant, *modules):
    """The body with [spatial]'s `variant` (None: the models as built):
    "fused" turns fused_conv on in every ResnetBlock2D of `modules` (the
    parameters are the same either way), "int8" sets the int8_large conv
    mode with int8_bwd."""
    from diffusion_image_editing_tpu_torch.models.layers import ResnetBlock2D
    from diffusion_image_editing_tpu_torch.ops.conv import conv_mode

    blocks = [m for mod in modules if mod is not None for m in mod.modules()
              if isinstance(m, ResnetBlock2D)]
    saved = [b.fused_conv for b in blocks]
    with contextlib.ExitStack() as stack:
        if variant == "fused":
            for b in blocks:
                b.fused_conv = True
            stack.callback(lambda: [setattr(b, "fused_conv", f) for b, f in zip(blocks, saved)])
        elif variant == "int8":
            stack.enter_context(conv_mode("int8_large", min_h=INT8_MIN_H, int8_bwd=True))
        yield


@contextlib.contextmanager
def cudnn_conv3x3_rows():
    """The whole map's rows of every stride-1 3x3 `F.conv2d` (cuDNN) that the
    body runs, in a list; under a spatial split a rank's output rows times
    the ranks."""
    from diffusion_image_editing_tpu_torch.ops.split import current

    seen, orig = [], F.conv2d

    def watched(x, weight, bias=None, stride=1, padding=0, *args, **kwargs):
        if tuple(weight.shape[-2:]) == (3, 3) and stride in (1, (1, 1)):
            pad_h = padding if isinstance(padding, int) else padding[0]
            split = current()
            seen.append((x.shape[2] + 2 * pad_h - 2) * (1 if split is None else split.size))
        return orig(x, weight, bias, stride, padding, *args, **kwargs)

    F.conv2d = watched
    try:
        yield seen
    finally:
        F.conv2d = orig


def variant_pieces(w, family: str, dev, path) -> dict:
    """[spatial]'s pieces and the guided steps SPATIAL_VARIANT_STEPS, each
    from the whole run's latent path[i], on the host in f32."""
    return {"pieces": spatial_pieces(w, family, dev),
            "guided_steps": [guided_step(w, path[i].to(dev), i).float().cpu()
                             for i in SPATIAL_VARIANT_STEPS]}


def int8_conv_exact(dev) -> dict:
    """One int8 conv at the decode's stage at the gate, 128 rows of 512
    channels (INT8_CONV_CASES[-1]), split over every rank of the group
    against the same conv whole on the same input, forward and int8_bwd dx:
    the s32 sums are exact and the scales the max over the ranks, so both
    must be the whole conv's bits."""
    import torch.distributed as dist

    from diffusion_image_editing_tpu_torch.ops.conv import conv3x3, conv_mode
    from diffusion_image_editing_tpu_torch.ops.split import (SpatialSplit, gather_rows,
                                                             scatter_rows, spatial_split)

    _, n, c, h, wd = INT8_CONV_CASES[-1]
    g = torch.Generator(device=dev).manual_seed(29)
    x = torch.randn((n, c, h, wd), generator=g, device=dev).to(torch.bfloat16)
    wt = (torch.randn((c, c, 3, 3), generator=g, device=dev) * 0.03).to(torch.bfloat16)
    cot = torch.randn((n, c, h, wd), generator=g, device=dev).to(torch.bfloat16)
    outs = []
    for split in (None, SpatialSplit(dist.group.WORLD)):
        xx = x.clone().requires_grad_(True)
        with conv_mode("int8", int8_bwd=True):
            rows = scatter_rows(xx, split)
            with spatial_split(split):
                y = conv3x3(rows, wt)
            y = gather_rows(y, split)
            (dx,) = torch.autograd.grad(y, xx, cot)
        outs.append((y.detach(), dx))
    (y0, dx0), (y1, dx1) = outs
    return {"shape": (n, c, h, wd), "fwd_equal": bool(torch.equal(y0, y1)),
            "dx_equal": bool(torch.equal(dx0, dx1))}


def variant_rank_run(variant: str, w, unet, vae, family: str, dev, path) -> dict:
    """A rank's run of one variant: its pieces and steps with launch counts,
    plain K7 / GroupNorm / attention calls on the card, the int8 conv calls
    and the rows of the cuDNN 3x3 convs, then the control under
    `zero_halo` (the pieces and the first step)."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.ops import conv as C
    from diffusion_image_editing_tpu_torch.ops import fused_conv as FC

    with spatial_variant(variant, unet, vae):
        before = C.CALL_COUNTS["int8"]
        with (plain_watch([(FC, "affine_silu_conv3x3_reference")]) as plain_k7,
              plain_groupnorm_watch() as plain_gn, plain_attention_watch() as plain_attn,
              cudnn_conv3x3_rows() as rows):
            ops.reset_launch_counts()
            run = variant_pieces(w, family, dev, path)
            counts = ops.launch_counts()
        int8_calls = C.CALL_COUNTS["int8"] - before
        with zero_halo():
            control = dict(spatial_pieces(w, family, dev),
                           guided_step=guided_step(w, path[0].to(dev), 0).float().cpu())
    return dict(run, counts=counts, plain=dict(plain_k7, **plain_gn, **plain_attn),
                int8_calls=int8_calls, cudnn_rows=max(rows, default=0), control=control)


def spatial_models(family: str, dev, cfgs: dict):
    """The seeded models of a [spatial] run, bf16, as `build_models` makes
    [main]'s: (unet, vae) for SD, (unet, None) for DDPM."""
    from diffusion_image_editing_tpu_torch.models import AutoencoderKL, UNet2D, UNet2DCondition

    torch.manual_seed(0)
    if family == "sd":
        return (UNet2DCondition(cfgs["sd_unet"], device=dev, dtype=torch.bfloat16),
                AutoencoderKL(cfgs["sd_vae"], device=dev, dtype=torch.bfloat16))
    return UNet2D(cfgs["ddpm_unet"], device=dev, dtype=torch.bfloat16), None


def weights_digest(*modules) -> str:
    """A digest of every parameter's first 1024 values, bytes exact."""
    import hashlib

    h = hashlib.sha256()
    for m in modules:
        if m is None:
            continue
        for name, t in m.state_dict().items():
            h.update(name.encode())
            h.update(t.detach().flatten()[:1024].float().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def spatial_wrapper(family: str, unet, vae, dev):
    """[spatial]'s wrapper and 512 / 256 px input image (seeded): SD with
    [main]'s fixed text embedding, or unclipped DDPM."""
    from diffusion_image_editing_tpu_torch.core import schedule_for_model
    from diffusion_image_editing_tpu_torch.pipeline import DDPM

    rng = np.random.default_rng(0)
    if family == "sd":
        text_emb = torch.from_numpy(rng.standard_normal(
            (2, 77, unet.config.cross_attention_dim), dtype=np.float32)).to(torch.bfloat16)
        w = fixed_text_sd(unet, vae, schedule_for_model("sd", SPATIAL_STEPS), text_emb, dev)
        size = vae.config.sample_size
    else:
        w = DDPM(unet, schedule_for_model("ddpm", SPATIAL_STEPS, clip_sample=False), device=dev)
        size = unet.config.sample_size
    img = torch.from_numpy(rng.uniform(-1.0, 1.0, (1, 3, size, size)).astype(np.float32))
    return w, img.to(dev)


def spatial_pieces(w, family: str, dev) -> dict:
    """One UNet call (CFG for SD), and for SD one decode with its latent
    gradient and one encode, on fixed inputs; outputs on the host in f32."""
    if family == "sd":
        pieces = forward_pieces(w, dev)
        decoded, vjp = pieces["decode"]()
        return {"eps": pieces["eps"]().float().cpu(),
                "decode": (decoded.float().cpu(), vjp.float().cpu()),
                "encode": pieces["encode"]().float().cpu()}
    d, c = w.unet.config.sample_size, w.unet.config.in_channels
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, c, d, d),
                                                                  dtype=np.float32)).to(dev)
    return {"eps": w.eps_fn()(x, np.array([501])).float().cpu()}


def inversion_step(w, x, i: int):
    """Step i of the pipeline's DDIM inversion (`engine.invert.ddim_invert`'s
    loop) from the latent x, through the wrapper's closures."""
    from diffusion_image_editing_tpu_torch.core import schedule as S

    sched = w.schedule
    t = int(sched.timesteps[::-1][i])
    return S.next_step(sched, x, w.eps_fn(w.prep_text(None), SPATIAL_CFG)(x, t), t)


def guided_step(w, x, i: int):
    """Step i of the guided edit (`engine.edit.edit_split`'s loop at eta 0)
    from the latent x: the UNet, the DDIM update, the colour nudge through
    the decode's VJP."""
    from diffusion_image_editing_tpu_torch.core import schedule as S
    from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

    sched = w.schedule
    t = int(sched.timesteps[i])
    eps = w.eps_fn(w.prep_text(None), SPATIAL_CFG)(x, t).detach()
    x, _ = S.ddim_step(sched, x, eps, t)
    x, _ = SingleColorAttrFunc(**SPATIAL_GUIDE).apply_batched(
        x, torch.zeros_like(x), eps, t, i, sched, w.decode_fn(), mask=None, x0=None)
    return x


def inversion_path(w, img) -> list:
    """The latents of the DDIM inversion of img, step by step: x_0 (the
    encoded image) to x_SPATIAL_STEPS, on the host in f32."""
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline

    x = EditPipeline(w).prepare_for_edit(img)[0]
    path = [x.float().cpu()]
    for i in range(SPATIAL_STEPS):
        x = inversion_step(w, x, i)
        path.append(x.float().cpu())
    return path


class StepProbe:
    """Stands in for the attribute function of an edit: runs the colour
    guidance's `apply_batched` and keeps each step's latent (on the host in
    f32). Given the whole run's latents `path` (x_0 the edit's start, x_i+1
    after step i), it returns path[i + 1] in its place, so that every step
    of the edit starts from the whole run's own latent."""

    def __init__(self, path=None):
        from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc

        self.attr, self.path, self.outs = SingleColorAttrFunc(**SPATIAL_GUIDE), path, []

    def apply_batched(self, x, z, eps, t, step_idx, sched, decode_fn, **kwargs):
        out, z = self.attr.apply_batched(x, z, eps, t, step_idx, sched, decode_fn, **kwargs)
        self.outs.append(out.detach().float().cpu())
        if self.path is None:
            return out, z
        return self.path[int(step_idx) + 1].to(out.device, out.dtype), z


def spatial_edit(w, img, start, probe: StepProbe) -> dict:
    """The pipeline's DDIM inversion of `img`, then SPATIAL_STEPS guided
    steps (`probe`) from `start` and the decode, through the public
    pipeline: the inverted latent, the image and the seconds of each."""
    from diffusion_image_editing_tpu_torch.pipeline import EditPipeline

    pipe = EditPipeline(w)
    dev = img.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.perf_counter()
    xt, *_ = pipe.prepare_real_image_edit(img, eta=0.0, inversion_method="ddim")
    sync()
    t1 = time.perf_counter()
    out = pipe.edit_image(start.to(dev), attr_func=probe, collect=True)
    sync()
    t2 = time.perf_counter()
    return {"xt": xt.float().cpu(), "imgs": out.imgs.float().cpu(),
            "inv_s": t1 - t0, "edit_s": t2 - t1}


@contextlib.contextmanager
def zero_halo():
    """The control of [spatial]'s checks: the split with zeros in place of
    the neighbours' rows in every halo exchange, forward and backward (each
    rank's rows meet the convs as an image of their own; GroupNorm and
    attention still see every rank), the fault a split most easily has."""
    from diffusion_image_editing_tpu_torch.ops.split import _HaloRows

    saved = {k: _HaloRows.__dict__[k] for k in ("forward", "backward")}

    def forward(ctx, x, split, above, below):
        ctx.above, ctx.below = above, below
        return F.pad(x, (0, 0, above, below))

    def backward(ctx, g):
        return g[:, :, ctx.above:g.shape[2] - ctx.below], None, None, None

    _HaloRows.forward, _HaloRows.backward = staticmethod(forward), staticmethod(backward)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(_HaloRows, k, v)


def _tree_map(fn, obj):
    """`fn` on every leaf of nested dicts, lists and tuples."""
    if isinstance(obj, dict):
        return {k: _tree_map(fn, v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_tree_map(fn, v) for v in obj)
    return fn(obj)


def _spatial_mesh(spec: str):
    from diffusion_image_editing_tpu_torch.parallel import cfg_mesh, make_mesh

    return cfg_mesh(cfg=2, sp=2) if spec == "cfg2xsp2" else make_mesh((4,), ("sp",))


def spatial_rank(rank: int, world: int, store_path: str, payload: dict, queue) -> None:
    """One of [spatial]'s ranks: a gloo group over a FileStore, every rank
    on the same device; builds each family's seeded models (their digest
    must be the parent's), splits them over the family's mesh, runs the
    pieces, each inversion step from the whole run's latent, one counted
    edit whose guided steps each start from the whole run's latent, and the
    controls under `zero_halo`, and puts its results on `queue`."""
    import datetime
    import traceback

    import torch.distributed as dist

    from diffusion_image_editing_tpu_torch import ops

    torch.set_num_threads(2)
    dev = torch.device(payload["device"])
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=SPATIAL_TIMEOUT_S))
    try:
        out = {}
        for family, (spec, _) in SPATIAL_RUNS.items():
            whole = _tree_map(torch.from_numpy, payload["whole"][family])
            unet, vae = spatial_models(family, dev, payload["cfgs"])
            digest = weights_digest(unet, vae)
            if digest != payload["digest"][family]:
                raise RuntimeError(f"rank {rank}: {family} weights digest {digest} is not the "
                                   f"parent's {payload['digest'][family]}")
            w, img = spatial_wrapper(family, unet, vae, dev)
            wm = w.to_mesh(_spatial_mesh(spec))
            pieces = spatial_pieces(wm, family, dev)  # also warms the split's shapes
            inv, path = whole["inv"], whole["path"]
            inv_steps = [inversion_step(wm, inv[i].to(dev), i).float().cpu()
                         for i in range(SPATIAL_STEPS)]
            probe = StepProbe(path)
            with plain_groupnorm_watch() as plain_gn, plain_attention_watch() as plain_attn:
                ops.reset_launch_counts()
                res = spatial_edit(wm, img, path[0], probe)
                counts = ops.launch_counts()
            with zero_halo():
                control = dict(spatial_pieces(wm, family, dev),
                               inversion_step=inversion_step(wm, inv[0].to(dev), 0).float().cpu(),
                               guided_step=guided_step(wm, path[0].to(dev), 0).float().cpu())
            out[family] = dict(res, pieces=pieces, inversion_steps=inv_steps,
                               guided_steps=probe.outs,
                               control=control, counts=counts, plain=dict(plain_gn, **plain_attn),
                               eps_fn=type(wm.eps_fn(wm.prep_text(None))).__name__)
            for v in SPATIAL_VARIANTS:
                t0 = time.perf_counter()
                out[family][v] = variant_rank_run(v, wm, unet, vae, family, dev, path)
                out[family][v]["seconds"] = time.perf_counter() - t0
            del unet, vae, w, wm
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out["int8_conv"] = int8_conv_exact(dev)
        # numpy through the queue: a tensor would be shared by a file
        # descriptor that dies with this process
        queue.put((rank, _tree_map(lambda v: v.numpy() if torch.is_tensor(v) else v, out)))
    except BaseException:
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def step_err(got, path, i: int) -> float:
    """max |got - path[i + 1]| / max |path[i + 1] - path[i]|: a step's error
    relative to the whole step's move."""
    want, move = path[i + 1].float(), (path[i + 1] - path[i]).float()
    return ((got.float() - want).abs().max() / move.abs().max()).item()


def _piece_checks(ref: dict, r0: dict) -> list:
    """The pieces' checks of `spatial_checks` and `variant_checks`."""
    checks = []
    for name, want in ref["pieces"].items():
        wants = want if isinstance(want, tuple) else (want,)
        gots = r0["pieces"][name] if isinstance(want, tuple) else (r0["pieces"][name],)
        ctrls = r0["control"][name] if isinstance(want, tuple) else (r0["control"][name],)
        for part, g, c, wv in zip(("", "_vjp"), gots, ctrls, wants):
            checks.append((name + part, rel_err(g, wv), rel_err(c, wv), tuple(wv.shape), None))
    return checks


def variant_checks(ref: dict, r0: dict, path) -> list:
    """A variant's checks of rank 0's results against the whole run's with
    the same variant, as `spatial_checks`' entries: the pieces, and the
    guided steps from path[i], each read against the whole step's move."""
    checks = _piece_checks(ref, r0)

    def err(got, i, j):
        want = ref["guided_steps"][j].float()
        return ((got.float() - want).abs().max() / (want - path[i]).abs().max()).item()

    errs = [err(g, i, j) for j, (i, g) in enumerate(zip(SPATIAL_VARIANT_STEPS,
                                                        r0["guided_steps"]))]
    checks.append(("guided_step", max(errs), err(r0["control"]["guided_step"], 0, 0),
                   tuple(path[0].shape), errs))
    return checks


def spatial_checks(family: str, ref: dict, r0: dict) -> list:
    """[spatial]'s checks of rank 0's results against the whole run's: each
    as (name, reading, its control's reading, the shape compared, the
    steps' readings or None)."""
    checks = _piece_checks(ref, r0)
    for kind, path in (("inversion_step", ref["inv"]), ("guided_step", ref["path"])):
        errs = [step_err(g, path, i) for i, g in enumerate(r0[kind + "s"])]
        checks.append((kind, max(errs), step_err(r0["control"][kind], path, 0),
                       tuple(path[0].shape), errs))
    # the final image decodes the whole run's last latent: its control is
    # the decode piece's
    checks.append(("image", rel_err(r0["imgs"], ref["imgs"]),
                   checks[[c[0] for c in checks].index("decode")][2] if family == "sd" else None,
                   tuple(ref["imgs"].shape), None))
    return checks


def spatial_variant_report(family: str, spec: str, ref: dict, got: dict) -> list:
    """Logs each variant's checks, ranks and launches; returns the failures."""
    failures = []
    for v in SPATIAL_VARIANTS:
        r0 = got[0][family][v]
        for name, reading, control, shape, steps in variant_checks(ref[v], r0, ref["path"]):
            tol = SPATIAL_TOL[family][f"{v} {name}"]
            ok = reading <= tol < control
            what = ("max over the steps, each from the whole run's latent, / the step's move"
                    if steps else "max |split - whole| / max |whole|")
            log(f"[spatial] {family} {spec} {v} {name} {shape}: {what} {reading:.4e} (tol {tol}); "
                f"control with zero halo rows {control:.4e}"
                + (f"; by step {[float(f'{e:.3g}') for e in steps]}" if steps else "")
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{family} {v} {name}")
        same = all(torch.equal(a, b) for r in got for k in ("pieces", "guided_steps")
                   for a, b in zip(_tree_leaves(got[r][family][v][k]), _tree_leaves(r0[k])))
        log(f"[spatial] {family} {spec} {v}: the {SPATIAL_WORLD} ranks' pieces and steps "
            f"bit-equal: {same}")
        if not same:
            failures.append(f"{family} {v} ranks part")
        for r in sorted(got):
            g = got[r][family][v]
            counts = {k: n for k, n in g["counts"].items() if n}
            log(f"[spatial] {family} {spec} {v} rank {r}: launches {counts}; int8 convs "
                f"{g['int8_calls']}; cuDNN 3x3 convs up to {g['cudnn_rows']} rows of the whole "
                f"map; plain on the card {g['plain']}; {g['seconds']:.1f} s")
            bad = any(g["plain"].values()) or (
                g["counts"]["affine_silu_conv3x3"] == 0 if v == "fused"
                else g["int8_calls"] == 0 or g["cudnn_rows"] >= INT8_MIN_H)
            if bad:
                failures.append(f"{family} {v} rank {r} launches, int8 or plain calls")
    return failures


def _tree_leaves(obj) -> list:
    """The leaves of nested dicts, lists and tuples, in order."""
    if isinstance(obj, dict):
        return [x for k in obj for x in _tree_leaves(obj[k])]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _tree_leaves(v)]
    return [obj]


def phase_spatial(smi: str, unet, vae, dev=torch.device("cuda"), ddpm_cfg=None) -> dict:
    """ROADMAP item 18b on the card: SPATIAL_WORLD processes on the one
    device (a gloo group over a FileStore; NCCL refuses two ranks on one
    GPU), each launching the kernels on its own rows, run the SD-1.5 edit
    on cfg2xsp2 with the [main] models and the DDPM 256 px edit on sp4;
    the parent runs the same whole. Checks every piece, every inversion and
    guided step (each from the whole run's latent) and the final image
    against the whole run within SPATIAL_TOL, each control beyond it, every
    rank's results bit-equal, each rank's launches of the family's kernels
    non-zero, no plain attention or GroupNorm on the card. Returns rank 0's
    launch counts of both edits added up."""
    import dataclasses
    import queue as queue_mod

    import torch.multiprocessing as mp

    from diffusion_image_editing_tpu_torch.models import DDPM_CELEBAHQ_256

    ddpm_cfg = ddpm_cfg or DDPM_CELEBAHQ_256
    cfgs = {"sd_unet": dataclasses.replace(unet.config, fused_conv=False),
            "sd_vae": dataclasses.replace(vae.config, fused_conv=False), "ddpm_unet": ddpm_cfg}
    whole, digest = {}, {}
    for family in SPATIAL_RUNS:
        if family == "sd":
            models = (unet, vae)
        else:
            models = spatial_models("ddpm", dev, cfgs)
        digest[family] = weights_digest(*models)
        w, img = spatial_wrapper(family, *models, dev)
        pieces = spatial_pieces(w, family, dev)
        inv = inversion_path(w, img)
        spatial_edit(w, img, inv[-1], StepProbe())  # warm-up
        probe = StepProbe()
        whole[family] = dict(spatial_edit(w, img, inv[-1], probe), pieces=pieces, inv=inv,
                             path=[inv[-1]] + probe.outs)
        for v in SPATIAL_VARIANTS:
            with spatial_variant(v, *models):
                whole[family][v] = variant_pieces(w, family, dev, whole[family]["path"])
        del w, models
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="spatial_store_") as root:
        payload = {"device": str(dev), "cfgs": cfgs, "digest": digest,
                   "whole": {f: _tree_map(lambda v: v.numpy(),
                                          {k: whole[f][k] for k in ("inv", "path")})
                             for f in whole}}
        procs = [ctx.Process(target=spatial_rank, args=(r, SPATIAL_WORLD,
                                                        os.path.join(root, "store"), payload,
                                                        results))
                 for r in range(SPATIAL_WORLD)]
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + SPATIAL_TIMEOUT_S
        try:
            while len(got) < SPATIAL_WORLD:
                try:
                    rank, value = results.get(timeout=5)
                    got[rank] = value
                except queue_mod.Empty:
                    dead = [p.exitcode for p in procs if not p.is_alive() and p.exitcode]
                    if dead or time.monotonic() > deadline:
                        raise RuntimeError(f"[spatial] ranks gave {sorted(got)} of "
                                           f"{SPATIAL_WORLD} results; exit codes "
                                           f"{[p.exitcode for p in procs]}")
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join(timeout=30)
    bad = {r: v for r, v in got.items() if isinstance(v, str)}
    if bad:
        raise RuntimeError(f"[spatial] ranks failed: {bad}")
    got = {r: _tree_map(lambda v: torch.from_numpy(v) if isinstance(v, np.ndarray) else v, res)
           for r, res in got.items()}
    log(f"[spatial] {SPATIAL_WORLD} processes on {dev} (gloo, host copies for the "
        f"collectives; the kernels run on the card) in {time.perf_counter() - t0:.1f} s, "
        f"on {smi}")

    failures, total = [], None
    for r in sorted(got):
        e = got[r]["int8_conv"]
        log(f"[spatial] rank {r}: an int8 conv {tuple(e['shape'])} split over the "
            f"{SPATIAL_WORLD} ranks against the same conv whole, forward bit-equal "
            f"{e['fwd_equal']}, int8_bwd dx bit-equal {e['dx_equal']}")
        if not (e["fwd_equal"] and e["dx_equal"]):
            failures.append(f"rank {r} int8 conv split is not the whole conv's bits")
    for family, (spec, must) in SPATIAL_RUNS.items():
        ref, r0 = whole[family], got[0][family]
        for name, reading, control, shape, steps in spatial_checks(family, ref, r0):
            tol = SPATIAL_TOL[family][name]
            ok = reading <= tol and (control is None or control > tol)
            what = ("max over the steps, each from the whole run's latent, / the step's move"
                    if name.endswith("_step") else "max |split - whole| / max |whole|")
            log(f"[spatial] {family} {spec} {name} {shape}: {what} {reading:.4e} (tol {tol}); "
                "control with zero halo rows "
                + ("none (the identity codec)" if control is None else f"{control:.4e}")
                + (f"; by step {[float(f'{e:.3g}') for e in steps]}" if steps else "")
                + f" {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{family} {name}")
        finite = all(bool(torch.isfinite(r0[k]).all()) for k in ("xt", "imgs"))
        keys = ("xt", "imgs", "inversion_steps", "guided_steps")
        same = all(torch.equal(a, b) for r in got for k in keys
                   for a, b in zip(_as_list(got[r][family][k]), _as_list(r0[k])))
        log(f"[spatial] {family} {spec}: the {SPATIAL_WORLD} ranks' inverted latent "
            f"{tuple(r0['xt'].shape)}, steps and image {tuple(r0['imgs'].shape)} bit-equal: "
            f"{same}; finite: {finite}; closure {r0['eps_fn']}")
        if not (same and finite):
            failures.append(f"{family} ranks part or not finite")
        for r in sorted(got):
            g = got[r][family]
            counts = {k: g["counts"][k] for k in g["counts"] if g["counts"][k]}
            log(f"[spatial] {family} {spec} rank {r}: launches {counts}; plain on the card "
                f"{g['plain']}; inversion {g['inv_s'] / SPATIAL_STEPS * 1e3:.1f} ms/step, "
                f"guided edit {g['edit_s'] / SPATIAL_STEPS * 1e3:.1f} ms/step (four processes "
                f"sharing one card, not a speed of the split)")
            if any(g["counts"][k] == 0 for k in must) or any(g["plain"].values()):
                failures.append(f"{family} rank {r} launches or plain calls")
        log(f"[spatial] {family} whole on one process: inversion "
            f"{ref['inv_s'] / SPATIAL_STEPS * 1e3:.1f} ms/step, guided edit "
            f"{ref['edit_s'] / SPATIAL_STEPS * 1e3:.1f} ms/step")
        failures += spatial_variant_report(family, spec, ref, got)
        total = ({k: v for k, v in r0["counts"].items()} if total is None
                 else {k: total[k] + r0["counts"][k] for k in total})
    if failures:
        raise RuntimeError(f"[spatial] failed: {failures}")
    return total


def _as_list(v) -> list:
    return list(v) if isinstance(v, (list, tuple)) else [v]


# ---------------------------------------------------------------------------
# 7g. extra: item 19's blocks through K8
# ---------------------------------------------------------------------------

EXTRA_TOL = 2e-2  # max |K8 - plain| / max |plain| of a bf16 block: twice ABN_TOL's bf16 step


def _bf16_convs(module):
    """Convolutions in bf16, the ABNs' f32 parameters and statistics as they are."""
    for m in module.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.to(torch.bfloat16)
    return module


def phase_extra(smi: str, dev=torch.device("cuda")) -> dict:
    """`DeeplabV3Head` (ASPP, 19 classes) and a 2-conv `IdentityResidualBlock`
    at width 256 on a (4, 256, 64, 64) bf16 map, eval and training mode,
    every ABN through K8, against the same block with K8's plain version;
    times both. Returns the launch counts of the kernel runs."""
    from diffusion_image_editing_tpu_torch import ops
    from diffusion_image_editing_tpu_torch.models import DeeplabV3Head, IdentityResidualBlock
    from diffusion_image_editing_tpu_torch.ops import abn as ABN

    gen = torch.Generator(device=dev).manual_seed(3)
    torch.manual_seed(3)
    blocks = {"DeeplabV3Head": (DeeplabV3Head(256, 256, 256, 19, device=dev), 3),
              "IdentityResidualBlock": (IdentityResidualBlock(256, (256, 256), device=dev), 2)}
    x = _randn((4, 256, 64, 64), gen, dev)
    failures, total = [], None
    for name, (block, n_abn) in blocks.items():
        _bf16_convs(block)
        with torch.no_grad():
            for m in block.modules():
                if isinstance(m, ABN.FusedABNorm):
                    c = m.weight.shape[0]
                    m.weight.copy_(1 + 0.2 * torch.randn(c, generator=gen, device=dev))
                    m.bias.copy_(0.1 * torch.randn(c, generator=gen, device=dev))
                    m.running_mean.copy_(0.1 * torch.randn(c, generator=gen, device=dev))
                    m.running_var.uniform_(0.5, 1.5, generator=gen)
        for mode in ("eval", "train"):
            block.train(mode == "train")
            state = {k: v.clone() for k, v in block.state_dict().items()}
            with torch.no_grad():
                ops.reset_launch_counts()
                y = block(x)
                counts = ops.launch_counts()
                block.load_state_dict(state)
                orig, ABN._apply = ABN._apply, ABN.abn_apply_reference
                try:
                    ref = block(x)
                    block.load_state_dict(state)
                    plain_ms = time_ms(lambda: block(x), reps=5)
                finally:
                    ABN._apply = orig
                block.load_state_dict(state)
                ms = time_ms(lambda: block(x))
                block.load_state_dict(state)
            rel = rel_err(y, ref)
            ok = (rel <= EXTRA_TOL and bool(torch.isfinite(y).all())
                  and counts["abn_apply"] == n_abn)
            log(f"[extra] {name} {mode} x{tuple(x.shape)} bf16 -> {tuple(y.shape)}: K8 vs its "
                f"plain version max |diff| {(y.float() - ref.float()).abs().max().item():.4e}, "
                f"relative {rel:.4e} (tol {EXTRA_TOL}); K8 launches {counts['abn_apply']} "
                f"(want {n_abn}) {'ok' if ok else 'FAIL'} | block with K8 {ms:.4f} ms, with "
                f"the plain ABN {plain_ms:.4f} ms, on {smi}")
            if not ok:
                failures.append(f"{name} {mode}")
            total = counts if total is None else {k: total[k] + counts[k] for k in total}
    if failures:
        raise RuntimeError(f"[extra] failed: {failures}")
    return total


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
# 10b. metrics
# ---------------------------------------------------------------------------

METRICS_N = 4  # generated images of the attribute evaluation and of the round trip


def phase_metrics(smi: str, dev=torch.device("cuda")) -> dict:
    """The CLI's `metrics` flow at full width on the DDPM CelebA-HQ-256 UNet
    (loaded as [ddpm_edit] loads it) with the anyGAN ResNet-50 as guidance
    and as predictor: `run_attribute_evaluation` (METRICS_N images, eta 1,
    edit-friendly DDPM re-inversion, the default t_skip, ClassifierAttrFunc
    as [ddpm_edit]'s), then the CLI's round trip without `--attr-func`
    (DDPM inversion and re-generation) scored by `inversion_roundtrip_metrics`
    with a full-width LPIPS, that LPIPS held against the CPU. Checks the
    metrics and the launch counts; returns the evaluation's counts."""
    import copy
    import inspect

    from diffusion_image_editing_tpu_torch.engine import ddpm_invert, ddpm_sample
    from diffusion_image_editing_tpu_torch.evals import (
        inversion_roundtrip_metrics, make_lpips_fn, run_attribute_evaluation)
    from diffusion_image_editing_tpu_torch.guidance import ClassifierAttrFunc
    from diffusion_image_editing_tpu_torch.pipeline import (
        EditPipeline, create_diffusion_model, get_pretrained_anygan)

    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="metrics_ckpt_") as root:
        written, _ = write_family_checkpoint(root, "ddpm", dev)
        clf_path = os.path.join(root, "anygan.pth")
        written["anygan"] = write_anygan(clf_path, dev)
        t0 = time.perf_counter()
        w = create_diffusion_model("ddpm", sample_clipping=False, checkpoint_dir=root,
                                   num_inference_steps=STEPS, device=dev)
        _, clf = get_pretrained_anygan(clf_path, width=ANYGAN_WIDTH, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    n_tensors = check_loaded("metrics", {"unet": w.unet, "anygan": clf}, written)
    del written
    log(f"[metrics] DDPM CelebA-HQ-256 and the anyGAN ResNet-50 loaded in {load_s:.3f} s, "
        f"{n_tensors} tensors bit-equal to those written")
    per = per_forward_launches(family_pieces(w, dev))
    check_family_pieces("metrics", w, per)
    predict = clf_logits_fn(clf)
    attr = ClassifierAttrFunc(t1=0, t2=STEPS, clf_apply_fn=predict, **CLF)
    pipe = EditPipeline(w)
    seconds = {}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t
            return out
        return run

    w.generate_images = timed("generation", w.generate_images)
    pipe.prepare_real_image_edit = timed("inversion", pipe.prepare_real_image_edit)
    pipe.edit_image = timed("edit", pipe.edit_image)
    t_skip = min(36, STEPS - 1)  # run_attribute_evaluation's default
    # the re-inversion runs at prepare_real_image_edit's default chunk
    inv_chunk = inspect.signature(EditPipeline.prepare_real_image_edit).parameters["chunk"].default
    calls = STEPS + math.ceil(STEPS / inv_chunk) + (STEPS - t_skip)
    with counted_block("[metrics] run_attribute_evaluation",
                       implied_launches(per, calls, 0, 0, 0)) as run:
        res = run_attribute_evaluation(w, pipe, predict, attr, n_samples=METRICS_N,
                                       num_inference_steps=STEPS, eta=1.0, seed=0,
                                       inversion="ddpm")
    peak = torch.cuda.max_memory_allocated()
    rest = run["seconds"] - sum(seconds.values())
    log(f"[metrics] {METRICS_N} images: generation ({STEPS} steps) {seconds['generation']:.3f} "
        f"s, DDPM re-inversion (batched, chunk {inv_chunk}) {seconds['inversion']:.3f} s, "
        f"{STEPS - t_skip} ClassifierAttrFunc-guided steps + identity decode "
        f"{seconds['edit']:.3f} s, predictions and scores {rest:.3f} s; whole "
        f"{run['seconds']:.3f} s; peak memory {peak / 2**30:.2f} GiB, on {smi}")
    cons, deltas = res["attribute_consistency"], res["score_deltas"]
    values = [d for _, _, d in deltas]
    top = ", ".join(f"{name} {d:+.3e}" for _, name, d in deltas[:3])
    log(f"[metrics] attribute consistency over {len(cons)} attributes: mean "
        f"{np.mean(list(cons.values())):.2f} %, min {min(cons.values()):.2f} %; score deltas: "
        f"{top} ... {deltas[-1][1]} {deltas[-1][2]:+.3e}")
    if (len(cons) != 40 or not all(0.0 <= v <= 100.0 for v in cons.values())
            or len(deltas) != 40 or not all(math.isfinite(d) for d in values)
            or values != sorted(values, reverse=True)
            or sorted(i for i, _, _ in deltas) != list(range(40))):
        raise RuntimeError(f"[metrics] malformed attribute metrics: {res}")

    gen = torch.Generator(device=dev).manual_seed(0)
    with counted_block("[metrics] round trip (DDPM inversion + re-generation)",
                       implied_launches(per, 2 * STEPS, 0, 0, 0)) as rt:
        x0 = torch.randn(w.latent_shape(METRICS_N), generator=gen, device=dev) * 0.5
        inv = ddpm_invert(w.schedule, w.eps_fn(), x0, eta=1.0, generator=gen)
        recon = ddpm_sample(w.schedule, w.eps_fn(), inv.zs, inv.xts, t_skip=0)
    lp_cpu = seeded_lpips()
    lp = copy.deepcopy(lp_cpu).to(dev)
    lpips_fn = make_lpips_fn(lp)
    t0 = time.perf_counter()
    scores = inversion_roundtrip_metrics(x0, recon, lpips_fn)
    lpips_s = time.perf_counter() - t0
    with torch.no_grad():
        self_d = lpips_fn(x0, x0).abs().max().item()
        ab, ba = lpips_fn(x0, recon), lpips_fn(recon, x0)
        sym = ((ab - ba).abs().max() / ab.abs().max()).item()
        a = torch.cat([x0[:1], x0[:1]])
        b = torch.cat([recon[:1], x0[1:2]])  # a near pair and a far one
        card = lpips_fn(a, b).cpu()
        cpu = lp_cpu(a.cpu(), b.cpu())
    err = ((card - cpu).abs().max() / cpu.abs().max()).item()
    log(f"[metrics] round trip of {METRICS_N} random images {rt['seconds']:.3f} s: {scores}; "
        f"the metrics {lpips_s:.3f} s; LPIPS(a, a) max {self_d:.3e} (at most 1e-6), "
        f"|LPIPS(a, b) - LPIPS(b, a)| / LPIPS {sym:.3e} (at most 1e-5); LPIPS card "
        f"{card.tolist()} against cpu {cpu.tolist()}: max relative {err:.3e} (tol {LPIPS_TOL})")
    if not (math.isfinite(scores["psnr"]) and math.isfinite(scores["lpips"]) and self_d <= 1e-6
            and sym <= 1e-5 and err <= LPIPS_TOL):
        raise RuntimeError(f"[metrics] round-trip metrics or LPIPS checks failed: {scores}, "
                           f"self {self_d}, symmetry {sym}, card vs cpu {err}")
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
    remat_counts = phase_remat(smi, unet, vae)
    pace_probe("before [sweep]")
    sweep_counts = phase_sweep(smi, unet, vae)
    dist_counts = phase_dist(smi, unet, vae)
    spatial_counts = phase_spatial(smi, unet, vae)
    pace_probe("before [proxy]")
    proxy_counts = phase_proxy(smi, unet, vae)
    encprop_counts = phase_encprop(smi, unet, vae)
    int8_counts = phase_int8(smi, unet, vae)
    seg_fast_counts = phase_seg_edit(smi, unet, vae, fast=True)
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
    metrics_counts = phase_metrics(smi)
    gc.collect()
    torch.cuda.empty_cache()
    seg_counts = phase_seg(smi)
    extra_counts = phase_extra(smi)
    for name, e in entries.items():
        # K7 runs only in the fused-conv configuration, K8 only on the
        # trainer's path; the rest are read from the default path's run.
        e["launches"] = {"affine_silu_conv3x3": fused_counts,
                         "abn_apply": seg_counts}.get(name, counts)[name]
        e["launches_by_phase"] = {"remat": remat_counts[name], "metrics": metrics_counts[name],
                                  "sweep": sweep_counts[name], "dist": dist_counts[name],
                                  "proxy": proxy_counts[name], "encprop": encprop_counts[name],
                                  "int8": int8_counts[name], "seg_fast": seg_fast_counts[name],
                                  "spatial_rank0": spatial_counts[name],
                                  "extra": extra_counts[name]}
    log(json.dumps({"kernels": list(entries.values())}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
