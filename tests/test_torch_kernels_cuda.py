"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; every test skips without a card. Run
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest sets JAX up, which these tests do not
use). chip_smoke.py holds the kernels at the main path's shapes; these
cases add what the path does not reach.

Attention (K1-K3): ragged query and key lengths that are no multiple of any
tile, a single row, and head dims padded inside the kernel to each built
width (8 -> 16, 24 -> 32, 56 -> 64, 72 -> 80, 472 -> 512; 64 itself, the
TINY DDPM UNet's single head), on both designs: narrow
heads (padded width up to 160) with one warp per 16 rows, and the wide
heads' warpgroup designs. The forward's warpgroup design for the
wide heads (64-row blocks in pairs that split the keys, 32-key tiles) at
the VAE's shapes, rows and keys that are no multiple of a block or a tile,
fewer keys than one tile (the second block of a pair has none), several
batches and heads, 456 padded to 512 (472 and 33 rows are cases of the
first forward test), and a negative scale, one launch each. K3's warpgroup
design for the wide heads (clusters of two blocks, one holding dV and the
other dK, 32-query tiles) at the VAE's and the DDPM's shapes, query and key
counts that fill no tile (Sq != Sk), one query tile, several batches and
heads with an odd tile count, and 472 padded to 512, each within the
gradient tolerance and bit-equal on a second call; K2's warpgroup design
for the wide heads (64-row blocks in clusters of two that split the keys,
32-key tiles) at the same five shapes and with fewer keys than one tile,
the same way. The forward's 128-row design (padded
width 48: head dim 40, whose row sum comes from the PV product, and 48,
which sums P itself; padded width 80, two row fragments a warp: 72 and 80)
at query and key lengths that are no multiple of its 128-row block or its
64-key tile, 77 and 1 keys, several batches and heads (batch 16 of 8
heads, a sweep's CFG UNet), one launch each; a negative scale goes to the
4-warp design; more heads than the launch grid's y dimension takes
(65535) are refused. Tolerances, bf16 in and out as on the
main path, each as max |kernel - plain| / max |plain|: forward 2e-2, a few
times the readings that chip_smoke.py prints at the main path's shapes
(PERF.md); gradients 2e-2 (P and dS are rounded to bf16 in the kernels'
products). Log-sum-exp max |kernel - plain| 1e-3 (f32 sums of bf16 products
in another order).

GroupNorm (K4-K6): H * W not a multiple of 8 (the scalar paths), C / G = 1
and 2, batch 20, slabs at and above K4's limit, large-mean input, and
K4 and K5 each at every cluster size (1, 2, 4, 8 blocks a slab), with
slabs whose 16-byte vectors (or elements, on the scalar path) do not
split evenly over the cluster, and K4 at its route limit (512 KiB).
Two calls of K4 and of K5 give the same bits. Output tolerance 1e-2 of max |plain|: both round the
same f32 value to bf16, so they differ by at most one bf16 step (2^-7
relative) where the f32 values straddle a rounding boundary. Statistics:
mean within 1e-5 * (|mean| + 1), rstd within 1e-4 relative (f32 sums in
another order).

Fused conv (K7): H, W = 4, 12 x 20, 7 x 9 (no 16-byte rows of x or y) and
64; Cin of 8, 16, 24, 72 and 960 (not whole 64-channel chunks) and Cout of
16, 24, 320 and 960 (not whole cout tiles of either width); maps of fewer
pixels than one 128-pixel tile at batch 1, 2 and 3 (a tile then holds
several images, or part of one); shapes that split Cin; bf16 and f32
bias. B lies far from zero, so silu(B) in the halo would show. Tolerance
2e-2 of max |plain| (f32 accumulation in another order, one rounding of
the output where the plain version rounds the conv and the bias add
apart). Two calls on the same inputs are bit-equal, and a weight changed
in place is packed anew. Gradients through the autograd function 2e-2 (the
same backward ops on both sides, fed by outputs that differ by the
forward's rounding). K7's halo form (a rank's rows of the spatial split
with a neighbour's row above and below, real or the image's edge): 1, 2,
3, 4 and 32 rows, each edge flag, the same tolerances; a slice of a map
with its real neighbours within 2e-2 of the whole map's rows (its tiles
and splits differ), and both edges off on a zero-padded map bit-equal to
the whole map's output.

ABN (K8): the trainer's shapes (the stem's 224 x 224 x 64 at batch 16,
layer4's 14 x 14 x 512, the 1 x 1 norms), H * W not a multiple of the
vector width (7 x 9; 14 x 14 in bf16), a tensor that is not 16-byte
aligned, each activation, f32 and bf16. The kernel repeats the plain
version's f32 operations in order, each rounded: f32 within 1e-5 of
max |plain| (bit-equal for identity and leaky_relu; expm1 may differ by an
ulp), bf16 within 1e-2 (one bf16 step where the f32 values straddle a
rounding boundary). The training autograd function on the card against the
same on the CPU: rtol 1e-4 (per-channel sums in another order).
"""

import pytest
import torch

import diffusion_image_editing_tpu_torch.ops as OPS
from diffusion_image_editing_tpu_torch.ops import abn as ABN
from diffusion_image_editing_tpu_torch.ops import attention as A
from diffusion_image_editing_tpu_torch.ops import fused_conv as FC
from diffusion_image_editing_tpu_torch.ops import groupnorm as GN

pytestmark = pytest.mark.cuda

FWD_TOL, LSE_TOL, GRAD_TOL = 2e-2, 1e-3, 2e-2
GN_TOL, MEAN_TOL, RSTD_TOL = 1e-2, 1e-5, 1e-4
CONV_TOL = 2e-2
ABN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


def _launched(fn):
    before = OPS.launch_counts()
    out = fn()
    torch.cuda.synchronize()
    after = OPS.launch_counts()
    return out, {n: after[n] - before[n] for n in after if after[n] != before[n]}


def _rand(shape, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d",
    [
        (1, 1, 1, 1, 8),
        (1, 77, 77, 2, 40),
        (1, 100, 300, 3, 24),
        (2, 64, 77, 8, 80),
        (1, 200, 64, 2, 72),
        (1, 130, 65, 2, 160),
        (2, 256, 256, 1, 64),  # TINY_UNET2D's single 64-wide head
        (1, 70, 33, 3, 56),    # 56 padded to 64
        (1, 96, 50, 1, 472),
        (1, 33, 200, 1, 512),
    ],
)
def test_forward_and_lse_match_plain(gen, b, s_q, s_k, h, d):
    q = _rand((b, s_q, h, d), gen)
    k, v = _rand((b, s_k, h, d), gen), _rand((b, s_k, h, d), gen)
    scale = d ** -0.5
    out, lse = A.flash_attn_fwd(q, k, v, scale, with_lse=True)
    ref = A.attention_reference(q, k, v, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    ref_lse = torch.logsumexp(logits, dim=-1).reshape(b * h, s_q)
    err = (out.float() - ref.float()).abs().max() / ref.float().abs().max()
    assert err.item() <= FWD_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    primal = A.attention(q, k, v, scale)  # no gradient asked: the kernel without lse
    assert torch.equal(primal, out)


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d,scale",
    [
        (1, 1, 1, 1, 40, 0.16),
        (2, 130, 77, 3, 40, 0.16),      # the cross-attention's 77 keys, a ragged tile
        (2, 257, 1, 2, 40, 0.16),       # one key; two blocks and a row past them
        (1, 200, 129, 2, 40, 0.16),     # 3 key tiles, the last of one key
        (3, 384, 640, 2, 40, 0.16),     # whole blocks and tiles, 10 tiles through the ring
        (1, 150, 190, 2, 48, 0.144),    # no padding column: P summed by the warp
        (2, 300, 77, 2, 40, -0.16),     # a negative scale takes the 4-warp design
        (2, 1024, 77, 3, 80, 0.11),     # head dim 80: two row fragments a warp
        (1, 100, 130, 2, 72, 0.12),     # 72 in 80: the ones column
        (1, 200, 300, 2, 80, 0.11),
        (16, 1000, 77, 8, 40, 0.16),    # batch 16 (a sweep's CFG UNet): 128 heads on grid y
        (1, 1024, 1024, 14, 32, 32 ** -0.5),  # the LDM UNet's heads of 32 at 32 x 32
        (1, 256, 256, 21, 32, 32 ** -0.5),    # ... at 16 x 16
        (1, 64, 64, 28, 32, 32 ** -0.5),      # ... at 8 x 8: half a block of rows
        (2, 130, 77, 3, 32, 0.18),      # padded 32: ragged rows, 77 keys
        (1, 100, 130, 2, 24, 0.2),      # 24 in 32: the ones column
        (2, 300, 77, 2, 32, -0.18),     # a negative scale takes the 4-warp design
        (1, 1000, 1000, 3, 32, 0.18),   # 128-key tiles split over a cluster, the last ragged
        (1, 200, 1000, 2, 80, 0.11),    # 64-key tiles split, the last of 40 keys
        (1, 130, 520, 2, 40, 0.16),     # split with the ones column: 5 tiles and 4
    ],
)
def test_forward_rows128_design_matches_plain(gen, b, s_q, s_k, h, d, scale):
    q = _rand((b, s_q, h, d), gen)
    k, v = _rand((b, s_k, h, d), gen), _rand((b, s_k, h, d), gen)
    (out, lse), launched = _launched(lambda: A.flash_attn_fwd(q, k, v, scale, with_lse=True))
    ref = A.attention_reference(q, k, v, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    ref_lse = torch.logsumexp(logits, dim=-1).reshape(b * h, s_q)
    assert launched == {"flash_attn_fwd": 1}
    assert _rel(out, ref) <= FWD_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    primal, launched = _launched(lambda: A.attention(q, k, v, scale))
    assert launched == {"flash_attn_fwd": 1} and torch.equal(primal, out)


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d,scale",
    [
        (2, 256, 256, 8, 160, 160 ** -0.5),   # the SD UNet's 16 x 16: keys split over a cluster
        (2, 256, 77, 8, 160, 160 ** -0.5),    # its cross-attention: one ragged tile a rank
        (16, 256, 256, 8, 160, 160 ** -0.5),  # [sweep]'s batch 16: 512 row blocks, no split
        (16, 256, 77, 8, 160, 160 ** -0.5),
        (20, 256, 77, 8, 160, 160 ** -0.5),   # the batched inversion's
        (2, 64, 64, 8, 160, 160 ** -0.5),     # 8 x 8: one key tile, no split
        (2, 64, 77, 8, 160, 160 ** -0.5),     # two tiles, the second of 13 keys
        (1, 128, 256, 8, 160, 0.08),          # [spatial]'s rank: rows against all keys
        (1, 130, 65, 2, 160, 0.08),           # ragged rows; the second rank one key
        (3, 200, 300, 5, 152, 0.08),          # 152 in 160; ragged rows and keys, a split
        (8, 200, 300, 20, 152, 0.08),         # the same unsplit: the TMA store drops columns
        (1, 10, 1, 1, 160, 0.08),             # one key: one tile, no split
        (4, 500, 700, 40, 160, 0.08),         # 1280 row blocks, 11 tiles through the ring
        (2, 256, 77, 8, 160, -0.08),          # a negative scale takes the 4-warp design
    ],
)
def test_forward_wg_design_matches_plain(gen, b, s_q, s_k, h, d, scale):
    q = _rand((b, s_q, h, d), gen)
    k, v = _rand((b, s_k, h, d), gen), _rand((b, s_k, h, d), gen)
    (out, lse), launched = _launched(lambda: A.flash_attn_fwd(q, k, v, scale, with_lse=True))
    ref = A.attention_reference(q, k, v, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    ref_lse = torch.logsumexp(logits, dim=-1).reshape(b * h, s_q)
    assert launched == {"flash_attn_fwd": 1}
    assert _rel(out, ref) <= FWD_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    primal, launched = _launched(lambda: A.attention(q, k, v, scale))
    assert launched == {"flash_attn_fwd": 1} and torch.equal(primal, out)


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d,scale",
    [
        (1, 4096, 4096, 1, 512, 512 ** -0.5),  # the VAE's mid-block attention
        (1, 256, 256, 1, 512, 512 ** -0.5),    # the VAE at 16 x 16 latents
        (1, 100, 130, 1, 512, 0.044),          # ragged rows and keys
        (1, 64, 20, 1, 512, 0.044),            # fewer keys than one 32-key tile
        (1, 10, 300, 1, 512, 0.044),           # fewer rows than one 64-row block
        (1, 65, 1, 1, 512, 0.044),             # one key: the second block of the pair has none
        (1, 70, 33, 1, 512, 0.044),            # two tiles, one a block, the second of one key
        (2, 130, 77, 3, 512, 0.044),           # batches and heads, rows not whole blocks
        (1, 80, 90, 2, 456, 0.047),            # the narrowest width the design takes
        (1, 100, 300, 1, 512, -0.044),         # a negative scale
    ],
)
def test_forward_wide_design_matches_plain(gen, b, s_q, s_k, h, d, scale):
    q = _rand((b, s_q, h, d), gen)
    k, v = _rand((b, s_k, h, d), gen), _rand((b, s_k, h, d), gen)
    (out, lse), launched = _launched(lambda: A.flash_attn_fwd(q, k, v, scale, with_lse=True))
    ref = A.attention_reference(q, k, v, scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    ref_lse = torch.logsumexp(logits, dim=-1).reshape(b * h, s_q)
    assert launched == {"flash_attn_fwd": 1}
    assert _rel(out, ref) <= FWD_TOL
    assert (lse - ref_lse).abs().max().item() <= LSE_TOL
    primal, launched = _launched(lambda: A.attention(q, k, v, scale))
    assert launched == {"flash_attn_fwd": 1} and torch.equal(primal, out)


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d",
    [(1, 77, 77, 2, 40), (2, 64, 77, 8, 80), (1, 100, 130, 1, 512), (2, 256, 256, 1, 64),
     (1, 70, 33, 3, 56)],
)
def test_backward_matches_plain(gen, b, s_q, s_k, h, d):
    q = _rand((b, s_q, h, d), gen).requires_grad_()
    k = _rand((b, s_k, h, d), gen).requires_grad_()
    v = _rand((b, s_k, h, d), gen).requires_grad_()
    dout = _rand((b, s_q, h, d), gen)
    scale = d ** -0.5
    grads, launched = _launched(
        lambda: torch.autograd.grad(A.attention(q, k, v, scale), (q, k, v), dout))
    ref = torch.autograd.grad(A.attention_reference(q, k, v, scale), (q, k, v), dout)
    for g, r in zip(grads, ref):
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= GRAD_TOL
    assert launched == {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1}


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d",
    [
        (1, 4096, 4096, 1, 512),  # the VAE's mid-block attention
        (1, 256, 256, 1, 512),    # the DDPM UNet's 16 x 16 attention
        (1, 1000, 777, 2, 512),   # queries and keys that fill no tile, Sq != Sk
        (1, 20, 70, 1, 512),      # one query tile, two key clusters, the second of 6 keys
        (3, 70, 64, 2, 472),      # batches and heads, three query tiles, 472 padded to 512
    ],
)
def test_bwd_dkv_wide_design_matches_plain_and_reruns_bit_equal(gen, b, s_q, s_k, h, d):
    q, dout = _rand((b, s_q, h, d), gen), _rand((b, s_q, h, d), gen)
    k, v = _rand((b, s_k, h, d), gen), _rand((b, s_k, h, d), gen)
    scale = d ** -0.5
    out, lse = A.flash_attn_fwd(q, k, v, scale, with_lse=True)
    args = (q, k, v, dout, lse, A.attention_delta(dout, out), scale)
    got, launched = _launched(lambda: A.flash_attn_bwd_dkv(*args))
    want = A.attention_bwd_dkv_reference(*args)
    assert launched == {"flash_attn_bwd_dkv": 1}
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16 and _rel(g, w) <= GRAD_TOL
    again = A.flash_attn_bwd_dkv(*args)
    assert all(torch.equal(g, a) for g, a in zip(got, again))  # deterministic: no atomics


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d",
    [
        (1, 4096, 4096, 1, 512),  # the VAE's mid-block attention
        (1, 256, 256, 1, 512),    # the DDPM UNet's 16 x 16 attention
        (1, 1000, 777, 2, 512),   # queries and keys that fill no tile, Sq != Sk
        (1, 20, 70, 1, 512),      # one query block, three key tiles, the last of 6 keys
        (3, 70, 64, 2, 472),      # batches and heads, two query blocks, 472 padded to 512
        (1, 33, 20, 1, 512),      # fewer keys than one tile: the second block of a pair has none
    ],
)
def test_bwd_dq_wide_design_matches_plain_and_reruns_bit_equal(gen, b, s_q, s_k, h, d):
    q, dout = _rand((b, s_q, h, d), gen), _rand((b, s_q, h, d), gen)
    k, v = _rand((b, s_k, h, d), gen), _rand((b, s_k, h, d), gen)
    scale = d ** -0.5
    out, lse = A.flash_attn_fwd(q, k, v, scale, with_lse=True)
    args = (q, k, v, dout, lse, A.attention_delta(dout, out), scale)
    got, launched = _launched(lambda: A.flash_attn_bwd_dq(*args))
    want = A.attention_bwd_dq_reference(*args)
    assert launched == {"flash_attn_bwd_dq": 1}
    assert got.dtype == torch.bfloat16 and _rel(got, want) <= GRAD_TOL
    assert torch.equal(got, A.flash_attn_bwd_dq(*args))  # deterministic: no atomics


def test_more_heads_than_the_grid_takes_are_refused(gen):
    """One block row a head on grid y, at most 65535 of them."""
    q = _rand((A.GRID_Y_MAX // 8 + 1, 1, 8, 40), gen)
    with pytest.raises(ValueError, match="gridDim|grid's y"):
        A.flash_attn_fwd(q, q, q, 0.16, with_lse=False)


@pytest.mark.parametrize("d", [96, 120, 256])
def test_head_dims_not_built_are_refused(gen, d):
    q = _rand((1, 16, 1, d), gen)
    with pytest.raises(ValueError, match="not built"):
        A.attention(q, q, q)


@pytest.mark.parametrize(
    "n,c,h,w,g,act,mean",
    [
        (1, 32, 7, 9, 32, "silu", 0.0),        # C/G = 1, H*W = 63: scalar K4
        (2, 64, 13, 13, 32, "gelu", 0.0),      # C/G = 2, H*W = 169
        (20, 320, 8, 8, 32, "silu", 0.0),      # batch 20 (the inversion's)
        (1, 96, 128, 128, 32, "relu", 0.0),    # 96 KiB, one piece's most: K4, cluster 4
        (1, 96, 128, 130, 32, None, 0.0),      # 97.5 KiB: K4, cluster 4
        (1, 32, 250, 251, 32, "silu", 0.0),    # C/G = 1, odd slab: scalar K4, cluster 4
        (1, 128, 200, 200, 32, "gelu", 0.0),   # 312.5 KiB: K4, cluster 4
        (2, 320, 64, 64, 32, "silu", 50.0),    # large mean, K4 cluster 2
        (1, 24, 128, 128, 8, "silu", 0.0),     # K4 cluster 8 (8 slabs of 96 KiB)
        (1, 32, 8, 4999, 32, "gelu", 0.0),     # K4 cluster 4, 4999 vectors: uneven pieces
        (1, 32, 111, 113, 32, "silu", 0.0),    # K4's scalar path, cluster 2, 12543 elements
        (1, 128, 256, 256, 32, "silu", 50.0),  # large mean, K4 at its route limit
        (1, 128, 512, 512, 32, "silu", 50.0),  # large mean, K5 + K6
        (5, 32, 224, 240, 32, "silu", 0.0),    # K4, cluster 2 (160 slabs of 105 KiB)
        (1, 32, 248, 249, 32, "relu", 0.0),    # K4 cluster 4, 7719 vectors: uneven pieces
        (1, 32, 328, 329, 32, None, 0.0),      # K4 cluster 4, 13489 vectors: uneven pieces
        (20, 640, 64, 64, 32, "silu", 0.0),    # batch 20: K4 cluster 2, 640 slabs of 160 KiB
        (2, 640, 64, 64, 32, "silu", 50.0),    # 160 KiB slabs, large mean
        (1, 512, 128, 128, 32, "silu", 0.0),   # 512 KiB, K4's route limit: cluster 8
        (1, 256, 256, 256, 32, "silu", 0.0),   # 1 MiB: K5 (cluster 4) + K6
        (1, 160, 250, 251, 32, "silu", 0.0),   # 613 KiB, H*W % 8 != 0: K5 + K6's scalar path
    ],
)
def test_group_norm_matches_plain(gen, n, c, h, w, g, act, mean):
    x = (torch.randn((n, c, h, w), generator=gen, device="cuda") + mean).to(torch.bfloat16)
    scale = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    bias = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
    fused = GN.uses_fused_kernel(x.shape, g)
    (out, m, r), launched = _launched(lambda: GN.group_norm_kernels(x, scale, bias, g, 1e-6, act))
    assert launched == ({"group_norm_fused": 1} if fused
                        else {"group_norm_stats": 1, "group_norm_apply": 1})
    ref_m, ref_r = GN.group_norm_moments(x, g, 1e-6)
    assert ((m - ref_m).abs() / (ref_m.abs() + 1)).max().item() <= MEAN_TOL
    assert ((r - ref_r).abs() / ref_r).max().item() <= RSTD_TOL
    assert _rel(out, GN.group_norm_reference(x, scale, bias, g, 1e-6, act)) <= GN_TOL
    assert torch.equal(GN.group_norm(x, scale, bias, g, 1e-6, act), out)


@pytest.mark.parametrize(
    "shape,groups,cluster",
    [
        ((1, 32, 7, 9), 32, 1),          # the scalar path, 63 elements a slab
        ((2, 320, 64, 64), 32, 1),
        ((2, 640, 64, 64), 32, 2),
        ((1, 32, 250, 251), 32, 2),      # scalar, 62750 elements: uneven pieces
        ((1, 128, 512, 512), 32, 4),
        ((1, 32, 8, 24999), 32, 4),      # 24999 vectors: uneven pieces
        ((1, 64, 256, 256), 8, 8),
        ((1, 8, 8, 24999), 8, 8),        # 24999 vectors: uneven pieces
    ],
)
def test_group_norm_stats_at_every_cluster_size(gen, shape, groups, cluster):
    """K5 called alone, whatever the route would take, at each cluster size
    (held to the shape by the assertion on `stats_cluster_blocks`)."""
    assert GN.stats_cluster_blocks(shape, groups) == cluster
    x = (torch.randn(shape, generator=gen, device="cuda") + 3.0).to(torch.bfloat16)
    (m, r), launched = _launched(lambda: GN.group_norm_stats(x, groups, 1e-6))
    assert launched == {"group_norm_stats": 1}
    ref_m, ref_r = GN.group_norm_moments(x, groups, 1e-6)
    assert ((m - ref_m).abs() / (ref_m.abs() + 1)).max().item() <= MEAN_TOL
    assert ((r - ref_r).abs() / ref_r).max().item() <= RSTD_TOL
    again = GN.group_norm_stats(x, groups, 1e-6)
    assert torch.equal(m, again[0]) and torch.equal(r, again[1])


@pytest.mark.parametrize(
    "shape", [(2, 320, 64, 64), (2, 1280, 8, 8), (1, 32, 7, 9), (1, 128, 512, 512),
              (2, 640, 64, 64), (1, 32, 250, 251)])
def test_group_norm_kernels_rerun_bit_equal(gen, shape):
    """Every sum runs in one fixed order, with no atomics: K4 (all but the
    VAE's 2 MiB slabs) and K5 give the same bits on a second call."""
    x = _rand(shape, gen)
    scale = (1 + 0.2 * torch.randn(shape[1], generator=gen, device="cuda")).to(torch.bfloat16)
    bias = (0.2 * torch.randn(shape[1], generator=gen, device="cuda")).to(torch.bfloat16)
    if GN.uses_fused_kernel(shape, 32):
        first = GN.group_norm_fused(x, scale, bias, 32, 1e-6, "silu")
        second = GN.group_norm_fused(x, scale, bias, 32, 1e-6, "silu")
    else:
        first, second = GN.group_norm_stats(x, 32, 1e-6), GN.group_norm_stats(x, 32, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("act", GN.ACTS)
@pytest.mark.parametrize("shape", [(2, 64, 16, 16), (1, 64, 128, 128)], ids=["K4", "K5+K6"])
def test_group_norm_gradient_matches_plain(gen, shape, act):
    """f32 scale and bias here (the kernels take both types)."""
    x = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16).requires_grad_()
    scale = (1 + 0.2 * torch.randn(shape[1], generator=gen, device="cuda")).requires_grad_()
    bias = (0.2 * torch.randn(shape[1], generator=gen, device="cuda")).requires_grad_()
    cot = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    out = GN.group_norm(x, scale, bias, 32, 1e-6, act)
    ref = GN.group_norm_reference(x, scale, bias, 32, 1e-6, act)
    assert _rel(out, ref) <= GN_TOL
    grads = torch.autograd.grad(out, (x, scale, bias), cot)
    ref_grads = torch.autograd.grad(ref, (x, scale, bias), cot)
    for got, want in zip(grads, ref_grads):
        assert _rel(got, want) <= GRAD_TOL


def test_group_norm_refuses_what_no_kernel_takes(gen):
    x = torch.randn((1, 64, 8, 8), generator=gen, device="cuda")
    s, b = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    for dtype in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match="bfloat16"):
            GN.group_norm(x.to(dtype), s, b, 32)
    with pytest.raises(ValueError, match="groups"):
        GN.group_norm(x.to(torch.bfloat16), s, b, 24)
    with pytest.raises(ValueError, match=r"\(N, C, H, W\)"):
        GN.group_norm(x.to(torch.bfloat16).reshape(1, 64, 64), s, b, 32)
    with pytest.raises(ValueError, match="activation"):
        GN.group_norm(x.to(torch.bfloat16), s, b, 32, act="tanh")


def _conv_inputs(gen, n, cin, cout, h, w, bias_dtype):
    x = torch.randn((n, cin, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    a = 1 + 0.2 * torch.randn((n, cin), generator=gen, device="cuda")
    b = 1.5 + 0.5 * torch.randn((n, cin), generator=gen, device="cuda")  # silu(B) far from 0
    wt = (torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / (9 * cin) ** 0.5)
    bias = 0.1 * torch.randn(cout, generator=gen, device="cuda")
    return x, a, b, wt.to(torch.bfloat16), bias.to(bias_dtype)


@pytest.mark.parametrize(
    "n,cin,cout,h,w,bias_dtype",
    [
        (2, 16, 24, 4, 4, torch.bfloat16),
        (1, 24, 16, 12, 20, torch.float32),
        (1, 16, 16, 7, 9, torch.bfloat16),
        (2, 24, 960, 64, 64, torch.bfloat16),
        (1, 960, 24, 12, 20, torch.float32),
        (2, 960, 960, 8, 8, torch.bfloat16),
        (2, 8, 24, 4, 4, torch.bfloat16),        # one k16 step of a chunk, half of it padding
        (1, 72, 320, 16, 16, torch.bfloat16),    # a chunk and an eighth; two 160-wide tiles
        (3, 24, 320, 4, 4, torch.float32),       # 48 pixels: three images in one tile
        (1, 64, 16, 8, 8, torch.bfloat16),       # 64 pixels: half a tile
        (2, 128, 24, 8, 8, torch.float32),       # 128 pixels: two images, one tile
        (3, 72, 24, 8, 8, torch.bfloat16),       # 192 pixels: the second tile half empty
        (3, 8, 16, 7, 9, torch.bfloat16),        # 63-pixel images straddle the tiles
        (5, 24, 24, 12, 20, torch.float32),      # W = 20: a ragged 8-pixel unit a row
        (2, 1280, 1280, 8, 8, torch.bfloat16),   # the UNet's 8 x 8: 10 splits
        (2, 1920, 640, 32, 32, torch.bfloat16),  # 2 splits of 15 chunks
        (3, 320, 72, 7, 9, torch.float32),       # splits with no 16-byte rows
    ],
)
def test_fused_conv_matches_plain(gen, n, cin, cout, h, w, bias_dtype):
    args = _conv_inputs(gen, n, cin, cout, h, w, bias_dtype)
    y, launched = _launched(lambda: FC.affine_silu_conv3x3(*args))
    assert launched == {"affine_silu_conv3x3": 1}
    assert y.shape == (n, cout, h, w) and y.dtype == torch.bfloat16
    assert _rel(y, FC.affine_silu_conv3x3_reference(*args)) <= CONV_TOL
    assert torch.equal(FC.affine_silu_conv3x3(*args), y)  # deterministic


def test_fused_conv_repacks_a_weight_changed_in_place(gen):
    x, a, b, wt, bias = _conv_inputs(gen, 2, 64, 32, 8, 8, torch.bfloat16)
    y0 = FC.affine_silu_conv3x3(x, a, b, wt, bias)
    misses = FC.packed_weight.misses
    assert torch.equal(FC.affine_silu_conv3x3(x, a, b, wt, bias), y0)
    assert FC.packed_weight.misses == misses  # the same weight: served from the cache
    wt.mul_(-1.0)
    y1 = FC.affine_silu_conv3x3(x, a, b, wt, bias)
    assert FC.packed_weight.misses == misses + 1
    assert _rel(y1, FC.affine_silu_conv3x3_reference(x, a, b, wt, bias)) <= CONV_TOL
    assert _rel(y1, y0) > 0.5  # and not the stale copy's output
    clone = wt.clone()  # another tensor with the same values
    assert torch.equal(FC.affine_silu_conv3x3(x, a, b, clone, bias), y1)
    assert FC.packed_weight.misses == misses + 2


@pytest.mark.parametrize("shape", [(2, 16, 24, 12, 20), (1, 64, 32, 64, 64)])
def test_fused_conv_gradients_match_plain(gen, shape):
    n, cin, cout, h, w = shape
    leaves = [t.requires_grad_() for t in _conv_inputs(gen, n, cin, cout, h, w, torch.bfloat16)]
    cot = torch.randn((n, cout, h, w), generator=gen, device="cuda").to(torch.bfloat16)
    grads = torch.autograd.grad(FC.affine_silu_conv3x3(*leaves), leaves, cot)
    ref = torch.autograd.grad(FC.affine_silu_conv3x3_reference(*leaves), leaves, cot)
    for got, want in zip(grads, ref):
        assert got.dtype == want.dtype and _rel(got, want) <= GRAD_TOL


@pytest.mark.parametrize(
    "shape,match",
    [((1, 16, 3, 8), "H="), ((1, 16, 8, 65), "W="), ((1, 12, 8, 8), "Cin=")],
)
def test_fused_conv_refuses_shapes(gen, shape, match):
    n, cin, h, w = shape
    args = _conv_inputs(gen, n, cin, 16, h, w, torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        FC.affine_silu_conv3x3(*args)


@pytest.mark.parametrize(
    "n,cin,cout,h,w,halo",
    [
        (2, 16, 24, 4, 4, (True, True)),
        (2, 24, 320, 1, 8, (True, False)),       # one row a rank: 16 images a tile
        (3, 72, 24, 2, 8, (False, True)),        # two rows: images straddle the tiles
        (1, 24, 16, 3, 20, (False, False)),      # a whole image in the halo form
        (2, 1280, 1280, 1, 8, (True, True)),     # the UNet's 8 x 8 on sp8: splits
        (2, 320, 320, 32, 64, (True, False)),    # the UNet's 64 x 64 on sp2, last rank
    ],
)
def test_fused_conv_halo_form_matches_plain(gen, n, cin, cout, h, w, halo):
    """K7 on a rank's h rows with a neighbour's row above and below: a real
    row is activated, an edge row stands for the zero padding."""
    args = _conv_inputs(gen, n, cin, cout, h + 2, w, torch.bfloat16) + (halo,)
    y, launched = _launched(lambda: FC.affine_silu_conv3x3(*args))
    assert launched == {"affine_silu_conv3x3": 1}
    assert y.shape == (n, cout, h, w)
    assert _rel(y, FC.affine_silu_conv3x3_reference(*args)) <= CONV_TOL
    assert torch.equal(FC.affine_silu_conv3x3(*args), y)  # deterministic


def test_fused_conv_halo_form_is_the_whole_map_sliced(gen):
    """Rows [8, 16) of a 24-row map with their real neighbours give the
    whole map's rows; edges not real on a zero-padded map give the whole
    map's output bit for bit (the same patches, tiles and sums)."""
    x, a, b, wt, bias = _conv_inputs(gen, 2, 64, 96, 24, 16, torch.bfloat16)
    whole = FC.affine_silu_conv3x3(x, a, b, wt, bias)
    part = FC.affine_silu_conv3x3(x[:, :, 7:17], a, b, wt, bias, (True, True))
    assert _rel(part, whole[:, :, 8:16]) <= CONV_TOL
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1))
    assert torch.equal(FC.affine_silu_conv3x3(padded, a, b, wt, bias, (False, False)), whole)


@pytest.mark.parametrize("halo", [(True, False), (False, True)])
def test_fused_conv_halo_form_gradients_match_plain(gen, halo):
    leaves = [t.requires_grad_() for t in _conv_inputs(gen, 2, 16, 24, 3 + 2, 20,
                                                       torch.bfloat16)]
    cot = torch.randn((2, 24, 3, 20), generator=gen, device="cuda").to(torch.bfloat16)
    grads = torch.autograd.grad(FC.affine_silu_conv3x3(*leaves, halo), leaves, cot)
    ref = torch.autograd.grad(FC.affine_silu_conv3x3_reference(*leaves, halo), leaves, cot)
    for got, want in zip(grads, ref):
        assert got.dtype == want.dtype and _rel(got, want) <= GRAD_TOL


def test_fused_conv_halo_form_refuses_no_rows(gen):
    args = _conv_inputs(gen, 1, 16, 16, 2, 8, torch.bfloat16)
    with pytest.raises(ValueError, match="H=0"):
        FC.affine_silu_conv3x3(*args, (True, True))


def test_fused_conv_refuses_dtypes(gen):
    x, a, b, wt, bias = _conv_inputs(gen, 1, 16, 16, 8, 8, torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        FC.affine_silu_conv3x3(x.float(), a, b, wt.float(), bias)


def _abn_inputs(gen, shape, dtype):
    c = shape[1]
    x = (2.0 * torch.randn(shape, generator=gen, device="cuda") + 0.5).to(dtype)
    mean, var = ABN.mean_var(x)
    w = 1.0 + 0.3 * torch.randn(c, generator=gen, device="cuda")
    w[::3] *= -1.0
    b = 0.2 * torch.randn(c, generator=gen, device="cuda")
    return x, mean, torch.rsqrt(var + 1e-5), w, b


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("act", ABN.ACTS)
@pytest.mark.parametrize(
    "shape",
    [(16, 64, 224, 224), (16, 512, 14, 14), (16, 128, 1, 1), (2, 64, 56, 56), (3, 5, 7, 9),
     (2, 3, 1, 1)],
    ids=lambda s: "x".join(map(str, s)),
)
def test_abn_apply_matches_plain(gen, shape, act, dtype):
    x, mean, rstd, w, b = _abn_inputs(gen, shape, dtype)
    y, launched = _launched(lambda: ABN.abn_apply(x, mean, rstd, w, b, act, 0.01))
    assert launched == {"abn_apply": 1}
    assert y.shape == x.shape and y.dtype == dtype
    ref = ABN.abn_apply_reference(x, mean, rstd, w, b, act, 0.01)
    assert _rel(y, ref) <= ABN_TOL[dtype]
    if dtype == torch.float32 and act != "elu":
        assert torch.equal(y, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_abn_apply_unaligned_input(gen, dtype):
    """A contiguous x that starts 4 bytes past a 16-byte boundary takes the
    scalar path."""
    shape = (2, 8, 16, 16)
    n = 2 * 8 * 16 * 16
    buf = torch.randn(n + 8, generator=gen, device="cuda").to(dtype)
    x = buf[2:2 + n].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16
    _, mean, rstd, w, b = _abn_inputs(gen, shape, dtype)
    y = ABN.abn_apply(x, mean, rstd, w, b, "leaky_relu", 0.01)
    ref = ABN.abn_apply_reference(x, mean, rstd, w, b, "leaky_relu", 0.01)
    assert _rel(y, ref) <= ABN_TOL[dtype]


def test_abn_apply_refuses(gen):
    x, mean, rstd, w, b = _abn_inputs(gen, (2, 8, 4, 4), torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ABN.abn_apply(x.half(), mean, rstd, w, b)
    with pytest.raises(ValueError, match="contiguous"):
        ABN.abn_apply(x.transpose(2, 3), mean, rstd, w, b)
    with pytest.raises(ValueError, match="weight"):
        ABN.abn_apply(x, mean, rstd, w.double(), b)
    with pytest.raises(ValueError, match="Unknown activation|activation"):
        ABN.abn_apply(x, mean, rstd, w, b, "tanh")
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ABN.fused_abn(x.half(), w, b)


@pytest.mark.parametrize("act", ABN.ACTS)
def test_fused_abn_train_on_card_matches_cpu(gen, act):
    x, _, _, w, b = _abn_inputs(gen, (4, 24, 14, 14), torch.float32)
    cot = torch.randn(x.shape, generator=gen, device="cuda")
    rm, rv = torch.zeros(24, device="cuda"), torch.ones(24, device="cuda")
    results = []
    for dev in ("cuda", "cpu"):
        leaves = [t.to(dev).clone().requires_grad_() for t in (x, w, b)]
        (y, new_mean, new_var), launched = _launched(lambda: ABN.fused_abn(
            *leaves, activation=act, running_mean=rm.to(dev), running_var=rv.to(dev)))
        assert launched == ({"abn_apply": 1} if dev == "cuda" else {})
        grads = torch.autograd.grad((y * cot.to(dev)).sum(), leaves)
        results.append([t.detach().cpu() for t in (y, new_mean, new_var, *grads)])
    for got, want in zip(*results):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
