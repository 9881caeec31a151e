"""The port's CUDA attention kernels against the plain version, on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; every test skips without a card. Run
on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py -q

(`--noconftest`: the suite's conftest sets JAX up, which these tests do not
use). chip_smoke.py holds the kernels at the main path's shapes; these
cases add what the path does not reach: ragged query and key lengths that
are no multiple of any tile, a single row, and head dims padded inside the
kernel to each built width (8 -> 16, 24 -> 32, 72 -> 80, 472 -> 512), on
both designs: narrow heads (padded width up to 160) with one warp per 16
rows, and wider heads cut into four slices, one warp each.

Tolerances, bf16 in and out as on the main path, each as max |kernel -
plain| / max |plain|: forward 2e-2, a few times the readings that
chip_smoke.py prints at the main path's shapes (PERF.md); gradients 2e-2
(P and dS are rounded to bf16 in the kernels' products). Log-sum-exp max |kernel - plain| 1e-3
(f32 sums of bf16 products in another order).
"""

import pytest
import torch

from diffusion_image_editing_tpu_torch.ops import attention as A

pytestmark = pytest.mark.cuda

FWD_TOL, LSE_TOL, GRAD_TOL = 2e-2, 1e-3, 2e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


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
    "b,s_q,s_k,h,d",
    [(1, 77, 77, 2, 40), (2, 64, 77, 8, 80), (1, 100, 130, 1, 512)],
)
def test_backward_matches_plain(gen, b, s_q, s_k, h, d):
    q = _rand((b, s_q, h, d), gen).requires_grad_()
    k = _rand((b, s_k, h, d), gen).requires_grad_()
    v = _rand((b, s_k, h, d), gen).requires_grad_()
    dout = _rand((b, s_q, h, d), gen)
    scale = d ** -0.5
    before = A.launch_counts()
    grads = torch.autograd.grad(A.attention(q, k, v, scale), (q, k, v), dout)
    after = A.launch_counts()
    ref = torch.autograd.grad(A.attention_reference(q, k, v, scale), (q, k, v), dout)
    for g, r in zip(grads, ref):
        err = (g.float() - r.float()).abs().max() / r.float().abs().max()
        assert err.item() <= GRAD_TOL
    assert {n: after[n] - before[n] for n in after} == {
        "flash_attn_fwd": 1, "flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1}


@pytest.mark.parametrize("d", [64, 120, 256])
def test_head_dims_not_built_are_refused(gen, d):
    q = _rand((1, 16, 1, d), gen)
    with pytest.raises(ValueError, match="not built"):
        A.attention(q, q, q)
