"""The port's attention against the JAX package's, same inputs from numpy.

On the CPU the port's `attention` runs its plain version; the JAX side runs
its Pallas kernels in interpret mode (as tests/test_ops_attention.py does)
and its jnp reference. The CUDA kernels themselves are held against the
plain version on the card by chip_smoke.py.

Tolerances: f32 on both sides; the forward differs only in summation order
(rtol 2e-4, atol 2e-5, as the JAX kernel tests use); gradients go through
one more product each (rtol 2e-3, atol 2e-4).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_image_editing_tpu_torch.ops as OPS
from diffusion_image_editing_tpu_torch.ops import attention as T

# The JAX package's ops/__init__ re-exports the function `attention` under the
# submodule's name, so take the module itself from the import system.
J = importlib.import_module("diffusion_image_editing_tpu.ops.attention")

FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=2e-3, atol=2e-4)


def _qkv(seed, b, s_q, s_k, h, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s_q, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s_k, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s_k, h, d)).astype(np.float32)
    return q, k, v


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


@pytest.mark.parametrize(
    "b,s_q,s_k,h,d",
    [
        (2, 64, 64, 2, 40),  # SD head dim 40
        (1, 64, 77, 2, 40),  # ragged 77-token cross-attention context
        (1, 64, 64, 1, 512),  # VAE-like single wide head
        (2, 16, 16, 8, 160),
    ],
)
def test_forward_matches_jax_reference(b, s_q, s_k, h, d):
    q, k, v = _qkv(b * s_k + d, b, s_q, s_k, h, d)
    ref = J.attention_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out = T.attention(*_t(q, k, v))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_causal_matches_jax():
    q, k, v = _qkv(3, 1, 16, 16, 2, 8)
    ref = J.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True)
    out = T.attention(*_t(q, k, v), causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


@pytest.mark.parametrize("b,s,h,d", [(1, 256, 2, 40), (1, 256, 1, 512)])
def test_forward_matches_jax_pallas_kernel_interpret(b, s, h, d):
    """The JAX flash forward kernel (interpret mode) and the port agree."""
    q, k, v = _qkv(7 + d, b, s, s, h, d)
    scale = d ** -0.5
    ref = J._flash_attention_fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                      interpret=True, block_q=64, block_k=128)
    out = T.attention(*_t(q, k, v), scale=scale)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)


def test_vjp_matches_jax_pallas_backward_interpret(monkeypatch):
    """jax.vjp through `attention(use_pallas=True)` (forward + both backward
    kernels in interpret mode) against torch.autograd.grad of the port."""
    monkeypatch.setenv("DIE_TPU_ATTN_INTERPRET", "1")
    monkeypatch.setenv("DIE_TPU_ATTN_BLOCK_Q", "64")
    monkeypatch.setenv("DIE_TPU_ATTN_BLOCK_K", "128")
    b, s, h, d = 1, 256, 2, 40
    q, k, v = _qkv(40, b, s, s, h, d)
    g = np.random.default_rng(41).standard_normal((b, s, h, d)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda *a: J.attention(*a, use_pallas=True),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))

    tq, tk, tv = _t(q, k, v, grad=True)
    out_t = T.attention(tq, tk, tv)
    grads_t = torch.autograd.grad(out_t, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), **FWD_TOL)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GRAD_TOL)


@pytest.mark.parametrize("s_k", [64, 77])
def test_vjp_matches_jax_reference(s_k):
    """Backward of the plain path, including the ragged 77-token context."""
    b, s_q, h, d = 1, 64, 2, 40
    q, k, v = _qkv(50 + s_k, b, s_q, s_k, h, d)
    g = np.random.default_rng(51).standard_normal((b, s_q, h, d)).astype(np.float32)
    _, vjp = jax.vjp(J.attention_reference, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv = _t(q, k, v, grad=True)
    grads_t = torch.autograd.grad(T.attention(tq, tk, tv), (tq, tk, tv), torch.from_numpy(g))
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GRAD_TOL)


@pytest.mark.parametrize("s_k", [64, 77])
def test_plain_backward_pieces_match_jax_vjp(s_k):
    """The plain versions of the backward kernels (dQ; dK and dV), fed the
    forward's log-sum-exp and delta as the kernels are, against jax.vjp of
    the JAX reference."""
    b, s_q, h, d = 1, 64, 2, 40
    scale = d ** -0.5
    q, k, v = _qkv(90 + s_k, b, s_q, s_k, h, d)
    g = np.random.default_rng(91).standard_normal((b, s_q, h, d)).astype(np.float32)
    _, vjp = jax.vjp(J.attention_reference, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(g))
    tq, tk, tv, tg = _t(q, k, v, g)
    logits = torch.einsum("bqhd,bkhd->bhqk", tq, tk) * scale
    lse = torch.logsumexp(logits, dim=-1).reshape(b * h, s_q)
    delta = T.attention_delta(tg, T.attention_reference(tq, tk, tv, scale))
    args = (tq, tk, tv, tg, lse, delta, scale)
    grads_t = (T.attention_bwd_dq_reference(*args),) + T.attention_bwd_dkv_reference(*args)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **GRAD_TOL)


def test_delta_is_rowsum_of_dout_times_out():
    """The backward's row term, laid out (B*H, S) as the kernels read it; the
    JAX package forms the same sum over the head-split (B*H, S, D) layout."""
    rng = np.random.default_rng(60)
    dout, out = (rng.standard_normal((2, 8, 3, 16)).astype(np.float32) for _ in range(2))
    delta = T.attention_delta(torch.from_numpy(dout), torch.from_numpy(out))
    ref = (dout * out).sum(-1).transpose(0, 2, 1).reshape(6, 8)
    np.testing.assert_allclose(delta.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wrapper", ["fwd", "dq", "dkv"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper never runs the plain version: a CPU tensor is an error."""
    q, k, v = _t(*_qkv(70, 1, 16, 16, 1, 8))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    stats = torch.zeros(1, 16)
    before = OPS.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "fwd":
            T.flash_attn_fwd(q, k, v, 0.35, with_lse=True)
        elif wrapper == "dq":
            T.flash_attn_bwd_dq(q, k, v, q, stats, stats, 0.35)
        else:
            T.flash_attn_bwd_dkv(q, k, v, q, stats, stats, 0.35)
    assert OPS.launch_counts() == before


def test_cpu_attention_leaves_launch_counts_alone():
    OPS.reset_launch_counts()
    T.attention(*_t(*_qkv(80, 1, 8, 8, 1, 8)))
    counts = OPS.launch_counts()
    assert {k: counts[k] for k in ("flash_attn_fwd", "flash_attn_bwd_dq",
                                   "flash_attn_bwd_dkv")} == {
        "flash_attn_fwd": 0, "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0}


def _model_head_dims():
    """Head dims of every attention in the port's models (SD UNet: C / heads
    per transformer; DDPM / LDM UNet: its attention_head_dim, or C for one
    head; the autoencoders' mid block: C, one head)."""
    from diffusion_image_editing_tpu_torch.models import (
        DDPM_CELEBAHQ_256, LDM_CELEBAHQ_256_UNET, LDM_CELEBAHQ_VQVAE, SD15_UNET, SD_VAE,
        TINY_SD_UNET, TINY_UNET2D, TINY_VAE, TINY_VQVAE)
    dims = set()
    for cfg in (SD15_UNET, TINY_SD_UNET):
        dims |= {c // cfg.attention_head_dim for c in cfg.block_out_channels}
    for cfg in (DDPM_CELEBAHQ_256, LDM_CELEBAHQ_256_UNET, TINY_UNET2D):
        widths = {cfg.block_out_channels[-1]} | {
            c for c, t in zip(cfg.block_out_channels, cfg.down_block_types) if "Attn" in t}
        dims |= {cfg.attention_head_dim or c for c in widths}
    for cfg in (SD_VAE, TINY_VAE, LDM_CELEBAHQ_VQVAE, TINY_VQVAE):
        dims.add(cfg.block_out_channels[-1])
    return sorted(dims)


@pytest.mark.parametrize("d", _model_head_dims())
def test_kernels_are_built_for_every_model_head_dim(d):
    assert T.kernel_takes_head_dim(d)


def test_built_head_dims_match_the_cuda_sources():
    import re
    from pathlib import Path

    csrc = Path(T.__file__).parent / "csrc"

    def widths(macro, source="flash_attn_common.cuh"):
        line = re.search(rf"#define {macro}\(X\)(.*)", (csrc / source).read_text()).group(1)
        return tuple(int(w) for w in re.findall(r"X\((\d+)\)", line))

    assert widths("FA_NARROW_DIMS") == T.NARROW_HEAD_DIMS
    assert widths("FA_WIDE_SLICES") == T.WIDE_SLICE_DIMS
    assert [d for d in (8, 40, 64, 120, 256, 472, 512, 520) if T.kernel_takes_head_dim(d)] == [
        8, 40, 64, 472, 512]


def test_forward_dispatch_matches_the_cuda_source():
    """The narrow widths that take the forward's 128-row design, and those
    that take its warpgroup design, are those the .cu dispatches to each,
    and each is a built narrow width."""
    import re
    from pathlib import Path

    src = (Path(T.__file__).parent / "csrc" / "flash_attn_fwd.cu").read_text()
    line = re.search(r"#define FA_FWD_ROWS128_DIMS\(X\)(.*)", src).group(1)
    cases = re.findall(r"X\((\d+), (\d+)\)", line)  # (padded width, row fragments a warp)
    assert tuple(int(w) for w, _ in cases) == T.FWD_ROWS128_HEAD_DIMS
    assert all(8 % int(mf) == 0 for _, mf in cases)
    assert set(T.FWD_ROWS128_HEAD_DIMS) <= set(T.NARROW_HEAD_DIMS)
    assert "FA_FWD_ROWS128_DIMS(FA_CASE)" in src
    line = re.search(r"#define FA_FWD_WG_DIMS\(X\)(.*)", src).group(1)
    assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", line)) == T.FWD_WG_HEAD_DIMS
    assert set(T.FWD_WG_HEAD_DIMS) <= set(T.NARROW_HEAD_DIMS)
    assert not set(T.FWD_WG_HEAD_DIMS) & set(T.FWD_ROWS128_HEAD_DIMS)
    assert "FA_FWD_WG_DIMS(FA_CASE)" in src


def test_forward_wide_dispatch_matches_the_cuda_source():
    """The wide slices that take the forward's warpgroup design are those
    the .cu dispatches to it, and each is a built wide slice."""
    import re
    from pathlib import Path

    src = (Path(T.__file__).parent / "csrc" / "flash_attn_fwd.cu").read_text()
    line = re.search(r"#define FA_FWD_WIDE_SLICES\(X\)(.*)", src).group(1)
    assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", line)) == T.FWD_WIDE_SLICE_DIMS
    assert set(T.FWD_WIDE_SLICE_DIMS) == set(T.WIDE_SLICE_DIMS)  # the forward's only wide path
    assert "FA_FWD_WIDE_SLICES(FA_CASE)" in src


def test_bwd_dkv_wide_dispatch_matches_the_cuda_source():
    """The wide slices that take K3's warpgroup design are those the .cu
    dispatches to it, and each is a built wide slice."""
    import re
    from pathlib import Path

    src = (Path(T.__file__).parent / "csrc" / "flash_attn_bwd_dkv.cu").read_text()
    line = re.search(r"#define FA_BWD_DKV_WIDE_SLICES\(X\)(.*)", src).group(1)
    assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", line)) == T.BWD_DKV_WIDE_SLICE_DIMS
    assert set(T.BWD_DKV_WIDE_SLICE_DIMS) == set(T.WIDE_SLICE_DIMS)  # K3's only wide path
    assert "FA_BWD_DKV_WIDE_SLICES(FA_CASE)" in src


def test_bwd_dq_wide_dispatch_matches_the_cuda_source():
    """The wide slices that take K2's warpgroup design are those the .cu
    dispatches to it, and each is a built wide slice."""
    import re
    from pathlib import Path

    src = (Path(T.__file__).parent / "csrc" / "flash_attn_bwd_dq.cu").read_text()
    line = re.search(r"#define FA_BWD_DQ_WIDE_SLICES\(X\)(.*)", src).group(1)
    assert tuple(int(w) for w in re.findall(r"X\((\d+)\)", line)) == T.BWD_DQ_WIDE_SLICE_DIMS
    assert set(T.BWD_DQ_WIDE_SLICE_DIMS) == set(T.WIDE_SLICE_DIMS)  # K2's only wide path
    assert "FA_BWD_DQ_WIDE_SLICES(FA_CASE)" in src
