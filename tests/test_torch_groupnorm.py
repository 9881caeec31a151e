"""The port's GroupNorm against the JAX package's, same inputs from numpy.

On the CPU the port's `group_norm` runs its plain version through the same
autograd function the card uses (forward: `group_norm_moments` then
`group_norm_apply_reference`, the plain versions of K5 and K6; backward:
`group_norm_backward` from the saved mean and rstd). The JAX side runs
`group_norm_reference` and its Pallas kernels in interpret mode, as
tests/test_ops_groupnorm.py does. The CUDA kernels themselves are held
against the plain version on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py).

Layout: JAX is NHWC, the port NCHW; inputs are transposed at the boundary.
Tolerances, f32 on both sides: the forward differs in summation order only
(rtol 1e-5, atol 1e-5); gradients add one backward pass (rtol 1e-4, atol
1e-5). Against the JAX Pallas kernels, which take the variance as
E[x^2] - mean^2, rtol 1e-4, atol 1e-5 (as tests/test_ops_groupnorm.py holds
them to the JAX reference). The large-mean case (x ~ N(50, 1)) is held to
the JAX reference at atol 1e-4: a two-pass variance keeps about
|mean| * 2^-24 * sqrt(count) of error, the single-pass form would lose
most digits.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffusion_image_editing_tpu_torch.ops as OPS
from diffusion_image_editing_tpu.ops import groupnorm as J
from diffusion_image_editing_tpu_torch.ops import groupnorm as T

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
PALLAS_TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, n, h, w, c, mean=0.0):
    rng = np.random.default_rng(seed)
    x = (mean + rng.standard_normal((n, h, w, c))).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    cot = rng.standard_normal((n, h, w, c)).astype(np.float32)
    return x, scale, bias, cot


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


# (n, h, w, c, groups): C/G from 2 to 40, H*W odd and even.
SHAPES = [(2, 5, 7, 8, 4), (1, 8, 8, 64, 32), (2, 4, 6, 96, 8), (1, 6, 6, 80, 2)]


@pytest.mark.parametrize("act", T.ACTS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_group_norm_and_gradient_match_jax(shape, act):
    n, h, w, c, g = shape
    x, scale, bias, cot = _inputs(sum(shape), n, h, w, c)

    def f(x_, s_, b_):
        return jnp.sum(J.group_norm_reference(x_, s_, b_, g, 1e-6, act) * cot)

    ref = J.group_norm_reference(jnp.asarray(x), scale, bias, g, 1e-6, act)
    ref_grads = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                              jnp.asarray(bias))
    tx = _nchw(x).requires_grad_()
    ts, tb = torch.tensor(scale, requires_grad=True), torch.tensor(bias, requires_grad=True)
    out = T.group_norm(tx, ts, tb, g, 1e-6, act)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **FWD_TOL)
    dx, ds, db = torch.autograd.grad((out * _nchw(cot)).sum(), (tx, ts, tb))
    np.testing.assert_allclose(_nhwc(dx), np.asarray(ref_grads[0]), **GRAD_TOL)
    np.testing.assert_allclose(ds.numpy(), np.asarray(ref_grads[1]), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(ref_grads[2]), **GRAD_TOL)


@pytest.mark.parametrize(
    "kernel,shape",
    [
        ("single_block", (2, 8, 8, 128)),   # JAX's row 5 (tests/test_ops_groupnorm.py:68)
        ("pallas", (2, 16, 16, 128)),       # within 4 MiB: group_norm_pallas -> single block
        ("pallas", (1, 96, 96, 128)),       # 4.5 MiB of f32: the tiled rows 6 and 7
    ],
)
def test_group_norm_matches_jax_pallas_interpret(kernel, shape):
    x, scale, bias, _ = _inputs(7, *shape)
    fn = J.group_norm_single_block if kernel == "single_block" else J.group_norm_pallas
    ref = fn(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, act="silu",
             interpret=True)
    out = T.group_norm(_nchw(x), torch.tensor(scale), torch.tensor(bias), 32, act="silu")
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), **PALLAS_TOL)


@pytest.mark.parametrize("act", ["silu", None])
def test_group_norm_large_mean_matches_jax_reference(act):
    x, scale, bias, _ = _inputs(11, 2, 16, 16, 64, mean=50.0)
    ref = J.group_norm_reference(jnp.asarray(x), scale, bias, 32, 1e-6, act)
    out = T.group_norm(_nchw(x), torch.tensor(scale), torch.tensor(bias), 32, 1e-6, act)
    np.testing.assert_allclose(_nhwc(out), np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("act", ["silu", None])
def test_gradient_of_a_strided_cotangent(act):
    """The attention block transposes GroupNorm's output, so the gradient
    that comes back is a strided view."""
    x, scale, bias, cot = _inputs(13, 1, 4, 6, 16)
    tx = _nchw(x).requires_grad_()
    ts, tb = torch.tensor(scale), torch.tensor(bias)
    # A contiguous (1, 24, 16) cotangent reaches the (1, 16, 4, 6) output as a strided view.
    cot_t = torch.tensor(cot.reshape(1, 24, 16))

    def grad(fn):
        out = fn(tx, ts, tb, 4, 1e-6, act).reshape(1, 16, 24).transpose(1, 2)
        return torch.autograd.grad(out, tx, cot_t)[0]

    torch.testing.assert_close(grad(T.group_norm), grad(T.group_norm_reference),
                               rtol=1e-4, atol=1e-5)


def test_plain_stats_and_apply_compose_to_the_reference():
    """K5's and K6's plain versions are the two halves of K4's."""
    x, scale, bias, _ = _inputs(3, 2, 6, 10, 48)
    tx, ts, tb = _nchw(x), torch.tensor(scale), torch.tensor(bias)
    mean, rstd = T.group_norm_moments(tx, 16, 1e-6)
    assert mean.shape == rstd.shape == (2, 16) and mean.dtype == torch.float32
    xg = tx.reshape(2, 16, -1)
    torch.testing.assert_close(mean, xg.mean(-1))
    torch.testing.assert_close(rstd, torch.rsqrt(xg.var(-1, unbiased=False) + 1e-6))
    torch.testing.assert_close(T.group_norm_apply_reference(tx, mean, rstd, ts, tb, "gelu"),
                               T.group_norm_reference(tx, ts, tb, 16, 1e-6, "gelu"))


def test_bf16_input_keeps_its_dtype():
    x, scale, bias, _ = _inputs(5, 1, 8, 8, 32)
    out = T.group_norm(_nchw(x).to(torch.bfloat16), torch.tensor(scale), torch.tensor(bias), 8)
    ref = T.group_norm(_nchw(x), torch.tensor(scale), torch.tensor(bias), 8)
    assert out.dtype == torch.bfloat16
    torch.testing.assert_close(out.float(), ref, rtol=2e-2, atol=2e-2)


def test_unknown_activation_is_refused():
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(ValueError, match="activation"):
        T.group_norm(x, torch.ones(4), torch.zeros(4), 2, act="tanh")


@pytest.mark.parametrize(
    "shape,fused",
    [
        ((2, 320, 64, 64), True),     # SD UNet 64 x 64 x 320: 80 KiB slabs
        ((2, 640, 64, 64), True),     # 160 KiB
        ((2, 1280, 8, 8), True),
        ((1, 512, 64, 64), True),     # SD VAE 64 x 64 x 512: 128 KiB
        ((1, 128, 512, 512), False),  # SD VAE 512 x 512 x 128: 2 MiB
        ((1, 96, 128, 128), True),    # 96 KiB, FUSED_MAX_PIECE_BYTES: a cluster of one takes it
        ((1, 512, 128, 128), True),   # SD VAE 128 x 128 x 512: exactly FUSED_MAX_SLAB_BYTES
        ((1, 256, 256, 256), False),  # SD VAE 256 x 256 x 256: 1 MiB
    ],
)
def test_route_rule_by_slab_size(shape, fused):
    assert T.uses_fused_kernel(shape, 32) is fused


@pytest.mark.parametrize("wrapper", ["fused", "stats", "apply"])
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """A kernel wrapper never runs the plain version: a CPU tensor is an
    error, and `group_norm` on the CPU launches nothing."""
    x = torch.zeros(1, 8, 4, 4, dtype=torch.bfloat16)
    s, b = torch.ones(8, dtype=torch.bfloat16), torch.zeros(8, dtype=torch.bfloat16)
    stats = torch.zeros(1, 4)
    before = OPS.launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "fused":
            T.group_norm_fused(x, s, b, 4, 1e-6, "silu")
        elif wrapper == "stats":
            T.group_norm_stats(x, 4, 1e-6)
        else:
            T.group_norm_apply(x, stats, stats, s, b, "silu")
    T.group_norm(x, s, b, 4)
    assert OPS.launch_counts() == before


# Every GroupNorm shape of chip_smoke.py's [main] run: the SD-1.5 UNet at
# batch 2 (the guided steps) and 20 (the batched inversion), the SD VAE's
# encoder and decoder from 64 to 512 px; 32 groups each.
PATH_SHAPES = [
    (n, c, hw, hw) for n in (2, 20) for c, hw in (
        (320, 64), (640, 64), (960, 64), (320, 32), (640, 32), (960, 32), (1280, 32), (1920, 32),
        (640, 16), (1280, 16), (1920, 16), (2560, 16), (1280, 8), (2560, 8))
] + [(1, c, hw, hw) for c, hw in ((512, 64), (512, 128), (256, 128), (512, 256), (256, 256),
                                  (128, 256), (256, 512), (128, 512))]
# (shape, groups) at the edges: the scalar path (H * W % 8 != 0, C / G = 1),
# a slab of one element and of two vectors, vectors that split unevenly
# over the cluster, K4's slab limit, and N * G = 65535, the grid's limit.
EDGE_SHAPES = [
    ((1, 32, 7, 9), 32), ((1, 32, 1, 1), 32), ((1, 64, 1, 8), 32), ((1, 32, 250, 251), 32),
    ((1, 32, 248, 249), 32), ((1, 32, 328, 329), 32), ((1, 96, 128, 128), 32),
    ((2, 64, 13, 13), 32), ((4369, 30, 8, 8), 15), ((4369, 60, 32, 32), 15),
    ((1, 24, 128, 128), 8), ((1, 32, 8, 4999), 32), ((1, 32, 111, 113), 32),
]
PIECE_CASES = (
    [("K5", s, 32) for s in PATH_SHAPES] + [("K5", s, g) for s, g in EDGE_SHAPES]
    + [("K4", s, g) for s, g in [(s, 32) for s in PATH_SHAPES] + EDGE_SHAPES
       if T.uses_fused_kernel(s, g)])


@pytest.mark.parametrize("kernel,shape,groups", PIECE_CASES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_cluster_and_pieces_cover_each_slab(kernel, shape, groups):
    """The host's choice for K4 and K5: a portable cluster size, and pieces
    that are non-empty, balanced to one atom, cover the slab exactly and,
    on the vector path, start on 16-byte boundaries; the grid (k, N * G)
    within its limits."""
    if kernel == "K5":
        k, atom = T.stats_cluster_blocks(shape, groups), T.stats_atom(shape, groups)
    else:
        k, atom = T.fused_cluster_blocks(shape, groups), T.fused_atom(shape, groups)
    assert k in T.CLUSTER_SIZES
    length = T.slab_bytes(shape, groups) // 2
    pieces = T.slab_pieces(length, k, atom)
    assert len(pieces) == k and pieces[0][0] == 0
    assert all(start + n == following for (start, n), (following, _) in zip(pieces, pieces[1:]))
    assert sum(n for _, n in pieces) == length
    assert all(n > 0 for _, n in pieces)
    assert max(n for _, n in pieces) - min(n for _, n in pieces) <= atom
    if kernel == "K4":
        assert max(n for _, n in pieces) * 2 <= T.FUSED_MAX_PIECE_BYTES
    if shape[2] * shape[3] % 8 == 0:  # slabs and pieces of whole 16-byte vectors
        assert atom == 8 and length % 8 == 0
        assert all(start % 8 == 0 and n % 8 == 0 for start, n in pieces)
    assert shape[0] * groups <= 65535  # the grid is (k, N * G) blocks: y at most 65535


@pytest.mark.parametrize(
    "shape,k5,k4",
    [
        ((1, 128, 512, 512), 4, None),  # 32 slabs of 2 MiB: 128 blocks, one an SM
        ((2, 640, 64, 64), 2, None),    # 64 slabs of 160 KiB: 128 blocks
        ((1, 512, 64, 64), 2, None),    # 32 slabs of 128 KiB: no piece under 48 KiB
        ((20, 640, 64, 64), 1, None),   # 640 slabs: the card is full without a cluster
        ((2, 320, 64, 64), 1, 2),       # 64 slabs of 80 KiB: K4 in 128 blocks
        ((2, 1280, 8, 8), 1, 1),        # 5 KiB slabs stay whole
        ((1, 32, 1, 1), 1, 1),          # one element: one piece
    ],
)
def test_cluster_size_at_path_shapes(shape, k5, k4):
    assert T.stats_cluster_blocks(shape, 32) == k5
    if k4 is not None:
        assert T.fused_cluster_blocks(shape, 32) == k4


def test_largest_cluster_takes_the_largest_slab():
    """K4 at 8 blocks a slab: 8 slabs of 96 KiB, pieces of 12 KiB."""
    assert T.fused_cluster_blocks((1, 24, 128, 128), 8) == 8


def test_cluster_constants_match_the_sources():
    """The Python route and cluster rule against the CUDA sources."""
    csrc = Path(T.__file__).parent / "csrc"
    for name in ("group_norm_stats.cu", "group_norm_fused.cu"):
        src = (csrc / name).read_text()
        assert f"kMaxCluster = {T.CLUSTER_SIZES[-1]};" in src, name
        assert "sm90::launch_clustered(" in src, name
    assert "cudaLaunchAttributeClusterDimension" in (csrc / "sm90_async.cuh").read_text()
    fused = (csrc / "group_norm_fused.cu").read_text()
    assert f"kFusedMaxPieceBytes = {T.FUSED_MAX_PIECE_BYTES // 1024} * 1024;" in fused
    assert T.FUSED_MAX_SLAB_BYTES <= T.CLUSTER_SIZES[-1] * T.FUSED_MAX_PIECE_BYTES
