"""The port's activated batch norm against the JAX package's, same inputs
from numpy.

On the CPU the port runs K8's plain version (`abn_apply_reference`) inside
the same autograd functions the card uses; the JAX side runs its Pallas
kernel in interpret mode where the test says so, else its jnp path. K8
itself is held against the plain version on the card (chip_smoke.py,
tests/test_torch_kernels_cuda.py).

Layout: JAX is NHWC, the port NCHW; inputs are transposed at the boundary.
Tolerances, f32 on both sides:
* K8's plain version against the Pallas kernel: the same f32 operations in
  the same order, so rtol 1e-6 (exp-type functions may differ by an ulp);
* forward with batch statistics: sums in another order, rtol 1e-5, atol
  1e-5;
* gradients: one backward pass more, rtol 1e-4, atol 1e-5 (the per-channel
  sums of the backward run over N * H * W = 256 terms);
* running statistics: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.ops import abn as J
import diffusion_image_editing_tpu_torch.ops as OPS
from diffusion_image_editing_tpu_torch.ops import abn as T

PALLAS_TOL = dict(rtol=1e-6, atol=1e-6)
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _inputs(seed, shape=(2, 4, 8, 128), mean=0.0):
    """NHWC x, weights with a few negative entries, bias, cotangent."""
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (mean + rng.standard_normal(shape)).astype(np.float32)
    w = (1.0 + 0.3 * rng.standard_normal(c)).astype(np.float32)
    w[::7] *= -1.0
    b = (0.2 * rng.standard_normal(c)).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)
    return x, w, b, cot


@pytest.mark.parametrize("activation", T.ACTS)
def test_reference_matches_pallas_kernel(activation):
    x, w, b, _ = _inputs(0)
    rng = np.random.default_rng(1)
    mean = (0.1 * rng.standard_normal(128)).astype(np.float32)
    rstd = (1.0 + 0.2 * rng.random(128)).astype(np.float32)
    want = J._abn_apply(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(rstd), jnp.asarray(w),
                        jnp.asarray(b), activation, 0.01, use_pallas=True, interpret=True)
    got = T.abn_apply_reference(_nchw(x), *(torch.tensor(a) for a in (mean, rstd, w, b)),
                                activation, 0.01)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), **PALLAS_TOL)


def test_reference_keeps_bf16():
    x, w, b, _ = _inputs(2, (1, 2, 4, 8))
    mean, rstd = np.zeros(8, np.float32), np.ones(8, np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = J._abn_apply(xb, jnp.asarray(mean), jnp.asarray(rstd), jnp.asarray(w),
                        jnp.asarray(b), "leaky_relu", 0.01, use_pallas=False)
    got = T.abn_apply_reference(_nchw(x).to(torch.bfloat16),
                                *(torch.tensor(a) for a in (mean, rstd, w, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got.float()), np.asarray(want, np.float32))


@pytest.mark.parametrize("activation", T.ACTS)
def test_fused_abn_train_forward_and_gradients(activation):
    x, w, b, cot = _inputs(3, (2, 4, 8, 24), mean=0.5)
    jx, jw, jb, jcot = map(jnp.asarray, (x, w, b, cot))

    def f(x_, w_, b_):
        y = J.fused_abn_train(x_, w_, b_, 1e-5, activation, 0.01, None, False)
        return jnp.sum(y * jcot), y

    (_, want), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True)(jx, jw, jb)
    leaves = [_nchw(x).requires_grad_(), torch.tensor(w).requires_grad_(),
              torch.tensor(b).requires_grad_()]
    y, _, _ = T.fused_abn(*leaves, activation=activation)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), **FWD_TOL)
    grads = torch.autograd.grad((y * _nchw(cot)).sum(), leaves)
    np.testing.assert_allclose(_nhwc(grads[0]), np.asarray(jgrads[0]), **GRAD_TOL)
    for got, ref in zip(grads[1:], jgrads[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **GRAD_TOL)


def test_mean_var_is_single_pass_f32():
    x, *_ = _inputs(4, (2, 3, 5, 6), mean=2.0)
    jm, jv = J.mean_var(jnp.asarray(x))
    tm, tv = T.mean_var(_nchw(x))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **FWD_TOL)
    xf = _nchw(x)
    assert torch.equal(tv, (xf * xf).mean((0, 2, 3)) - tm * tm)


def test_running_update_eval_mode_and_module():
    """Training updates running stats with the unbiased variance and
    momentum 0.1; eval mode normalises with them. Through FusedABNorm
    against the JAX layer, and through fused_abn directly."""
    x, w, b, cot = _inputs(5, (2, 3, 4, 16))
    rng = np.random.default_rng(6)
    rm = (0.1 * rng.standard_normal(16)).astype(np.float32)
    rv = (1.0 + 0.5 * rng.random(16)).astype(np.float32)
    variables = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(rm), "var": jnp.asarray(rv)}}
    layer = J.FusedABNorm(use_pallas=False)
    y_train, mutated = layer.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])

    mod = T.FusedABNorm(16)
    mod.load_state_dict({"weight": torch.tensor(w), "bias": torch.tensor(b),
                         "running_mean": torch.tensor(rm), "running_var": torch.tensor(rv)})
    mod.train()
    np.testing.assert_allclose(_nhwc(mod(_nchw(x))), np.asarray(y_train), **FWD_TOL)
    np.testing.assert_allclose(mod.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]), **FWD_TOL)
    np.testing.assert_allclose(mod.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]), **FWD_TOL)

    # Eval mode with the updated statistics, and its gradients.
    variables["batch_stats"] = mutated["batch_stats"]
    jx, jcot = jnp.asarray(x), jnp.asarray(cot)

    def f(x_, params):
        y = layer.apply({"params": params, "batch_stats": variables["batch_stats"]}, x_)
        return jnp.sum(y * jcot), y

    (_, want), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jx, variables["params"])
    mod.eval()
    xt = _nchw(x).requires_grad_()
    y = mod(xt)
    np.testing.assert_allclose(_nhwc(y), np.asarray(want), **FWD_TOL)
    dx, dw, db = torch.autograd.grad((y * _nchw(cot)).sum(), [xt, mod.weight, mod.bias])
    np.testing.assert_allclose(_nhwc(dx), np.asarray(gx), **GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(gp["weight"]), **GRAD_TOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(gp["bias"]), **GRAD_TOL)

    # fused_abn's functional form: n = N * H * W = 24, var * 24 / 23.
    _, new_mean, new_var = T.fused_abn(_nchw(x), torch.tensor(w), torch.tensor(b),
                                       running_mean=torch.tensor(rm),
                                       running_var=torch.tensor(rv))
    mean, var = T.mean_var(_nchw(x))
    assert torch.allclose(new_var, 0.9 * torch.tensor(rv) + 0.1 * (var * 24 / 23), rtol=1e-6)
    assert torch.allclose(new_mean, 0.9 * torch.tensor(rm) + 0.1 * mean, rtol=1e-6)


@pytest.mark.parametrize("activation", T.ACTS)
def test_invert_activation(activation):
    rng = np.random.default_rng(7)
    y = rng.standard_normal((2, 3, 4, 5)).astype(np.float32)
    act = J._act_forward(jnp.asarray(y), activation, 0.01)
    want = J.invert_activation(act, activation, 0.01)
    got = T.invert_activation(torch.tensor(np.asarray(act)), activation, 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), y, rtol=1e-5, atol=1e-6)


def test_cpu_uses_the_plain_version_and_counts_no_launch():
    x, w, b, _ = _inputs(8, (1, 2, 2, 8))
    before = OPS.launch_counts()["abn_apply"]
    T.fused_abn(_nchw(x), torch.tensor(w), torch.tensor(b))
    assert OPS.launch_counts()["abn_apply"] == before
    with pytest.raises(ValueError, match="CUDA"):
        T.abn_apply(_nchw(x), *(torch.zeros(8) for _ in range(4)))


def test_sync_is_not_ported_yet(tmp_path):
    """Synced statistics are ported: `axis_name` (a process group) runs. Over
    a gloo group of one rank the functional form, its gradients and the
    layer equal the unsynced ones to the bit (a sum over one rank and a
    division by 1). Two ranks: tests/test_torch_dist.py."""
    import torch.distributed as dist

    x, w, b, cot = _inputs(8, (2, 3, 3, 8))
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        runs = []
        for axis in (None, group):
            xt = _nchw(x).requires_grad_(True)
            wt, bt = (torch.tensor(a, requires_grad=True) for a in (w, b))
            y, new_mean, new_var = T.fused_abn(xt, wt, bt, axis_name=axis,
                                               running_mean=torch.zeros(8),
                                               running_var=torch.ones(8))
            grads = torch.autograd.grad((y * _nchw(cot)).sum(), (xt, wt, bt))
            layer = T.FusedABNorm(8, axis_name=axis)
            layer(_nchw(x))
            runs.append((y, new_mean, new_var, *grads, layer.running_mean, layer.running_var))
        assert T.group_size(group) == 1 and T.group_size(None) == 1
        for got, want in zip(runs[1], runs[0]):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
    finally:
        dist.destroy_process_group()
