"""The port's BiSeNet against the JAX package's, same weights and inputs.

Weights are seeded Flax variables made from numpy (params and running
statistics), carried into the port by `state_dict_from_jax(kind="bisenet")`
and, the other way round, the port's `norm="bn"` state dict goes into JAX
through its face-parsing checkpoint loader (`port_torchvision_state_dict`),
which proves the port's key names are the checkpoint's.

Layout: JAX is NHWC, the port NCHW; inputs and outputs are transposed at
the boundary. Tolerances, f32 on both sides, on the three heads as
max |port - jax| / max |jax|:
* eval mode (running statistics): 1e-5, convolutions summed in another
  order;
* train mode (batch statistics): 1e-3. At this size the 1x1 norms
  (`conv_avg`, both `bn_atten`) normalise over N = 2 values each, and the
  single-pass variance E[x^2] - mean^2 of two nearly equal values keeps few
  digits, so summation-order differences grow about 100-fold there;
* running statistics after one train-mode forward: rtol 1e-4, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.models import bisenet as JB
from diffusion_image_editing_tpu.models.layers import upsample_nearest as j_upsample
from diffusion_image_editing_tpu.models.port import port_torchvision_state_dict
from diffusion_image_editing_tpu_torch.models import bisenet as TB
from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
from diffusion_image_editing_tpu_torch.models.resnet import NormAct, norm_layers

N_CLASSES, WIDTH, SIZE = 5, 8, 64
EVAL_TOL, TRAIN_TOL = 1e-5, 1e-3
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def _fill(path, leaf, rng):
    name = path[-1].key
    shape = leaf.shape
    if name == "kernel":
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if name in ("scale", "weight"):
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name == "var":
        return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def jax_variables(module, seed, size=SIZE):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, l: _fill(p, l, rng), shapes)


def _image(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).standard_normal((n, size, size, 3)).astype(np.float32)


def _nchw(a):
    return torch.tensor(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _rel(got, want):
    want = np.asarray(want).transpose(0, 3, 1, 2)
    return float(np.abs(got.detach().numpy() - want).max() / np.abs(want).max())


@pytest.fixture(scope="module", params=["abn", "bn"])
def pair(request):
    norm = request.param
    jm = JB.BiSeNet(n_classes=N_CLASSES, norm=norm, width=WIDTH)
    variables = jax_variables(jm, seed=1)
    tm = TB.BiSeNet(n_classes=N_CLASSES, norm=norm, width=WIDTH)
    tm.load_state_dict(state_dict_from_jax(variables, "bisenet"), strict=True)
    return norm, jm, variables, tm


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_heads_match_jax(pair, train):
    norm, jm, variables, tm = pair
    x = _image(2)
    apply = jax.jit(jm.apply, static_argnames=("train", "mutable"))
    outs = apply(variables, jnp.asarray(x), train=train,
                 mutable=("batch_stats",) if train else False)
    if train:
        outs, mutated = outs
    model = tm if not train else TB.BiSeNet(n_classes=N_CLASSES, norm=norm, width=WIDTH)
    if train:  # a fresh copy, so the module-scoped model keeps its statistics
        model.load_state_dict(tm.state_dict())
    model.train(train)
    got = model(_nchw(x))
    assert len(got) == 3
    for g, w in zip(got, outs):
        assert g.shape == (2, N_CLASSES, SIZE, SIZE) and g.dtype == torch.float32
        assert _rel(g, w) <= (TRAIN_TOL if train else EVAL_TOL)
    if train:
        want = state_dict_from_jax({"batch_stats": mutated["batch_stats"]}, "bisenet")
        sd = model.state_dict()
        for key, value in want.items():
            if key.endswith("num_batches_tracked"):
                assert int(sd[key]) == 1
            else:
                np.testing.assert_allclose(sd[key].numpy(), value.numpy(), **STATS_TOL)


def test_bn_state_dict_loads_through_the_checkpoint_loader():
    """The port's bn state dict, read by the JAX package's loader of the
    face-parsing checkpoint, gives the JAX model the port's outputs."""
    tm = TB.BiSeNet(n_classes=N_CLASSES, norm="bn", width=WIDTH)
    torch.manual_seed(3)
    with torch.no_grad():  # non-trivial running statistics
        for m in norm_layers(tm):
            m.running_mean.normal_(0.0, 0.1)
            m.running_var.uniform_(0.8, 1.2)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    for key in ("cp.resnet.layer2.0.downsample.1.running_var", "cp.arm16.conv.bn.weight",
                "cp.resnet.layer1.0.bn1.num_batches_tracked", "ffm.convblk.conv.weight",
                "conv_out16.conv_out.weight", "cp.conv_avg.bn.running_mean"):
        assert key in sd
    variables = port_torchvision_state_dict(sd)
    x = _image(4)
    want = jax.jit(JB.BiSeNet(n_classes=N_CLASSES, norm="bn", width=WIDTH).apply)(variables, x)
    tm.eval()
    for g, w in zip(tm(_nchw(x)), want):
        assert _rel(g, w) <= EVAL_TOL
    # and back: the checkpoint's variables through the port's converter
    back = state_dict_from_jax(variables, "bisenet")
    assert set(back) == set(sd)
    for key, value in back.items():
        np.testing.assert_array_equal(value.numpy(), sd[key])


@pytest.mark.parametrize("norm", ["bn", "abn"])
def test_path_has_31_norm_layers(norm):
    model = TB.BiSeNet(norm=norm, width=4)
    layers = norm_layers(model, norm)
    assert len(layers) == 31 == len(norm_layers(model))
    assert sum(m.activation == "identity" for m in layers) == 13  # bn2, downsample, bn_atten


def test_resize_and_upsample_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 9, 3)).astype(np.float32)
    for h, w in ((7, 9), (16, 20), (64, 33)):
        want = JB.resize_bilinear_align_corners(jnp.asarray(x), h, w)
        got = TB.resize_bilinear_align_corners(_nchw(x), h, w)
        np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2),
                                   rtol=1e-5, atol=1e-5)
    for h, w in ((14, 18), (21, 27), (10, 13)):
        want = j_upsample(jnp.asarray(x), h, w)
        got = TB.upsample_nearest(_nchw(x), h, w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).transpose(0, 3, 1, 2))


def test_compute_dtype_bf16_keeps_params_and_heads_f32():
    model = TB.BiSeNet(n_classes=N_CLASSES, norm="abn", width=WIDTH, dtype=torch.bfloat16)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    model.train()
    outs = model(torch.randn(2, 3, 32, 32))
    assert all(o.dtype == torch.float32 and torch.isfinite(o).all() for o in outs)
    assert all(m.running_mean.dtype == torch.float32 for m in norm_layers(model))


def test_abn_sync_is_not_ported_yet(tmp_path):
    """abn_sync is ported: `axis_name` reaches every norm of the BiSeNet, and
    over a gloo group of one rank a training step's outputs, gradients and
    running statistics equal norm="abn"'s to the bit (two ranks:
    tests/test_torch_dist.py). Synced statistics for "bn" are not ported."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        torch.manual_seed(0)
        ref = TB.BiSeNet(n_classes=N_CLASSES, norm="abn", width=WIDTH)
        sync = TB.BiSeNet(n_classes=N_CLASSES, norm="abn_sync", width=WIDTH, axis_name=group)
        sync.load_state_dict(ref.state_dict())
        synced = norm_layers(sync, "abn_sync")
        assert len(synced) == len(norm_layers(ref)) and all(m.axis_name is group for m in synced)
        x = torch.randn(2, 3, 32, 32)
        runs = []
        for model in (ref, sync):
            model.train()
            loss = sum(o.square().mean() for o in model(x))
            grads = torch.autograd.grad(loss, list(model.parameters()))
            runs.append((loss, grads, [b.clone() for b in model.buffers()]))
        torch.testing.assert_close(runs[1][0], runs[0][0], rtol=0, atol=0)
        for got, want in zip(runs[1][1] + tuple(runs[1][2]), runs[0][1] + tuple(runs[0][2])):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
        assert NormAct(8, "abn_sync").axis_name is None  # no group: one rank
        with pytest.raises(NotImplementedError, match="abn_sync"):
            NormAct(8, "bn", axis_name=group)
    finally:
        dist.destroy_process_group()
