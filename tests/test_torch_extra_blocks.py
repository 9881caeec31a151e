"""The port's extra segmentation blocks (`models/extra_blocks.py`) against the
JAX package's: seeded Flax variables carried across by
`state_dict_from_jax(..., "abn_blocks")`, the same NHWC input, f32, in eval
mode (the running statistics), rtol 1e-4, atol 1e-5, and in training mode
(batch statistics, and the running ones updated), rtol 1e-4, atol 1e-4:
the DeepLab head's pooled branch normalises two values a channel (batch 2
at 1 x 1), by the single-pass E[x^2] - mean^2 in f32 of both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu import models as JM
from diffusion_image_editing_tpu_torch import models as TM
from tests.torch_port_helpers import nchw

TOL = dict(rtol=1e-4, atol=1e-5)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-4)

BLOCKS = {
    "deeplab": (lambda: JM.DeeplabV3Head(hidden_channels=8, out_channels=12, num_classes=5,
                                         dilations=(2, 4, 6)),
                lambda: TM.DeeplabV3Head(6, 8, 12, 5, (2, 4, 6), device="cpu"), (2, 16, 16, 6)),
    "deeplab_no_classes": (lambda: JM.DeeplabV3Head(hidden_channels=8, out_channels=12,
                                                    dilations=(1, 2, 3)),
                           lambda: TM.DeeplabV3Head(6, 8, 12, None, (1, 2, 3), device="cpu"),
                           (2, 8, 8, 6)),
    "residual2": (lambda: JM.IdentityResidualBlock(channels=(8, 8)),
                  lambda: TM.IdentityResidualBlock(8, (8, 8), device="cpu"), (2, 8, 8, 8)),
    "residual3_stride2": (lambda: JM.IdentityResidualBlock(channels=(8, 16, 32), stride=2,
                                                           dilation=2),
                          lambda: TM.IdentityResidualBlock(8, (8, 16, 32), 2, 2, device="cpu"),
                          (2, 8, 8, 8)),
    "dense": (lambda: JM.DenseModule(growth=4, layers=3),
              lambda: TM.DenseModule(8, 4, 3, device="cpu"), (2, 8, 8, 8)),
}


def _fill(path, leaf, rng):
    name, shape = path[-1].key, leaf.shape
    if name == "kernel":
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if name == "weight":
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name == "var":
        return rng.uniform(0.5, 1.5, shape).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


@pytest.mark.parametrize("name", list(BLOCKS))
@pytest.mark.parametrize("train", [False, True])
def test_block_matches_jax(name, train):
    make_j, make_t, shape = BLOCKS[name]
    jm = make_j()
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros(shape))
    rng = np.random.default_rng(0)
    variables = jax.tree_util.tree_map_with_path(lambda p, l: _fill(p, l, rng), dict(shapes))
    tm = make_t()
    tm.load_state_dict(TM.state_dict_from_jax(variables, "abn_blocks"))
    tm.train(train)
    with torch.no_grad():
        got = tm(torch.from_numpy(nchw(x)))
    if train:
        want, updated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        stats = TM.state_dict_from_jax({"batch_stats": updated["batch_stats"]}, "abn_blocks")
        state = tm.state_dict()
        for k, v in stats.items():
            np.testing.assert_allclose(state[k].numpy(), v.numpy(), err_msg=k, **TRAIN_TOL)
    else:
        want = jm.apply(variables, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), nchw(want), **(TRAIN_TOL if train else TOL))


def test_global_avg_pool():
    x = np.random.default_rng(2).standard_normal((2, 4, 4, 3)).astype(np.float32)
    got = TM.GlobalAvgPool2d()(torch.from_numpy(nchw(x)))
    np.testing.assert_allclose(got.numpy(), np.asarray(JM.GlobalAvgPool2d().apply({}, x)),
                               **TOL)


def test_residual_block_refuses_other_depths():
    with pytest.raises(ValueError, match="length 2 or 3"):
        TM.IdentityResidualBlock(8, (8,), device="cpu")
