"""Shared helpers of the port's CPU tests (tests/test_torch_*.py).

`jax_params` makes seeded Flax params for a JAX module from numpy without
running its initializers (`jax.eval_shape` traces only), which keeps the
tiny models' set-up to a second or two; `state_dict_from_jax` carries the
same values into the port. `FixedTextSD` is the port's `SD` with a fixed
[uncond; cond] text embedding, as bench.py's wrapper."""

import math

import jax
import jax.numpy as jnp
import numpy as np

from diffusion_image_editing_tpu_torch.pipeline import SD


class FixedTextSD(SD):
    """No CLIP weights here: a fixed [uncond; cond] embedding, as bench.py."""

    def __init__(self, *args, text_emb, **kwargs):
        super().__init__(*args, **kwargs)
        self.fixed_text_emb = text_emb.to(self.device)

    def prep_text(self, prompt_ids=None):
        return self.fixed_text_emb


def _fill(path, leaf, rng):
    name = path[-1].key
    shape = leaf.shape
    if name == "kernel":
        fan_in = math.prod(shape[:-1])
        return (rng.standard_normal(shape) / math.sqrt(fan_in)).astype(np.float32)
    if name == "scale":
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return (0.02 * rng.standard_normal(shape)).astype(np.float32)


def jax_params(module, seed, *example_args):
    """{'params': ...} for `module.init(key, *example_args)`, values from numpy."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *example_args)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(lambda p, l: _fill(p, l, rng), shapes)


def tiny_unet_params(seed=0):
    from diffusion_image_editing_tpu import models as JM

    module = JM.UNet2DCondition(JM.TINY_SD_UNET)
    return module, jax_params(module, seed, jnp.zeros((1, 8, 8, 4)), jnp.int32(0),
                              jnp.zeros((1, 7, 32)))


def tiny_vae_params(seed=1):
    from diffusion_image_editing_tpu import models as JM

    module = JM.AutoencoderKL(JM.TINY_VAE)
    return module, jax_params(module, seed, jnp.zeros((1, 32, 32, 3)))


def nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)
