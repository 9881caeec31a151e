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
import torch

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


# A synthetic CLIP vocabulary: every byte, every byte ending a word, a few
# merges and the two special tokens.
TOKEN_MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"), ("t", "h"),
                ("th", "e</w>"), ("r", "e"), ("re", "d</w>"), ("c", "a"), ("ca", "t</w>")]


def write_tokenizer_dir(path):
    """An HF tokenizer directory (vocab.json + merges.txt); returns the vocab."""
    import json
    import os

    from diffusion_image_editing_tpu_torch.host.tokenizer import bytes_to_unicode

    byte_vocab = list(bytes_to_unicode().values())
    tokens = byte_vocab + [v + "</w>" for v in byte_vocab]
    tokens += ["".join(m) for m in TOKEN_MERGES] + ["<|startoftext|>", "<|endoftext|>"]
    vocab = {t: i for i, t in enumerate(tokens)}
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vocab.json"), "w") as f:
        json.dump(vocab, f)
    with open(os.path.join(path, "merges.txt"), "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in TOKEN_MERGES))
    return vocab


def tiny_clip_params(vocab_size, seed=2):
    """A TINY-width CLIP that takes the tokenizer's 77 ids and vocabulary:
    (JAX module, params, the port's config)."""
    import dataclasses

    from diffusion_image_editing_tpu import models as JM
    from diffusion_image_editing_tpu_torch import models as TM

    jcfg = dataclasses.replace(JM.TINY_CLIP_TEXT, vocab_size=vocab_size,
                               max_position_embeddings=77)
    module = JM.CLIPTextEncoder(jcfg)
    tcfg = dataclasses.replace(TM.TINY_CLIP_TEXT, vocab_size=vocab_size,
                               max_position_embeddings=77)
    return module, jax_params(module, seed, jnp.zeros((1, 77), jnp.int32)), tcfg


def to_safetensors(model_dir, shards=1):
    """Rewrite a component directory's `pytorch_model.bin` as one
    `model.safetensors`, or as `shards` files listed by an index."""
    import json
    import os

    from safetensors.torch import save_file

    path = os.path.join(model_dir, "pytorch_model.bin")
    state = torch.load(path, weights_only=True)
    os.remove(path)
    if shards == 1:
        save_file(state, os.path.join(model_dir, "model.safetensors"))
        return
    keys, weight_map = list(state), {}
    for i in range(shards):
        name = f"model-{i + 1:05d}-of-{shards:05d}.safetensors"
        save_file({k: state[k] for k in keys[i::shards]}, os.path.join(model_dir, name))
        weight_map.update({k: name for k in keys[i::shards]})
    with open(os.path.join(model_dir, "model.safetensors.index.json"), "w") as f:
        json.dump({"weight_map": weight_map}, f)


def write_tiny_sd_dir(root, fmt="bin", legacy_vae_names=False):
    """An HF-layout TINY SD directory (unet/, vae/, text_encoder/,
    tokenizer/) from seeded Flax params, f32, its weights in `fmt` "bin" or
    "safetensors"; returns the params by kind."""
    import os

    from diffusion_image_editing_tpu_torch import models as TM
    from diffusion_image_editing_tpu_torch.models.port import save_checkpoint_dir

    vocab = write_tokenizer_dir(os.path.join(root, "tokenizer"))
    _, uparams = tiny_unet_params()
    _, vparams = tiny_vae_params()
    _, cparams, ccfg = tiny_clip_params(len(vocab))
    for sub, kind, module, params, kw in (
            ("unet", "unet_cond", TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu"), uparams, {}),
            ("vae", "vae", TM.AutoencoderKL(TM.TINY_VAE, device="cpu"), vparams,
             dict(legacy_attention_names=legacy_vae_names)),
            ("text_encoder", "clip_text", TM.CLIPTextEncoder(ccfg, device="cpu"), cparams, {})):
        module.load_state_dict(TM.state_dict_from_jax(params, kind))
        save_checkpoint_dir(module, os.path.join(root, sub), **kw)
        if fmt == "safetensors":
            to_safetensors(os.path.join(root, sub))
    return {"unet": uparams, "vae": vparams, "clip": cparams}
