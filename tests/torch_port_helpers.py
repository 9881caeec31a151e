"""Shared helpers of the port's CPU tests (tests/test_torch_*.py).

`jax_params` makes seeded Flax params for a JAX module from numpy without
running its initializers (`jax.eval_shape` traces only), which keeps the
tiny models' set-up to a second or two; `state_dict_from_jax` carries the
same values into the port. `FixedTextSD` is the port's `SD` with a fixed
[uncond; cond] text embedding, as bench.py's wrapper. `write_tiny_sd_dir`,
`write_tiny_ddpm_dir` and `write_tiny_ldm_dir` write TINY HF-layout
checkpoint directories for the port's factory and CLI."""

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


def jax_vq_config(tcfg):
    """The JAX package's AutoencoderConfig of the port's VQ config."""
    import dataclasses

    from diffusion_image_editing_tpu import models as JM

    fields = {f.name for f in dataclasses.fields(JM.AutoencoderConfig)}
    return JM.AutoencoderConfig(**{k: v for k, v in dataclasses.asdict(tcfg).items()
                                   if k in fields})


def tiny_ldm_unet_configs():
    """A TINY LDM-style UNet2D (flip_sin_to_cos, no frequency shift, the
    symmetric downsample pad, heads of dim 8): (JAX config, port config)."""
    import dataclasses

    from diffusion_image_editing_tpu import models as JM
    from diffusion_image_editing_tpu_torch import models as TM

    kw = dict(flip_sin_to_cos=True, freq_shift=0.0, downsample_padding=1, attention_head_dim=8)
    return (dataclasses.replace(JM.TINY_UNET2D, **kw),
            dataclasses.replace(TM.TINY_UNET2D, **kw))


def tiny_unet2d_params(cfg=None, seed=3):
    """(JAX UNet2D, params) for `cfg` (default the JAX TINY_UNET2D)."""
    from diffusion_image_editing_tpu import models as JM

    cfg = cfg or JM.TINY_UNET2D
    module = JM.UNet2D(cfg)
    d = cfg.sample_size
    return module, jax_params(module, seed, jnp.zeros((1, d, d, cfg.in_channels)), jnp.int32(0))


def tiny_vq_params(seed=4):
    """(JAX VQModel at the port's TINY_VQVAE, params); the codebook is
    drawn standard normal, so that codes lie where the latents do."""
    from diffusion_image_editing_tpu import models as JM
    from diffusion_image_editing_tpu_torch import models as TM

    jcfg = jax_vq_config(TM.TINY_VQVAE)
    module = JM.VQModel(jcfg)
    params = jax_params(module, seed, jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed + 100)
    params["params"]["quantize"]["embedding"] = rng.standard_normal(
        (jcfg.num_vq_embeddings, jcfg.vq_embed_dim)).astype(np.float32)
    return module, params


def resnet50_variables(width=8, seed=5):
    """(JAX ResNet50(width), variables with non-trivial running statistics)."""
    from diffusion_image_editing_tpu import models as JM

    module = JM.ResNet50(num_outputs=80, width=width)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "mean":
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return _fill(path, leaf, rng)

    return module, jax.tree_util.tree_map_with_path(fill, shapes)


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


def write_bisenet_checkpoint(path, seed=0, width=8, n_classes=19):
    """A face-parsing-style checkpoint file, `{"state_dict": {"module." +
    key: tensor}}`, of a seeded port `BiSeNet(norm="bn")` with non-trivial
    norm parameters and running statistics; returns the state dict."""
    from diffusion_image_editing_tpu_torch.models import BiSeNet
    from diffusion_image_editing_tpu_torch.models.resnet import norm_layers

    with torch.random.fork_rng():
        torch.manual_seed(seed)
        model = BiSeNet(n_classes=n_classes, norm="bn", width=width, device="cpu")
        with torch.no_grad():
            for m in norm_layers(model):
                m.weight.uniform_(0.8, 1.2)
                m.bias.normal_(0.0, 0.1)
                m.running_mean.normal_(0.0, 0.1)
                m.running_var.uniform_(0.8, 1.2)
    state = model.state_dict()
    torch.save({"state_dict": {"module." + k: v for k, v in state.items()}}, path)
    return state


def write_tiny_ddpm_dir(root, legacy_attention_names=True, seed=3):
    """An HF-layout TINY DDPM directory (unet/: the port's TINY_UNET2D, f32,
    from seeded Flax params); returns the params."""
    import os

    from diffusion_image_editing_tpu_torch import models as TM
    from diffusion_image_editing_tpu_torch.models.port import save_checkpoint_dir

    _, params = tiny_unet2d_params(seed=seed)
    unet = TM.UNet2D(TM.TINY_UNET2D, device="cpu")
    unet.load_state_dict(TM.state_dict_from_jax(params, "unet2d"))
    save_checkpoint_dir(unet, os.path.join(root, "unet"),
                        legacy_attention_names=legacy_attention_names)
    return params


def write_tiny_ldm_dir(root, unet_legacy=False, vq_legacy=True, seed=3):
    """An HF-layout TINY LDM directory (unet/: TINY_UNET2D on the 16 x 16 x 3
    latent; vqvae/: TINY_VQVAE), f32, from seeded Flax params, each under
    the attention naming asked for; returns {"unet": params, "vq": params}."""
    import os

    from diffusion_image_editing_tpu_torch import models as TM
    from diffusion_image_editing_tpu_torch.models.port import save_checkpoint_dir

    _, uparams = tiny_unet2d_params(seed=seed)
    _, vparams = tiny_vq_params(seed=seed + 1)
    for sub, kind, module, params, legacy in (
            ("unet", "unet2d", TM.UNet2D(TM.TINY_UNET2D, device="cpu"), uparams, unet_legacy),
            ("vqvae", "vq", TM.VQModel(TM.TINY_VQVAE, device="cpu"), vparams, vq_legacy)):
        module.load_state_dict(TM.state_dict_from_jax(params, kind))
        save_checkpoint_dir(module, os.path.join(root, sub), legacy_attention_names=legacy)
    return {"unet": uparams, "vq": vparams}


def write_anygan_checkpoint(path, width=8, seed=5, nested=True):
    """A torchvision-keyed ResNet-50 `.pth` (fc -> 80) from seeded JAX
    variables, under "state_dict" when `nested`; returns the variables."""
    from diffusion_image_editing_tpu_torch import models as TM

    _, variables = resnet50_variables(width, seed)
    state = TM.state_dict_from_jax(variables, "resnet50")
    torch.save({"state_dict": state} if nested else state, path)
    return variables
