"""Weights carried across: diffusers-layout mirror state dict -> the JAX
package's `port_state_dict` -> the port's `state_dict_from_jax` reproduces
the original keys and values exactly (transposes only, no arithmetic), and
the port's modules load it under diffusers' key names."""

import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.models.port import port_state_dict
from diffusion_image_editing_tpu_torch import models as TM
from tests.torch_mirrors import TorchAutoencoderKL, TorchUNet2D, TorchUNet2DCondition, TorchVQModel

CASES = {
    "unet_cond": (lambda: TorchUNet2DCondition(TM.TINY_SD_UNET), "unet2d_cond",
                  lambda: TM.UNet2DCondition(TM.TINY_SD_UNET, device="cpu")),
    "vae": (lambda: TorchAutoencoderKL(TM.TINY_VAE, attn_naming="modern"), "vae",
            lambda: TM.AutoencoderKL(TM.TINY_VAE, device="cpu")),
    "unet2d": (lambda: TorchUNet2D(TM.TINY_UNET2D, attn_naming="modern"), "unet2d",
               lambda: TM.UNet2D(TM.TINY_UNET2D, device="cpu")),
    "vq": (lambda: TorchVQModel(TM.TINY_VQVAE, attn_naming="modern"), "vq",
           lambda: TM.VQModel(TM.TINY_VQVAE, device="cpu")),
    # The port's CLIP carries transformers' names: it is its own mirror.
    "clip_text": (lambda: TM.CLIPTextEncoder(TM.TINY_CLIP_TEXT, device="cpu"), "clip_text",
                  lambda: TM.CLIPTextEncoder(TM.TINY_CLIP_TEXT, device="cpu")),
}


def _mirror_state(kind):
    torch.manual_seed(0)
    mirror = CASES[kind][0]()
    return {k: v.detach().numpy() for k, v in mirror.state_dict().items()}


@pytest.mark.parametrize("kind", sorted(CASES))
def test_round_trip_reproduces_mirror_state_dict(kind):
    original = _mirror_state(kind)
    flax_params = port_state_dict(original, CASES[kind][1])
    back = TM.state_dict_from_jax(flax_params, kind)
    assert sorted(back) == sorted(original)
    for key, value in original.items():
        np.testing.assert_array_equal(back[key].numpy(), value, err_msg=key)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_port_modules_use_diffusers_keys(kind):
    """The port's module loads the mirror's state dict with strict=True."""
    model = CASES[kind][2]()
    state = {k: torch.from_numpy(v) for k, v in _mirror_state(kind).items()}
    model.load_state_dict(state, strict=True)
    assert sorted(model.state_dict()) == sorted(state)


def test_unknown_kind_raises():
    with pytest.raises(ValueError, match="Unknown kind"):
        TM.state_dict_from_jax({}, "unet")  # the JAX loader's kinds are unet2d / unet2d_cond
