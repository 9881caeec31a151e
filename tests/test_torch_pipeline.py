"""The port's entry points: where they run and what they refuse."""

import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu_torch.core import resolve_device, schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.models import (
    TINY_SD_UNET, TINY_VAE, AutoencoderKL, UNet2DCondition)
from diffusion_image_editing_tpu_torch.pipeline import SD, EditPipeline


@pytest.fixture(scope="module")
def pipe():
    torch.manual_seed(0)
    sd = SD(UNet2DCondition(TINY_SD_UNET, device="cpu"), AutoencoderKL(TINY_VAE, device="cpu"),
            schedule_for_model("sd", 4), text_emb=torch.zeros(2, 7, 32), device="cpu")
    return EditPipeline(sd)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        SD(UNet2DCondition(TINY_SD_UNET, device="cpu"), AutoencoderKL(TINY_VAE, device="cpu"),
           schedule_for_model("sd", 4))
    assert resolve_device("cpu") == torch.device("cpu")


def test_wrapper_places_everything_on_its_device(pipe):
    sd = pipe.diffusion_wrapper
    assert sd.device.type == "cpu" and sd.schedule.device.type == "cpu"
    assert sd.prep_text(None).shape == (2, 7, 32)
    with pytest.raises(NotImplementedError):
        sd.prep_text(np.zeros(77, np.int32))


@pytest.mark.parametrize("kwargs", [dict(inversion_method="ddim"), dict(mode="split"),
                                    dict(classes=[17])])
def test_unported_options_raise(pipe, kwargs):
    with pytest.raises(NotImplementedError):
        pipe.prepare_real_image_edit(torch.zeros(1, 3, 32, 32), **kwargs)


def test_edit_image_checks_its_inputs(pipe):
    xt = torch.zeros(1, 4, 16, 16)
    attr = SingleColorAttrFunc()
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=1.0, zs=None, attr_func=attr)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=0.0, attr_func=None)
    with pytest.raises(ValueError):
        pipe.edit_image(xt, eta=1.0, zs=torch.zeros(4, 1, 4, 16, 16), xts=torch.zeros(5),
                        attr_func=attr)
    with pytest.raises(NotImplementedError):
        pipe.edit_image(xt, attr_func=attr, mode="fused")
    with pytest.raises(NotImplementedError):
        EditPipeline(pipe.diffusion_wrapper, segmentation_fn=lambda img: img)


def test_ddim_edit_runs_without_noise_maps(pipe):
    out = pipe.edit_image(torch.randn(1, 4, 16, 16, generator=torch.Generator().manual_seed(0)),
                          eta=0.0, attr_func=SingleColorAttrFunc(t2=4), collect=False)
    assert out.imgs.shape == (1, 3, 32, 32) and out.model_outputs is None
    assert torch.isfinite(out.imgs).all()
