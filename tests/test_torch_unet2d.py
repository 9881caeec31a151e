"""The port's UNet2D (the DDPM and LDM denoisers) against the JAX package's,
weights carried across with `state_dict_from_jax`, inputs from numpy: the
TINY config (DDPM-style: no sin/cos flip, frequency shift 1, the
asymmetric downsample pad, one 64-wide head) and a TINY LDM-style config
(flip, shift 0, the symmetric pad, heads of dim 8).

Layout: JAX is NHWC, the port NCHW; the tests transpose at the boundary.
Tolerances: f32 on both sides, summation order only: rtol 1e-4, atol 1e-5
(observed about 1.3e-6 on outputs of magnitude about 2.5)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu import models as JM
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.models import port as TP
from diffusion_image_editing_tpu_torch.models.layers import AttentionBlock2D
from tests.torch_port_helpers import nchw, tiny_ldm_unet_configs, tiny_unet2d_params

FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _configs(name):
    if name == "ddpm":
        return JM.TINY_UNET2D, TM.TINY_UNET2D
    return tiny_ldm_unet_configs()


@pytest.fixture(scope="module", params=["ddpm", "ldm"])
def pair(request):
    jcfg, tcfg = _configs(request.param)
    ju, params = tiny_unet2d_params(jcfg)
    tu = TM.UNet2D(tcfg, device="cpu")
    tu.load_state_dict(TM.state_dict_from_jax(params, "unet2d"))
    return ju, params, tu


@pytest.mark.parametrize("t", [np.int32(500), np.array([999, 1], np.int32)])
def test_unet2d_forward_matches_jax(pair, t):
    """Scalar and per-sample timesteps."""
    ju, params, tu = pair
    x = np.random.default_rng(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    ref = jax.jit(ju.apply)(params, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        out = tu(torch.from_numpy(nchw(x)), t)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 3, 16, 16)
    np.testing.assert_allclose(out.numpy(), nchw(ref), **FWD_TOL)


CONFIG_NAMES = ("TINY_UNET2D", "DDPM_CELEBAHQ_256", "LDM_CELEBAHQ_256_UNET")


def test_published_configs_match_jax():
    """Field for field; the port has no `dropout` (it trains no UNet2D), so
    every JAX config must have 0.0 there."""
    for name in CONFIG_NAMES:
        want = dataclasses.asdict(getattr(JM, name))
        got = dataclasses.asdict(getattr(TM, name))
        assert got.pop("fused_conv") is False
        assert want.pop("dropout") == 0.0, name
        assert got == want, name


@pytest.mark.parametrize("name,heads,blocks", [
    ("TINY_UNET2D", [1], 4), ("LDM_CELEBAHQ_256_UNET", [14, 21, 28], 16),
    ("DDPM_CELEBAHQ_256", [1], 6)])
def test_attention_heads_and_count(name, heads, blocks):
    """The LDM UNet's heads of dim 32 (14, 21 and 28 of them), the DDPM
    UNet's one 512-wide head, and the attention blocks of one forward."""
    cfg = getattr(TM, name)
    with torch.device("meta"):
        unet = TM.UNet2D(cfg, device="meta")
    attns = [m for m in unet.modules() if isinstance(m, AttentionBlock2D)]
    assert len(attns) == blocks
    assert sorted({m.num_heads for m in attns}) == heads


def test_ldm_unet_has_274m_parameters():
    with torch.device("meta"):
        unet = TM.UNet2D(TM.LDM_CELEBAHQ_256_UNET, device="meta")
    assert round(sum(p.numel() for p in unet.parameters()) / 1e6) == 274


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_config_json_round_trip_matches_jax(name):
    """A config written as the HF `config.json` of a `unet/` directory (as
    diffusers writes it, with its `dropout` of 0.0) reads back as the same
    config through the port's loader and as the JAX package's config of that
    name through the JAX loader."""
    from diffusion_image_editing_tpu.models import port as JP

    js = TP.config_to_json(getattr(TM, name))
    js["dropout"] = 0.0
    assert TP.unet2d_config_from_json(js) == getattr(TM, name)
    assert JP.unet2d_config_from_json(js) == getattr(JM, name)
