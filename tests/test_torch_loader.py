"""The port's checkpoint-directory loader and SD factory against the JAX
package's, on synthetic HF-layout directories the tests write.

Every format the loader reads (`.bin`, one `.safetensors`, shards with an
index) and both VAE attention namings load bit-exactly into the port's
modules. The modules the port loads give the outputs of the JAX modules
that the JAX package's `load_checkpoint_dir` loads from the same directory:
f32 on both sides, rtol 1e-4, atol 1e-5 (as tests/test_torch_models.py).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.models import AutoencoderKL as JVAE
from diffusion_image_editing_tpu.models import CLIPTextEncoder as JCLIP
from diffusion_image_editing_tpu.models import UNet2DCondition as JUNet
from diffusion_image_editing_tpu.models.port import load_checkpoint_dir as j_load
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.models import port as P
from diffusion_image_editing_tpu_torch.pipeline import SD, create_diffusion_model
from diffusion_image_editing_tpu_torch.pipeline import factory
from tests.torch_port_helpers import nchw, to_safetensors, write_tiny_sd_dir

FWD_TOL = dict(rtol=1e-4, atol=1e-5)
KINDS = {"unet": "unet2d_cond", "vae": "vae", "text_encoder": "clip_text"}


@pytest.fixture(scope="module")
def sd_dirs(tmp_path_factory):
    """One TINY SD directory a weights format, the VAE under both namings."""
    out = {}
    for fmt, legacy in (("bin", False), ("safetensors", True)):
        root = str(tmp_path_factory.mktemp(fmt))
        write_tiny_sd_dir(root, fmt, legacy_vae_names=legacy)
        out[fmt] = root
    sharded = str(tmp_path_factory.mktemp("sharded"))
    write_tiny_sd_dir(sharded, "bin")
    for sub in KINDS:
        to_safetensors(os.path.join(sharded, sub), shards=3)
    out["sharded"] = sharded
    return out


@pytest.mark.parametrize("fmt", ["safetensors", "sharded"])
@pytest.mark.parametrize("sub", sorted(KINDS))
def test_every_format_loads_bit_exactly(sd_dirs, fmt, sub):
    ref = P.load_checkpoint_dir(os.path.join(sd_dirs["bin"], sub), KINDS[sub], device="cpu")
    got = P.load_checkpoint_dir(os.path.join(sd_dirs[fmt], sub), KINDS[sub], device="cpu")
    want = ref.state_dict()
    assert set(got.state_dict()) == set(want)
    for k, v in got.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_layouts_on_disk(sd_dirs):
    vae = os.listdir(os.path.join(sd_dirs["safetensors"], "vae"))
    assert "model.safetensors" in vae
    names = P.load_weights(os.path.join(sd_dirs["safetensors"], "vae"))
    assert any(".attentions.0.query." in k for k in names)  # the legacy naming
    assert not any(".to_q." in k for k in names)
    shards = os.listdir(os.path.join(sd_dirs["sharded"], "unet"))
    assert sum(n.endswith(".safetensors") for n in shards) == 3
    assert "model.safetensors.index.json" in shards


def test_loaded_modules_match_jax(sd_dirs):
    """The same directory through both packages' loaders, then the same
    inputs through both modules."""
    root = sd_dirs["safetensors"]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    z = rng.standard_normal((1, 16, 16, 4)).astype(np.float32)
    ids = rng.integers(0, 500, (2, 77), dtype=np.int32)
    t = np.array([901, 11], np.int32)

    ucfg, uparams = j_load(os.path.join(root, "unet"), "unet2d_cond")
    unet = P.load_checkpoint_dir(os.path.join(root, "unet"), "unet2d_cond", device="cpu")
    ref = JUNet(ucfg).apply(uparams, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        out = unet(torch.from_numpy(nchw(x)), t, torch.from_numpy(ctx))
    np.testing.assert_allclose(out.numpy(), nchw(ref), **FWD_TOL)

    vcfg, vparams = j_load(os.path.join(root, "vae"), "vae")
    vae = P.load_checkpoint_dir(os.path.join(root, "vae"), "vae", device="cpu")
    ref = JVAE(vcfg).apply(vparams, jnp.asarray(z), method="decode")
    with torch.no_grad():
        out = vae.decode(torch.from_numpy(nchw(z)))
    np.testing.assert_allclose(out.numpy(), nchw(ref), **FWD_TOL)

    ccfg, cparams = j_load(os.path.join(root, "text_encoder"), "clip_text")
    clip = P.load_checkpoint_dir(os.path.join(root, "text_encoder"), "clip_text", device="cpu")
    ref = JCLIP(ccfg).apply(cparams, jnp.asarray(ids))
    with torch.no_grad():
        out = clip(torch.from_numpy(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **FWD_TOL)
    assert clip.config == dataclasses.replace(
        TM.TINY_CLIP_TEXT, vocab_size=ccfg.vocab_size, max_position_embeddings=77)


def test_loader_casts_to_the_module_dtype(sd_dirs):
    path = os.path.join(sd_dirs["bin"], "text_encoder")
    half = P.load_checkpoint_dir(path, "clip_text", device="cpu", dtype=torch.bfloat16)
    full = P.load_checkpoint_dir(path, "clip_text", device="cpu")
    for k, v in half.state_dict().items():
        assert v.dtype == torch.bfloat16 and torch.equal(v, full.state_dict()[k].bfloat16()), k


def test_transformers_position_ids_buffer_is_taken(sd_dirs, tmp_path):
    src = os.path.join(sd_dirs["bin"], "text_encoder")
    state = P.load_weights(src)
    state["text_model.embeddings.position_ids"] = torch.arange(77)[None]
    torch.save(state, tmp_path / "pytorch_model.bin")
    (tmp_path / "config.json").write_text(open(os.path.join(src, "config.json")).read())
    P.load_checkpoint_dir(str(tmp_path), "clip_text", device="cpu")


@pytest.mark.parametrize("change", ["unmapped", "missing"])
def test_key_mismatch_raises(sd_dirs, tmp_path, change):
    src = os.path.join(sd_dirs["bin"], "vae")
    state = P.load_weights(src)
    if change == "unmapped":
        state["decoder.extra.weight"] = torch.zeros(1)
    else:
        del state["decoder.conv_out.bias"]
    torch.save({"state_dict": state}, tmp_path / "model.pt")
    (tmp_path / "config.json").write_text(open(os.path.join(src, "config.json")).read())
    with pytest.raises(ValueError, match="decoder"):
        P.load_checkpoint_dir(str(tmp_path), "vae", device="cpu")


def test_directory_without_weights_raises(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"block_out_channels": [16, 32]}))
    with pytest.raises(FileNotFoundError):
        P.load_checkpoint_dir(str(tmp_path), "vae", device="cpu")


@pytest.mark.parametrize("kind", ["unet2d", "vq"])
def test_later_kinds_raise(tmp_path, kind):
    """The DDPM / LDM kinds (Queue A item 14) load a directory; they raise
    as the other kinds do, on one without weights (tests/test_torch_families.py
    holds them against the JAX loader)."""
    from tests.torch_port_helpers import write_tiny_ldm_dir

    (tmp_path / "config.json").write_text(json.dumps({"block_out_channels": [16, 32]}))
    with pytest.raises(FileNotFoundError):
        P.load_checkpoint_dir(str(tmp_path), kind, device="cpu")
    write_tiny_ldm_dir(str(tmp_path))
    sub, cls = {"unet2d": ("unet", TM.UNet2D), "vq": ("vqvae", TM.VQModel)}[kind]
    assert isinstance(P.load_checkpoint_dir(str(tmp_path / sub), kind, device="cpu"), cls)


def test_factory_builds_sd_from_a_directory(sd_dirs):
    sd = create_diffusion_model("sd", checkpoint_dir=sd_dirs["bin"], num_inference_steps=4,
                                device="cpu")
    assert isinstance(sd, SD) and sd.tokenizer is not None and sd.text_encoder is not None
    assert sd.unet.conv_in.weight.dtype == torch.bfloat16  # the port's compute dtype
    assert sd.schedule.num_inference_steps == 4 and sd.device.type == "cpu"
    assert sd.data_dimensionality == 8 and sd.latent_shape(3) == (3, 4, 8, 8)
    emb = sd.prep_text(sd.tokenizer.encode("hello"))
    assert tuple(emb.shape) == (2, 77, 32) and emb.dtype == torch.float32


def test_factory_random_weights_warn(monkeypatch, capsys):
    monkeypatch.setattr(factory, "SD15_UNET", TM.TINY_SD_UNET)
    monkeypatch.setattr(factory, "SD_VAE", TM.TINY_VAE)
    monkeypatch.setattr(factory, "CLIP_VIT_L_14_TEXT", TM.TINY_CLIP_TEXT)
    a = create_diffusion_model("sd", device="cpu", dtype=torch.float32)
    b = create_diffusion_model("sd", device="cpu", dtype=torch.float32)
    assert "random-init" in capsys.readouterr().err
    assert a.tokenizer is None
    assert torch.equal(a.unet.conv_in.weight, b.unet.conv_in.weight)  # seeded


@pytest.mark.parametrize("name,exc", [("ddpm", FileNotFoundError),
                                      ("ldm", FileNotFoundError), ("nope", ValueError)])
def test_factory_other_families_raise(tmp_path, name, exc):
    """An unknown family; DDPM and LDM read their own directories (`unet/`,
    and `vqvae/` for LDM), and an SD directory has no `unet/` of theirs."""
    (tmp_path / "unet").mkdir()
    with pytest.raises(exc):
        create_diffusion_model(name, checkpoint_dir=str(tmp_path), device="cpu")


def test_factory_needs_cuda_unless_asked(monkeypatch, sd_dirs):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_diffusion_model("sd", checkpoint_dir=sd_dirs["bin"])
