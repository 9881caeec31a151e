"""The DDPM and LDM families in the port, held against the JAX package as a
user starts them: TINY HF-layout checkpoint directories (both attention
namings) loaded by both packages' loaders and factories, f32; a 3-step
generation with and without pred-x0 clipping; DDIM and edit-friendly DDPM
inversion of a real image (`prepare_real_image_edit`) and a 3-step edit
guided by `ClassifierAttrFunc` (the anyGAN ResNet-50 at width 8) through
each family's codec: the identity for DDPM, the quantizing VQ decode for
LDM; the clipping schedule refused for a real-image edit; and the CLI's
`generate` / `edit --family ddpm|ldm --device cpu`.

Tolerances, as tests/test_torch_pipeline.py and tests/test_torch_segguide.py:
module outputs rtol 1e-4, atol 1e-5; generations, inversion trajectories
and noise maps rtol 1e-4, atol 1e-3; the guided edit's trajectories and
image atol 1e-2 (three guided steps of f32 sums in another order)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from diffusion_image_editing_tpu.engine.denoise import DecodeClosure as JDecodeClosure
from diffusion_image_editing_tpu.guidance import ClassifierAttrFunc as JClassifierAttrFunc
from diffusion_image_editing_tpu.models.port import load_checkpoint_dir as j_load
from diffusion_image_editing_tpu.ops import resize as JR
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu.pipeline.factory import create_diffusion_model as j_create
from diffusion_image_editing_tpu_torch import cli
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.guidance import ClassifierAttrFunc
from diffusion_image_editing_tpu_torch.models import port as P
from diffusion_image_editing_tpu_torch.ops import resize as TR
from diffusion_image_editing_tpu_torch.pipeline import (
    DDPM, LDM, SD, EditPipeline, create_diffusion_model)
from diffusion_image_editing_tpu_torch.pipeline import factory
from tests.torch_port_helpers import (
    nchw, resnet50_variables, write_tiny_ddpm_dir, write_tiny_ldm_dir)

FWD = dict(rtol=1e-4, atol=1e-5)
TRAJ = dict(rtol=1e-4, atol=1e-3)
EDIT = dict(rtol=0, atol=1e-2)
STEPS, T_SKIP = 4, 1
GUIDE = dict(loss_scale=50.0, t1=0, t2=STEPS, idx_for_class=20, idx_of_interest=1)


def nchw5(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 1, 4, 2, 3))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """{family: directory}: DDPM's UNet under the legacy attention names;
    LDM's UNet under the current ones and its VQ model under the legacy."""
    out = {}
    for family, write in (("ddpm", write_tiny_ddpm_dir), ("ldm", write_tiny_ldm_dir)):
        root = str(tmp_path_factory.mktemp(family))
        write(root)
        out[family] = root
    img = np.random.default_rng(0).integers(0, 255, (40, 40, 3), dtype=np.uint8)
    Image.fromarray(img).save(os.path.join(out["ddpm"], "face.png"))
    return out


# ---------------------------------------------------------------------------
# Checkpoint directories
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("legacy", [False, True], ids=["to_q", "query"])
@pytest.mark.parametrize("kind", ["unet2d", "vq"])
def test_directories_in_both_namings_load_in_both_packages(tmp_path, kind, legacy):
    """The port's and the JAX loader read the same directory, written under
    either attention naming, into modules that compute the same function."""
    root = str(tmp_path)
    if kind == "unet2d":
        params = write_tiny_ddpm_dir(root, legacy_attention_names=legacy)
    else:
        params = write_tiny_ldm_dir(root, vq_legacy=legacy)["vq"]
    sub = os.path.join(root, "unet" if kind == "unet2d" else "vqvae")
    names = open(os.path.join(sub, "config.json")).read()
    state = torch.load(os.path.join(sub, "pytorch_model.bin"), weights_only=True)
    assert any(".query." in k for k in state) == legacy
    assert any(".to_q." in k for k in state) == (not legacy)
    module = P.load_checkpoint_dir(sub, kind, device="cpu")
    jcfg, jparams = j_load(sub, kind)
    loaded = dict(jax.tree_util.tree_leaves_with_path(jparams))
    for path, value in jax.tree_util.tree_leaves_with_path(params):
        np.testing.assert_array_equal(np.asarray(loaded[path]), np.asarray(value))
    if kind == "unet2d":
        from diffusion_image_editing_tpu.models import UNet2D as JUNet2D

        assert module.config == TM.TINY_UNET2D and "downsample_padding" in names
        x = np.random.default_rng(1).standard_normal((1, 16, 16, 3)).astype(np.float32)
        want = JUNet2D(jcfg).apply(jparams, jnp.asarray(x), jnp.int32(300))
        with torch.no_grad():
            got = module(torch.from_numpy(nchw(x)), 300)
    else:
        from diffusion_image_editing_tpu.models import VQModel as JVQModel

        assert module.config == TM.TINY_VQVAE and '"vq_embed_dim": 3' in names
        x = np.random.default_rng(1).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
        want = JVQModel(jcfg).apply(jparams, jnp.asarray(x))
        with torch.no_grad():
            got = module(torch.from_numpy(nchw(x)))
    np.testing.assert_allclose(got.numpy(), nchw(want), **FWD)


def test_loaders_need_cuda_unless_asked(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.load_checkpoint_dir(os.path.join(dirs["ddpm"], "unet"), "unet2d")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.load_checkpoint_dir(os.path.join(dirs["ldm"], "vqvae"), "vq")
    for name in ("ddpm", "ldm"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_diffusion_model(name, checkpoint_dir=dirs[name])


# ---------------------------------------------------------------------------
# The factory and generation
# ---------------------------------------------------------------------------


def _pair(dirs, family, clip):
    jw = j_create(family, sample_clipping=clip, checkpoint_dir=dirs[family],
                  num_inference_steps=STEPS, dtype=jnp.float32)
    tw = create_diffusion_model(family, sample_clipping=clip, checkpoint_dir=dirs[family],
                                num_inference_steps=STEPS, dtype=torch.float32, device="cpu")
    return jw, tw


@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_factory_builds_the_family_from_a_directory(dirs, family):
    _, tw = _pair(dirs, family, True)
    assert isinstance(tw, DDPM if family == "ddpm" else LDM) and not isinstance(tw, SD)
    assert tw.family == family and tw.schedule.clip_sample
    assert tw.prep_text("ignored") is None and tw.latent_shape(2) == (2, 3, 16, 16)
    assert not tw.unet.training and not any(p.requires_grad for p in tw.unet.parameters())
    if family == "ldm":
        assert isinstance(tw.vqvae, TM.VQModel) and not tw.vqvae.training
    bf = create_diffusion_model(family, checkpoint_dir=dirs[family], device="cpu")
    assert bf.unet.conv_in.weight.dtype == torch.bfloat16  # the port's compute dtype
    assert not create_diffusion_model(family, sample_clipping=False, checkpoint_dir=dirs[family],
                                      device="cpu").schedule.clip_sample


@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_factory_random_weights_warn(monkeypatch, capsys, family):
    monkeypatch.setattr(factory, "DDPM_CELEBAHQ_256", TM.TINY_UNET2D)
    monkeypatch.setattr(factory, "LDM_CELEBAHQ_256_UNET", TM.TINY_UNET2D)
    monkeypatch.setattr(factory, "LDM_CELEBAHQ_VQVAE", TM.TINY_VQVAE)
    a = create_diffusion_model(family, device="cpu", dtype=torch.float32)
    b = create_diffusion_model(family, device="cpu", dtype=torch.float32)
    assert "random-init" in capsys.readouterr().err
    assert torch.equal(a.unet.conv_in.weight, b.unet.conv_in.weight)  # seeded
    if family == "ldm":
        assert torch.equal(a.vqvae.quantize.embedding.weight, b.vqvae.quantize.embedding.weight)


@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_generation_matches_jax(dirs, family, clip):
    """3 steps of 4 (the wrapper's schedule cut by `num_inference_steps`),
    with and without pred-x0 clipping; the clipped and unclipped images
    differ (the clip is honoured)."""
    jw, tw = _pair(dirs, family, clip)
    xt = 1.5 * np.random.default_rng(2).standard_normal((1, 16, 16, 3)).astype(np.float32)
    jimg, jtraj = jw.generate_image(jnp.asarray(xt), num_inference_steps=3, collect=True)
    timg, ttraj = tw.generate_image(torch.from_numpy(nchw(xt)), num_inference_steps=3,
                                    collect=True)
    np.testing.assert_allclose(ttraj.x0.numpy(), nchw(jtraj.x0), **TRAJ)
    np.testing.assert_allclose(ttraj.pred_original_samples.numpy(),
                               nchw5(jtraj.pred_original_samples), **TRAJ)
    np.testing.assert_allclose(timg.numpy(), nchw(jimg), **TRAJ)
    size = 16 if family == "ddpm" else 32
    assert tuple(timg.shape) == (1, 3, size, size)
    pred = ttraj.pred_original_samples
    assert (pred.abs().max().item() <= 1.0) == clip
    _, other = _pair(dirs, family, not clip)
    oimg, _ = other.generate_image(torch.from_numpy(nchw(xt)), num_inference_steps=3)
    assert (oimg - timg).abs().max().item() > 1e-3


def test_generate_images_draws_from_its_seed(dirs):
    _, tw = _pair(dirs, "ddpm", True)
    a, _, xt, zs = tw.generate_images(num_images=2, num_inference_steps=2, seed=3, eta=1.0)
    b, *_ = tw.generate_images(num_images=2, num_inference_steps=2, seed=3, eta=1.0)
    assert torch.equal(a, b) and tuple(xt.shape) == (2, 3, 16, 16) and zs.shape[0] == 2


# ---------------------------------------------------------------------------
# Real-image editing with classifier guidance
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def clf():
    """Both packages' anyGAN ResNet-50 (width 8) on a decoded image, as
    bench.py's `clf_logits`: (JAX params, JAX fn, port fn)."""
    jr, variables = resnet50_variables(8)
    tr = TM.ResNet50(width=8, device="cpu").eval().requires_grad_(False)
    tr.load_state_dict(TM.state_dict_from_jax(variables, "resnet50"))

    def j_fn(p, img):
        return jr.apply(p, JR.imagenet_normalize(JR.to_unit_range(img.astype(jnp.float32))),
                        train=False)

    def t_fn(img):
        return tr(TR.imagenet_normalize(TR.to_unit_range(img.float())))

    return variables, j_fn, t_fn


def _image(family, seed=5):
    size = 16 if family == "ddpm" else 32
    return np.random.default_rng(seed).uniform(-1, 1, (1, size, size, 3)).astype(np.float32)


def _prepare(dirs, family, method, mode=None):
    jw, tw = _pair(dirs, family, False)
    img = _image(family)
    key = jax.random.PRNGKey(6)
    eta = 1.0 if method == "ddpm" else 0.0
    t_skip = T_SKIP if method == "ddpm" else None
    jout = JEditPipeline(jw).prepare_real_image_edit(
        jnp.asarray(img), eta=eta, inversion_method=method, key=key, mode=mode, t_skip=t_skip)
    noise = None
    if method == "ddpm":  # the trajectory noise JAX's sample_xts draws from the key
        noise = torch.from_numpy(nchw5(jax.random.normal(key, (STEPS, 1, 16, 16, 3))))
    tout = EditPipeline(tw).prepare_real_image_edit(
        torch.from_numpy(nchw(img)), eta=eta, inversion_method=method, noise=noise, mode=mode,
        t_skip=t_skip)
    return (jw, tw), jout, tout


@pytest.mark.parametrize("method,mode", [("ddim", None), ("ddpm", "split"), ("ddpm", "batched")])
@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_prepare_real_image_edit_matches_jax(dirs, family, method, mode):
    """The encode (identity or VQ) and the inversion; no mask, so no alpha
    channel for these 3-channel latents."""
    _, (jxt, jzs, jxts, jmask, _), (txt, tzs, txts, tmask, _) = _prepare(
        dirs, family, method, mode)
    assert jmask is None and tmask is None
    np.testing.assert_allclose(txt.numpy(), nchw(jxt), **TRAJ)
    if method == "ddpm":
        np.testing.assert_allclose(tzs.numpy(), nchw5(jzs), **TRAJ)
        np.testing.assert_allclose(txts.numpy(), nchw5(jxts), **TRAJ)
    else:
        assert tzs is None and txts is None


def test_prepare_masks_without_alpha_for_3_channel_latents(dirs):
    """A class mask on a DDPM wrapper keeps its 3 channels, as JAX's: SD's
    alpha channel is SD's alone."""
    jw, tw = _pair(dirs, "ddpm", False)
    parsing = np.zeros((32, 32), np.int32)
    parsing[:16] = 17
    img = _image("ddpm")
    jmask = JEditPipeline(jw, segmentation_fn=lambda x: jnp.asarray(parsing)).\
        prepare_real_image_edit(jnp.asarray(img), classes=[17])[3]
    pipe = EditPipeline(tw, segmentation_fn=lambda x: torch.from_numpy(parsing))
    xt, _, _, mask, _ = pipe.prepare_real_image_edit(torch.from_numpy(nchw(img)), classes=[17])
    assert tuple(mask.shape) == (1, 3, 16, 16) and 0 < mask.mean().item() < 1
    np.testing.assert_array_equal(mask.numpy(), nchw(jmask))
    assert tuple(xt.shape) == (1, 3, 16, 16)


@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_real_image_edit_refuses_a_clipping_schedule(dirs, family):
    """JAX asserts clip_sample is off for a real-image edit of DDPM or LDM;
    the port raises ValueError, before the inversion."""
    jw, tw = _pair(dirs, family, True)
    img = _image(family)
    with pytest.raises(AssertionError, match="clip_sample=False"):
        JEditPipeline(jw).prepare_real_image_edit(jnp.asarray(img))
    with pytest.raises(ValueError, match="clip_sample=False"):
        EditPipeline(tw).prepare_real_image_edit(torch.from_numpy(nchw(img)))


@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_classifier_guided_edit_matches_jax(dirs, clf, family):
    """DDPM inversion (batched, t_skip 1), then 3 ClassifierAttrFunc-guided
    steps: each nudge's gradient runs through the family's decode (the
    identity, or the VQ decode's straight-through estimator) and the
    ResNet-50; the guided image differs from the unguided one."""
    variables, j_fn, t_fn = clf
    (jw, tw), (jxt, jzs, jxts, _, _), (txt, tzs, txts, _, _) = _prepare(
        dirs, family, "ddpm", "batched")
    jattr = JClassifierAttrFunc(clf_params=variables, clf_apply_fn=j_fn, **GUIDE)
    jout = JEditPipeline(jw).edit_image(jxt, eta=1.0, zs=jzs, xts=jxts, attr_func=jattr,
                                        inversion_method="ddpm", t_skip=T_SKIP, mode="split")
    runs = {}
    for name, t1 in (("guided", 0), ("unguided", STEPS)):
        attr = ClassifierAttrFunc(clf_apply_fn=t_fn, **dict(GUIDE, t1=t1))
        runs[name] = EditPipeline(tw).edit_image(txt, eta=1.0, zs=tzs, xts=txts, attr_func=attr,
                                                 inversion_method="ddpm", t_skip=T_SKIP)
    tout = runs["guided"]
    assert tout.model_outputs.shape[0] == STEPS - T_SKIP
    np.testing.assert_allclose(tout.pred_original_samples.numpy(),
                               nchw5(jout.pred_original_samples), **EDIT)
    np.testing.assert_allclose(tout.imgs.numpy(), nchw(jout.imgs), **EDIT)
    assert torch.isfinite(tout.imgs).all()
    assert (tout.imgs - runs["unguided"].imgs).abs().max().item() > 1e-3


def test_ldm_decode_closure_quantizes_with_a_straight_through_gradient(dirs):
    """LDM's guidance decode is the VQ decode at scale 1.0: its gradient to
    the latent is the post-quantization decoder's, as JAX's DecodeClosure."""
    jw, tw = _pair(dirs, "ldm", False)
    rng = np.random.default_rng(9)
    z = rng.standard_normal((1, 16, 16, 3)).astype(np.float32)
    w = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    jdec = jw.decode_fn()
    assert isinstance(jdec, JDecodeClosure) and float(jdec.scale) == 1.0
    ref = jax.grad(lambda z_: jnp.sum(jdec(z_) * w))(jnp.asarray(z))
    zt = torch.from_numpy(nchw(z)).requires_grad_(True)
    (grad,) = torch.autograd.grad((tw.decode_fn()(zt) * torch.from_numpy(nchw(w))).sum(), zt)
    np.testing.assert_allclose(grad.numpy(), nchw(ref), rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("clip", [[], ["--no-sample-clipping"]], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("family", ["ddpm", "ldm"])
def test_cli_generate(dirs, tmp_path, family, clip):
    """`generate --family ddpm|ldm` writes the wrapper's image; clipping is
    on unless `--no-sample-clipping`, as the JAX CLI's default."""
    from diffusion_image_editing_tpu_torch.host.transforms import tensors_to_pils

    prefix = str(tmp_path / "g")
    assert cli.main(["generate", "--device", "cpu", "--family", family, "--checkpoint-dir",
                     dirs[family], "--steps", "2", "--out-prefix", prefix] + clip) == 0
    w = create_diffusion_model(family, sample_clipping=not clip, checkpoint_dir=dirs[family],
                               num_inference_steps=2, device="cpu")
    imgs, *_ = w.generate_images(num_inference_steps=2, seed=0)
    got = np.asarray(Image.open(f"{prefix}_0.png"))
    assert got.shape == ((16, 16, 3) if family == "ddpm" else (32, 32, 3))
    np.testing.assert_array_equal(got, np.asarray(tensors_to_pils(imgs)[0]))


@pytest.mark.parametrize("family,extra", [
    ("ddpm", ["--inversion-method", "ddpm", "--eta", "1", "--t-skip", "1"]),
    ("ldm", ["--inversion-method", "ddim", "--edit-mode", "fused"])])
def test_cli_edit(dirs, tmp_path, family, extra):
    """`edit --family ddpm|ldm`: a real-image edit at the codec's size."""
    out = tmp_path / "e.png"
    args = ["edit", "--device", "cpu", "--family", family, "--checkpoint-dir", dirs[family],
            "--image", os.path.join(dirs["ddpm"], "face.png"), "--steps", "3", "--attr-func",
            "SingleColorAttrFunc", "--t2", "3", "--out", str(out)]
    assert cli.main(args + extra) == 0
    with Image.open(out) as im:
        assert im.size == ((16, 16) if family == "ddpm" else (32, 32))
