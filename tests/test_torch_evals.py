"""The port's `evals/metrics.py` against the JAX package's on the same
inputs: MSE and PSNR, the anyGAN attribute predictions, consistency and
score deltas, the round-trip metrics (with LPIPS), and
`run_attribute_evaluation` on a TINY DDPM in both of its flows. The
generated images are handed to both packages by a test double of
`generate_images` (the two draw their noise differently), and the
edit-friendly inversion takes the JAX package's trajectory noise. The
predictor is one small function written for both (channel means and mean
squares through a seeded projection), with margins checked to keep the
argmax off ties.

Tolerances, f32: metrics rtol 1e-5, atol 1e-6 (LPIPS rtol 1e-4); the
score deltas after a 4-step guided edit atol 1e-4; the consistency
percentages exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.evals import lpips as JL
from diffusion_image_editing_tpu.evals import metrics as JM
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu.pipeline.factory import create_diffusion_model as j_create
from diffusion_image_editing_tpu_torch.evals import LPIPS, make_lpips_fn
from diffusion_image_editing_tpu_torch.evals import metrics as TMet
from diffusion_image_editing_tpu_torch.guidance import SingleColorAttrFunc
from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
from diffusion_image_editing_tpu_torch.pipeline import EditPipeline, create_diffusion_model
from diffusion_image_editing_tpu_torch.utils.constants import ANY_GAN_ATTRS
from tests.torch_port_helpers import jax_params, nchw, write_tiny_ddpm_dir

MET = dict(rtol=1e-5, atol=1e-6)
DELTA = dict(rtol=0, atol=1e-4)
STEPS, N = 4, 3
PROJ = np.random.default_rng(11).standard_normal((6, 80)).astype(np.float32) * 4


def j_predict(imgs):
    feats = jnp.concatenate([jnp.mean(imgs, axis=(1, 2)), jnp.mean(imgs**2, axis=(1, 2))], -1)
    return feats @ jnp.asarray(PROJ)


def t_predict(imgs):
    feats = torch.cat([imgs.mean(dim=(2, 3)), (imgs**2).mean(dim=(2, 3))], -1)
    return feats @ torch.from_numpy(PROJ)


def _imgs(n=N, size=16, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, 3)).astype(np.float32)


def _margin(imgs):
    logits = np.asarray(j_predict(jnp.asarray(imgs))).reshape(-1, 40, 2)
    return np.abs(logits[..., 0] - logits[..., 1]).min()


def test_mse_and_psnr_match_jax():
    a, b = _imgs(seed=1), _imgs(seed=2)
    for fn in ("mse", "psnr"):
        np.testing.assert_allclose(getattr(TMet, fn)(torch.from_numpy(nchw(a)),
                                                     torch.from_numpy(nchw(b))).numpy(),
                                   np.asarray(getattr(JM, fn)(a, b)), **MET)
    same = TMet.psnr(torch.from_numpy(nchw(a)), torch.from_numpy(nchw(a)))
    assert (same > 100).all()  # the 1e-12 floor, as JAX


def test_attribute_metrics_match_jax():
    a, b = _imgs(seed=3), _imgs(seed=4) * 0.5
    assert min(_margin(a), _margin(b)) > 1e-4  # far above the logits' f32 differences
    ta, tb = torch.from_numpy(nchw(a)), torch.from_numpy(nchw(b))
    pred = TMet.predict_attributes(t_predict, ta)
    assert pred.shape == (N, 40, 2)
    np.testing.assert_allclose(pred.numpy(), np.asarray(JM.predict_attributes(j_predict, a)),
                               **MET)
    for skip in (None, [0, 20, 39]):
        got = TMet.attribute_consistency(ta, tb, t_predict, skip)
        assert got == JM.attribute_consistency(a, b, j_predict, skip)
        assert len(got) == 40 - len(skip or []) and all(0 <= v <= 100 for v in got.values())
    got = TMet.avg_increase_decrease_per_attribute(ta, tb, t_predict)
    ref = JM.avg_increase_decrease_per_attribute(a, b, j_predict)
    assert [g[:2] for g in got] == [r[:2] for r in ref]
    np.testing.assert_allclose([g[2] for g in got], [r[2] for r in ref], **MET)
    assert [g[2] for g in got] == sorted((g[2] for g in got), reverse=True)
    assert {g[1] for g in got} == set(ANY_GAN_ATTRS)


def test_inversion_roundtrip_metrics_match_jax():
    x0, recon = _imgs(seed=5), _imgs(seed=5) + 0.01 * _imgs(seed=6)
    jm = JL.LPIPS(width_mult=0.125)
    params = jax_params(jm, 2, jnp.asarray(x0), jnp.asarray(x0))
    tl = LPIPS(0.125, device="cpu")
    tl.load_state_dict(state_dict_from_jax(params, "lpips"))
    ref = JM.inversion_roundtrip_metrics(jnp.asarray(x0), jnp.asarray(recon),
                                         JL.make_lpips_fn(params, width_mult=0.125))
    got = TMet.inversion_roundtrip_metrics(torch.from_numpy(nchw(x0)),
                                           torch.from_numpy(nchw(recon)), make_lpips_fn(tl))
    assert set(got) == {"psnr", "mse", "lpips"} and all(isinstance(v, float) for v in got.values())
    np.testing.assert_allclose(got["psnr"], ref["psnr"], **MET)
    np.testing.assert_allclose(got["mse"], ref["mse"], **MET)
    np.testing.assert_allclose(got["lpips"], ref["lpips"], rtol=1e-4, atol=1e-7)
    assert set(TMet.inversion_roundtrip_metrics(torch.from_numpy(nchw(x0)),
                                                torch.from_numpy(nchw(recon)))) == {"psnr", "mse"}


@pytest.fixture(scope="module")
def ddpm(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ddpm"))
    write_tiny_ddpm_dir(root)
    jw = j_create("ddpm", sample_clipping=False, checkpoint_dir=root, num_inference_steps=STEPS,
                  dtype=jnp.float32)
    tw = create_diffusion_model("ddpm", sample_clipping=False, checkpoint_dir=root,
                                num_inference_steps=STEPS, dtype=torch.float32, device="cpu")
    return jw, tw


def _generated(eta):
    """(images, x_T, zs) that both packages' `generate_images` hand over."""
    rng = np.random.default_rng(12)
    xt = rng.standard_normal((N, 16, 16, 3)).astype(np.float32)
    zs = rng.standard_normal((STEPS, N, 16, 16, 3)).astype(np.float32) if eta > 0 else None
    return _imgs(seed=13), xt, zs


def nchw5(a):
    return np.ascontiguousarray(np.asarray(a).transpose(0, 1, 4, 2, 3))


@pytest.mark.parametrize("inversion,eta", [(None, 0.0), (None, 1.0), ("ddpm", 1.0)],
                         ids=["noise-maps-eta0", "noise-maps-eta1", "ddpm-inversion"])
def test_run_attribute_evaluation_matches_jax(ddpm, monkeypatch, inversion, eta):
    jw, tw = ddpm
    imgs, xt, zs = _generated(eta)
    monkeypatch.setattr(jw, "generate_images", lambda **kw: (
        jnp.asarray(imgs), None, jnp.asarray(xt), None if zs is None else jnp.asarray(zs)),
        raising=False)
    monkeypatch.setattr(tw, "generate_images", lambda **kw: (
        torch.from_numpy(nchw(imgs)), None, torch.from_numpy(nchw(xt)),
        None if zs is None else torch.from_numpy(nchw5(zs))), raising=False)
    seed, t_skip = 2, 1
    noise = nchw5(jax.random.normal(jax.random.PRNGKey(seed + 1), (STEPS, N, 16, 16, 3)))

    class JaxNoise(EditPipeline):
        """The edit-friendly inversion's trajectory noise as JAX draws it."""

        def prepare_real_image_edit(self, img, **kw):
            assert kw.pop("generator").initial_seed() == seed + 1
            return super().prepare_real_image_edit(img, noise=torch.from_numpy(noise), **kw)

    color = dict(target=0.9, color_idx=0, loss_scale=20.0, t1=0, t2=STEPS)
    kw = dict(n_samples=N, num_inference_steps=STEPS, eta=eta, seed=seed, inversion=inversion,
              t_skip=t_skip, skip_idx=[5])
    ref = JM.run_attribute_evaluation(jw, JEditPipeline(jw), j_predict, JSingleColor(**color),
                                      **kw)
    got = TMet.run_attribute_evaluation(tw, JaxNoise(tw), t_predict,
                                        SingleColorAttrFunc(**color), **kw)
    assert got["attribute_consistency"] == ref["attribute_consistency"]
    assert len(got["attribute_consistency"]) == 39
    gd = {i: d for i, _, d in got["score_deltas"]}
    rd = {i: d for i, _, d in ref["score_deltas"]}
    np.testing.assert_allclose([gd[i] for i in range(40)], [rd[i] for i in range(40)], **DELTA)
    assert any(abs(d) > 1e-3 for d in gd.values())  # the guidance moved the scores


def test_run_attribute_evaluation_checks_its_options(ddpm):
    _, tw = ddpm
    attr = SingleColorAttrFunc(t2=STEPS)
    with pytest.raises(ValueError, match="eta > 0"):
        TMet.run_attribute_evaluation(tw, EditPipeline(tw), t_predict, attr, n_samples=1,
                                      num_inference_steps=2, inversion="ddpm")
    with pytest.raises(ValueError, match="Unknown inversion"):
        TMet.run_attribute_evaluation(tw, EditPipeline(tw), t_predict, attr, n_samples=1,
                                      num_inference_steps=2, inversion="ddim")
