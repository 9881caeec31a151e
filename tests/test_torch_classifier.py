"""Classifier guidance, the port against the JAX package, same weights and
inputs (numpy, seeded), f32 on both sides, NCHW against NHWC: the anyGAN
ResNet-50 (width 8) in eval mode, `ClassifierAttrFunc`'s loss and one
nudge through the identity codec (DDPM) at batch 2, with and without the
quadratic regulariser, the registry's two names, and the `.pth` loader
and `get_pretrained_anygan` against the JAX loader reading the same file.

Tolerances: logits and losses max |port - jax| / max |jax| <= 1e-5
(convolutions summed in another order; observed about 1e-6); one nudge
rtol 1e-4, atol 5e-5, as the other guidance nudges
(tests/test_torch_segguide.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.engine.denoise import DecodeClosure as JDecodeClosure
from diffusion_image_editing_tpu.guidance import ClassifierAttrFunc as JClassifierAttrFunc
from diffusion_image_editing_tpu.ops import resize as JR
from diffusion_image_editing_tpu.pipeline import factory as JF
from diffusion_image_editing_tpu_torch import models as TM
from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.engine.denoise import DecodeClosure
from diffusion_image_editing_tpu_torch.guidance import (
    AnyGANAttrFunc, ClassifierAttrFunc, create_attr_func_registry)
from diffusion_image_editing_tpu_torch.ops import resize as TR
from diffusion_image_editing_tpu_torch.pipeline import get_pretrained_anygan
from tests.torch_port_helpers import nchw, resnet50_variables, write_anygan_checkpoint

EVAL_TOL = 1e-5
NUDGE = dict(rtol=1e-4, atol=5e-5)
WIDTH, SIZE = 8, 32
GUIDE = dict(loss_scale=50.0, t1=0, t2=4, idx_for_class=20, idx_of_interest=1)
REGULARIZED = dict(GUIDE, regularize_idx=31, regularize_pred_idx=0,
                   regularize_score=(0.5, -0.25))


def _rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def clf_pair():
    jr, variables = resnet50_variables(WIDTH)
    tr = TM.ResNet50(width=WIDTH, device="cpu").eval()
    tr.load_state_dict(TM.state_dict_from_jax(variables, "resnet50"))
    return jr, variables, tr


def clf_fns(clf_pair):
    """Both packages' decoded image -> logits, as bench.py's `clf_logits`."""
    jr, variables, tr = clf_pair

    def j_fn(p, img):
        return jr.apply(p, JR.imagenet_normalize(JR.to_unit_range(img.astype(jnp.float32))),
                        train=False)

    def t_fn(img):
        return tr(TR.imagenet_normalize(TR.to_unit_range(img.float())))

    return j_fn, t_fn


@pytest.mark.parametrize("size", [32, 64])
def test_resnet50_logits_match_jax(clf_pair, size):
    jr, variables, tr = clf_pair
    x = np.random.default_rng(size).standard_normal((2, size, size, 3)).astype(np.float32)
    want = jax.jit(lambda v, x_: jr.apply(v, x_, train=False))(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tr(torch.from_numpy(nchw(x)))
    assert tuple(got.shape) == (2, 80) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= EVAL_TOL


def test_resnet50_carries_torchvision_keys(clf_pair):
    """320 tensors (53 norms with their 5 entries each, 53 convs, fc), and
    the JAX variables round-trip through the torchvision state dict."""
    from diffusion_image_editing_tpu.models.port import port_torchvision_state_dict

    _, variables, tr = clf_pair
    state = tr.state_dict()
    assert len(state) == 320
    assert {"conv1.weight", "bn1.running_var", "layer1.0.downsample.0.weight",
            "layer1.0.downsample.1.num_batches_tracked", "layer4.2.conv3.weight",
            "fc.weight", "fc.bias"} <= set(state)
    back = port_torchvision_state_dict({k: v.numpy() for k, v in state.items()})
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    again = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(leaves) == len(again)
    for path, value in leaves:
        np.testing.assert_array_equal(np.asarray(again[path]), np.asarray(value))


@pytest.mark.parametrize("kw", [GUIDE, REGULARIZED], ids=["plain", "regularized"])
def test_classifier_loss_matches_jax(clf_pair, kw):
    j_fn, t_fn = clf_fns(clf_pair)
    img = np.random.default_rng(5).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    want = JClassifierAttrFunc(clf_params=clf_pair[1], clf_apply_fn=j_fn, **kw).loss(
        jnp.asarray(img))
    with torch.no_grad():
        got = ClassifierAttrFunc(clf_apply_fn=t_fn, **kw).loss(torch.from_numpy(nchw(img)))
    assert got.dim() == 0
    assert abs(float(got) - float(want)) <= EVAL_TOL * max(1.0, abs(float(want)))


@pytest.mark.parametrize("kw", [GUIDE, REGULARIZED], ids=["plain", "regularized"])
def test_classifier_nudge_at_batch_2_matches_jax(clf_pair, kw):
    """`apply_batched` through the identity codec (DDPM's pixel space), one
    image at a time: each image's logit gets its own gradient."""
    j_fn, t_fn = clf_fns(clf_pair)
    js = j_schedule("ddpm", 4, clip_sample=False)
    ts = schedule_for_model("ddpm", 4, clip_sample=False)
    rng = np.random.default_rng(6)
    x, eps = (rng.standard_normal((2, SIZE, SIZE, 3)).astype(np.float32) for _ in range(2))
    idx = 1
    t = int(js.timesteps[idx])
    jx, _ = JClassifierAttrFunc(clf_params=clf_pair[1], clf_apply_fn=j_fn, **kw).apply_batched(
        jnp.asarray(x), None, jnp.asarray(eps), jnp.int32(t), jnp.int32(idx), js,
        JDecodeClosure())
    tx, _ = ClassifierAttrFunc(clf_apply_fn=t_fn, **kw).apply_batched(
        torch.from_numpy(nchw(x)), None, torch.from_numpy(nchw(eps)), t, idx, ts,
        DecodeClosure())
    np.testing.assert_allclose(tx.numpy(), nchw(jx), **NUDGE)
    moved = np.abs(nchw(jx) - nchw(x)).max(axis=(1, 2, 3))
    assert (moved > 1e-3).all()  # both images moved, each by its own gradient


def test_registry_has_both_names():
    reg = create_attr_func_registry()
    assert reg.get_attribute_functions() == ["SingleColorAttrFunc", "MultiColorAttrFunc",
                                             "NetAttrFunc", "ClassifierAttrFunc",
                                             "AnyGANAttrFunc"]
    af = reg.get("ClassifierAttrFunc", {"idx_for_class": 20, "idx_of_interest": 1})
    assert isinstance(af, ClassifierAttrFunc) and (af.idx_for_class, af.idx_of_interest) == (20, 1)
    assert AnyGANAttrFunc is ClassifierAttrFunc
    assert isinstance(reg.get("AnyGANAttrFunc"), ClassifierAttrFunc)
    with pytest.raises(ValueError, match="clf_apply_fn"):
        af.loss(torch.zeros(1, 3, 8, 8))


@pytest.mark.parametrize("nested", [True, False], ids=["state_dict", "flat"])
def test_anygan_checkpoint_loads_as_the_jax_loader_reads_it(tmp_path, nested):
    path = str(tmp_path / "anygan.pth")
    write_anygan_checkpoint(path, width=WIDTH, nested=nested)
    j_apply, j_vars = JF.get_pretrained_anygan(path, width=WIDTH)
    module = TM.load_anygan_checkpoint(path, device="cpu")
    apply_fn, same = get_pretrained_anygan(path, width=WIDTH, device="cpu")
    assert not module.training and not same.training and same.width == WIDTH
    x = np.random.default_rng(7).standard_normal((2, SIZE, SIZE, 3)).astype(np.float32)
    want = j_apply(j_vars, jnp.asarray(x))
    with torch.no_grad():
        got = apply_fn(torch.from_numpy(nchw(x)))
        assert torch.equal(module(torch.from_numpy(nchw(x))), got)
    assert _rel(got.numpy(), want) <= EVAL_TOL


def test_get_pretrained_anygan_random_weights_and_device(tmp_path, monkeypatch, capsys):
    _, a = get_pretrained_anygan(width=WIDTH, device="cpu")
    _, b = get_pretrained_anygan(width=WIDTH, device="cpu")
    assert "random-init" in capsys.readouterr().err
    assert torch.equal(a.fc.weight, b.fc.weight) and not a.training  # seeded, eval
    assert not any(p.requires_grad for p in a.parameters())
    path = str(tmp_path / "anygan.pth")
    write_anygan_checkpoint(path, width=WIDTH)
    with pytest.raises(ValueError, match="width 8"):
        get_pretrained_anygan(path, width=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_pretrained_anygan(path, width=WIDTH)
