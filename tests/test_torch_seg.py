"""The port's segmentation trainer against the JAX package's: losses,
schedule and parameter groups, three training steps, the feed, the
checkpoints, the data stream, the CLI, and that the trainer imports
without PIL.

Tolerances, f32 on both sides:
* losses and their gradients: rtol 1e-5, atol 1e-6 (log-sum-exp and sums
  in another order). The OHEM pivot is value-exact on both sides, so the
  branch taken and the elements that carry gradient are the same;
* three training steps: 64 px, batch 4, width 8, learning rate 1e-2 for abn
  and 1e-3 for bn (constant over the three steps: warmup starts at lr0).
  Losses rtol 1e-4. Weights: max |port - jax| within 2e-2 of the largest
  update max |jax - start| (the updates are 1e-4 to 1e-2 of weights of
  order 1, so f32 rounding of the weights alone is about 1e-3 of an
  update; batch norm over 4 values at the 1x1 norms amplifies the rest).
  Running statistics rtol 1e-3, atol 1e-5.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.seg import data as JD
from diffusion_image_editing_tpu.seg import losses as JL
from diffusion_image_editing_tpu.seg import optim as JO
from diffusion_image_editing_tpu.seg import train as JT
from diffusion_image_editing_tpu_torch import cli
from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
from diffusion_image_editing_tpu_torch.seg import data as TD
from diffusion_image_editing_tpu_torch.seg import losses as TL
from diffusion_image_editing_tpu_torch.seg import optim as TO
from diffusion_image_editing_tpu_torch.seg import train as TT

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def _logits_labels(seed, shape=(2, 12, 10, 7), scale=3.0, ignore=True):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal(shape)).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:3]).astype(np.int32)
    if ignore:
        labels[0, :2] = 255
    return logits, labels


def _torch_pair(logits, labels):
    x = torch.tensor(np.ascontiguousarray(logits.transpose(0, 3, 1, 2)), requires_grad=True)
    return x, torch.tensor(labels)


def _check_loss(jfn, tfn, logits, labels, **kw):
    jval, jgrad = jax.value_and_grad(lambda l: jfn(l, jnp.asarray(labels), **kw))(
        jnp.asarray(logits))
    x, y = _torch_pair(logits, labels)
    val = tfn(x, y, **kw)
    (grad,) = torch.autograd.grad(val, x)
    np.testing.assert_allclose(float(val.detach()), float(jval), **LOSS_TOL)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad).transpose(0, 3, 1, 2), **LOSS_TOL)
    return float(val.detach())


@pytest.mark.parametrize(
    "scale,n_min,thresh",
    [(3.0, 16, 0.7), (0.2, 16, 0.7), (3.0, 2000, 0.7), (0.2, 200, 0.05)],
    ids=["thresh-branch", "topk-branch", "n_min-clipped", "topk-few-above"],
)
def test_ohem_matches_jax(scale, n_min, thresh):
    logits, labels = _logits_labels(0, scale=scale)
    _check_loss(JL.ohem_ce_loss, TL.ohem_ce_loss, logits, labels, n_min=n_min, thresh=thresh)


def test_ohem_with_ties_matches_jax():
    """Equal losses straddle the pivot: value and gradient as JAX's (tied
    elements at the pivot get no gradient on either side)."""
    logits, labels = _logits_labels(1, scale=0.1, ignore=False)
    logits[:, :6] = logits[0, 0, 0]
    labels[:, :6] = labels[0, 0, 0]
    _check_loss(JL.ohem_ce_loss, TL.ohem_ce_loss, logits, labels, n_min=50, thresh=0.05)


def test_kth_largest_matches_sort():
    """The OHEM pivot's bit search gives the sorted value, ties and zeros
    included, as the JAX package's does."""
    rng = np.random.default_rng(3)
    flat = np.abs(rng.standard_normal(5000)).astype(np.float32)
    flat[::5] = 0.0
    flat[1::7] = flat[1]
    want = -np.sort(-flat)
    for k in (1, 2, 17, 800, 2500, 4999, 5000):
        got = TL._kth_largest_nonneg(torch.tensor(flat), k)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == want[k - 1] == float(JL._kth_largest_nonneg(jnp.asarray(flat), k))


def test_focal_and_ce_match_jax():
    logits, labels = _logits_labels(2)
    _check_loss(JL.softmax_focal_loss, TL.softmax_focal_loss, logits, labels)
    _check_loss(JL.softmax_focal_loss, TL.softmax_focal_loss, logits, labels, gamma=0.5)
    _check_loss(JL.cross_entropy_loss, TL.cross_entropy_loss, logits, labels)


def test_schedule_matches_jax():
    jsched = JO.warmup_poly_schedule()
    tsched = TO.warmup_poly_schedule()
    for step in (0, 1, 10, 500, 999, 1000, 1001, 5000, 79999, 80000, 90000):
        np.testing.assert_allclose(tsched(step), float(jsched(step)), rtol=1e-6)


def test_parameter_groups_match_jax():
    from diffusion_image_editing_tpu.models.bisenet import BiSeNet as JBiSeNet

    tm = TT.create_model(TT.TrainConfig(n_classes=5, width=4, norm="abn"), device="cpu")
    shapes = jax.eval_shape(JBiSeNet(n_classes=5, norm="abn", width=4).init,
                            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    labels = JO.param_group_labels(shapes["params"])
    # Each JAX parameter as an array filled with its group's index, carried
    # to the port's names by the converter.
    coded = jax.tree_util.tree_map(
        lambda s, lab: np.full(s.shape, TO.GROUPS.index(lab), np.float32),
        shapes["params"], labels)
    want = {k: TO.GROUPS[int(v.flatten()[0])]
            for k, v in state_dict_from_jax({"params": coded}, "bisenet").items()}
    got = {name: TO.param_group_label(name, p) for name, p in tm.named_parameters()}
    assert got == want
    groups = TO.param_groups(tm)
    assert all(n.split(".")[0] in ("ffm", "conv_out", "conv_out16", "conv_out32")
               for g in ("wd_mul", "nowd_mul") for n in groups[g])
    opt = TO.make_optimizer(tm)
    assert [g["label"] for g in opt.param_groups] == list(TO.GROUPS)
    assert [g["weight_decay"] for g in opt.param_groups] == [5e-4, 0.0, 5e-4, 0.0]
    assert [g["lr_mul"] for g in opt.param_groups] == [1.0, 1.0, 10.0, 10.0]


def _tiny_cfg(norm, lr, **kw):
    return dict(n_classes=5, image_size=64, batch_size_per_device=4, width=8, norm=norm,
                lr0=lr, warmup_start_lr=lr, **kw)


def _fill(path, leaf, rng):
    name = path[-1].key
    shape = np.shape(leaf)
    if name == "kernel":
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if name in ("scale", "weight"):
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name == "var":
        return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def _batches(seed, n, size=64, batch=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = rng.standard_normal((batch, size, size, 3)).astype(np.float32)
        lab = rng.integers(0, 5, (batch, size, size)).astype(np.int32)
        lab[0, :3] = 255
        out.append((img, lab))
    return out


@pytest.mark.parametrize("norm,lr", [("abn", 1e-2), ("bn", 1e-3)])
def test_three_train_steps_match_jax(norm, lr):
    kw = _tiny_cfg(norm, lr)
    jcfg, tcfg = JT.TrainConfig(**kw), TT.TrainConfig(**kw)
    # JAX's create_train_state without its eager init (slow for ABN): the
    # variables' shapes only, filled from numpy.
    jmodel = JT.create_model(jcfg)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    rng = np.random.default_rng(1)
    start = jax.tree_util.tree_map_with_path(lambda p, l: _fill(p, l, rng), dict(shapes))
    tx = JO.make_optimizer(start["params"], lr0=lr, warmup_start_lr=lr)
    jstate = JT.TrainState(step=jnp.int32(0), params=start["params"],
                           batch_stats=start["batch_stats"], opt_state=tx.init(start["params"]),
                           tx=tx)
    tmodel, tstate = TT.create_train_state(tcfg, 0, "cpu")
    tmodel.load_state_dict(state_dict_from_jax(start, "bisenet"))
    jstep, tstep = jax.jit(JT.make_train_step(jmodel, jcfg)), TT.make_train_step(tmodel, tcfg)
    for img, lab in _batches(2, 3):
        jstate, jloss = jstep(jstate, jnp.asarray(img), jnp.asarray(lab))
        tstate, tloss = tstep(tstate, img, lab)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-4)
    assert tstate.step == int(jstate.step) == 3
    want = state_dict_from_jax({"params": jstate.params, "batch_stats": jstate.batch_stats},
                               "bisenet")
    w0 = state_dict_from_jax(start, "bisenet")
    got = tmodel.state_dict()
    weights = [k for k in want if not k.startswith(("running", "num")) and
               not k.rsplit(".", 1)[1].startswith(("running", "num"))]
    update = max(float((want[k] - w0[k]).abs().max()) for k in weights)
    err = max(float((got[k] - want[k]).abs().max()) for k in weights)
    assert update > 10 * lr * 1e-2 and err <= 2e-2 * update, (err, update)
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-3, atol=1e-5)


def test_uint8_feed_equals_float_feed():
    ds_raw = TD.SyntheticFaceMask(n=4, size=16, raw=True)
    img, lab = ds_raw[0]
    f_img = ((img.astype(np.float32) / 255.0 - TD.IMAGENET_MEAN) / TD.IMAGENET_STD)[None]
    x_raw, y_raw = TT._prep_batch(img[None], lab[None], torch.device("cpu"))
    x_f, y_f = TT._prep_batch(f_img, lab[None].astype(np.int32), torch.device("cpu"))
    assert x_raw.shape == (1, 3, 16, 16) and x_raw.is_contiguous()
    assert torch.equal(x_raw, x_f) and torch.equal(y_raw, y_f) and y_raw.dtype == torch.int64
    jx, _ = JT._prep_batch(jnp.asarray(img[None]), jnp.asarray(lab[None]))
    np.testing.assert_array_equal(x_raw.numpy(), np.asarray(jx).transpose(0, 3, 1, 2))


def _stream(cfg_kw, seed=0):
    ds = TD.SyntheticFaceMask(n=8, size=cfg_kw["image_size"], raw=True)
    return TD.batch_iterator(ds, cfg_kw["batch_size_per_device"], seed=seed)


def test_checkpoint_resume_is_a_true_resume(tmp_path):
    kw = dict(image_size=32, batch_size_per_device=2, width=4, norm="abn", ckpt_every=2)
    cfg = TT.TrainConfig(**kw)
    _, straight, losses = TT.train_loop(cfg, _stream(kw), num_steps=4, device="cpu")
    it = _stream(kw)
    _, first, l1 = TT.train_loop(cfg, it, ckpt_dir=str(tmp_path), num_steps=2, device="cpu")
    assert first.step == 2 and sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002.pt"]
    model, resumed, l2 = TT.train_loop(cfg, it, ckpt_dir=str(tmp_path), num_steps=4,
                                       device="cpu")
    assert resumed.step == 4 and len(l2) == 2
    assert l1 + l2 == losses
    for (k, a), b in zip(model.state_dict().items(), straight.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert TT.restore_checkpoint(tmp_path, TT.create_train_state(cfg, 1, "cpu")[1]).step == 4
    empty = TT.create_train_state(cfg, 1, "cpu")[1]
    assert TT.restore_checkpoint(tmp_path / "none", empty) is empty and empty.step == 0


@pytest.mark.parametrize("raw", [False, True])
def test_synthetic_stream_matches_jax(raw):
    ds_j = JD.SyntheticFaceMask(n=10, size=8, raw=raw)
    ds_t = TD.SyntheticFaceMask(n=10, size=8, raw=raw)
    for kw in (dict(), dict(num_workers=2), dict(prefetch=2, process_index=1, process_count=2)):
        jit_ = JD.batch_iterator(ds_j, 3, seed=5, **{"process_index": 0, "process_count": 1,
                                                     **kw})
        tit = TD.batch_iterator(ds_t, 3, seed=5, **kw)
        for _ in range(5):
            (ji, jl), (ti, tl) = next(jit_), next(tit)
            assert ji.dtype == ti.dtype and jl.dtype == tl.dtype
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)
        for it in (jit_, tit):
            if hasattr(it, "close"):
                it.close()


def test_cli_seg_train_on_cpu(tmp_path, capsys):
    rc = cli.main(["seg-train", "--device", "cpu", "--image-size", "32", "--batch-size", "2",
                   "--width", "4", "--norm", "abn", "--num-steps", "2", "--prefetch", "0",
                   "--num-workers", "0", "--raw-feed", "--ckpt-dir", str(tmp_path)])
    assert rc == 0
    assert "seg-train: step 2, 2 steps this run" in capsys.readouterr().out
    assert (tmp_path / "step_00000002.pt").exists()
    # norm abn_sync runs: without torchrun it is the single-process trainer,
    # its statistics synced over one rank, so it equals abn to the bit.
    sync_dir = tmp_path / "sync"
    rc = cli.main(["seg-train", "--device", "cpu", "--image-size", "32", "--batch-size", "2",
                   "--width", "4", "--norm", "abn_sync", "--num-steps", "2", "--prefetch", "0",
                   "--num-workers", "0", "--raw-feed", "--ckpt-dir", str(sync_dir)])
    assert rc == 0
    assert "seg-train: step 2, 2 steps this run" in capsys.readouterr().out
    abn = torch.load(tmp_path / "step_00000002.pt", weights_only=True)["model"]
    sync = torch.load(sync_dir / "step_00000002.pt", weights_only=True)["model"]
    assert abn.keys() == sync.keys()
    for k in abn:
        assert torch.equal(abn[k], sync[k]), k


def test_seg_imports_without_pil():
    code = ("import sys; sys.modules['PIL'] = None\n"
            "import diffusion_image_editing_tpu_torch.seg as S, diffusion_image_editing_tpu_torch.cli\n"
            "ds = S.SyntheticFaceMask(n=2, size=8, raw=True)\n"
            "img, lab = next(S.batch_iterator(ds, 2))\n"
            "assert img.shape == (2, 8, 8, 3)\n"
            "try:\n    S.data.color_jitter(None, None)\nexcept ImportError:\n    print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr
