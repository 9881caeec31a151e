"""`AttrFunc.sample_losses` and the path `apply_batched` takes for a
chunk's losses, on the CPU at a tiny size: each built-in loss's row form
against its per-sample `calculate_loss`, the chunked nudge against each
image's own `apply`, one classifier call a chunk where no leaf is swept and
one a sample where one is, and the counters of the two paths.

Tolerances: losses rtol 1e-5 (the same sums, taken over rows instead of
slices); nudges (the state's change) rtol 1e-4, atol 1e-4 of the largest
element, as the other chunked nudges (tests/test_torch_remat.py)."""

import dataclasses

import pytest
import torch

from diffusion_image_editing_tpu_torch.core import schedule_for_model
from diffusion_image_editing_tpu_torch.guidance import (
    AttrFunc, ClassifierAttrFunc, MultiColorAttrFunc, NetAttrFunc, SingleColorAttrFunc)
from diffusion_image_editing_tpu_torch.utils.logging import COUNTERS

B, SIZE = 4, 8
SCHED = schedule_for_model("ddpm", 4, clip_sample=False)
STEP = 1
T = int(SCHED.timesteps[STEP])


def _net(c_out: int, seed: int) -> torch.nn.Module:
    """A tiny conv net from a 3-channel image to `c_out` channels."""
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Conv2d(3, 6, 3, padding=1), torch.nn.Tanh(),
                               torch.nn.Conv2d(6, c_out, 3, padding=1))


SEG = _net(19, 1)
CLF_NET = _net(80, 2)


def seg_fn(img):
    return SEG(img)


def clf_fn(img):
    return CLF_NET(img).mean(dim=(2, 3))  # (B, 80)


def _dist(a, b):
    """A metric_fn: (B,) distances."""
    return (a - b).abs().mean(dim=(1, 2, 3))


@dataclasses.dataclass(frozen=True)
class LossOnly(AttrFunc):
    """A loss with no row form: a red channel's mean."""

    def loss(self, decoded):
        return decoded[:, 0].mean()


MASKED = dict(use_mask=True, mask_pred_original_sample=True, lambda_=0.3)
CASES = {
    "single": SingleColorAttrFunc(target=0.8, color_idx=1, loss_scale=3.0),
    "multi": MultiColorAttrFunc(r_target=0.9, g_target=0.2, b_target=0.4, loss_scale=3.0),
    "net": NetAttrFunc(seg_apply_fn=seg_fn, idx_for_class=(2, 5), loss_scale=5.0),
    "clf": ClassifierAttrFunc(clf_apply_fn=clf_fn, idx_for_class=20, idx_of_interest=1,
                              loss_scale=50.0),
    "clf_regularized": ClassifierAttrFunc(clf_apply_fn=clf_fn, idx_for_class=20,
                                          idx_of_interest=1, regularize_idx=31,
                                          regularize_pred_idx=0,
                                          regularize_score=(0.5, -0.25), loss_scale=50.0),
    "masked_l2": SingleColorAttrFunc(target=0.8, metric="l2", loss_scale=3.0, **MASKED),
    "masked_metric_fn": MultiColorAttrFunc(r_target=0.9, metric_fn=_dist, loss_scale=3.0,
                                           **MASKED),
    "loss_only": LossOnly(loss_scale=3.0),
}


def _inputs(seed: int):
    """Latents, eps, a per-sample mask and a shared x0 (x0 per sample in
    `masked_l2`, to take both kinds)."""
    g = torch.Generator().manual_seed(seed)
    x, eps = (torch.randn(B, 3, SIZE, SIZE, generator=g) for _ in range(2))
    mask = (torch.rand(B, 1, SIZE, SIZE, generator=g) > 0.5).float()
    x0 = torch.rand(B, 3, SIZE, SIZE, generator=g) * 2 - 1
    return x, eps, mask, x0


def _assert_same_nudge(got, want, x):
    scale = float((want - x).abs().max())
    assert scale > 0
    torch.testing.assert_close(got - x, want - x, rtol=1e-4, atol=1e-4 * scale)


def decode(z):
    return torch.tanh(0.7 * z)


def _own(a, i):
    """Sample i's row of a per-sample tensor; a shared one as it is."""
    return a[i:i + 1] if len(a) == B else a


def _mask_x0(case, mask, x0):
    if case == "masked_l2":
        return mask[:1], x0  # a shared mask, x0 per sample
    return mask, x0[:1]  # a mask per sample, a shared x0


@pytest.mark.parametrize("case", sorted(CASES))
def test_sample_losses_are_each_image_s_own_loss_and_the_chunks_nudge_each_alone(case):
    af = CASES[case]
    x, eps, mask, x0 = _inputs(3)
    mask, x0 = _mask_x0(case, mask, x0)
    img = decode(x)
    with torch.no_grad():
        got = af.sample_losses(img, mask, x0)
        want = torch.stack([af.calculate_loss(img[i:i + 1], _own(mask, i), _own(x0, i))
                            for i in range(B)])
    assert got.shape == (B,)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    alone = torch.cat([af.apply(x[i:i + 1], None, eps[i:i + 1], T, STEP, SCHED, decode,
                                mask=_own(mask, i), x0=_own(x0, i))[0] for i in range(B)])
    for chunk in (B, 2):
        out, _ = dataclasses.replace(af, vjp_chunk=chunk).apply_batched(
            x, None, eps, T, STEP, SCHED, decode, mask=mask, x0=x0)
        _assert_same_nudge(out, alone, x)


def test_a_chunk_calls_the_classifier_once_unless_a_leaf_is_swept():
    calls = []

    def counted(img):
        calls.append(img.shape[0])
        return clf_fn(img)

    x, eps, _, _ = _inputs(4)
    af = dataclasses.replace(CASES["clf"], clf_apply_fn=counted, vjp_chunk=B)
    swept = dataclasses.replace(af, loss_scale=torch.full((B,), 50.0))
    outs = {}
    for path, f, want_calls in (("batched", af, [B]), ("looped", swept, [1] * B)):
        calls.clear()
        before = {k: COUNTERS["guidance.loss_samples." + k] for k in ("batched", "looped")}
        outs[path], _ = f.apply_batched(x, None, eps, T, STEP, SCHED, decode)
        assert calls == want_calls
        want_counts = dict.fromkeys(before, 0)
        want_counts[path] = B
        assert {k: COUNTERS["guidance.loss_samples." + k] - v
                for k, v in before.items()} == want_counts
    _assert_same_nudge(outs["looped"], outs["batched"], x)
