"""The opt-in accelerations under the spatial split: `fused_conv=True`
(GroupNorm+SiLU -> conv through K7's halo form, `ops/fused_conv.py`) and
the conv modes (`ops/conv.py`: shift9, int8, int8_large, `int8_bwd`), over
a two-rank gloo world spawned once for the module
(tests/torch_spatial_workers.py's `run_modes_rank`), held against the same
ops run whole and, for a TINY SD edit on sp2, against the JAX package's
`to_mesh` under DIE_TPU_FUSED_CONV=1 and under DIE_TPU_CONV=int8_large
(the fused path runs its `_jnp_fwd` on the CPU). The JAX flags are read
when a program is traced and its jitted programs are cached by module, so
each JAX edit runs in a process of its own, spawned beside the ranks,
with its flags set before it traces anything.

Tolerances, f32:
* each split op and its gradient against the whole op: atol 2e-5 relative
  to the output's scale (tests/test_torch_spatial.py's: the same sums in
  another order; readings up to 5e-7);
* the int8 conv's forward, and its dx under `int8_bwd`, split against
  whole: bit-equal (the s32 sums are exact once the per-tensor scale is
  the max over the ranks);
* the control, the moment fold's backward without the ranks' sum: its
  gradient must miss the op tolerance (it reads about 0.2 against 6e-5)
  while its forward holds it;
* the CFG pair over two ranks under conv mode "int8" against the pair
  whole: the op tolerance; its control, each rank's own int8 scale, must
  miss it;
* the fused edit on the mesh against off it and against JAX's: rtol 2e-4,
  atol 2e-5 (tests/test_torch_spatial.py's PIPE; readings about 1e-5);
* the int8_large edit, relative L2 within 1e-3 (readings about 2e-6): its
  activations differ from the whole run's and from JAX's by f32 rounding,
  and a value at a rounding boundary may move by one quantization step, as
  tests/test_torch_conv.py holds the int8 decode against JAX's;
* every rank's result bit-equal.
"""

import os

import numpy as np
import pytest

from diffusion_image_editing_tpu.ops import conv as JC
from diffusion_image_editing_tpu.ops import fused_conv as JFC
from diffusion_image_editing_tpu.parallel import cfg_mesh as j_cfg_mesh
from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
from tests import torch_spatial_workers as W
from tests.test_torch_spatial import OP_TOL, PIPE, Ranks, _jax_edit, _jax_sd
from tests.torch_port_helpers import tiny_unet_params, tiny_vae_params

INT8_EDIT_REL = 1e-3
OPS = ["fused_block", "fused_one_row", "int8", "int8_bwd", "int8_large", "shift9"]
JAX_ENV = {"fused": {"DIE_TPU_FUSED_CONV": "1"},
           "int8_large": {"DIE_TPU_CONV": "int8_large",
                          "DIE_TPU_INT8_MIN_H": str(W.MODES_MIN_H)}}


@pytest.fixture(scope="module")
def payload():
    """The seeded TINY SD weights (the JAX package's, as state dicts), the
    text embedding and the image; the JAX processes rebuild the same
    weights from their seeds."""
    rng = np.random.default_rng(0)
    _, uparams = tiny_unet_params()
    _, vparams = tiny_vae_params()
    return {
        "unet": {k: v.numpy() for k, v in state_dict_from_jax(uparams, "unet_cond").items()},
        "vae": {k: v.numpy() for k, v in state_dict_from_jax(vparams, "vae").items()},
        "text": rng.standard_normal((2, 7, 32)).astype(np.float32),
        "img": (0.3 * rng.standard_normal((1, 3, 32, 32))).astype(np.float32)}


def run_jax_edit(index: int, world: int, store_path: str, payload: dict, queue) -> None:
    """JAX's `to_mesh(cfg_mesh(cfg=1, sp=2))` edit of the TINY SD under the
    flags of variant `index` of JAX_ENV, in a process of its own (a
    `Ranks` target): the flags are set before anything is traced."""
    import traceback

    import tests.conftest  # noqa: F401  (the 8 virtual CPU devices)

    variant = list(JAX_ENV)[index]
    try:
        os.environ.update(JAX_ENV[variant])
        jax_side = {"unet": tiny_unet_params(), "vae": tiny_vae_params()}
        sd = _jax_sd(jax_side, payload["text"])
        img = payload["img"].transpose(0, 2, 3, 1)
        out = _jax_edit(sd.to_mesh(j_cfg_mesh(cfg=1, sp=2)), img, cfg_scale=2.0)
        traced = {"fused": JFC.TRACE_COUNTS["fallback"], "int8": JC.TRACE_COUNTS["int8"]}
        queue.put((index, (np.asarray(out[0]), np.asarray(out[1]), traced)))
    except BaseException:
        queue.put((index, traceback.format_exc()))
        raise


@pytest.fixture(scope="module")
def jax_runs(payload, tmp_path_factory):
    """Each variant's JAX edit, its process started with the fixture."""
    procs = Ranks(len(JAX_ENV), {k: payload[k] for k in ("text", "img")},
                  str(tmp_path_factory.mktemp("jax_modes")), run_jax_edit)

    def results():
        return {v: procs.results()[i] for i, v in enumerate(JAX_ENV)}

    yield results
    procs.close()


@pytest.fixture(scope="module")
def ranks(payload, jax_runs, tmp_path_factory):
    """The two ranks, started after the JAX processes, which run beside them."""
    r = Ranks(2, payload, str(tmp_path_factory.mktemp("spatial_modes")), W.run_modes_rank)
    yield r.results
    r.close()


@pytest.mark.parametrize("op", OPS)
def test_split_mode_matches_the_whole_op(ranks, op):
    """Forward and gradient of the split op against the whole op on each
    rank, ranks bit-equal; the paths the split took."""
    res = ranks()
    for rank in range(2):
        o = res[rank]["ops"][op]
        assert o["fwd"] <= OP_TOL * max(o["scale"], 1.0), o["fwd"]
        assert o["grad"] <= OP_TOL * max(o["scale"], 1.0), o["grad"]
        if op == "fused_block":  # both convs of the block fused, whole and split
            assert o["fused"] == {"split": 2, "whole": 2}, o["fused"]
        if op.startswith("int8"):  # whole and split both quantized
            assert o["paths"] == {"xla": 0, "shift9": 0, "int8": 2}, o["paths"]
        if op == "shift9":
            assert o["paths"] == {"xla": 0, "shift9": 2, "int8": 0}, o["paths"]
    for k in ("y", "dx"):
        np.testing.assert_array_equal(res[0]["ops"][op][k], res[1]["ops"][op][k])


@pytest.mark.parametrize("op", ["int8", "int8_bwd", "int8_large"])
def test_split_int8_is_bit_equal_to_whole(ranks, op):
    """The s32 sums are exact and the scale is the max over the ranks, so
    the int8 forward split is the whole conv's bits; under int8_bwd so is
    dx (the cotangent's halo, its scale over the ranks)."""
    for rank in range(2):
        o = ranks()[rank]["ops"][op]
        assert o["fwd_equal"], o["fwd"]
        if op != "int8":
            assert o["grad_equal"], o["grad"]


def test_moment_fold_without_the_ranks_sum_fails(ranks):
    """The control: each rank keeps its own share of the folded moments'
    gradient. The forward still holds; the latent's gradient does not."""
    for rank in range(2):
        o = ranks()[rank]["fold_control"]
        assert o["fwd"] <= OP_TOL * max(o["scale"], 1.0), o["fwd"]
        assert o["grad"] > OP_TOL * max(o["scale"], 1.0), o["grad"]


def test_cfg_pair_int8_scale_spans_the_pair(ranks):
    """With the CFG pair over two ranks, an int8 conv's scale is the max
    over both branches, as over the whole batch: the eps matches the pair
    run whole; the control, each rank's own max, does not."""
    res = ranks()
    for rank in range(2):
        o = res[rank]["cfg_int8"]
        assert o["fwd"] <= OP_TOL * max(o["scale"], 1.0), o["fwd"]
        assert o["control"] > OP_TOL * max(o["scale"], 1.0), o["control"]
    np.testing.assert_array_equal(res[0]["cfg_int8"]["eps"], res[1]["cfg_int8"]["eps"])


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("variant", ["fused", "int8_large"])
def test_tiny_sd_edit_on_sp2_matches_jax_to_mesh(ranks, jax_runs, variant):
    """DDIM inversion and a 3-step colour-guided edit of the TINY SD on
    `cfg_mesh(cfg=1, sp=2)` with fused_conv, or under int8_large (the VAE's
    32-row stage quantized: 16 rows a rank), against the port off the mesh
    and JAX's `to_mesh` under the same flags."""
    res = ranks()
    jxt, jimgs, traced = jax_runs()[variant]
    assert traced["fused" if variant == "fused" else "int8"] > 0, traced
    for rank in range(2):
        e = res[rank]["sd"][variant]
        if variant == "fused":
            assert e["fused"]["split"] > 0 and e["fused"]["whole"] > 0, e["fused"]
            for k in ("xt", "imgs"):
                np.testing.assert_allclose(e["mesh"][k], e["whole"][k], err_msg=k, **PIPE)
            np.testing.assert_allclose(e["mesh"]["xt"], jxt, **PIPE)
            np.testing.assert_allclose(e["mesh"]["imgs"], jimgs, **PIPE)
        else:
            assert e["paths"]["int8"] > 0 and e["fused"]["split"] == 0, (e["paths"], e["fused"])
            for k, want in (("xt", jxt), ("imgs", jimgs)):
                assert _rel(e["mesh"][k], e["whole"][k]) < INT8_EDIT_REL, k
                assert _rel(e["mesh"][k], want) < INT8_EDIT_REL, k
        assert np.isfinite(e["mesh"]["imgs"]).all()
    for k in ("xt", "imgs"):
        np.testing.assert_array_equal(res[0]["sd"][variant]["mesh"][k],
                                      res[1]["sd"][variant]["mesh"][k])
