"""The spatial split of one edit (`ops/split.py`, `parallel/edit_shard.py`,
`DiffusionWrapper.to_mesh`) over real gloo collectives: two ranks, then four,
each spawned once for the module (`torch.multiprocessing`, start method
"spawn", a FileStore under the test's directory), each running every check of
tests/torch_spatial_workers.py; the test holds their results against each
other, against the port run whole, and against the JAX package's `to_mesh` on
its 8-virtual-device CPU mesh (tests/conftest.py), from the same seeded TINY
weights (`state_dict_from_jax`).

Tolerances, f32 (tests/test_edit_shard.py's, where the JAX package holds its
own mesh against its own whole run):
* each split op and its gradient against the whole op: atol 2e-5 relative
  to the output's scale (readings about 1e-7: the same sums in another
  order);
* the decode split over the whole mesh against the whole decode: rtol 2e-5,
  atol 2e-5; its gradient rtol 5e-5, atol 5e-5;
* the pipeline (DDIM inversion, then a 3-step colour-guided edit) on the mesh
  against off it: rtol 2e-4, atol 2e-5 (readings about 3e-5);
* against the JAX package's `to_mesh`: the same tolerances;
* every rank's result bit-equal.
"""

import os
import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch.multiprocessing as mp
from jax.sharding import Mesh

from diffusion_image_editing_tpu.core import schedule_for_model as j_schedule
from diffusion_image_editing_tpu.guidance import SingleColorAttrFunc as JSingleColor
from diffusion_image_editing_tpu.parallel import cfg_mesh as j_cfg_mesh
from diffusion_image_editing_tpu.parallel import shard_decode_fn as j_shard_decode_fn
from diffusion_image_editing_tpu.parallel import spatial_shard as j_spatial_shard
from diffusion_image_editing_tpu.pipeline import DDPM as JDDPM
from diffusion_image_editing_tpu.pipeline import SD as JSD
from diffusion_image_editing_tpu.pipeline import EditPipeline as JEditPipeline
from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
from tests import torch_spatial_workers as W
from tests.torch_port_helpers import (nchw, tiny_unet2d_params, tiny_unet_params,
                                      tiny_vae_params, write_tiny_ddpm_dir, write_tiny_sd_dir)

RANKS_TIMEOUT_S = 300  # the two ranks take about 10 s alone, the four about 10 s
OP_TOL = 2e-5
DECODE = dict(rtol=2e-5, atol=2e-5)
DECODE_GRAD = dict(rtol=5e-5, atol=5e-5)
PIPE = dict(rtol=2e-4, atol=2e-5)
STEPS = W.STEPS
ATTR = dict(target=0.9, color_idx=0, loss_scale=5.0, t1=0, t2=STEPS)


class Ranks:
    """`world` spawned ranks running `target`; `results()` waits for them
    (once)."""

    def __init__(self, world, payload, root, target=W.run_rank):
        ctx = mp.get_context("spawn")
        self.world = world
        self.queue = ctx.Queue()
        store = os.path.join(root, f"store{world}")
        self.procs = [ctx.Process(target=target, args=(r, world, store, payload, self.queue))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self):
        if self._results is None:
            got, deadline = {}, time.monotonic() + RANKS_TIMEOUT_S
            while len(got) < self.world:
                try:
                    rank, value = self.queue.get(timeout=5)
                    got[rank] = value
                except queue.Empty:
                    dead = [p.exitcode for p in self.procs if not p.is_alive()]
                    assert not any(dead) and time.monotonic() < deadline, (
                        f"ranks gave {sorted(got)} of {self.world} results; exit codes "
                        f"{[p.exitcode for p in self.procs]}")
            for p in self.procs:
                p.join(timeout=60)
            bad = {r: v for r, v in got.items() if isinstance(v, str)}
            assert not bad, bad
            assert all(p.exitcode == 0 for p in self.procs), [p.exitcode for p in self.procs]
            self._results = got
        return self._results

    def close(self):
        for p in self.procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=30)


@pytest.fixture(scope="module")
def weights():
    """Seeded TINY weights and inputs: the JAX modules and params, and the
    payload of numpy arrays the ranks load."""
    rng = np.random.default_rng(0)
    junet, uparams = tiny_unet_params()
    jvae, vparams = tiny_vae_params()
    junet2d, u2params = tiny_unet2d_params()
    text = rng.standard_normal((2, 7, 32)).astype(np.float32)
    payload = {
        "unet": {k: v.numpy() for k, v in state_dict_from_jax(uparams, "unet_cond").items()},
        "vae": {k: v.numpy() for k, v in state_dict_from_jax(vparams, "vae").items()},
        "unet2d": {k: v.numpy() for k, v in state_dict_from_jax(u2params, "unet2d").items()},
        "text": text,
        "z": rng.standard_normal((1, 4, 16, 16)).astype(np.float32),
        "img": (0.3 * rng.standard_normal((1, 3, 32, 32))).astype(np.float32),
        "img16": (0.3 * rng.standard_normal((1, 3, 16, 16))).astype(np.float32)}
    jax_side = {"unet": (junet, uparams), "vae": (jvae, vparams), "unet2d": (junet2d, u2params)}
    return payload, jax_side


@pytest.fixture(scope="module")
def ranks(weights, tmp_path_factory):
    """The two-rank and the four-rank worlds, started together."""
    from PIL import Image

    payload, _ = weights
    root = tmp_path_factory.mktemp("spatial")
    write_tiny_sd_dir(str(root / "sd"))
    write_tiny_ddpm_dir(str(root / "ddpm"))
    face = str(root / "face.png")
    Image.fromarray(np.random.default_rng(3).integers(0, 255, (32, 32, 3), np.uint8)).save(face)
    payload = dict(payload, cli_dir=str(root), sd_dir=str(root / "sd"),
                   ddpm_dir=str(root / "ddpm"), face=face)
    worlds = {n: Ranks(n, payload, str(root)) for n in (2, 4)}
    yield worlds
    for r in worlds.values():
        r.close()


def _jax_sd(jax_side, text):
    class JFixedTextSD(JSD):
        def prep_text(self, prompt_ids):
            return jnp.asarray(text)

    (junet, uparams), (jvae, vparams) = jax_side["unet"], jax_side["vae"]
    return JFixedTextSD(junet, jax.tree.map(jnp.asarray, uparams), j_schedule("sd", STEPS),
                        jvae, jax.tree.map(jnp.asarray, vparams))


def _jax_edit(wrapper, img, **kw):
    pipe = JEditPipeline(wrapper)
    xt, *_ = pipe.prepare_real_image_edit(jnp.asarray(img), eta=0.0, inversion_method="ddim",
                                          **kw)
    out = pipe.edit_image(xt, attr_func=JSingleColor(**ATTR), collect=False, **kw)
    return nchw(xt), nchw(out.imgs)


@pytest.fixture(scope="module")
def jax_runs(weights):
    """The JAX package's `to_mesh` edits and its full-mesh decode VJP."""
    payload, jax_side = weights
    img = payload["img"].transpose(0, 2, 3, 1)
    sd = _jax_sd(jax_side, payload["text"])
    out = {"sd": _jax_edit(sd.to_mesh(j_cfg_mesh(cfg=2, sp=2)), img, cfg_scale=2.0)}
    junet2d, u2params = jax_side["unet2d"]
    ddpm = JDDPM(junet2d, jax.tree.map(jnp.asarray, u2params),
                 j_schedule("ddpm", STEPS, clip_sample=False))
    mesh = Mesh(np.array(jax.devices()[:2]), ("sp",))
    out["ddpm"] = _jax_edit(ddpm.to_mesh(mesh), payload["img16"].transpose(0, 2, 3, 1))

    mesh = j_cfg_mesh(cfg=2, sp=1)
    axes = tuple(mesh.axis_names)
    vae_apply = sd.vae.apply
    keep = j_spatial_shard(mesh, axes)
    dec = j_shard_decode_fn(
        sd.decode_fn(), mesh,
        apply_fn=lambda p, z: vae_apply(p, z, method="decode", shard_fn=keep), axes=axes)
    z = jnp.asarray(payload["z"].transpose(0, 2, 3, 1))
    img_out = jax.jit(lambda f, z_: f(z_))(dec, z)
    grad = jax.jit(jax.grad(lambda z_: jnp.sum(dec(z_) ** 2)))(z)
    out["decode"] = (nchw(img_out), nchw(grad))
    return out


@pytest.mark.parametrize("op", ["conv", "conv_one_row", "down_pad1", "down_pad0", "groupnorm",
                                "attention"])
def test_split_op_matches_the_whole_op(ranks, op):
    res = ranks[2].results()
    for rank in range(2):
        o = res[rank]["ops"][op]
        assert o["fwd"] <= OP_TOL * max(o["scale"], 1.0), o["fwd"]
        assert o["grad"] <= OP_TOL * max(o["scale"], 1.0), o["grad"]
    for k in ("y", "dx"):
        np.testing.assert_array_equal(res[0]["ops"][op][k], res[1]["ops"][op][k])


def test_uneven_rows_raise_naming_the_stage(ranks):
    for rank in range(2):
        assert "Downsample2D at 6 rows" in ranks[2].results()[rank]["uneven"]


def test_full_mesh_decode_and_its_gradient(ranks, jax_runs):
    """`shard_decode_fn(..., axes=None)`: the decode's rows over every rank,
    plain and with checkpointed blocks, against the whole decode and
    against the JAX package's full-mesh decode."""
    res = ranks[2].results()
    jimg, jgrad = jax_runs["decode"]
    for rank in range(2):
        d = res[rank]["decode"]
        for name in ("split", "split_remat"):
            np.testing.assert_allclose(d[name]["img"], d["whole"]["img"], **DECODE)
            np.testing.assert_allclose(d[name]["grad"], d["whole"]["grad"], **DECODE_GRAD)
            np.testing.assert_allclose(d[name]["img"], jimg, **DECODE)
            np.testing.assert_allclose(d[name]["grad"], jgrad, **DECODE_GRAD)
    for name in ("split", "split_remat"):
        for k in ("img", "grad"):
            np.testing.assert_array_equal(res[0]["decode"][name][k], res[1]["decode"][name][k])


def _check_edit(results, key, spec, jax_run, eps_fn):
    jxt, jimgs = jax_run
    for rank, r in results.items():
        e = r[key][spec] if spec else r[key]
        assert e["eps_fn"] == eps_fn
        for k in ("xt", "imgs"):
            np.testing.assert_allclose(e["mesh"][k], e["whole"][k], err_msg=k, **PIPE)
        np.testing.assert_allclose(e["mesh"]["xt"], jxt, **PIPE)
        np.testing.assert_allclose(e["mesh"]["imgs"], jimgs, **PIPE)
        assert np.isfinite(e["mesh"]["imgs"]).all()
    first = results[0][key][spec] if spec else results[0][key]
    for rank, r in results.items():
        e = r[key][spec] if spec else r[key]
        for k in ("xt", "imgs"):
            np.testing.assert_array_equal(e["mesh"][k], first["mesh"][k])


@pytest.mark.parametrize("spec", ["sp2", "cfg2"])
def test_sd_to_mesh_edit_on_two_ranks(ranks, jax_runs, spec):
    """SD on `cfg_mesh(cfg=1, sp=2)` (the UNet's rows split, the pair whole)
    and `cfg_mesh(cfg=2, sp=1)` (the pair split, the UNet's rows whole), the
    codec's rows over both ranks either way: DDIM inversion and a guided
    edit through the public pipeline."""
    _check_edit(ranks[2].results(), "sd", spec, jax_runs["sd"], "ShardedCfgEpsClosure")


def test_sd_cfg2xsp2_edit_on_four_ranks(ranks, jax_runs):
    """The pair over `cfg`, the UNet's rows over `sp`, the codec's over all
    four ranks, against JAX's `to_mesh(cfg_mesh(cfg=2, sp=2))`."""
    _check_edit(ranks[4].results(), "sd", "cfg2xsp2", jax_runs["sd"], "ShardedCfgEpsClosure")


def test_ddpm_to_mesh_sp2(ranks, jax_runs):
    """DDPM: the unconditional UNet's rows over the whole mesh
    (`ShardedEpsClosure`), the identity codec."""
    _check_edit(ranks[2].results(), "ddpm", None, jax_runs["ddpm"], "ShardedEpsClosure")


@pytest.mark.parametrize("world,spec", [(2, "sp2"), (2, "cfg2"), (4, "cfg2xsp2")])
def test_cli_shard_runs_on_gloo_ranks(ranks, world, spec):
    """`--shard` under a group that is up, as under torchrun: `generate
    --family ddpm --shard sp2`, `edit --family sd --shard cfg2` and
    `--shard cfg2xsp2`; the first rank writes the image."""
    res = ranks[world].results()
    for rank in range(world):
        c = res[rank]["cli"][spec]
        assert c["rc"] == 0 and c["written"], c
        assert (c["out"] != "") == (rank == 0), c["out"]


def test_cli_refuses_a_cfg_run_on_a_mesh_without_cfg(ranks):
    """As the JAX package's P("cfg", "sp") refuses a mesh without a cfg axis."""
    for rank in range(2):
        msg = ranks[2].results()[rank]["cli_refused"]
        assert msg.startswith("--shard sp2:") and "mesh sp2 has none" in msg, msg
