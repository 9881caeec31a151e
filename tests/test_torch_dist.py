"""The port's multi-rank pieces over real gloo collectives: two ranks
spawned once for the module (`torch.multiprocessing`, start method
"spawn", a FileStore under the test's directory, so no port is fixed),
each running every check of tests/torch_dist_workers.py on its own CPU
thread; the test holds their results against each other, against the
one-process port and against the JAX package.

Tolerances, f32:
* synced ABN on two halves against unsynced ABN on the whole batch
  (mean_var, edz_eydz, FusedABNorm's output, dx, dweight, dbias, running
  statistics): rtol 1e-5, atol 1e-6 (the same sums split in two and added);
* two data-parallel BiSeNet steps (width 4, 32 px, a global batch of 8,
  four a rank) against JAX's `make_sharded_train_step` on a 2-device mesh
  from the same weights: tests/test_torch_seg.py's three-step tolerances
  (losses rtol 1e-4; weights max |port - jax| within 2e-2 of the largest
  update; running statistics rtol 1e-3, atol 1e-5); the two ranks'
  parameters, buffers and losses bit-equal;
* the CFG pair on two ranks (one branch each, batch b UNet calls) against
  `CfgEpsClosure` (one batch-2b call), and a 3-step guided edit on the
  mesh against the same off it: rtol 1e-5, atol 1e-5 (convolutions at
  another batch may sum in another order); both ranks bit-equal;
* sweeps over a data axis of 2 against the same without a mesh (a
  loss-scale grid, a seed sweep; the UNet at batch 2 a rank against 4):
  atol 2e-4, tests/test_torch_sweep.py's (readings about 1e-5); both
  ranks bit-equal.

Each rank steps on 4 samples: BiSeNet's norms over 2 samples at its 1 x 1
maps are too ill-conditioned for the weights' tolerance (the variance of
two values near each other, for JAX's `bn` step and the port's alike).
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

from diffusion_image_editing_tpu.seg import optim as JO
from diffusion_image_editing_tpu.seg import train as JT
from diffusion_image_editing_tpu_torch.models import state_dict_from_jax
from tests import torch_dist_workers as W

WORLD = 2
RANKS_TIMEOUT_S = 400  # the ranks take about 60 s alone, 75 s in a -n 6 run
ABN_TOL = dict(rtol=1e-5, atol=1e-6)
PAIR_TOL = dict(rtol=1e-5, atol=1e-5)
SWEEP_TOL = dict(rtol=0, atol=2e-4)
TRAIN_KW = dict(n_classes=5, image_size=32, batch_size_per_device=4, width=4)
LR = {"abn_sync": 1e-2, "bn": 1e-3}


def _fill(path, leaf, rng):
    """Seeded weights of order 1 and running statistics, as test_torch_seg."""
    name = path[-1].key
    shape = np.shape(leaf)
    if name == "kernel":
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    if name in ("scale", "weight"):
        return (1.0 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name == "var":
        return (1.0 + 0.2 * rng.random(shape)).astype(np.float32)
    return (0.1 * rng.standard_normal(shape)).astype(np.float32)


def _cfg_kw(norm):
    return dict(TRAIN_KW, lr0=LR[norm], warmup_start_lr=LR[norm])


def _jax_start(norm):
    jmodel = JT.create_model(JT.TrainConfig(**_cfg_kw(norm), norm=norm),
                             axis_name="dp" if norm == "abn_sync" else None)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    rng = np.random.default_rng(1)
    return jmodel, jax.tree_util.tree_map_with_path(lambda p, l: _fill(p, l, rng), dict(shapes))


def _batches():
    rng = np.random.default_rng(2)
    out = []
    for _ in range(2):
        img = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
        lab = rng.integers(0, 5, (8, 32, 32)).astype(np.int32)
        lab[0, :3] = 255
        out.append((img, lab))
    return out


class Ranks:
    """The spawned ranks; `results()` waits for them (once)."""

    def __init__(self, payload, root):
        ctx = mp.get_context("spawn")
        self.queue = ctx.Queue()
        store = os.path.join(root, "store")
        self.procs = [ctx.Process(target=W.run_rank, args=(r, WORLD, store, payload, self.queue))
                      for r in range(WORLD)]
        for p in self.procs:
            p.start()
        self._results = None

    def results(self):
        if self._results is None:
            got, deadline = {}, time.monotonic() + RANKS_TIMEOUT_S
            while len(got) < WORLD:
                try:
                    rank, value = self.queue.get(timeout=5)
                    got[rank] = value
                except queue.Empty:
                    # A rank that died without a result fails the module now,
                    # not at the deadline.
                    dead = [p.exitcode for p in self.procs if not p.is_alive()]
                    assert not any(dead) and time.monotonic() < deadline, (
                        f"ranks gave {sorted(got)} of {WORLD} results; exit codes "
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
def ranks(tmp_path_factory):
    rng = np.random.default_rng(0)
    x = (0.5 + rng.standard_normal((4, 8, 5, 5))).astype(np.float32)
    w = (1.0 + 0.3 * rng.standard_normal(8)).astype(np.float32)
    w[::3] *= -1.0
    abn = {"x": x, "xhat": rng.standard_normal(x.shape).astype(np.float32),
           "dz": rng.standard_normal(x.shape).astype(np.float32),
           "cot": rng.standard_normal(x.shape).astype(np.float32),
           "w": w, "b": (0.2 * rng.standard_normal(8)).astype(np.float32)}
    start = {norm: {k: v.numpy() for k, v in
                    state_dict_from_jax(_jax_start(norm)[1], "bisenet").items()}
             for norm in LR}
    root = tmp_path_factory.mktemp("dist")
    payload = {"abn": abn, "cli_dir": str(root),
               "train": {"cfg": {n: _cfg_kw(n) for n in LR}, "start": start,
                         "batches": _batches()}}
    r = Ranks(payload, str(root))
    yield r
    r.close()


def test_synced_abn_equals_the_joined_batch(ranks):
    res = ranks.results()
    for rank in range(WORLD):
        a = res[rank]["abn"]
        assert max(a["errs"].values()) <= 1e-5, a["errs"]
        for k, want in a["layer_want"].items():
            np.testing.assert_allclose(a["layer"][k], want, err_msg=k, **ABN_TOL)
    for k in ("dw", "db", "rm", "rv"):
        np.testing.assert_array_equal(res[0]["abn"]["layer"][k], res[1]["abn"]["layer"][k])


@pytest.mark.parametrize("norm", ["abn_sync", "bn"])
def test_sharded_train_step_matches_jax(ranks, norm):
    jmodel, start = _jax_start(norm)
    jcfg = JT.TrainConfig(**_cfg_kw(norm), norm=norm)
    tx = JO.make_optimizer(start["params"], lr0=LR[norm], warmup_start_lr=LR[norm])
    jstate = JT.TrainState(step=jnp.int32(0), params=start["params"],
                           batch_stats=start["batch_stats"], opt_state=tx.init(start["params"]),
                           tx=tx)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    step = JT.make_sharded_train_step(jmodel, jcfg, mesh)
    jlosses = []
    for batch in _batches():
        jstate, loss = step(jstate, *JT.shard_batch(batch, mesh))
        jlosses.append(float(loss))
    res = ranks.results()
    r0, r1 = res[0]["train"][norm], res[1]["train"][norm]
    assert r0["step"] == r1["step"] == 2 and r0["losses"] == r1["losses"]
    for k in r0["state"]:
        np.testing.assert_array_equal(r0["state"][k], r1["state"][k], err_msg=k)
    np.testing.assert_allclose(r0["losses"], jlosses, rtol=1e-4)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": jstate.params, "batch_stats": jstate.batch_stats}, "bisenet").items()}
    w0 = {k: v.numpy() for k, v in state_dict_from_jax(start, "bisenet").items()}
    weights = [k for k in want if "running" not in k and "num_batches" not in k]
    update = max(float(np.abs(want[k] - w0[k]).max()) for k in weights)
    err = max(float(np.abs(r0["state"][k] - want[k]).max()) for k in weights)
    assert update > 10 * LR[norm] * 1e-2 and err <= 2e-2 * update, (err, update)
    for k in want:
        if "running" in k:
            np.testing.assert_allclose(r0["state"][k], want[k], rtol=1e-3, atol=1e-5, err_msg=k)


def test_cfg_pair_over_two_ranks(ranks):
    res = ranks.results()
    for rank in range(WORLD):
        c = res[rank]["cfg"]
        assert c["eps_fn"] == "ShardedCfgEpsClosure"
        np.testing.assert_allclose(c["eps"], c["eps_plain"], **PAIR_TOL)
        np.testing.assert_allclose(c["edit"], c["edit_plain"], **PAIR_TOL)
        assert np.abs(c["edit"]).max() > 0
    for k in ("eps", "edit"):
        np.testing.assert_array_equal(res[0]["cfg"][k], res[1]["cfg"][k])


def test_sweeps_over_a_data_axis(ranks):
    res = ranks.results()
    for rank in range(WORLD):
        s = res[rank]["sweep"]
        assert s["edit"].shape == (4, 1, 4, 16, 16) and s["seeds"].shape == (4, 1, 4, 16, 16)
        np.testing.assert_allclose(s["edit"], s["edit_plain"], **SWEEP_TOL)
        np.testing.assert_allclose(s["seeds"], s["seeds_plain"], **SWEEP_TOL)
    for k in ("edit", "seeds"):
        np.testing.assert_array_equal(res[0]["sweep"][k], res[1]["sweep"][k])


def test_cli_seg_train_abn_sync_on_two_ranks(ranks):
    res = ranks.results()
    assert res[0]["cli"]["rc"] == res[1]["cli"]["rc"] == 0
    assert "seg-train: step 2, 2 steps this run" in res[0]["cli"]["out"]
    assert "2 ranks" in res[0]["cli"]["out"] and res[1]["cli"]["out"] == ""
    assert res[0]["cli"]["files"] == ["step_00000002.pt"]
