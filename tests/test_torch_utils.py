"""The port's `utils/config.py`, `utils/logging.py` and `utils/debug.py`
against the JAX package's: every config dataclass serialises to the JAX
package's JSON, text for text, and back; the logger writes its file and
demotes other ranks; the profiler trace is written; the step timer counts
and, on a CUDA device, waits for it; the finite checks raise where the
JAX package's do."""

import dataclasses
import json
import logging

import numpy as np
import pytest
import torch

from diffusion_image_editing_tpu.utils import config as JC
from diffusion_image_editing_tpu.utils import logging as JLog
from diffusion_image_editing_tpu_torch.utils import config as TC
from diffusion_image_editing_tpu_torch.utils import debug as TD
from diffusion_image_editing_tpu_torch.utils import logging as TLog


@pytest.mark.parametrize("name,kw", [
    ("ModelSpec", {}), ("ModelSpec", dict(family="sd", dtype="bfloat16")),
    ("EditConfig", {}), ("EditConfig", dict(eta=1.0, classes=(17, 4), attr_func="NetAttrFunc",
                                            metric="lpips", t_skip=None)),
    ("MeshConfig", {}), ("MeshConfig", dict(axis_names=("cfg", "sp"), shape=(2, 4))),
])
def test_config_json_is_the_jax_package_s(name, kw):
    tcfg, jcfg = getattr(TC, name)(**kw), getattr(JC, name)(**kw)
    assert [f.name for f in dataclasses.fields(tcfg)] == [f.name for f in dataclasses.fields(jcfg)]
    text = TC.to_json(tcfg)
    assert text == JC.to_json(jcfg)
    assert TC.from_json(type(tcfg), text) == tcfg
    assert TC.from_json(type(tcfg), JC.to_json(jcfg)) == tcfg
    extra = json.dumps(dict(json.loads(text), unknown=1))
    assert TC.from_json(type(tcfg), extra) == tcfg  # unknown keys dropped, as JAX


def test_setup_logger(tmp_path, monkeypatch):
    logger = TLog.setup_logger(str(tmp_path), name="port_test")
    logger.info("hello")
    for h in logger.handlers:
        h.flush()
    assert "hello" in (tmp_path / "port_test.log").read_text()
    for h in logger.handlers:
        h.close()
    assert logger.level == logging.INFO and len(logger.handlers) == 2
    ref = JLog.setup_logger(None, name="jax_test")
    assert [type(h) for h in ref.handlers] == [type(h) for h in
                                               TLog.setup_logger(None, "port_test2").handlers]
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda: 1)
    assert TLog.setup_logger(None, name="port_test3").level == logging.ERROR


def test_profile_trace(tmp_path):
    with TLog.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]


def test_step_timer(monkeypatch):
    syncs = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: syncs.append(device))
    for device, n_sync in ((None, 0), ("cpu", 0), ("cuda:0", 4)):
        t, ref = TLog.StepTimer(device), JLog.StepTimer()
        for timer in (t, ref):
            for _ in range(2):
                with timer.phase("a"):
                    pass
        s = t.summary()
        assert s.keys() == ref.summary().keys() and s["a"]["count"] == 2
        assert s["a"]["mean_s"] == pytest.approx(s["a"]["total_s"] / 2)
        assert len(syncs) == n_sync
        syncs.clear()


def test_assert_finite_and_checkify_nans():
    TD.assert_finite({"a": torch.ones(3), "b": [np.zeros(2), 1.0, "text", torch.arange(3)]})
    with pytest.raises(FloatingPointError, match=r"\['a'\]\[1\]"):
        TD.assert_finite({"a": [torch.ones(2), torch.tensor([1.0, float("nan")])]})
    with pytest.raises(FloatingPointError):
        TD.assert_finite(np.array([np.inf]))
    guarded = TD.checkify_nans(lambda x: 1.0 / x)
    assert float(guarded(torch.tensor(2.0))) == 0.5
    with pytest.raises(FloatingPointError, match="lambda"):
        guarded(torch.tensor(0.0))
    pair = TD.checkify_nans(lambda x: (x, {"y": x.log()}))
    pair(torch.tensor(2.0))
    with pytest.raises(FloatingPointError, match=r"\[1\]\['y'\]"):
        pair(torch.tensor(-1.0))
