"""The port's checkpoints, hooks and event writers (CPU), as
tests/test_checkpoint.py and tests/test_resume.py hold the JAX package's:
the ``Checkpointer`` round trip, ``max_to_keep``, a fresh directory, a save
cut short before its rename, and a saved trainer state read back by
``build.py:init_params`` as ``MODEL.WEIGHTS`` with every tensor loaded;
each hook's period against the JAX hook's on the same iterations, the
anomaly hook's ``FloatingPointError``, and ``metrics.json`` lines equal to
the JAX ``WriterHook``'s."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
import logging
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.engine import hooks as jhooks
from ttdg_mgm_tpu.utils import events as jevents
from ttdg_mgm_torch.checkpoint import save as tsave
from ttdg_mgm_torch.checkpoint.save import Checkpointer
from ttdg_mgm_torch.engine import hooks as thooks
from ttdg_mgm_torch.utils import events as tevents

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _state(step: int) -> dict:
    g = torch.Generator().manual_seed(step)
    return {"model": {"w": torch.randn(3, 4, generator=g), "b": torch.arange(4.0) + step},
            "optimizer": {"state": {0: {"momentum_buffer": torch.randn(3, generator=g)}},
                          "param_groups": [{"lr": 0.1, "params": [0]}]},
            "iteration": step}


def _equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


def test_roundtrip(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck"))
    path = ckpt.save(7, _state(7))
    assert ckpt.latest_step() == 7 and os.path.basename(path) == "model_0000007.pth"
    assert _equal(ckpt.restore(), _state(7))
    with open(tmp_path / "ck" / "last_checkpoint") as f:
        assert f.read() == "model_0000007.pth"
    # d2's layout: the file alone is a checkpoint the reference's tools read
    assert torch.load(path, weights_only=False).keys() == {"model", "optimizer", "iteration"}


def test_resume_or_load_fresh(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "fresh"))
    assert ckpt.latest_step() is None and ckpt.restore() is None
    assert ckpt.resume_or_load() == (None, False)


def test_max_to_keep(tmp_path):
    ckpt = Checkpointer(str(tmp_path / "ck3"), max_to_keep=2)
    for s in (1, 2, 3):
        ckpt.save(s, _state(s))
    assert ckpt.steps() == [2, 3] and ckpt.latest_step() == 3
    assert _equal(ckpt.restore(step=2), _state(2))
    state, resumed = ckpt.resume_or_load()
    assert resumed and state["iteration"] == 3


def test_interrupted_save_leaves_no_partial_file(tmp_path, monkeypatch):
    """A save cut short before its ``os.replace`` leaves the directory as it
    was: no file under the new checkpoint's name, no temporary file, and the
    latest checkpoint still the earlier one."""
    ckpt = Checkpointer(str(tmp_path / "ck"))
    ckpt.save(2, _state(2))
    before = sorted(os.listdir(ckpt.directory))

    def cut(src, dst):
        raise KeyboardInterrupt

    monkeypatch.setattr(tsave.os, "replace", cut)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save(4, _state(4))
    monkeypatch.undo()
    assert sorted(os.listdir(ckpt.directory)) == before
    assert ckpt.latest_step() == 2 and _equal(ckpt.restore(), _state(2))


def test_saved_state_loads_as_model_weights(tmp_path, caplog):
    """A trainer state saved by the checkpointer is a d2 checkpoint:
    ``init_params`` reads it as ``MODEL.WEIGHTS`` into a model drawn from
    another seed, every tensor loaded, none of another shape, none absent."""
    from ttdg_mgm_torch.build import build_trainer, init_params, model_kwargs
    from ttdg_mgm_torch.config import setup_cfg
    from ttdg_mgm_torch.models.rcnn import MaskRCNN

    opts = ["MODEL.RESNETS.DEPTH", "14", "MODEL.FPN.OUT_CHANNELS", "32",
            "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "32",
            "MODEL.GRAPH.UNIV_SIZE", "8", "MODEL.WEIGHTS", ""]
    cfg_path = os.path.join(REPO, "configs", "seg_res50fpn_source.yaml")
    trainer = build_trainer(setup_cfg(cfg_path, opts), device="cpu", seed=0)
    path = Checkpointer(str(tmp_path / "ck")).save(0, trainer.state_dict())
    cfg = setup_cfg(cfg_path, opts[:-1] + [path])
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        model = init_params(cfg, MaskRCNN(**model_kwargs(cfg)), seed=5)
    n = len([k for k in model.state_dict() if not k.startswith("discriminator")])
    assert f"loaded {n} tensors" in caplog.text
    assert "0 of another shape and 0 absent" in caplog.text
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


class _FakeCkpt:
    def __init__(self):
        self.steps = []

    def save(self, step, tree, **_):
        self.steps.append(step)


class _FakeTrainer:
    def __init__(self):
        self.tests = []

    def state_dict(self):
        return {}

    def test(self, names, **kw):
        self.tests.append((tuple(names), kw))
        return {"x": 1.0}


def test_hook_periods_match_jax():
    """The checkpoint, eval and anomaly hooks fire on the same iterations as
    the JAX hooks (``(it + 1) % period`` and ``it % period``)."""
    for period in (1, 3, 4):
        got, want = _FakeCkpt(), _FakeCkpt()
        t, j = thooks.PeriodicCheckpointHook(got, _FakeTrainer(), period), \
            jhooks.PeriodicCheckpointHook(want, _FakeTrainer(), period)
        te, je = _FakeTrainer(), _FakeTrainer()
        tev = thooks.PeriodicEvalHook(te, ["a"], period, ttt=False)
        jev = jhooks.PeriodicEvalHook(je, ["a"], period, ttt=False)
        for it in range(13):
            for h in (t, j, tev, jev):
                h(it, {})
        assert got.steps == want.steps and len(got.steps) == 13 // period
        assert te.tests == je.tests and [s for s, _ in tev.results] == [s for s, _ in
                                                                        jev.results]
    assert thooks.PeriodicCheckpointHook(got, _FakeTrainer(), 0)(4, {}) is None


def test_anomaly_hook_raises_at_its_period():
    bad = {"loss_cls": torch.tensor(float("nan")), "total_loss": torch.tensor(1.0)}
    inf = {"loss_cls": torch.tensor(float("inf"))}
    hook = thooks.AnomalyDetectionHook(period=4)
    hook(3, bad)  # not at the period: not read
    for it, m in ((4, bad), (8, inf)):
        with pytest.raises(FloatingPointError, match=f"iteration={it}: loss_cls"):
            hook(it, m)
        with pytest.raises(FloatingPointError, match=f"iteration={it}: loss_cls"):
            jhooks.AnomalyDetectionHook(period=4)(it, {k: jnp.asarray(float(v))
                                                       for k, v in m.items()})
    hook(4, {"total_loss": torch.tensor(2.0)})


def test_metrics_json_matches_jax_writer(tmp_path):
    """The same losses through the port's and the JAX ``WriterHook`` with a
    ``JSONWriter``: the same ``metrics.json`` lines, ``time`` aside; the
    port's hook adds the last iteration after training."""
    paths = tmp_path / "t" / "metrics.json", tmp_path / "j" / "metrics.json"
    th = thooks.WriterHook(tevents.EventStorage(), [tevents.JSONWriter(str(paths[0])),
                                                    tevents.TerminalWriter()], period=2)
    jh = jhooks.WriterHook(jevents.EventStorage(), [jevents.JSONWriter(str(paths[1]))],
                           period=2)
    rng = np.random.RandomState(0)
    for it in range(5):
        m = {k: np.float32(rng.rand()) for k in ("loss_cls", "loss_mask", "total_loss")}
        th(it, {k: torch.tensor(v) for k, v in m.items()})
        jh(it, {k: jnp.asarray(v) for k, v in m.items()})
    jh.writers[0].close()
    lines = [[json.loads(x) for x in p.read_text().splitlines()] for p in paths]
    assert len(lines[0]) == len(lines[1]) == 2
    for a, b in zip(*lines):
        assert a.keys() == b.keys() == {"iteration", "loss_cls", "loss_mask", "total_loss",
                                        "time"}
        assert {k: v for k, v in a.items() if k != "time"} == {k: v for k, v in b.items()
                                                               if k != "time"}
    th.after_train(4, {"total_loss": torch.tensor(0.5)})
    last = json.loads(paths[0].read_text().splitlines()[-1])
    assert last["iteration"] == 4 and last["total_loss"] == 0.5
    th.after_train(5, {"total_loss": torch.tensor(0.25)})  # written at its period already
    assert len(paths[0].read_text().splitlines()) == 3


def test_event_storage_and_tensorboard_import(monkeypatch, tmp_path):
    with tevents.EventStorage(3) as s:
        assert tevents.EventStorage.current() is s
        s.put_scalars(a=1, b=2.5)
        s.step()
        s.put_scalar("a", 4)
    assert tevents.EventStorage.current() is None
    assert s.history("a") == [(3, 1.0), (4, 4.0)] and s.latest() == {"a": 4.0, "b": 2.5}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="tensorboard"):
        tevents.TensorboardWriter(str(tmp_path))
