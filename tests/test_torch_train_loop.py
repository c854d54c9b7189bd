"""The source train loop against the JAX package's (CPU).

* Loop parity: 3 steps of ``BaselineTrainer.train`` on both sides, from the
  committed fixture weights (``checkpoint/bridge.py`` carries them across),
  through each package's own train loader (square 64 px canvas, batch 2,
  shortest edge drawn from three sizes, flips), with a small learning rate.
  The port's step is wrapped here to take the JAX loop's own sampling
  uniforms: ``rng = PRNGKey(seed)``, then ``rng, sub = split(rng)`` per
  step, then ``torch_port_fixture.jax_uniforms(sub, ...)``.  Each step's
  losses agree at rtol 1e-4; the final weights per leaf within 3e-3 of the
  leaf's largest update plus 1e-6.  The loader seed is one on which the
  two packages' HiPPI solves reach the same fixed point on all 3 steps.
  On these batches (4 nodes per graph, one class, an adjacency of scale
  4e8 whose entries tie) HiPPI's fixed point is decided by float32
  round-off: a relative change of 1e-7 in its start moves its output by
  0.25 on each of loader seeds 0, 1 and 3.  On loader seeds 1-5 the two
  packages land on different fixed points, and ``loss_matching`` differs
  by 2.6-10.7 % on the first step where they do, the five other losses of
  that step agreeing at rtol 1e-4 (tests/test_torch_source_step.py's
  docstring names the other round-off effects that a seed must avoid).
* Kill and resume (the port): a fresh trainer resumes the saved weights,
  momentum and step count bit for bit, its learning rate continues from
  the count, and its run on to ``max_iter`` equals the saved trainer's own
  second ``train`` call (both restart the loader and the generator from
  ``seed``, as in the JAX package); ``test`` then runs on the same trainer.
* ``LossEvalHook``: its period, the same value on every call with the same
  weights, and ``FloatingPointError`` on a non-finite loss.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from demo_config import DEMO
from torch_port_fixture import jax_model_and_params, jax_uniforms, port_model
from ttdg_mgm_tpu.data import coco as jcoco
from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_tpu.engine.trainer import BaselineTrainer as JTrainer
from ttdg_mgm_tpu.solver import build as j_solver
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2
from ttdg_mgm_torch.checkpoint.save import Checkpointer
from ttdg_mgm_torch.data import coco as tcoco
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.engine.hooks import LossEvalHook
from ttdg_mgm_torch.engine.trainer import BaselineTrainer
from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights
from ttdg_mgm_torch.solver import build as t_solver

#: the loader's seed (see the module docstring for why this one)
LOADER_SEED = 0
LR = 1e-3
GEOM = dict(canvas=64, min_size=64, max_size=64, gt_cap=4, mask_res=32,
            train_min_sizes=(48, 56, 64))
SCHEDULE = dict(base_lr=1e-3, steps=(5,), gamma=0.1, warmup_iters=3, warmup_factor=0.1)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 disc images of 64 x 64 with polygon ground truth, in both
    packages' catalogs."""
    root = tmp_path_factory.mktemp("train_loop")
    images, anns = [], []
    yy, xx = np.mgrid[:64, :64]
    for i in range(4):
        arr = np.full((64, 64, 3), 30 + 5 * i, np.uint8)
        cx, cy, r = 22 + 5 * i, 28 + 2 * i, 9 + i
        arr[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = [200, 180 - 10 * i, 160]
        Image.fromarray(arr).save(root / f"im{i}.png")
        images.append({"id": i, "file_name": f"im{i}.png", "height": 64, "width": 64})
        t = np.linspace(0, 2 * np.pi, 13)[:-1]
        poly = np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], -1)
        anns.append({"id": i + 1, "image_id": i, "category_id": 1 + i % 2, "iscrowd": 0,
                     "bbox": [cx - r, cy - r, 2 * r, 2 * r], "area": float(np.pi * r * r),
                     "segmentation": [poly.reshape(-1).tolist()]})
    path = root / "train.json"
    path.write_text(json.dumps({"images": images, "annotations": anns, "categories": [
        {"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]}))
    name = "_torch_train_loop_ds"
    for cat, reg in ((TCatalog, tcoco.register_coco_instances),
                     (JCatalog, jcoco.register_coco_instances)):
        cat.remove(name)
        reg(name, str(path), str(root), evaluator_type="dice")
    yield name
    TCatalog.remove(name)
    JCatalog.remove(name)


def _record(store):
    return lambda it, m: store.append({k: float(v) for k, v in m.items()})


def _d2(params):
    return flax_params_to_d2(jax.tree.map(lambda x: np.asarray(x, np.float32), params),
                             box_head_channels=DEMO["model_kwargs"]["fpn_channels"])


def test_loop_matches_jax(dataset):
    jm, jp = jax_model_and_params()
    # the JAX step donates its state: train a copy of the shared fixture
    own = jax.tree.map(jnp.copy, jp)
    jt = JTrainer(jm, j_solver.build_optimizer(own, lambda _: LR), own, **GEOM)
    jlosses = []
    jt.train([dataset], max_iter=3, batch_size=2, seed=LOADER_SEED, hooks=[_record(jlosses)])

    pm = port_model(jp)
    pt = BaselineTrainer(pm, t_solver.build_optimizer(pm, lambda _: LR), **GEOM)
    real, rng = pt._source_step, [jax.random.PRNGKey(LOADER_SEED)]
    n_rois = DEMO["model_kwargs"]["post_nms_topk"] + GEOM["gt_cap"]

    def step(batch, generator=None):
        rng[0], sub = jax.random.split(rng[0])
        B, H, W = batch["image"].shape[:3]
        n_anchors = 3 * sum((H // s) * (W // s) for s in (4, 8, 16, 32, 64))
        u = jax_uniforms(sub, B, n_anchors, n_rois)
        return real(batch, uniforms={k: torch.from_numpy(np.array(v)) for k, v in u.items()})

    pt._source_step = step
    losses = []
    pt.train([dataset], max_iter=3, batch_size=2, seed=LOADER_SEED, hooks=[_record(losses)])
    assert pt.optimizer.count == int(jt.state.step) == 3 and len(losses) == len(jlosses) == 3
    for i, (got, want) in enumerate(zip(losses, jlosses)):
        assert got.keys() == want.keys()
        for k in want:
            assert np.isfinite(want[k])
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"step {i}: {k}")
    start, final = _d2(jp), _d2(jt.state.params)
    params = dict(pm.named_parameters())
    moved = 0
    for name, p in params.items():
        if not p.requires_grad:
            continue
        update = np.abs(final[name] - start[name]).max()
        moved += update > 0
        np.testing.assert_allclose(p.detach().numpy(), final[name], rtol=0,
                                   atol=3e-3 * update + 1e-6, err_msg=name)
    assert moved > 40


def _trainer(seed=None):
    """The fixture's weights, or with ``seed`` seeded random ones."""
    if seed is None:
        model = port_model(jax_model_and_params()[1])
    else:
        model = MaskRCNN(**DEMO["model_kwargs"])
        init_weights(model, torch.Generator().manual_seed(seed))
    opt = t_solver.build_optimizer(model, t_solver.warmup_multistep_schedule(**SCHEDULE))
    return BaselineTrainer(model, opt, **GEOM)


def _state(trainer):
    return {"model": {k: v.clone() for k, v in trainer.model.state_dict().items()},
            "momentum": [trainer.optimizer.sgd.state[p]["momentum_buffer"].clone()
                         for p in trainer.optimizer.params],
            "count": trainer.optimizer.count}


def _assert_equal_states(a, b):
    assert a["count"] == b["count"]
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for x, y in zip(a["momentum"], b["momentum"]):
        assert torch.equal(x, y)


def test_kill_and_resume(dataset, tmp_path):
    """Train 4 steps with a checkpoint every 2 and drop the trainer; a fresh
    trainer (other initial weights) resumes the saved state bit for bit and
    trains on to 6 with the learning rate of steps 4 and 5, as the first
    trainer's own second call does; then ``test`` runs on it."""
    ckpt_dir = str(tmp_path / "ck")
    t1 = _trainer()
    hooks = t1.default_hooks(checkpointer=Checkpointer(ckpt_dir), checkpoint_period=2,
                             output_dir=str(tmp_path / "out"), log_every=2)
    t1.train([dataset], max_iter=4, batch_size=2, seed=1, hooks=hooks)
    ckpt = Checkpointer(ckpt_dir)
    assert ckpt.steps() == [2, 4] and ckpt.latest_step() == 4
    saved = _state(t1)
    lines = (tmp_path / "out" / "metrics.json").read_text().splitlines()
    assert [json.loads(x)["iteration"] for x in lines] == [1, 3]

    t2 = _trainer(seed=7)
    assert not torch.equal(t2.model.state_dict()["roi_heads.box_head.fc1.weight"],
                           saved["model"]["roi_heads.box_head.fc1.weight"])
    assert t2.resume_or_load(ckpt)
    _assert_equal_states(_state(t2), saved)

    lrs = []
    t2.train([dataset], max_iter=6, batch_size=2, seed=1,
             hooks=[lambda it, m: lrs.append((it, t2.optimizer.sgd.param_groups[0]["lr"]))])
    sched = t_solver.warmup_multistep_schedule(**SCHEDULE)
    assert lrs == [(4, sched(4)), (5, sched(5))] and sched(4) != sched(5)
    t1.train([dataset], max_iter=6, batch_size=2, seed=1)
    _assert_equal_states(_state(t2), _state(t1))

    res = t2.test([dataset], ttt=True, tta_batch=2, min_batch_num=1, dice_threshold=0.0)
    assert t2.optimizer.count == 7 and np.isfinite(t2.last_tta_loss)
    assert len(res[dataset]) == 3 and all(np.isfinite(v) for v in res[dataset].values())


def test_loss_eval_hook(dataset):
    t = _trainer()
    hook = LossEvalHook(t, dataset, period=3, num_batches=2)
    for it in range(6):
        hook(it, {})
    assert [it for it, _ in hook.history] == [3, 6]
    assert hook.history[0][1] == hook.history[1][1] and np.isfinite(hook.history[0][1])
    assert len(hook._batches) == 2 and hook._batches[0]["image"].shape == (2, 64, 64, 3)
    with torch.no_grad():
        t.model.roi_heads.box_predictor.cls_score.bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="iteration=9"):
        hook(8, {})
