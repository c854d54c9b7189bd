"""The mean-teacher step against the JAX package (CPU), on the committed
golden fixture (both models carry its weights through
``checkpoint/bridge.py``), each comparison at rtol 1e-4 unless its test
states another tolerance:

* ``loss_domain``: both losses, and the gradients of the discriminator and
  of the FPN output that feeds it (reversed): within 1e-3 of each leaf's
  largest value;
* ``grad_reverse``: the gradient through it is exactly ``-scale`` times the
  gradient without it;
* ``proposals_weak``: identical valid slots and classes, boxes within 2e-2
  and scores within 1e-3 (``forward_inference``'s tolerances in
  tests/test_torch_models.py: the same box inference);
* ``threshold_pseudo_labels``: the case of tests/test_train_integration.py
  and a cut to ``max_boxes``, equal to JAX's;
* ``ema_update``: rtol 1e-5, atol 1e-7, as JAX's own test;
* one burn-in step (``make_source_step(..., loss_weight=0.1)``): its losses
  and total, and the weights after it within the source loop test's
  tolerance (tests/test_torch_train_loop.py: 3e-3
  of each leaf's update, plus 1e-6);
* one ``make_mt_step`` on JAX's own sampling uniforms (its ``rng`` split in
  three, the first two through ``torch_port_fixture.jax_uniforms``): every
  aux key, and the weights after it within the same loop tolerance.

The labelled batch is ``source_batch(6)`` (tests/test_torch_source_step.py
names the float32 round-off effects that seed avoids) with a contrast
change as its strong view; the unlabelled batch is ``source_batch(11)``
with another as its strong view.  On these batches the teacher's
detections score 0.98-0.998 on the discs and at most 0.28 elsewhere, so
the threshold 0.8 keeps 2-3 pseudo-boxes per image.  HiPPI's fixed point
in the labelled pass's ``loss_matching`` is decided by float32 round-off
on small batches (``ROADMAP.md`` Queue 3); with these batch seeds and
step key 7 the two packages reach the same one (``loss_matching`` equal to
every digit printed).
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo_config import DEMO
from torch_port_fixture import (jax_model_and_params, jax_uniforms, port_model, source_batch,
                                to_numpy_tree)
from ttdg_mgm_tpu.engine import steps as jsteps
from ttdg_mgm_tpu.solver import build as j_solver
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2
from ttdg_mgm_torch.engine.steps import (ema_update, make_mt_step, make_source_step,
                                         threshold_pseudo_labels)
from ttdg_mgm_torch.models.discriminator import grad_reverse
from ttdg_mgm_torch.solver import build as t_solver

LABEL_SEED, UNLABEL_SEED, STEP_KEY = 6, 11, 7
LR = 1e-3
GT_CAP = 4
C = DEMO["model_kwargs"]["fpn_channels"]


def _d2(params):
    return flax_params_to_d2(to_numpy_tree(params), box_head_channels=C)


def _mt_batch():
    lab, unl = source_batch(LABEL_SEED), source_batch(UNLABEL_SEED)
    return {"label_strong": lab["image"] * 0.9 + 10, "label_weak": lab["image"],
            "label_sizes": lab["image_sizes"], "gt_boxes": lab["gt_boxes"],
            "gt_classes": lab["gt_classes"], "gt_masks": lab["gt_masks"],
            "gt_valid": lab["gt_valid"],
            "unlabel_strong": np.clip(unl["image"] * 1.1 - 5, 0, 255).astype(np.float32),
            "unlabel_weak": unl["image"], "unlabel_sizes": unl["image_sizes"]}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _uniforms(rng, n_rois):
    size, B = DEMO["size"], 4
    n_anchors = 3 * sum((size // s) ** 2 for s in (4, 8, 16, 32, 64))
    return {k: torch.from_numpy(np.array(v)) for k, v in jax_uniforms(rng, B, n_anchors,
                                                                       n_rois).items()}


def _assert_loop_tolerance(pm, start, final):
    """The source loop test's tolerance: every trainable leaf within 3e-3 of its
    largest update plus 1e-6; returns how many leaves moved."""
    moved = 0
    for name, p in pm.named_parameters():
        if not p.requires_grad:
            continue
        update = np.abs(final[name] - start[name]).max()
        moved += update > 0
        np.testing.assert_allclose(p.detach().numpy(), final[name], rtol=0,
                                   atol=3e-3 * update + 1e-6, err_msg=name)
    return moved


def test_grad_reverse_negates_and_scales_exactly():
    x = torch.randn(2, 8, 5, 5, generator=torch.Generator().manual_seed(0), requires_grad=True)
    w = torch.randn(8, 5, 5, generator=torch.Generator().manual_seed(1))
    (x * w).sin().sum().backward()
    plain = x.grad.clone()
    for scale in (1.0, 0.1, 2.5):
        x.grad = None
        y = grad_reverse(x, scale)
        assert torch.equal(y, x)
        (y * w).sin().sum().backward()
        assert torch.equal(x.grad, -scale * plain)


def test_loss_domain_matches_jax():
    jm, jp = jax_model_and_params()
    b = _mt_batch()
    xs, xt = b["label_weak"], b["unlabel_weak"]

    def jloss(p):
        d = jm.apply({"params": p}, jnp.asarray(xs), jnp.asarray(xt), method=jm.loss_domain)
        return d["loss_D_img_s"] + d["loss_D_img_t"], d

    (_, jd), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    jg = _d2(jg)
    pm = port_model(jp)
    d = pm.loss_domain(torch.from_numpy(xs), torch.from_numpy(xt))
    assert set(d) == set(jd) == {"loss_D_img_s", "loss_D_img_t"}
    for k in jd:
        np.testing.assert_allclose(float(d[k].detach()), float(jd[k]), rtol=1e-4, err_msg=k)
    (d["loss_D_img_s"] + d["loss_D_img_t"]).backward()
    params = dict(pm.named_parameters())
    names = [n for n in params if n.startswith("D_img.")] + ["backbone.fpn_output2.weight"]
    for n in names:
        want = jg[n]
        assert np.abs(want).max() > 0, n
        np.testing.assert_allclose(params[n].grad.numpy(), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max(), err_msg=n)


def test_proposals_weak_matches_jax():
    jm, jp = jax_model_and_params()
    b = _mt_batch()
    j = jm.apply({"params": jp}, jnp.asarray(b["unlabel_weak"]), jnp.asarray(b["unlabel_sizes"]),
                 method=jm.proposals_weak)
    t = port_model(jp).proposals_weak(torch.from_numpy(b["unlabel_weak"]),
                                      torch.from_numpy(b["unlabel_sizes"]))
    assert set(t) == set(j) == {"boxes", "scores", "classes", "valid"}
    np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
    v = np.asarray(j["valid"])
    np.testing.assert_array_equal(t["classes"].numpy()[v], np.asarray(j["classes"])[v])
    np.testing.assert_allclose(t["boxes"].numpy(), np.asarray(j["boxes"]), atol=2e-2)
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]), atol=1e-3)
    assert not t["boxes"].requires_grad
    # the teacher's pseudo-labels of the MT step below exist
    assert ((t["scores"] > 0.8) & t["valid"]).sum(1).min() >= 2


@pytest.mark.parametrize("max_boxes", [None, 2])
def test_threshold_pseudo_labels_match_jax(max_boxes):
    det = {"boxes": np.arange(16, dtype=np.float32).reshape(1, 4, 4) + 1,
           "scores": np.asarray([[0.95, 0.5, 0.85, 0.1]], np.float32),
           "classes": np.asarray([[0, 1, 1, 0]], np.int32),
           "valid": np.asarray([[True, True, True, False]])}
    b, c, v = threshold_pseudo_labels(_torch(det), threshold=0.8, max_boxes=max_boxes)
    jb, jc, jv = jsteps.threshold_pseudo_labels({k: jnp.asarray(x) for k, x in det.items()},
                                                threshold=0.8, max_boxes=max_boxes)
    if max_boxes is None:
        assert v.tolist() == [[True, False, True, False]]
    for got, want in ((b, jb), (c, jc), (v, jv)):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert c.dtype == torch.int32


def test_ema_update_matches_jax():
    _, jp = jax_model_and_params()
    rs = np.random.RandomState(3)
    student = jax.tree.map(lambda x: x + jnp.asarray(rs.randn(*x.shape) * 1e-2, x.dtype), jp)
    want = _d2(jsteps.ema_update(jp, student, jnp.float32(0.9996)))
    t, s = port_model(jp), port_model(student)
    ema_update(t, s, 0.9996)
    sd = t.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-5, atol=1e-7, err_msg=name)
    # the fixed statistics stay, the affines move with the average
    np.testing.assert_array_equal(sd["backbone.bottom_up.stem.conv1.norm.running_var"].numpy(),
                                  port_model(jp).state_dict()[
                                      "backbone.bottom_up.stem.conv1.norm.running_var"].numpy())


def test_burn_in_step_matches_jax():
    """``make_source_step(..., loss_weight=0.1)``: the JAX trainer's burn-in
    step (``mean_teacher.py:62``)."""
    jm, jp = jax_model_and_params()
    b = _mt_batch()
    sup = {"image": b["label_strong"], "image_sizes": b["label_sizes"],
           **{k: b[k] for k in ("gt_boxes", "gt_classes", "gt_masks", "gt_valid")}}
    own = jax.tree.map(jnp.copy, jp)
    tx = j_solver.build_optimizer(own, lambda _: LR)
    rng = jax.random.PRNGKey(STEP_KEY)
    state, jm_ = jsteps.make_source_step(jm, tx, loss_weight=0.1)(
        jsteps.TrainState.create(own, tx), {k: jnp.asarray(v) for k, v in sup.items()}, rng)
    pm = port_model(jp)
    step = make_source_step(pm, t_solver.build_optimizer(pm, lambda _: LR), loss_weight=0.1)
    m = step(_torch(sup), uniforms=_uniforms(rng, DEMO["model_kwargs"]["post_nms_topk"]
                                              + b["gt_boxes"].shape[1]))
    assert set(m) == set(jm_)
    for k in jm_:
        np.testing.assert_allclose(float(m[k]), float(jm_[k]), rtol=1e-4, err_msg=k)
    np.testing.assert_allclose(float(m["total_loss"]),
                               0.1 * sum(float(v) for k, v in m.items() if k != "total_loss"),
                               rtol=1e-6)
    assert _assert_loop_tolerance(pm, _d2(jp), _d2(state.params)) > 40


@pytest.fixture(scope="module")
def mt_run():
    jm, jp = jax_model_and_params()
    b = _mt_batch()
    own = jax.tree.map(jnp.copy, jp)
    tx = j_solver.build_optimizer(own, lambda _: LR)
    rng = jax.random.PRNGKey(STEP_KEY)
    step = jsteps.make_mt_step(jm, tx, gt_cap=GT_CAP)
    state, aux = step(jsteps.TrainState.create(own, tx), jp,
                      {k: jnp.asarray(v) for k, v in b.items()}, rng)
    rng_sup, rng_unsup, _ = jax.random.split(rng, 3)
    K = DEMO["model_kwargs"]["post_nms_topk"]
    uniforms = {"sup": _uniforms(rng_sup, K + b["gt_boxes"].shape[1]),
                "unsup": _uniforms(rng_unsup, K + GT_CAP)}
    pm, teacher = port_model(jp), port_model(jp)
    opt = t_solver.build_optimizer(pm, lambda _: LR)
    metrics = make_mt_step(pm, opt, gt_cap=GT_CAP)(teacher, _torch(b), uniforms=uniforms)
    return dict(aux={k: float(v) for k, v in aux.items()},
                metrics={k: float(v) for k, v in metrics.items()}, pm=pm, teacher=teacher,
                start=_d2(jp), final=_d2(state.params))


def test_mt_step_losses_match_jax(mt_run):
    aux, m = mt_run["aux"], mt_run["metrics"]
    base = {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    assert set(m) == set(aux) == (base | {"loss_mask", "loss_matching", "loss_D_img_s",
                                          "loss_D_img_t", "total_loss"}
                                  | {k + "_pseudo" for k in base})
    for k, want in aux.items():
        assert np.isfinite(want), k
        np.testing.assert_allclose(m[k], want, rtol=1e-4, err_msg=k)
    assert aux["loss_matching"] > 0 and aux["loss_cls_pseudo"] > 0


def test_mt_step_weights_match_jax(mt_run):
    assert _assert_loop_tolerance(mt_run["pm"], mt_run["start"], mt_run["final"]) > 40
    # the teacher is read, never written
    for name, p in mt_run["teacher"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), mt_run["start"][name], err_msg=name)


def test_mt_step_total_weighs_its_losses(mt_run):
    """The total is the supervised losses, the pseudo pass's classification
    losses at ``unsup_weight`` 1 (its box regressions weighted 0) and the
    domain losses at ``dis_weight`` 0.1 (JAX ``steps.py:217-221``)."""
    m = mt_run["metrics"]
    sup = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask",
           "loss_matching")
    want = (sum(m[k] for k in sup) + m["loss_cls_pseudo"] + m["loss_rpn_cls_pseudo"]
            + 0.1 * (m["loss_D_img_s"] + m["loss_D_img_t"]))
    np.testing.assert_allclose(m["total_loss"], want, rtol=1e-6)
    assert m["loss_box_reg_pseudo"] > 0 and m["loss_rpn_loc_pseudo"] > 0
