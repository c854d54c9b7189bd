"""The mean-teacher training job: ``ATeacherTrainer.train_semisup`` as
``train_net_torch.py`` calls it (``SEMISUPNET.Trainer ateacher``), on the
cell's labelled and unlabelled splits.

Set-up builds the trainer with ``build.py:build_trainer`` from the cell's
configuration, loads the benchmark's weights into the student (the
teacher becomes its copy at burn-up), and trains the first :data:`FOLLOW` iterations through
``train_semisup`` (loader and sampling generator seeded with ``SEED``): with
``BURN_UP_STEP`` 1 a burn-in step, the teacher's copy and a mean-teacher
step, and a mean-teacher step after the teacher's moving average.  The
reference follows these (:func:`numbers`): each iteration's total loss
(``loss_gap``), the first gradient the optimizer got (``grad_gap``) and the
median leaf's change after the last (``median_change_gap``).  The teacher's
moving average is held to its formula on the run's own students
(``teacher_gap``, :func:`ema_gap`).  The window
calls ``train_semisup`` again on the same trainer, from the optimizer's
count on, every iteration a mean-teacher one, with a hook that ends the
loop once the window's seconds have passed.

The choosers, each call of them in an iteration (the teacher's and the
student's RPN proposals, HiPPI's fixed point, the pseudo-labels over
``BBOX_THRESHOLD``), are recorded in the program's run and imposed on the
reference's (:class:`CallLog`), as ``decisions.py`` does for a step's first
call.
"""

from __future__ import annotations

import functools
import math
import time

import numpy as np
import torch

import compare
from decisions import _cpu, _flat, _map, _shape
from jobs.common import first_gradient, free_program, program_cfg, trainable

#: iterations the reference follows: a burn-in step, then mean-teacher steps
FOLLOW = 3
#: the ulps of the student an element's moving-average step must reach for
#: :func:`ema_gap` to read it
RESOLVED = 8


class WindowClosed(Exception):
    """Raised by the window's hook to end the training loop."""


class CallLog:
    """Every call of each choice point ``(owner, attribute, key)`` between
    :meth:`begin` and :meth:`end`, in order; with ``follow`` (another run's
    ``steps``) each call returns that run's output of the same call instead,
    where the shapes agree."""

    def __init__(self, points, follow=None):
        self.steps: list = []
        self.follow = follow
        self.active = False
        self._undo = []
        for owner, attr, key in points:
            real = getattr(owner, attr)
            self._undo.append((owner, attr, real))
            setattr(owner, attr, self._wrap(real, key))

    def begin(self) -> None:
        self.steps.append({})
        self.active = True

    def end(self) -> None:
        self.active = False

    def close(self) -> None:
        for owner, attr, real in reversed(self._undo):
            setattr(owner, attr, real)

    def _wrap(self, real, key):
        def choose(*args, **kwargs):
            out = real(*args, **kwargs)
            if not self.active:
                return out
            calls = self.steps[-1].setdefault(key, [])
            calls.append(_cpu(out))
            if self.follow is None:
                return out
            theirs = self.follow[len(self.steps) - 1].get(key, [])
            i = len(calls) - 1
            if i >= len(theirs) or _shape(theirs[i]) != _shape(out):
                return out
            dev = next(t for t in _flat(out) if torch.is_tensor(t)).device
            return _map(theirs[i], lambda t: t.to(dev))

        return choose


def _program_points():
    from ttdg_mgm_torch.engine import steps as steps_mod
    from ttdg_mgm_torch.graph import universe as universe_mod
    from ttdg_mgm_torch.models import rcnn as rcnn_mod

    return [(rcnn_mod, "generate_proposals", "proposals"), (universe_mod, "hippi", "hippi"),
            (steps_mod, "threshold_pseudo_labels", "pseudo")]


def _train(run, max_iter: int, hooks) -> None:
    cfg = run.state["cfg"]
    run.state["trainer"].train_semisup(
        cfg.DATASETS.TRAIN_LABEL, cfg.DATASETS.TRAIN_UNLABEL, max_iter=max_iter,
        batch_size=cfg.SOLVER.IMG_PER_BATCH_LABEL, seed=cfg.SEED, log_every=10 ** 9,
        hooks=hooks)


def setup(run) -> None:
    from ttdg_mgm_torch import configure_torch
    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.data.builtin import register_all_medical

    configure_torch()
    cfg = program_cfg(run.cfg)
    register_all_medical(run.data_root, force=True)
    trainer = build_trainer(cfg, device=run.device)
    trainer.model.load_state_dict({k: v.to(run.device) for k, v in run.weights.items()})
    run.state = {"cfg": cfg, "trainer": trainer}
    params = trainable(trainer)
    got = {"losses": []}
    log = CallLog(_program_points())
    real_burnin, real_mt = trainer._burnin_step, trainer._mt_step

    def wrap(step):
        def logged(*a, **kw):
            log.begin()
            try:
                return step(*a, **kw)
            finally:
                log.end()
        return logged

    def capture(it, metrics):
        got["losses"].append(float(metrics["total_loss"]))
        if len(got["losses"]) == 1:
            got["grad"] = first_gradient(trainer.optimizer.sgd, params)
        if len(got["losses"]) < FOLLOW:
            got.setdefault("students", []).append(
                {n: p.detach().to("cpu", copy=True) for n, p in params.items()})

    trainer._burnin_step, trainer._mt_step = wrap(real_burnin), wrap(real_mt)
    try:
        _train(run, FOLLOW, [capture])
    finally:
        trainer._burnin_step, trainer._mt_step = real_burnin, real_mt
        log.close()
    teacher = dict(trainer.teacher.named_parameters())
    got["params"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    got["teacher"] = {n: teacher[n].detach().to("cpu", copy=True) for n in params}
    got["steps"] = log.steps
    run.state["got"] = got
    _instrument(run)


def _instrument(run) -> None:
    """The spans of a traced run (no-ops otherwise)."""
    from ttdg_mgm_torch.data import loader as loader_mod
    from ttdg_mgm_torch.engine import mean_teacher as mt_mod
    from ttdg_mgm_torch.ops import roi_pool as roi_pool_mod

    rec = run.recorder
    if not rec.on:
        return
    trainer = run.state["trainer"]
    dev = run.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
    rec.wrap(trainer, "_mt_step", "mt.step", sync=sync)
    rec.wrap(loader_mod, "load_image", "decode")
    real_loader = mt_mod.build_two_crop_loader

    def timed_loader(*a, **kw):
        return rec.wrap_iter(real_loader(*a, **kw), "mt.loader_wait")

    rec.replace(mt_mod, "build_two_crop_loader", timed_loader)
    pools = run.work.setdefault("pools_bwd", [])
    real_bwd = roi_pool_mod.multilevel_roi_pool_backward

    def backward(grad, level_shapes, rois, **kw):
        B = rois.shape[0]
        pools.append(([(B, h, w) for h, w in level_shapes], grad.shape[-1], rois.detach().clone(),
                      grad.shape[2], grad.element_size()))
        return real_bwd(grad, level_shapes, rois, **kw)

    # the wrapper takes the place of the module's name, which the function
    # itself reads for its launch counters
    functools.update_wrapper(backward, real_bwd)
    rec.replace(roi_pool_mod, "multilevel_roi_pool_backward", backward)


def window(run, seconds: float) -> None:
    t0 = time.perf_counter()
    iters = 0

    def hook(it, metrics):
        nonlocal iters
        iters += 1
        if time.perf_counter() - t0 >= seconds:
            raise WindowClosed

    try:
        _train(run, 10 ** 9, [hook])
    except WindowClosed:
        pass
    s = run.state["cfg"].SOLVER
    images = iters * (s.IMG_PER_BATCH_LABEL + s.IMG_PER_BATCH_UNLABEL)
    run.counts.update(mt_steps=iters, train_images=images, attempted=images, failed=0)


def reference(run, fp8: bool = False, follow: dict | None = None, counter=None,
              alter=None) -> dict:
    """The plain reference over the first :data:`FOLLOW` iterations, from the
    same seed, imposing the choices of ``follow`` (the program's run) when it
    is given.  ``counter`` is not taken (no metric of this job counts the
    reference's FLOPs), nor ``alter``: this job's faults are planted in the
    program (``control_faults.py``)."""
    from reference import cell
    from reference.mt import choice_points, run_mt

    if alter:
        raise ValueError("the mean-teacher job plants its faults in the program")
    cell.register(run.traffic, run.data_root)
    log = CallLog(choice_points(), follow=follow["steps"] if follow else None)
    try:
        out = run_mt(run.cfg, run.device, run.weights, FOLLOW, fp8=fp8, log=log,
                     model_module=run.model_module)
    finally:
        log.close()
    out["steps"] = log.steps
    return out


def check_choosers(got: dict, device, alter=None) -> None:
    """The choosers are imposed (:class:`CallLog`); none is checked by
    itself here."""


def ema_gap(teacher: dict, students: list, keep_rate: float) -> float:
    """How far a run's teacher lies from the moving average's formula on the
    run's own students.  With ``BURN_UP_STEP`` 1 the teacher is the student
    after iteration 0 (``S0``, its copy at burn-up) moved once by the
    moving average toward the student after iteration 1 (``S1``), so ``T -
    S0`` should be ``(1 - keep) (S1 - S0)``.  That step is a few float32 ulps
    of the student at most (keep 0.9996), so it is read only at the elements
    where it reaches :data:`RESOLVED` ulps of ``S0``, where rounding moves it
    by an eighth at most: the norm of ``(T - S0) - (1 - keep) (S1 - S0)``
    over that of ``(1 - keep) (S1 - S0)``, over those elements of every leaf
    pooled; 1 when no element reaches them.  A skipped moving average reads
    1, a keep rate of 0.999 1.5."""
    keep = float(np.float32(keep_rate))
    s0, s1 = students[0], students[1]
    num = den = 0.0
    for name, t in teacher.items():
        a = s0[name]
        ulp = (torch.nextafter(a.abs(), torch.full_like(a, math.inf)) - a.abs()).double()
        want = (1.0 - keep) * (s1[name].double() - a.double())
        resolved = want.abs() >= RESOLVED * ulp
        num += float(((t.double() - a.double() - want)[resolved] ** 2).sum())
        den += float((want[resolved] ** 2).sum())
    return math.sqrt(num / den) if den > 0 else 1.0


def numbers(got: dict, ref: dict, run, log=None) -> dict:
    p0 = {k: run.weights[k] for k in ref["grad"]}
    keep = compare.moving_leaves(ref["grad"], run.cfg["SOLVER"]["WEIGHT_DECAY"], p0)
    change_p, change_r = compare.change(got["params"], p0), compare.change(ref["params"], p0)
    if log is not None:
        log(f"losses: got {got['losses']}, reference {ref['losses']}")
        log("leaves whose change differs most: " + ", ".join(
            f"{k} {v:.4g}" for k, v in compare.leaf_gaps(change_p, change_r, keep)[:4]))
    return {
        "loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
        "grad_gap": compare.worst_leaf(got["grad"], ref["grad"], keep),
        "median_change_gap": compare.median_leaf(change_p, change_r, keep),
        "teacher_gap": ema_gap(got["teacher"], got["students"],
                               run.cfg["SEMISUPNET"]["EMA_KEEP_RATE"]),
    }


def check(run) -> dict:
    got = run.state["got"]
    free_program(run)
    ref = reference(run, follow=got)
    if run.trace:
        from roofline import roi_backward_work

        run.work["pool_bwd_work"] = [roi_backward_work(shapes, C, rois, P, elem)
                                     for shapes, C, rois, P, elem in run.work.pop("pools_bwd", [])]
    return numbers(got, ref, run, log=run.log)
