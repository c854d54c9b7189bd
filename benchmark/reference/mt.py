"""The plain reference of a mean-teacher cell: the first iterations of
``ATeacherTrainer.train_semisup`` (the port's ``engine/mean_teacher.py``)
on the reference's model, optimizer, two-crop loader and steps, built from
the cell's configuration and fed from the dataset files alone.  Like
``cell.py``, it imports nothing of the program.

An iteration below ``BURN_UP_STEP`` is a supervised step on the labelled
strong views with its loss weighted 0.1; at ``BURN_UP_STEP`` the teacher
becomes a copy of the student; after it, every ``TEACHER_UPDATE_ITER``
iterations the teacher's moving average (keep ``EMA_KEEP_RATE``), and each
iteration the mean-teacher step (``engine/steps.py:make_mt_step``).
"""

from __future__ import annotations

import copy

import torch

from reference import cell
from reference.data import loader as ref_loader
from reference.engine.steps import ema_update, make_mt_step, make_source_step


def choice_points():
    """``(owner, attribute, key)`` of the reference's choosers, whose every
    call's output is recorded or imposed (``jobs/mt.py:CallLog``): the RPN's
    proposals (top-k and NMS), HiPPI's fixed point, and the teacher's
    pseudo-labels (its detections over ``BBOX_THRESHOLD``)."""
    from reference.engine import steps as ref_steps
    from reference.graph import universe as ref_universe
    from reference.models import rcnn as ref_rcnn

    return [(ref_rcnn, "generate_proposals", "proposals"), (ref_universe, "hippi", "hippi"),
            (ref_steps, "threshold_pseudo_labels", "pseudo")]


def run_mt(cfg: dict, device, weights: dict, steps: int, fp8: bool = False, log=None,
           model_module=None) -> dict:
    """The first ``steps`` iterations from the loader seeded with ``SEED``
    and the sampling generator on ``device`` seeded with it.  Returns each
    iteration's total loss, the first gradient (the momentum after one
    step), the student's trainable parameters after each iteration but the
    last (``students``), and the student's and the teacher's after the
    last.  ``log`` (a ``jobs/mt.py:CallLog``) wraps each
    iteration (recording or imposing the choices)."""
    c = cell.Cfg(cfg)
    ss = c.SEMISUPNET
    model, opt = cell.build(cfg, device, weights, fp8, model_module)
    teacher = copy.deepcopy(model)
    geo = cell.geometry(c)
    params = cell._trainable(model, opt)
    t_params = dict(teacher.named_parameters())
    sup = c.DATALOADER.SUP_PERCENT
    loader = ref_loader.build_two_crop_loader(
        c.DATASETS.TRAIN_LABEL, c.DATASETS.TRAIN_UNLABEL,
        batch_size=c.SOLVER.IMG_PER_BATCH_LABEL, canvas=geo["canvas"], min_size=geo["min_size"],
        max_size=geo["max_size"], gt_cap=geo["gt_cap"], mask_res=256, seed=c.SEED,
        sup_percent=sup if sup < 100.0 else None, split_seed=c.DATALOADER.RANDOM_DATA_SEED,
        prefetch=0)
    gen = torch.Generator(device=device).manual_seed(c.SEED)
    burnin = make_source_step(model, opt, loss_weight=0.1)
    mt_step = make_mt_step(model, opt, unsup_weight=ss.UNSUP_LOSS_WEIGHT,
                           dis_weight=ss.DIS_LOSS_WEIGHT, pseudo_threshold=ss.BBOX_THRESHOLD,
                           gt_cap=geo["gt_cap"])
    keep = ss.EMA_KEEP_RATE or 0.9996
    out = {"losses": []}
    try:
        for it in range(steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(loader).items()}
            if log is not None:
                log.begin()
            if it < ss.BURN_UP_STEP:
                m = burnin({"image": batch["label_strong"], "image_sizes": batch["label_sizes"],
                            **{k: batch[k] for k in ("gt_boxes", "gt_classes", "gt_masks",
                                                     "gt_valid")}}, gen)
            else:
                if it == ss.BURN_UP_STEP:
                    teacher.load_state_dict(model.state_dict())
                elif it % ss.TEACHER_UPDATE_ITER == 0:
                    ema_update(teacher, model, keep)
                m = mt_step(teacher, batch, gen)
            if log is not None:
                log.end()
            out["losses"].append(float(m["total_loss"]))
            if it == 0:
                out["grad"] = {n: opt.sgd.state[p]["momentum_buffer"].detach().to("cpu", copy=True)
                               for n, p in params.items()}
            if it < steps - 1:
                out.setdefault("students", []).append(
                    {n: p.detach().to("cpu", copy=True) for n, p in params.items()})
    finally:
        loader.close()
    out["params"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    out["teacher"] = {n: t_params[n].detach().to("cpu", copy=True) for n in params}
    return out
