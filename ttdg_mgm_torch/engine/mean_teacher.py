"""The mean-teacher (adaptive-teacher) trainer.

Counterpart of ``ttdg_mgm_tpu/engine/mean_teacher.py:ATeacherTrainer``:
below ``burn_up_step`` a supervised step on the labelled strong views with
its loss weighted 0.1; at ``burn_up_step`` the teacher becomes a copy of
the student (a moving average with keep rate 0); after it, every
``teacher_update_iter`` steps the teacher's moving average (keep
``ema_keep_rate``), and on every step the mean-teacher step
(``engine/steps.py:make_mt_step``): the teacher's pseudo-labels on the weak
unlabelled views, the student's supervised, pseudo-labelled and domain
losses, one SGD step; with ``cross_domain``
(``SEMISUPNET.CROSS_DOMAIN_MATCHING``) also the cross-domain head's losses,
its EMA class centers (``self.centers``, zeros at the start) threaded
through every MT step.

The teacher is a second model of the same architecture, a deep copy of the
student when the trainer is built.  A checkpoint is detectron2's
``EnsembleTSModel`` layout, ``{"model": {"modelStudent.*",
"modelTeacher.*"}, "optimizer", "iteration"}``, which
``checkpoint/bridge.py:load_reference_checkpoint`` reads as
``MODEL.WEIGHTS`` (the teacher, or the student with ``TEST.EVAL_STU``).
As in the JAX package the class centers are not checkpointed: a resumed
run starts them at zero again.

Data parallel (``parallel/mesh.py``): the labelled and the unlabelled
batch are both sharded, each rank takes the MT step on its shards (the
teacher's pseudo-labels of its own unlabelled images), and the step
averages the gradients, the losses and the new class centers; the teacher
stays replicated, every rank computing the same moving average from the
same student.
"""

from __future__ import annotations

import copy
import logging

import torch

from ttdg_mgm_torch.data.loader import build_two_crop_loader
from ttdg_mgm_torch.engine.steps import (ema_update, make_mt_step, make_source_step,
                                         make_tta_step)
from ttdg_mgm_torch.engine.trainer import BaselineTrainer, rank_seed
from ttdg_mgm_torch.parallel import mesh
from ttdg_mgm_torch.solver.build import Optimizer

logger = logging.getLogger("ttdg_mgm_torch")

STUDENT, TEACHER = "modelStudent.", "modelTeacher."


class ATeacherTrainer(BaselineTrainer):
    """``BaselineTrainer`` with an EMA teacher (``self.teacher``) and
    :meth:`train_semisup`.  ``sup_percent`` (``DATALOADER.SUP_PERCENT``
    below 100) splits the labelled records with ``split_seed`` when no
    unlabelled datasets are given."""

    def __init__(self, model, optimizer, *, ema_keep_rate: float = 0.9996,
                 teacher_update_iter: int = 1, burn_up_step: int = 0,
                 unsup_weight: float = 1.0, dis_weight: float = 0.1,
                 pseudo_threshold: float = 0.8, cross_domain: bool = False,
                 sup_percent: float | None = None, split_seed: int = 0, **kw):
        super().__init__(model, optimizer, **kw)
        self.teacher = copy.deepcopy(model)
        self.sup_percent = sup_percent
        self.split_seed = split_seed
        self.ema_keep_rate = ema_keep_rate
        self.teacher_update_iter = teacher_update_iter
        self.burn_up_step = burn_up_step
        self._burnin_step = make_source_step(model, optimizer, loss_weight=0.1)
        self.cross_domain = cross_domain
        self.centers = torch.zeros(
            (model.num_classes + 1, model.cross_domain.dim),
            device=next(model.parameters()).device) if cross_domain else None
        self._mt_step = make_mt_step(model, optimizer, unsup_weight=unsup_weight,
                                     dis_weight=dis_weight, pseudo_threshold=pseudo_threshold,
                                     gt_cap=self.gt_cap, with_cross_domain=cross_domain)

    def train_semisup(self, label_names, unlabel_names, *, max_iter: int, batch_size: int = 4,
                      seed: int = 0, log_every: int = 20, hooks=()) -> None:
        """Mean-teacher training from the optimizer's step count to
        ``max_iter`` on batches of ``batch_size`` labelled and
        ``batch_size`` unlabelled images (``build_two_crop_loader``; each
        rank takes its shards of them).  The loader and the sampling
        generator (on the model's device) are seeded with ``seed``
        (:func:`~ttdg_mgm_torch.engine.trainer.rank_seed`) on every call.
        Hooks and the log as in ``BaselineTrainer.train``."""
        dev = next(self.model.parameters()).device
        loader = build_two_crop_loader(
            label_names, unlabel_names, batch_size=batch_size, canvas=self.canvas,
            min_size=self.min_size, max_size=self.max_size, gt_cap=self.gt_cap,
            mask_res=self.mask_res, seed=seed, sup_percent=self.sup_percent,
            split_seed=self.split_seed)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(seed))
        it = metrics = None
        try:
            for it in range(self.optimizer.count, max_iter):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in mesh.shard_batch(next(loader)).items()}
                if it < self.burn_up_step:
                    metrics = self._burnin_step(
                        {"image": batch["label_strong"], "image_sizes": batch["label_sizes"],
                         **{k: batch[k] for k in ("gt_boxes", "gt_classes", "gt_masks",
                                                  "gt_valid")}}, gen)
                else:
                    if it == self.burn_up_step:
                        # the moving average with keep rate 0: a copy
                        self.teacher.load_state_dict(self.model.state_dict())
                    elif it % self.teacher_update_iter == 0:
                        ema_update(self.teacher, self.model, self.ema_keep_rate)
                    if self.cross_domain:
                        metrics, self.centers = self._mt_step(self.teacher, self.centers,
                                                              batch, gen)
                    else:
                        metrics = self._mt_step(self.teacher, batch, gen)
                for h in hooks:
                    h(it, metrics)
                if it % log_every == 0:
                    logger.info("iter %d: %s", it,
                                {k: round(float(v), 4) for k, v in metrics.items()})
        finally:
            loader.close()
        if metrics is not None:
            for h in hooks:
                if hasattr(h, "after_train"):
                    h.after_train(it, metrics)

    def state_dict(self) -> dict:
        """d2's ``EnsembleTSModel`` checkpoint: the student and the teacher
        under ``modelStudent.`` and ``modelTeacher.``, the SGD state and the
        step count."""
        model = {STUDENT + k: v for k, v in self.model.state_dict().items()}
        model.update({TEACHER + k: v for k, v in self.teacher.state_dict().items()})
        return {"model": model, "optimizer": self.optimizer.sgd.state_dict(),
                "iteration": self.optimizer.count}

    def load_state_dict(self, state: dict) -> None:
        """Restore :meth:`state_dict`'s layout; a checkpoint of one model
        (``BaselineTrainer``'s) restores the student and keeps the teacher."""
        sd = state["model"]
        if any(k.startswith(STUDENT) for k in sd):
            self.teacher.load_state_dict({k[len(TEACHER):]: v for k, v in sd.items()
                                          if k.startswith(TEACHER)})
            sd = {k[len(STUDENT):]: v for k, v in sd.items() if k.startswith(STUDENT)}
        super().load_state_dict({**state, "model": sd})

    def test(self, dataset_names, *, eval_student: bool = False, **kw) -> dict:
        """``BaselineTrainer.test`` on the teacher, with a fresh optimizer
        (zero momentum, step 0) of the student's settings: the student is
        left as it is, and the teacher keeps its adaptation.  With
        ``eval_student`` (``TEST.EVAL_STU``) it adapts and evaluates the
        student instead."""
        if eval_student:
            return super().test(dataset_names, **kw)
        opt = self.optimizer
        saved = (self.model, opt, self._tta_step)
        t_opt = Optimizer([p for p in self.teacher.parameters() if p.requires_grad],
                          opt.schedule, momentum=opt.sgd.defaults["momentum"],
                          weight_decay=opt.sgd.defaults["weight_decay"], clip=opt.clip)
        self.model, self.optimizer = self.teacher, t_opt
        self._tta_step = make_tta_step(self.teacher, t_opt)
        try:
            return super().test(dataset_names, **kw)
        finally:
            self.model, self.optimizer, self._tta_step = saved
