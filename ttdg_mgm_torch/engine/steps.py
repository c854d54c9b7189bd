"""The training, mean-teacher and test-time-adaptation steps.

Counterparts of ``ttdg_mgm_tpu/engine/steps.py``: ``make_source_step`` (one
SGD step on the weighted sum of ``MaskRCNN.loss_supervised``'s losses),
``make_tta_step`` (one SGD step on ``MaskRCNN.loss_ttt`` per test batch),
``ema_update`` (the teacher's exponential moving average),
``threshold_pseudo_labels`` and ``make_mt_step`` (the mean-teacher step,
with or without the cross-domain head).  Losses are taken before the
update; the parameters update in place.

Data parallel (``parallel/mesh.py``): each rank runs a step on its own
shard of the global batch (its own graph matching, its own draws), and
after ``backward()`` the gradients, the total loss and every other loss
(and the cross-domain head's new class centers) are averaged over the
ranks before the optimizer, as the JAX steps ``pmean`` them under
``shard_map`` (``ttdg_mgm_tpu/engine/steps.py:81-82, 128-129, 243-249``).
The optimizer's clip then acts on the averaged gradients, as optax's does
after the ``pmean``.  The steps call the model's loss methods directly, so
the reduction is explicit (``DistributedDataParallel`` reduces only
through ``forward()``).  Without a process group it is a no-op.

Spans (``utils/profiling.py``) in the source and TTA steps:
``step.backward`` around ``backward()`` and ``step.optimizer`` around the
reduction and the optimizer's step; the forward's own are the model's
(``models/rcnn.py``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ttdg_mgm_torch.parallel import mesh
from ttdg_mgm_torch.solver.build import Optimizer
from ttdg_mgm_torch.utils.profiling import span


def reduce_step(optimizer: Optimizer, metrics: dict, *extra: torch.Tensor) -> dict:
    """Average over the ranks, in place and in one collective per dtype, the
    gradients of the optimizer's parameters (a parameter without one gets
    zeros first, as :meth:`Optimizer.step` gives it), ``metrics`` (detached
    copies, returned) and ``extra`` tensors.  A no-op without a process
    group."""
    metrics = {k: v.detach() for k, v in metrics.items()}
    if not mesh.active():
        return metrics
    metrics = {k: v.clone() for k, v in metrics.items()}
    for p in optimizer.params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    mesh.all_reduce_mean([p.grad for p in optimizer.params] + list(metrics.values())
                         + list(extra))
    return metrics


def make_source_step(model, optimizer: Optimizer, *,
                     loss_weight: float = 1.0) -> Callable[..., dict]:
    """Returns ``step(batch, generator=None, *, uniforms=None) -> metrics``
    for batches ``{"image", "image_sizes", "gt_boxes", "gt_classes",
    "gt_masks", "gt_valid"}`` on the model's device (``synth.synth_batch(...,
    with_gt=True)`` lays one out).  The step descends on the sum of the
    losses times ``loss_weight`` (0.1 in the mean-teacher burn-in).  The
    sampling uniforms come from ``generator``, or pre-drawn from
    ``uniforms`` (see ``MaskRCNN.loss_supervised``).  ``metrics`` holds
    every loss and ``total_loss`` (the weighted sum), detached on the
    device."""

    def step(batch, generator=None, *, uniforms=None):
        optimizer.zero_grad()
        losses = model.loss_supervised(
            batch["image"], batch["image_sizes"], batch["gt_boxes"], batch["gt_classes"],
            batch["gt_masks"], batch["gt_valid"], generator=generator, uniforms=uniforms)
        total = sum(losses.values()) * loss_weight
        with span("step.backward"):
            total.backward()
        with span("step.optimizer"):
            metrics = reduce_step(optimizer, {**losses, "total_loss": total})
            optimizer.step()
        return metrics

    return step


def make_tta_step(model, optimizer: Optimizer) -> Callable[[dict], torch.Tensor]:
    """Returns ``step(batch) -> loss`` for batches ``{"image": (B, H, W, 3),
    "image_sizes": (B, 2)}`` on the model's device."""

    def step(batch):
        optimizer.zero_grad()
        loss = model.loss_ttt(batch["image"], batch["image_sizes"])
        with span("step.backward"):
            loss.backward()
        with span("step.optimizer"):
            loss = reduce_step(optimizer, {"loss": loss})["loss"]
            optimizer.step()
        return loss

    return step


def _ema_tensors(model) -> list:
    """The tensors the teacher's moving average covers, in a fixed order:
    those that are parameters of the JAX model, so every parameter and the
    FrozenBatchNorm affines (``weight``, ``bias``); the fixed statistics
    ``running_mean`` and ``running_var`` are left out."""
    return [v for k, v in model.state_dict(keep_vars=True).items()
            if v.is_floating_point() and not k.endswith(("running_mean", "running_var"))]


@torch.no_grad()
def ema_update(teacher, student, keep_rate: float) -> None:
    """``t = t * keep + s * (1 - keep)`` in place over :func:`_ema_tensors`,
    in float32 as the JAX package (``keep`` rounded to float32, ``1 - keep``
    taken from that, each product and the sum rounded once)."""
    keep = float(np.float32(keep_rate))
    t, s = _ema_tensors(teacher), _ema_tensors(student)
    torch._foreach_mul_(t, keep)
    torch._foreach_add_(t, torch._foreach_mul(s, 1.0 - keep))


@torch.no_grad()
def threshold_pseudo_labels(detections: dict, *, threshold: float = 0.8,
                            max_boxes: int | None = None):
    """Detections scoring above ``threshold`` as ground truth (reference
    ``threshold_bbox``): ``(boxes, classes, valid)`` with the others zeroed,
    cut to the first ``max_boxes`` slots."""
    valid = detections["valid"] & (detections["scores"] > threshold)
    boxes = torch.where(valid[..., None], detections["boxes"], 0.0)
    classes = torch.where(valid, detections["classes"], 0).to(torch.int32)
    if max_boxes is not None:
        boxes, classes, valid = boxes[:, :max_boxes], classes[:, :max_boxes], valid[:, :max_boxes]
    return boxes, classes, valid


def make_mt_step(model, optimizer: Optimizer, *, unsup_weight: float = 1.0,
                 dis_weight: float = 0.1, pseudo_threshold: float = 0.8,
                 gt_cap: int = 20, with_cross_domain: bool = False) -> Callable:
    """The mean-teacher step of ``ttdg_mgm_tpu/engine/steps.py:make_mt_step``.
    Returns ``step(teacher, batch, generator=None, *, uniforms=None) ->
    metrics`` for the two-crop batch (``data/loader.py:build_two_crop_loader``)
    on the model's device:

    - the teacher detects on ``unlabel_weak`` (no gradient) and its
      detections scoring above ``pseudo_threshold``, cut to ``gt_cap``, are
      the pseudo-labels;
    - the student's loss is the supervised losses on ``label_strong``, plus
      ``unsup_weight`` times the pseudo-labelled pass's ``loss_cls`` and
      ``loss_rpn_cls`` on ``unlabel_strong`` (its box regression weighted 0,
      no mask head, no matching loss), plus ``dis_weight`` times the two
      domain losses on ``label_weak`` and ``unlabel_weak``;
    - with ``with_cross_domain``, plus the sum of the cross-domain head's
      losses (``MaskRCNN.loss_cross_domain`` on the strong views, source
      nodes from the GT boxes, target nodes from the pseudo-boxes) at
      weight 1; the head's EMA class centers are state the caller threads
      through: ``step(teacher, centers, batch, generator=None, *,
      uniforms=None) -> (metrics, new_centers)``;
    - one SGD step.  The teacher's moving average is a separate call
      (:func:`ema_update`).

    The sampling uniforms are ``uniforms["sup"]`` and ``uniforms["unsup"]``,
    each as ``MaskRCNN.loss_supervised`` takes them, and the head's
    completion noise ``uniforms["cd"]`` (``CrossDomainGraphHead.noise_shape``),
    or drawn from ``generator`` in that order.  ``metrics`` holds the
    supervised losses, the pseudo pass's with the suffix ``_pseudo``,
    ``loss_D_img_s``, ``loss_D_img_t``, the head's losses and
    ``total_loss``, detached on the device."""
    def run(teacher, centers, batch, generator, uniforms):
        uniforms = uniforms or {}
        det = teacher.proposals_weak(batch["unlabel_weak"], batch["unlabel_sizes"])
        p_boxes, p_classes, p_valid = threshold_pseudo_labels(
            det, threshold=pseudo_threshold, max_boxes=gt_cap)
        optimizer.zero_grad()
        sup = model.loss_supervised(
            batch["label_strong"], batch["label_sizes"], batch["gt_boxes"],
            batch["gt_classes"], batch["gt_masks"], batch["gt_valid"], generator=generator,
            uniforms=uniforms.get("sup"))
        unsup = model.loss_supervised(
            batch["unlabel_strong"], batch["unlabel_sizes"], p_boxes, p_classes,
            torch.zeros_like(batch["gt_masks"][:, :p_boxes.shape[1]]), p_valid,
            generator=generator, uniforms=uniforms.get("unsup"), source=False,
            with_mask=False)
        dom = model.loss_domain(batch["label_weak"], batch["unlabel_weak"])
        total = (sum(sup.values())
                 + (unsup["loss_cls"] + unsup["loss_rpn_cls"]) * unsup_weight
                 + (dom["loss_D_img_s"] + dom["loss_D_img_t"]) * dis_weight)
        cd = {}
        if with_cross_domain:
            noise = uniforms.get("cd")
            if noise is None:
                noise = model.cross_domain.draw_noise(generator, batch["label_strong"].device)
            cd, centers = model.loss_cross_domain(
                batch["label_strong"], batch["label_sizes"], batch["gt_boxes"],
                batch["gt_classes"], batch["gt_valid"], batch["unlabel_strong"],
                batch["unlabel_sizes"], p_boxes, p_classes, p_valid, centers, noise=noise)
            total = total + sum(cd.values())
        total.backward()
        metrics = {**sup, **{k + "_pseudo": v for k, v in unsup.items()}, **dom, **cd,
                   "total_loss": total}
        metrics = reduce_step(optimizer, metrics, *([centers] if with_cross_domain else []))
        optimizer.step()
        return metrics, centers

    if with_cross_domain:
        def step(teacher, centers, batch, generator=None, *, uniforms=None):
            return run(teacher, centers, batch, generator, uniforms)
    else:
        def step(teacher, batch, generator=None, *, uniforms=None):
            return run(teacher, None, batch, generator, uniforms)[0]
    return step
