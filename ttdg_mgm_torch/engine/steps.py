"""The source-training and test-time-adaptation steps.

Counterparts of ``ttdg_mgm_tpu/engine/steps.py:make_source_step`` (one SGD
step on the sum of ``MaskRCNN.loss_supervised``'s losses) and
``make_tta_step`` (one SGD step on ``MaskRCNN.loss_ttt`` per test batch).
Losses are taken before the update; the parameters update in place.
"""

from __future__ import annotations

from typing import Callable

import torch

from ttdg_mgm_torch.solver.build import Optimizer


def make_source_step(model, optimizer: Optimizer) -> Callable[..., dict]:
    """Returns ``step(batch, generator=None, *, uniforms=None) -> metrics``
    for batches ``{"image", "image_sizes", "gt_boxes", "gt_classes",
    "gt_masks", "gt_valid"}`` on the model's device (``synth.synth_batch(...,
    with_gt=True)`` lays one out).  The sampling uniforms come from
    ``generator``, or pre-drawn from ``uniforms`` (see
    ``MaskRCNN.loss_supervised``).  ``metrics`` holds every loss and
    ``total_loss``, detached on the device."""

    def step(batch, generator=None, *, uniforms=None):
        optimizer.zero_grad()
        losses = model.loss_supervised(
            batch["image"], batch["image_sizes"], batch["gt_boxes"], batch["gt_classes"],
            batch["gt_masks"], batch["gt_valid"], generator=generator, uniforms=uniforms)
        total = sum(losses.values())
        total.backward()
        optimizer.step()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        return metrics

    return step


def make_tta_step(model, optimizer: Optimizer) -> Callable[[dict], torch.Tensor]:
    """Returns ``step(batch) -> loss`` for batches ``{"image": (B, H, W, 3),
    "image_sizes": (B, 2)}`` on the model's device."""

    def step(batch):
        optimizer.zero_grad()
        loss = model.loss_ttt(batch["image"], batch["image_sizes"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
