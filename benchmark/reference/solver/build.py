"""Optimizer and learning-rate schedules: SGD with momentum and uniform
weight decay, optional gradient clipping.

Counterpart of ``ttdg_mgm_tpu/solver/build.py``: ``build_optimizer`` and
``trainable_mask`` (``optax`` chain ``clip`` -> ``add_decayed_weights`` ->
``sgd`` with momentum, frozen leaves set to zero) and the reference's
schedules (``warmup_multistep_schedule``, ``warmup_two_stage_schedule``,
``warmup_cosine_schedule``: pure ``step -> lr`` functions), with the same
semantics:

* weight decay is uniform: one value for every trainable parameter, no d2
  per-group rules;
* every trainable parameter is decayed on every step, also one that got no
  gradient (``U``, which the TTA loss detaches) -- ``torch.optim.SGD`` skips
  parameters whose ``.grad`` is ``None``, so :meth:`Optimizer.step` gives
  them zero gradients first;
* frozen parameters (the stem and ``res2 .. res{freeze_at}``; FrozenBN
  affines are buffers here) are not in the optimizer at all;
* gradient clipping (d2 ``SOLVER.CLIP_GRADIENTS``) acts on the raw
  gradients of the trainable parameters, before weight decay and momentum.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def _warmup_factor(step: float, warmup_iters: int, warmup_factor: float) -> float:
    alpha = min(step / max(warmup_iters, 1), 1.0)
    return 1.0 if step >= warmup_iters else warmup_factor * (1 - alpha) + alpha


def warmup_multistep_schedule(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                              warmup_iters: int = 1000, warmup_factor: float = 0.001):
    """Reference ``WarmupMultiStepLR``: linear warm-up, then ``gamma`` at each
    of ``steps``."""
    steps = tuple(steps)

    def schedule(count: int) -> float:
        decay = gamma ** sum(1 for s in steps if count >= s)
        return base_lr * decay * _warmup_factor(count, warmup_iters, warmup_factor)

    return schedule


def warmup_two_stage_schedule(base_lr: float, milestones: Sequence[int],
                              factor_list: Sequence[float], warmup_iters: int = 1000,
                              warmup_factor: float = 0.001):
    """Reference ``WarmupTwoStageMultiStepLR``: one LR factor per interval
    between ``milestones``."""
    milestones = tuple(milestones)
    factor_list = tuple(factor_list)
    if len(factor_list) != len(milestones) + 1:
        raise ValueError("factor_list needs one factor more than milestones")

    def schedule(count: int) -> float:
        factor = factor_list[sum(1 for m in milestones if count >= m)]
        return base_lr * factor * _warmup_factor(count, warmup_iters, warmup_factor)

    return schedule


def warmup_cosine_schedule(base_lr: float, max_iters: int, warmup_iters: int = 1000,
                           warmup_factor: float = 0.001):
    """Reference ``WarmupCosineLR``."""

    def schedule(count: int) -> float:
        cos = 0.5 * (1.0 + math.cos(math.pi * count / max_iters))
        return base_lr * cos * _warmup_factor(count, warmup_iters, warmup_factor)

    return schedule


@torch.no_grad()
def clip_gradients(params, clip_type: str, clip_value: float) -> None:
    """Clip the ``.grad`` of ``params`` in place: ``"value"`` clamps each
    element to ``±clip_value``; ``"norm"`` scales all of them by
    ``clip_value / norm`` when their global L2 norm reaches ``clip_value``
    (``optax.clip`` / ``clip_by_global_norm``)."""
    grads = [p.grad for p in params if p.grad is not None]
    if clip_type == "value":
        for g in grads:
            g.clamp_(-clip_value, clip_value)
    elif clip_type == "norm":
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        for g in grads:
            g.copy_(torch.where(norm < clip_value, g, g / norm * clip_value))
    else:
        raise ValueError(f"clip_type must be 'value' or 'norm', got {clip_type!r}")


def trainable_mask(model: torch.nn.Module, *, freeze_at: int = 2) -> dict:
    """``{name: trainable}`` over ``model.named_parameters()``: False for the
    stem (``freeze_at >= 1``), stages ``res2 .. res{freeze_at}`` and any norm.
    As in the JAX package, the freeze goes by those names, which a VGG trunk
    (``backbone.bottom_up.features.*``) never has: all its convs train
    whatever ``freeze_at`` says."""
    frozen = [f"backbone.bottom_up.res{i}." for i in range(2, freeze_at + 1)]
    if freeze_at >= 1:
        frozen.append("backbone.bottom_up.stem.")
    out = {}
    for name, _ in model.named_parameters():
        parts = name.split(".")
        is_norm = any(p == "norm" or p.endswith("_norm") for p in parts[:-1])
        out[name] = not (is_norm or name.startswith(tuple(frozen)))
    return out


class Optimizer:
    """SGD (momentum, uniform weight decay) over the trainable parameters,
    with the learning rate from ``schedule(step)``."""

    def __init__(self, params, schedule: Callable[[int], float], *, momentum: float,
                 weight_decay: float, clip: dict | None = None):
        self.params = list(params)
        self.schedule = schedule
        self.clip = clip
        self.count = 0
        self.sgd = torch.optim.SGD(self.params, lr=float(schedule(0)), momentum=momentum,
                                   weight_decay=weight_decay)

    def zero_grad(self):
        self.sgd.zero_grad(set_to_none=True)

    def step(self):
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.clip:
            clip_gradients(self.params, self.clip["type"], self.clip["value"])
        for g in self.sgd.param_groups:
            g["lr"] = float(self.schedule(self.count))
        self.sgd.step()
        self.count += 1


def build_optimizer(model: torch.nn.Module, schedule: Callable[[int], float], *,
                    momentum: float = 0.9, weight_decay: float = 1e-4,
                    freeze_at: int = 2, clip: dict | None = None) -> Optimizer:
    """Freeze what :func:`trainable_mask` freezes (``requires_grad=False``)
    and return the optimizer over the rest.  ``clip``: ``{"type": "value"
    or "norm", "value": float}`` (d2 ``CLIP_TYPE``, ``CLIP_VALUE``; the norm
    is L2) or None."""
    mask = trainable_mask(model, freeze_at=freeze_at)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return Optimizer(params, schedule, momentum=momentum, weight_decay=weight_decay, clip=clip)
