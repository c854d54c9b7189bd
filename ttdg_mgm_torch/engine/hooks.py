"""Trainer hooks.

This package's own copy of ``ttdg_mgm_tpu/engine/hooks.py``: periodic
full-state checkpoints, periodic test runs, the periodic validation loss
(reference ``LossEvalHook``), a finite-loss guard and the periodic writers,
each with the JAX package's period rule.  The learning-rate schedule lives
in the optimizer (``solver/build.py``), so there is no schedule hook.

Hooks are callables ``hook(iteration, metrics)`` that the trainer calls on
every iteration; ``metrics`` holds the step's losses as tensors on the
device.  A hook reads them on the host only at its own period, so the loop
does not wait on the device at every step.

Data parallel (``parallel/mesh.py``): every rank calls every hook; the
checkpointer writes on the main process only (``checkpoint/save.py``), the
trainers give the writer hook to the main process only, and
``LossEvalHook`` runs whole on every rank, as the JAX hook runs replicated.
"""

from __future__ import annotations

import logging
import math

import torch

logger = logging.getLogger("ttdg_mgm_torch")


def _floats(metrics: dict) -> dict:
    return {k: float(v) for k, v in metrics.items()}


class PeriodicCheckpointHook:
    """Save the trainer's full state (weights, momentum, step count) as the
    checkpoint of step ``it + 1`` whenever ``(it + 1) % period == 0``."""

    def __init__(self, checkpointer, trainer, period: int):
        self.ckpt = checkpointer
        self.trainer = trainer
        self.period = period

    def __call__(self, it: int, metrics: dict):
        if self.period > 0 and (it + 1) % self.period == 0:
            self.ckpt.save(it + 1, self.trainer.state_dict())


class PeriodicEvalHook:
    """``trainer.test(dataset_names, **test_kwargs)`` whenever ``(it + 1) %
    period == 0``; the results land in ``self.results``."""

    def __init__(self, trainer, dataset_names, period: int, **test_kwargs):
        self.trainer = trainer
        self.datasets = dataset_names
        self.period = period
        self.kwargs = test_kwargs
        self.results = []

    def __call__(self, it: int, metrics: dict):
        if self.period > 0 and (it + 1) % self.period == 0:
            self.results.append((it + 1, self.trainer.test(self.datasets, **self.kwargs)))


class LossEvalHook:
    """The mean validation loss whenever ``(it + 1) % period == 0``: the sum
    of ``loss_supervised``'s losses with the current weights, without
    gradients, over ``num_batches`` fixed batches of ``dataset_name`` (the
    train loader at seed 0 without flips, at the trainer's geometry).  Every
    batch and every call draws its sampling uniforms from a generator seeded
    0 (the JAX hook's fixed ``PRNGKey(0)``).  Results land in
    ``self.history``; a non-finite mean raises ``FloatingPointError``."""

    def __init__(self, trainer, dataset_name: str, period: int, num_batches: int = 8,
                 batch_size: int = 2):
        self.trainer = trainer
        self.dataset = dataset_name
        self.period = period
        self.num_batches = num_batches
        self.batch_size = batch_size
        self.history: list[tuple[int, float]] = []
        self._batches = None

    def _build(self):
        from ttdg_mgm_torch.data.loader import build_train_loader

        t = self.trainer
        loader = build_train_loader(
            [self.dataset], batch_size=self.batch_size, canvas=t.canvas, min_size=t.min_size,
            max_size=t.max_size, gt_cap=t.gt_cap, mask_res=t.mask_res, seed=0, flip_prob=0.0,
            prefetch=0)
        self._batches = [next(loader) for _ in range(self.num_batches)]

    @torch.no_grad()
    def __call__(self, it: int, metrics: dict):
        if self.period <= 0 or (it + 1) % self.period != 0:
            return
        if self._batches is None:
            self._build()
        model = self.trainer.model
        dev = next(model.parameters()).device
        total = 0.0
        for batch in self._batches:
            b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            losses = model.loss_supervised(
                b["image"], b["image_sizes"], b["gt_boxes"], b["gt_classes"], b["gt_masks"],
                b["gt_valid"], generator=torch.Generator(device=dev).manual_seed(0))
            total += float(sum(losses.values()))
        mean = total / max(len(self._batches), 1)
        self.history.append((it + 1, mean))
        logger.info("validation loss (%s) at iter %d: %.5f", self.dataset, it + 1, mean)
        if not math.isfinite(mean):
            raise FloatingPointError(f"validation loss became non-finite at iteration={it + 1}")


class AnomalyDetectionHook:
    """Raise ``FloatingPointError`` when a loss is NaN or infinite, checked
    whenever ``it % period == 0``."""

    def __init__(self, period: int = 20):
        self.period = max(period, 1)

    def __call__(self, it: int, metrics: dict):
        if it % self.period != 0:
            return
        for k, v in _floats(metrics).items():
            if math.isnan(v) or math.isinf(v):
                raise FloatingPointError(
                    f"Loss became infinite or NaN at iteration={it}: {k}={v}")


class WriterHook:
    """Put the losses into ``storage`` at iteration ``it`` and flush every
    writer whenever ``(it + 1) % period == 0``; :meth:`after_train` flushes
    the last iteration too when its period did not (d2's ``PeriodicWriter``
    writes once more after training; the JAX package's hook does not)."""

    def __init__(self, storage, writers, period: int = 20):
        self.storage = storage
        self.writers = writers
        self.period = max(period, 1)

    def _write(self, it: int, metrics: dict):
        self.storage.iter = it
        self.storage.put_scalars(**_floats(metrics))
        for w in self.writers:
            w.write(self.storage)

    def __call__(self, it: int, metrics: dict):
        if (it + 1) % self.period == 0:
            self._write(it, metrics)

    def after_train(self, it: int, metrics: dict):
        if (it + 1) % self.period != 0:
            self._write(it, metrics)
