"""Trainers: supervised source training and the eval-only TTA loop.

Counterpart of ``ttdg_mgm_tpu/engine/trainer.py``: ``postprocess_detections``,
``evaluate_dataset`` (with its ``Inference done ... s/iter`` log lines and
the Dice, COCO and VOC evaluators), ``aggregate_family_means`` and
``BaselineTrainer`` with ``train`` (one SGD step on the supervised losses
per batch, hooks on every iteration), its state and resume, and ``test``
(per test dataset, one SGD step on the multi-graph-matching loss per batch,
then inference, mask paste and evaluation).  The adaptation persists across
datasets within one call, as in the JAX package and the reference (which
adapts the model in place); ``reset_between_datasets`` restores the
weights, the momentum buffers and the step count before each dataset.

Resume follows the JAX package: the state is the weights, the SGD momentum
and the step count (which drives the schedule), and ``train`` runs from
that count to ``max_iter`` with its loader and its sampling generator
seeded with ``seed`` again, so a resumed run sees the stream of batches
from its start, not from where the saved run stopped.

The device work of a batch is the model's (``engine/steps.py``,
``MaskRCNN.forward_inference``) and the mask paste (``ops/mask_paste.py``),
on the model's device; this module is host-side orchestration.

Data parallel (``parallel/mesh.py``; JAX ``_put_batch``): every rank runs
the same seeded loader, so each holds the global batch bit for bit as a
single process loads it, and steps on its own shard of it; the weights are
replicated and stay so, since every rank applies the same averaged
gradients.  Each rank draws its sampling uniforms from its own generator,
seeded with :func:`rank_seed`.  In ``test`` the TTA steps are sharded the
same way and the evaluation runs whole on every rank, as in the JAX
package.  Without a process group all of this is the single-process run.
"""

from __future__ import annotations

import copy
import logging
import os
import time
from collections import defaultdict

import numpy as np
import torch

from ttdg_mgm_torch.data.catalog import DatasetCatalog
from ttdg_mgm_torch.data.loader import build_test_loader, build_train_loader, load_image
from ttdg_mgm_torch.engine.steps import make_source_step, make_tta_step
from ttdg_mgm_torch.evaluation.build import build_evaluator, flatten_results
from ttdg_mgm_torch.parallel import mesh
from ttdg_mgm_torch.ops.mask_paste import paste_masks
from ttdg_mgm_torch.utils.profiling import span
from ttdg_mgm_torch.utils.rle import segmentation_to_mask
from ttdg_mgm_torch.utils.visualize import dump_visualization

logger = logging.getLogger("ttdg_mgm_torch")


def postprocess_detections(det: dict, meta: dict, b: int, *, mask_threshold: float = 0.5,
                           score_floor: float = 0.0) -> dict:
    """Detections of image ``b`` rescaled to its original size, with their
    masks pasted there (d2 ``detector_postprocess``).  ``det`` holds
    ``forward_inference``'s tensors; the paste runs on their device.
    Returns NumPy arrays: boxes, scores, classes and ``(n, H, W)`` uint8
    masks.  Spans (``utils/profiling.py``), keyed by the image's
    ``image_id`` when ``meta`` has one: ``eval.postprocess`` around it all,
    ``eval.paste_masks`` around the paste and ``eval.to_host`` around the
    copies to host memory."""
    key = meta.get("image_id")
    with span("eval.postprocess", key):
        sy, sx = meta["scale"]
        valid = det["valid"][b]
        keep = det["scores"][b][valid] >= score_floor
        boxes = det["boxes"][b][valid][keep]
        scores = det["scores"][b][valid][keep]
        classes = det["classes"][b][valid][keep]
        probs = det["mask_probs"][b][valid][keep]
        oh, ow = meta["orig_height"], meta["orig_width"]
        boxes = boxes / torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=boxes.device)
        boxes[:, 0::2] = boxes[:, 0::2].clamp(0, ow)
        boxes[:, 1::2] = boxes[:, 1::2].clamp(0, oh)
        with span("eval.paste_masks", key):
            masks = paste_masks(probs, boxes, oh, ow, threshold=mask_threshold)
        with span("eval.to_host", key):
            return {"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
                    "classes": classes.cpu().numpy(), "masks": masks.cpu().numpy()}


def rank_seed(seed: int) -> int:
    """The seed of this rank's sampling generator: ``seed + rank * 2**32``,
    so rank 0 (and a single process) draws as before, and the ranks draw
    apart (the JAX steps fold the shard index into the step's key)."""
    return seed + (mesh.rank() << 32)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_dataset(model, dataset_name: str, *, canvas: int | str = "auto",
                     min_size: int = 800, max_size: int = 1333, batch_size: int = 1,
                     dice_threshold: float = 0.9, log_every: int = 50,
                     draw_dir: str | None = None, evaluator_type: str | None = None) -> dict:
    """Inference and evaluation over one dataset, on the model's device, with
    the reference's s/iter breakdown in the log.  The evaluator follows the
    dataset's ``evaluator_type`` (Dice when unset): Dice, E and S; COCO AP
    (box, and mask with a mask head; crowd GT as ignore regions); or VOC
    mAP (difficult GT ignored).  ``evaluator_type`` overrides it.  Returns
    one flat dict of scalars.

    The mask AP needs a mask for every GT: a dataset with an annotation
    whose ``segmentation`` is None raises ``ValueError`` before inference
    (the JAX package raises ``TypeError`` in the middle of the loop).

    ``draw_dir`` (``TEST.DRAW``): each evaluated image's original is loaded
    and its postprocessed detections dumped under ``<draw_dir>/visual`` and
    ``<draw_dir>/masks`` (``utils/visualize.py:dump_visualization``) before
    they are scored.  The dumps' seconds are kept out of the ``Eval`` figure
    of the s/iter lines and logged on a line of their own.

    Spans (``utils/profiling.py``): ``eval.inference`` around each batch's
    ``forward_inference`` (keyed by the batch's index), and per image
    (keyed by its ``image_id``) :func:`postprocess_detections`'s own,
    ``eval.draw``, ``eval.gt_masks`` (the GT rasterisation) and
    ``eval.score`` (the evaluator's ``process``)."""
    device = next(model.parameters()).device
    evaluator, etype = build_evaluator(dataset_name, dice_threshold=dice_threshold,
                                       evaluator_type=evaluator_type,
                                       mask_on=getattr(model, "mask_on", True))
    # parse the dataset once and index its records by image_id
    records_by_id = {r["image_id"]: r for r in DatasetCatalog.get(dataset_name)}
    with_segm = etype == "coco" and "segm" in evaluator.iou_types
    if with_segm:
        n_none = sum(a.get("segmentation") is None for r in records_by_id.values()
                     for a in r["annotations"])
        if n_none:
            raise ValueError(f"{dataset_name}: {n_none} annotations have no segmentation, so the "
                             "COCO mask AP cannot be computed; evaluate boxes only with "
                             "MODEL.MASK_ON False")
    loader = build_test_loader(dataset_name, batch_size=batch_size, canvas=canvas,
                               min_size=min_size, max_size=max_size)

    n_img = 0
    t_data = t_compute = t_eval = t_draw = 0.0
    t0 = time.perf_counter()
    for idx, (batch, metas) in enumerate(loader):
        t_data += time.perf_counter() - t0
        t1 = time.perf_counter()
        with span("eval.inference", idx):
            det = model.forward_inference(torch.from_numpy(batch["image"]).to(device),
                                          torch.from_numpy(batch["image_sizes"]).to(device))
            _sync(device)
        t_compute += time.perf_counter() - t1
        t2 = time.perf_counter()
        drawn = 0.0
        for b, meta in enumerate(metas[:metas[0]["n_real"]]):
            image_id = meta["image_id"]
            out = postprocess_detections(det, meta, b)
            record = records_by_id[image_id]
            if draw_dir is not None:
                t3 = time.perf_counter()
                with span("eval.draw", image_id):
                    dump_visualization(draw_dir, image_id, load_image(record["file_name"]), out)
                drawn += time.perf_counter() - t3
            anns = record["annotations"]
            gt_classes = [a["category_id"] for a in anns]
            with span("eval.gt_masks", image_id):
                gt_masks = ([segmentation_to_mask(a["segmentation"], record["height"],
                                                  record["width"]) for a in anns]
                            if etype == "dice" or with_segm else None)
            gt_boxes = np.asarray([a["bbox"] for a in anns], np.float64).reshape(-1, 4)
            with span("eval.score", image_id):
                if etype == "dice":
                    evaluator.process(out["masks"], out["classes"], out["scores"], gt_masks,
                                      gt_classes)
                elif etype == "coco":
                    evaluator.process(det_boxes=out["boxes"], det_scores=out["scores"],
                                      det_classes=out["classes"],
                                      det_masks=list(out["masks"]) if with_segm else None,
                                      gt_boxes=gt_boxes, gt_classes=gt_classes,
                                      gt_masks=gt_masks,
                                      gt_crowd=[a.get("iscrowd", 0) for a in anns])
                else:
                    evaluator.process(out["boxes"], out["scores"], out["classes"], gt_boxes,
                                      gt_classes,
                                      gt_difficult=[a.get("difficult", 0) for a in anns])
            n_img += 1
        t_eval += time.perf_counter() - t2 - drawn
        t_draw += drawn
        if n_img % log_every < batch_size:
            tot = max(n_img, 1)
            logger.info("Inference done %d img. Dataloading: %.4f s/iter. Inference: "
                        "%.4f s/iter. Eval: %.4f s/iter.",
                        n_img, t_data / tot, t_compute / tot, t_eval / tot)
        t0 = time.perf_counter()
    logger.info("Total inference time: %.4fs (%.6f s / iter per device)",
                t_data + t_compute + t_eval, t_compute / max(n_img, 1))
    if draw_dir is not None:
        logger.info("Visualization dumps of %d img under %s: %.4f s/iter.", n_img, draw_dir,
                    t_draw / max(n_img, 1))
    return flatten_results(evaluator.evaluate())


def aggregate_family_means(results: dict) -> dict:
    """Per-family means: datasets grouped by the name before the first
    ``_``, each family's metrics averaged under ``<family>_mean``."""
    fam = defaultdict(lambda: defaultdict(list))
    for name, res in results.items():
        if name.endswith("_mean"):
            continue
        d = name.split("_")[0]
        for metric, value in res.items():
            fam[d][metric].append(value)
    out = dict(results)
    for d, metrics in fam.items():
        out[f"{d}_mean"] = {m: float(np.mean(vs)) for m, vs in metrics.items()}
    return out


class BaselineTrainer:
    """Source training and eval-only TTA with ``model`` (its weights are the
    state) and ``optimizer`` (``solver/build.py:Optimizer``, whose step
    count drives the learning-rate schedule).

    Train geometry: an integer ``canvas`` is the square canvas, ``"auto"``
    d2's per-batch buckets; images are resized to a shortest edge drawn
    from ``train_min_sizes`` (``min_size`` when None) under ``max_size``;
    ``gt_cap`` GT slots per image, GT masks on a ``mask_res`` square grid.
    The test path uses ``test_canvas``, ``min_size`` and ``max_size``."""

    def __init__(self, model, optimizer, *, canvas: int | str = 800, min_size: int = 800,
                 max_size: int = 1333, gt_cap: int = 20, mask_res: int = 256,
                 train_min_sizes=None, test_canvas: int | str = "auto"):
        self.model = model
        self.optimizer = optimizer
        self.canvas = canvas
        # test geometry: "auto" is d2's ResizeShortestEdge(min_size, max_size)
        # on per-batch rectangular buckets; an integer keeps the square fit
        self.test_canvas = test_canvas
        self.min_size = min_size
        self.max_size = max_size
        self.train_min_sizes = train_min_sizes
        self.gt_cap = gt_cap
        self.mask_res = mask_res
        self._source_step = make_source_step(model, optimizer)
        self._tta_step = make_tta_step(model, optimizer)
        self.last_tta_loss = 0.0

    # ---------------- state and resume ----------------
    def state_dict(self) -> dict:
        """What a restart needs, in d2's checkpoint layout: the d2-named
        weights, the SGD state (momentum buffers) and the step count."""
        return {"model": self.model.state_dict(), "optimizer": self.optimizer.sgd.state_dict(),
                "iteration": self.optimizer.count}

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.sgd.load_state_dict(state["optimizer"])
        self.optimizer.count = int(state["iteration"])

    def resume_or_load(self, checkpointer) -> bool:
        """Restore the full state from ``checkpointer``'s latest checkpoint if
        there is one (the CLI forces resume, as the reference's does).
        Returns True when it resumed; otherwise the trainer keeps the weights
        it was built with (``MODEL.WEIGHTS``)."""
        state, resumed = checkpointer.resume_or_load()
        if resumed:
            self.load_state_dict(state)
            logger.info("resumed from checkpoint at iteration %d", self.optimizer.count)
        return resumed

    def default_hooks(self, *, checkpointer=None, checkpoint_period: int = 0,
                      output_dir: str | None = None, log_every: int = 20) -> list:
        """The reference trainers' hooks: the finite-loss guard, periodic
        full-state checkpoints (with ``checkpointer`` and a positive
        ``checkpoint_period``), and the ``metrics.json`` and terminal writers
        (with ``output_dir``, on the main process only), every
        ``log_every`` iterations."""
        from ttdg_mgm_torch.engine.hooks import (AnomalyDetectionHook, PeriodicCheckpointHook,
                                                 WriterHook)
        from ttdg_mgm_torch.utils.events import EventStorage, JSONWriter, TerminalWriter

        hooks = [AnomalyDetectionHook(period=log_every)]
        if checkpointer is not None and checkpoint_period > 0:
            hooks.append(PeriodicCheckpointHook(checkpointer, self, checkpoint_period))
        if output_dir is not None and mesh.is_main_process():
            writers = [JSONWriter(os.path.join(output_dir, "metrics.json")), TerminalWriter()]
            hooks.append(WriterHook(EventStorage(self.optimizer.count), writers,
                                    period=log_every))
        return hooks

    def train(self, dataset_names, *, max_iter: int, batch_size: int = 8, seed: int = 0,
              log_every: int = 20, hooks=()) -> None:
        """Source training from the optimizer's step count to ``max_iter``:
        one SGD step on the summed supervised losses per batch of
        ``batch_size`` labelled images of ``dataset_names`` (this rank's
        shard of it).  The loader and the sampling generator (on the model's
        device) are seeded with ``seed`` (:func:`rank_seed`) on every call.
        Each hook is called on every iteration with the step's losses on the
        device, and a hook's ``after_train(it, metrics)``, if it has one,
        after the last; every ``log_every`` iterations the losses are
        logged.  Spans (``utils/profiling.py``), keyed by the iteration:
        ``trainer.source_step`` around the step's call (the batch's copy to
        the device included) and ``trainer.hooks`` around the hooks."""
        dev = next(self.model.parameters()).device
        loader = build_train_loader(
            dataset_names, batch_size=batch_size, canvas=self.canvas, min_size=self.min_size,
            max_size=self.max_size, gt_cap=self.gt_cap, mask_res=self.mask_res, seed=seed,
            min_size_choices=self.train_min_sizes)
        gen = torch.Generator(device=dev).manual_seed(rank_seed(seed))
        it = metrics = None
        try:
            for it in range(self.optimizer.count, max_iter):
                host = mesh.shard_batch(next(loader))
                with span("trainer.source_step", it):
                    batch = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
                    metrics = self._source_step(batch, gen)
                with span("trainer.hooks", it):
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

    def _snapshot(self):
        return (copy.deepcopy(self.model.state_dict()),
                copy.deepcopy(self.optimizer.sgd.state_dict()), self.optimizer.count)

    def _restore(self, snap) -> None:
        weights, sgd, count = snap
        self.model.load_state_dict(weights)
        # a copy: the optimizer may keep the given buffers and update them
        self.optimizer.sgd.load_state_dict(copy.deepcopy(sgd))
        self.optimizer.count = count

    def test(self, dataset_names, *, ttt: bool = True, tta_batch: int = 4,
             min_batch_num: int | None = None, dice_threshold: float = 0.9,
             reset_between_datasets: bool = False, draw_dir: str | None = None,
             evaluator_type: str | None = None) -> dict:
        """Eval-only TTA over the test datasets: with ``ttt``, one TTA step
        per batch of ``tta_batch`` images (at most ``min_batch_num``
        batches; each rank adapts on its shard), then evaluation at that
        batch size (1 without ``ttt``; whole on every rank), dumping the
        detections under ``draw_dir`` when it is given (the caller passes it
        on the main process only).  Returns each dataset's metrics and each
        family's means.  Each TTA step's call (the batch's copy to the device
        included) is the span ``trainer.tta_step`` (``utils/profiling.py``),
        keyed by the batch's index."""
        results = {}
        source = self._snapshot() if reset_between_datasets else None
        dev = next(self.model.parameters()).device
        for name in dataset_names:
            if reset_between_datasets:
                self._restore(source)
            if ttt:
                loader = build_test_loader(name, batch_size=tta_batch, canvas=self.test_canvas,
                                           min_size=self.min_size, max_size=self.max_size)
                loss = None
                for idx, (batch, _) in enumerate(loader):
                    if min_batch_num is not None and idx >= min_batch_num:
                        break
                    shard = mesh.shard_batch({"image": batch["image"],
                                              "image_sizes": batch["image_sizes"]})
                    with span("trainer.tta_step", idx):
                        loss = self._tta_step({k: torch.from_numpy(v).to(dev)
                                               for k, v in shard.items()})
                if loss is not None:
                    self.last_tta_loss = float(loss)
                    logger.info("TTA on %s: final loss %.5f", name, self.last_tta_loss)
            results[name] = evaluate_dataset(
                self.model, name, canvas=self.test_canvas, min_size=self.min_size,
                max_size=self.max_size, batch_size=tta_batch if ttt else 1,
                dice_threshold=dice_threshold, evaluator_type=evaluator_type, draw_dir=draw_dir)
            logger.info("Results %s: %s", name, results[name])
        return aggregate_family_means(results)
