"""The eval-only TTA loop: per test dataset, one SGD step on the
multi-graph-matching loss per batch, then inference, mask paste and Dice.

Counterpart of ``ttdg_mgm_tpu/engine/trainer.py`` for the eval-only path:
``postprocess_detections``, ``evaluate_dataset`` (with its ``Inference done
... s/iter`` log lines), ``aggregate_family_means`` and
``BaselineTrainer.test``.  The adaptation persists across datasets within
one call, as in the JAX package and the reference (which adapts the model in
place); ``reset_between_datasets`` restores the weights, the momentum
buffers and the step count before each dataset.

The device work of a batch is the model's (``engine/steps.py``,
``MaskRCNN.forward_inference``) and the mask paste (``ops/mask_paste.py``),
on the model's device; this module is host-side orchestration.  Source
training (``BaselineTrainer.train``, its loader, hooks and checkpoints) is
not ported yet.
"""

from __future__ import annotations

import copy
import logging
import time
from collections import defaultdict

import numpy as np
import torch

from ttdg_mgm_torch.data.catalog import DatasetCatalog
from ttdg_mgm_torch.data.loader import build_test_loader
from ttdg_mgm_torch.engine.steps import make_tta_step
from ttdg_mgm_torch.evaluation.build import build_evaluator, flatten_results
from ttdg_mgm_torch.ops.mask_paste import paste_masks
from ttdg_mgm_torch.utils.rle import segmentation_to_mask

logger = logging.getLogger("ttdg_mgm_torch")

#: the visualizer (``TEST.DRAW``) is a later slice's
_NO_DRAW = ("drawing detections (TEST.DRAW) needs utils/visualize.py, which is not ported "
            "to ttdg_mgm_torch yet (ROADMAP.md, Queue 1: the COCO and VOC evaluators, the "
            "visualizer and bench.py)")


def postprocess_detections(det: dict, meta: dict, b: int, *, mask_threshold: float = 0.5,
                           score_floor: float = 0.0) -> dict:
    """Detections of image ``b`` rescaled to its original size, with their
    masks pasted there (d2 ``detector_postprocess``).  ``det`` holds
    ``forward_inference``'s tensors; the paste runs on their device.
    Returns NumPy arrays: boxes, scores, classes and ``(n, H, W)`` uint8
    masks."""
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
    masks = paste_masks(probs, boxes, oh, ow, threshold=mask_threshold)
    return {"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
            "classes": classes.cpu().numpy(), "masks": masks.cpu().numpy()}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_dataset(model, dataset_name: str, *, canvas: int | str = "auto",
                     min_size: int = 800, max_size: int = 1333, batch_size: int = 1,
                     dice_threshold: float = 0.9, log_every: int = 50,
                     draw_dir: str | None = None, evaluator_type: str | None = None) -> dict:
    """Inference and evaluation over one dataset, on the model's device, with
    the reference's s/iter breakdown in the log.  The evaluator follows the
    dataset's ``evaluator_type`` (Dice when unset); ``evaluator_type``
    overrides it.  Returns one flat dict of scalars."""
    if draw_dir is not None:
        raise NotImplementedError(_NO_DRAW)
    device = next(model.parameters()).device
    loader = build_test_loader(dataset_name, batch_size=batch_size, canvas=canvas,
                               min_size=min_size, max_size=max_size)
    evaluator, _ = build_evaluator(dataset_name, dice_threshold=dice_threshold,
                                   evaluator_type=evaluator_type,
                                   mask_on=getattr(model, "mask_on", True))
    # parse the dataset once and index its records by image_id
    records_by_id = {r["image_id"]: r for r in DatasetCatalog.get(dataset_name)}

    n_img = 0
    t_data = t_compute = t_eval = 0.0
    t0 = time.perf_counter()
    for batch, metas in loader:
        t_data += time.perf_counter() - t0
        t1 = time.perf_counter()
        det = model.forward_inference(torch.from_numpy(batch["image"]).to(device),
                                      torch.from_numpy(batch["image_sizes"]).to(device))
        _sync(device)
        t_compute += time.perf_counter() - t1
        t2 = time.perf_counter()
        for b, meta in enumerate(metas[:metas[0]["n_real"]]):
            out = postprocess_detections(det, meta, b)
            record = records_by_id[meta["image_id"]]
            anns = record["annotations"]
            gt_masks = [segmentation_to_mask(a["segmentation"], record["height"],
                                             record["width"]) for a in anns]
            evaluator.process(out["masks"], out["classes"], out["scores"], gt_masks,
                              [a["category_id"] for a in anns])
            n_img += 1
        t_eval += time.perf_counter() - t2
        if n_img % log_every < batch_size:
            tot = max(n_img, 1)
            logger.info("Inference done %d img. Dataloading: %.4f s/iter. Inference: "
                        "%.4f s/iter. Eval: %.4f s/iter.",
                        n_img, t_data / tot, t_compute / tot, t_eval / tot)
        t0 = time.perf_counter()
    logger.info("Total inference time: %.4fs (%.6f s / iter per device)",
                t_data + t_compute + t_eval, t_compute / max(n_img, 1))
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
    """Eval-only TTA over test datasets with ``model`` (its weights are the
    state) and ``optimizer`` (``solver/build.py:Optimizer``, its step count
    drives the learning-rate schedule)."""

    def __init__(self, model, optimizer, *, min_size: int = 800, max_size: int = 1333,
                 test_canvas: int | str = "auto"):
        self.model = model
        self.optimizer = optimizer
        # test geometry: "auto" is d2's ResizeShortestEdge(min_size, max_size)
        # on per-batch rectangular buckets; an integer keeps the square fit
        self.test_canvas = test_canvas
        self.min_size = min_size
        self.max_size = max_size
        self._tta_step = make_tta_step(model, optimizer)
        self.last_tta_loss = 0.0

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
        batches), then evaluation at that batch size (1 without ``ttt``).
        Returns each dataset's metrics and each family's means."""
        if draw_dir is not None:
            raise NotImplementedError(_NO_DRAW)
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
                    loss = self._tta_step({"image": torch.from_numpy(batch["image"]).to(dev),
                                           "image_sizes": torch.from_numpy(
                                               batch["image_sizes"]).to(dev)})
                if loss is not None:
                    self.last_tta_loss = float(loss)
                    logger.info("TTA on %s: final loss %.5f", name, self.last_tta_loss)
            results[name] = evaluate_dataset(
                self.model, name, canvas=self.test_canvas, min_size=self.min_size,
                max_size=self.max_size, batch_size=tta_batch if ttt else 1,
                dice_threshold=dice_threshold, evaluator_type=evaluator_type)
            logger.info("Results %s: %s", name, results[name])
        return aggregate_family_means(results)
