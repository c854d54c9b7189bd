"""Dice / E-measure / S-measure evaluator (host side, NumPy and SciPy).

This package's own copy of ``ttdg_mgm_tpu/evaluation/dice.py``: predictions
above the score threshold are matched per class to their best ground-truth
mask, and the metrics are

* **Dice** ``2|P & G| / (|P| + |G| + eps)``;
* **E-measure** (enhanced alignment, IJCAI'18): adaptive threshold at
  ``2 * mean(pred)``, alignment of the mean-centred maps, quadratic
  enhancement;
* **S-measure** (structure measure, ICCV'17): an object term (foreground and
  background apart) and a region term (SSIM over the four quadrants around
  the GT centroid), alpha 0.5.

Each prediction's best-match scores are kept in percent and averaged at
``evaluate()``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def dice_coefficient(pred: np.ndarray, gt: np.ndarray) -> float:
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    inter = np.logical_and(pred, gt).sum()
    return float(2.0 * inter / (pred.sum() + gt.sum() + 1e-6))


def enhanced_align(pred: np.ndarray, gt: np.ndarray) -> float:
    """E-measure with the reference's adaptive binarization of the pred."""
    pred = np.asarray(pred, np.float64)
    gt_b = np.asarray(gt, bool)
    th = min(2.0 * pred.mean(), 1.0)
    fm = (pred >= th).astype(np.float64)
    dgt = gt_b.astype(np.float64)
    if dgt.sum() == 0:
        enhanced = 1.0 - fm
    elif (~gt_b).sum() == 0:
        enhanced = fm
    else:
        afm = fm - fm.mean()
        agt = dgt - dgt.mean()
        align = 2.0 * agt * afm / (agt * agt + afm * afm + 1e-8)
        enhanced = (align + 1.0) ** 2 / 4.0
    h, w = gt_b.shape
    return float(enhanced.sum() / (h * w - 1 + 1e-8))


def _s_object(x_map: np.ndarray, region: np.ndarray) -> float:
    vals = x_map[region]
    if vals.size == 0:
        return 0.0
    x = vals.mean()
    sigma = vals.std()
    return float(2.0 * x / (x * x + 1.0 + sigma + 1e-8))


def _ssim(p: np.ndarray, g: np.ndarray) -> float:
    g = g.astype(np.float64)
    p = p.astype(np.float64)
    n = p.size
    if n <= 1:
        return 1.0 if p.size == g.size else 0.0
    x, y = p.mean(), g.mean()
    sx, sy = p.var(), g.var()
    sxy = ((p - x) * (g - y)).sum() / (n - 1)
    alpha = 4.0 * x * y * sxy
    beta = (x * x + y * y) * (sx + sy)
    if alpha != 0:
        return float(alpha / (beta + 1e-8))
    return 1.0 if beta == 0 else 0.0


def structure_measure(pred: np.ndarray, gt: np.ndarray, alpha: float = 0.5) -> float:
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt) > 0.5
    y = gt.mean()
    if y == 0:
        return float(1.0 - pred.mean())
    if y == 1:
        return float(pred.mean())

    # object-aware term
    u = gt.mean()
    obj = u * _s_object(pred * gt, gt) + (1 - u) * _s_object(
        (1.0 - pred) * (~gt), ~gt
    )

    # region-aware term: split at GT centroid (+1 offset as in the reference)
    cy, cx = ndimage.center_of_mass(gt)
    cy = int(round(cy)) + 1
    cx = int(round(cx)) + 1
    h, w = gt.shape
    area = h * w
    quads_g = [gt[:cy, :cx], gt[:cy, cx:], gt[cy:, :cx], gt[cy:, cx:]]
    quads_p = [pred[:cy, :cx], pred[:cy, cx:], pred[cy:, :cx], pred[cy:, cx:]]
    weights = [cy * cx / area, cy * (w - cx) / area, (h - cy) * cx / area,
               (h - cy) * (w - cx) / area]
    region = sum(wt * _ssim(p, g) for wt, p, g in zip(weights, quads_p, quads_g))
    return float(alpha * obj + (1 - alpha) * region)


class DiceEvaluator:
    """Streaming evaluator with the reference's per-prediction best-match
    aggregation.  ``process`` consumes already-decoded binary masks so it is
    front-end agnostic (reference decodes RLE inside; here decoding lives in
    the data layer / ``utils.rle``)."""

    def __init__(self, dataset_name: str = "", score_threshold: float = 0.9):
        self.dataset_name = dataset_name
        self.score_threshold = score_threshold
        self.reset()

    def reset(self):
        self.dice_scores = []
        self.ea_scores = []
        self.sm_scores = []

    def process(self, pred_masks, pred_classes, pred_scores, gt_masks, gt_classes):
        """One image: arrays/lists of per-instance binary (H, W) masks."""
        for pm, pc, ps in zip(pred_masks, pred_classes, pred_scores):
            if ps < self.score_threshold:
                continue
            best_d = best_e = best_s = 0.0
            for gm, gc in zip(gt_masks, gt_classes):
                if pc != gc:
                    continue
                best_d = max(best_d, dice_coefficient(pm, gm))
                best_e = max(best_e, enhanced_align(pm, gm))
                best_s = max(best_s, structure_measure(pm, gm))
            self.dice_scores.append(best_d * 100.0)
            self.ea_scores.append(best_e * 100.0)
            self.sm_scores.append(best_s * 100.0)

    def evaluate(self) -> dict:
        if not self.dice_scores:
            return {
                "Dice Coefficient": float("nan"),
                "Enhanced Alignment Metric": float("nan"),
                "Structural Similarity Metric": float("nan"),
            }
        return {
            "Dice Coefficient": float(np.mean(self.dice_scores)),
            "Enhanced Alignment Metric": float(np.mean(self.ea_scores)),
            "Structural Similarity Metric": float(np.mean(self.sm_scores)),
        }
