"""COCO-style AP (host-side NumPy, no pycocotools).

This package's own copy of ``ttdg_mgm_tpu/evaluation/coco_eval.py`` (the
reference's vendored d2 ``COCOEvaluator``): AP@[.5:.95], AP50, AP75 and the
small, medium and large area ranges for boxes and masks, with pycocotools'
matching: per image and class, score-sorted detections each take the
highest-IoU unmatched GT at each IoU threshold; crowd GT are ignore regions
whose IoU is over the detection's area; 101-point interpolated precision.

One difference, where the JAX package fails: a class with ground truth and
no detection at all scores AP 0 at every threshold, as in pycocotools; the
JAX evaluator raises ``IndexError`` there (an empty precision array).
"""

from __future__ import annotations

import numpy as np

IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}


def bbox_iou_matrix(dt, gt, gt_crowd=None):
    """Pairwise box IoU; for crowd GTs the denominator is the DETECTION
    area only (pycocotools ``iou(dt, gt, iscrowd=True)`` — a detection fully
    inside a crowd region scores 1 regardless of the region's extent)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1])
    a2 = (gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1])
    union = a1[:, None] + a2[None, :] - inter
    if gt_crowd is not None and gt_crowd.any():
        union = np.where(gt_crowd[None, :], np.broadcast_to(a1[:, None], union.shape), union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                          axis=1).sum(1).astype(np.int64)


def mask_iou_matrix(dt_masks, gt_masks, gt_crowd=None):
    """Pairwise mask IoU via packed bits + popcount (8 pixels/byte, the
    whole D x G grid in one vectorized AND — replaces the O(N*M) Python
    double loop over full-resolution masks).  Crowd GT union = det area
    (pycocotools semantics, reference ``coco_evaluation.py:598-642``)."""
    n, m = len(dt_masks), len(gt_masks)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    dp = np.stack([np.packbits(np.asarray(x, bool).ravel()) for x in dt_masks])
    gp = np.stack([np.packbits(np.asarray(x, bool).ravel()) for x in gt_masks])
    inter = _POPCOUNT[np.bitwise_and(dp[:, None], gp[None, :])].sum(-1)
    da = _POPCOUNT[dp].sum(-1)
    ga = _POPCOUNT[gp].sum(-1)
    union = (da[:, None] + ga[None, :] - inter).astype(np.float64)
    if gt_crowd is not None and gt_crowd.any():
        union = np.where(gt_crowd[None, :],
                         np.broadcast_to(da[:, None].astype(np.float64), union.shape),
                         union)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


class COCOEvaluator:
    """Streaming AP evaluator.  ``process`` takes per-image detections and
    ground truth (already decoded); ``evaluate`` returns the d2-style dict
    ``{"bbox": {AP, AP50, ...}, "segm": {...}}``."""

    def __init__(self, iou_types=("bbox", "segm")):
        self.iou_types = iou_types
        self._images = []

    def reset(self):
        self._images = []

    def process(self, *, det_boxes, det_scores, det_classes, det_masks=None,
                gt_boxes, gt_classes, gt_masks=None, gt_crowd=None):
        """``gt_crowd``: per-GT ``iscrowd`` flags.  Crowd GTs are IGNORE
        regions (pycocotools / reference ``coco_evaluation.py:598-642``):
        they never count toward recall, detections matching them are
        neither TP nor FP, they may absorb multiple detections, and their IoU
        denominator is the detection's own area."""
        n_gt = np.asarray(gt_classes, np.int64).reshape(-1).shape[0]
        self._images.append(dict(
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=np.asarray(det_scores, np.float64).reshape(-1),
            det_classes=np.asarray(det_classes, np.int64).reshape(-1),
            det_masks=det_masks,
            gt_boxes=np.asarray(gt_boxes, np.float64).reshape(-1, 4),
            gt_classes=np.asarray(gt_classes, np.int64).reshape(-1),
            gt_masks=gt_masks,
            gt_crowd=(np.zeros(n_gt, bool) if gt_crowd is None
                      else np.asarray(gt_crowd, bool).reshape(-1)),
        ))

    def _match_image(self, img, cls, iou_type, area_range):
        dsel = img["det_classes"] == cls
        gsel = img["gt_classes"] == cls
        dt_boxes = img["det_boxes"][dsel]
        scores = img["det_scores"][dsel]
        gt_boxes = img["gt_boxes"][gsel]
        crowd = img["gt_crowd"][gsel]
        order = np.argsort(-scores)
        dt_boxes = dt_boxes[order]
        scores = scores[order]
        ga = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        gt_ignore = crowd | (ga < area_range[0]) | (ga > area_range[1])
        # pycocotools sorts GTs ignore-last so the matching loop's
        # prefer-non-ignored break rule is correct
        gorder = np.argsort(gt_ignore, kind="mergesort")
        gt_boxes, gt_ignore, crowd = gt_boxes[gorder], gt_ignore[gorder], crowd[gorder]
        if iou_type == "segm" and img["det_masks"] is not None:
            dmask = [img["det_masks"][i] for i in np.nonzero(dsel)[0][order]]
            gmask = [img["gt_masks"][j] for j in np.nonzero(gsel)[0][gorder]]
            iou = mask_iou_matrix(dmask, gmask, crowd)
        else:
            iou = bbox_iou_matrix(dt_boxes, gt_boxes, crowd)
        n_dt, n_gt = iou.shape
        T = len(IOU_THRESHOLDS)
        dt_match = np.zeros((T, n_dt), np.int64) - 1
        dt_ignore = np.zeros((T, n_dt), bool)
        gt_matched = np.zeros((T, n_gt), bool)
        for t, thr in enumerate(IOU_THRESHOLDS):
            for d in range(n_dt):
                best, bj = thr, -1
                for j in range(n_gt):
                    # a non-crowd GT matches at most one detection; a crowd
                    # region may absorb any number (pycocotools evaluateImg)
                    if gt_matched[t, j] and not crowd[j]:
                        continue
                    if bj >= 0 and not gt_ignore[bj] and gt_ignore[j]:
                        break  # prefer non-ignored matches (pycocotools rule)
                    if iou[d, j] >= best:
                        best = iou[d, j]
                        bj = j
                if bj >= 0:
                    gt_matched[t, bj] = True
                    dt_match[t, d] = bj
                    dt_ignore[t, d] = gt_ignore[bj]
        # unmatched detections in ignored area ranges are ignored
        da = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1])
        out_of_range = (da < area_range[0]) | (da > area_range[1])
        dt_ignore |= (dt_match == -1) & out_of_range[None, :]
        n_gt_valid = int((~gt_ignore).sum())
        return scores, dt_match, dt_ignore, n_gt_valid

    def _ap_for(self, iou_type, area_range):
        classes = sorted({
            int(c) for img in self._images for c in img["gt_classes"]
        })
        aps = np.full((len(IOU_THRESHOLDS), len(classes)), np.nan)
        for ci, cls in enumerate(classes):
            scores_all, match_all, ignore_all = [], [], []
            total_gt = 0
            for img in self._images:
                s, m, ig, ngt = self._match_image(img, cls, iou_type, area_range)
                scores_all.append(s)
                match_all.append(m)
                ignore_all.append(ig)
                total_gt += ngt
            if total_gt == 0:
                continue
            scores = np.concatenate(scores_all)
            if not len(scores):
                aps[:, ci] = 0.0  # ground truth and no detection: no recall
                continue
            matches = np.concatenate(match_all, axis=1)
            ignores = np.concatenate(ignore_all, axis=1)
            order = np.argsort(-scores, kind="mergesort")
            matches = matches[:, order]
            ignores = ignores[:, order]
            for t in range(len(IOU_THRESHOLDS)):
                keep = ~ignores[t]
                tp = np.cumsum((matches[t] >= 0) & keep)
                fp = np.cumsum((matches[t] < 0) & keep)
                recall = tp / total_gt
                precision = tp / np.maximum(tp + fp, 1e-12)
                # monotone envelope + 101-pt interpolation
                for i in range(len(precision) - 1, 0, -1):
                    precision[i - 1] = max(precision[i - 1], precision[i])
                idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
                p[idx >= len(precision)] = 0.0
                aps[t, ci] = p.mean()
        return aps

    def evaluate(self) -> dict:
        results = {}
        for iou_type in self.iou_types:
            aps = self._ap_for(iou_type, AREA_RANGES["all"])
            with np.errstate(invalid="ignore"):
                res = {
                    "AP": float(np.nanmean(aps) * 100),
                    "AP50": float(np.nanmean(aps[0]) * 100),
                    "AP75": float(np.nanmean(aps[5]) * 100),
                }
            for name in ("small", "medium", "large"):
                a = self._ap_for(iou_type, AREA_RANGES[name])
                res["AP" + name[0]] = float(np.nanmean(a) * 100) if not np.all(np.isnan(a)) else float("nan")
            results[iou_type] = res
        return results
