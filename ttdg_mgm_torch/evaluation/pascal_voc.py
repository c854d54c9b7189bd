"""Pascal VOC detection mAP (host-side NumPy).

This package's own copy of ``ttdg_mgm_tpu/evaluation/pascal_voc.py`` (the
reference's ``PascalVOCDetectionEvaluator`` and ``voc_eval``): per-class AP
at IoU 0.5, by the area under the precision envelope or the VOC 2007
11-point metric, difficult GT ignored, optionally over a class subset.  The
class lists are the dataset loader's (``data/datasets/pascal_voc.py``).
"""

from __future__ import annotations

import numpy as np

from ttdg_mgm_torch.data.datasets.pascal_voc import (VOC_CLASS_NAMES,  # noqa: F401
                                                     WATERCOLOR_CLASS_NAMES)
from ttdg_mgm_torch.evaluation.coco_eval import bbox_iou_matrix


def voc_ap(recall, precision, use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.nonzero(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


class PascalVOCDetectionEvaluator:
    def __init__(self, class_names, *, iou_thresh: float = 0.5,
                 use_07_metric: bool = False, eval_class_subset=None):
        self.class_names = list(class_names)
        self.iou_thresh = iou_thresh
        self.use_07 = use_07_metric
        self.subset = (
            set(eval_class_subset) if eval_class_subset is not None else None
        )
        self.reset()

    def reset(self):
        self._images = []

    def process(self, det_boxes, det_scores, det_classes, gt_boxes, gt_classes,
                gt_difficult=None):
        gt_boxes = np.asarray(gt_boxes, np.float64).reshape(-1, 4)
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_boxes), bool)
        self._images.append(dict(
            det_boxes=np.asarray(det_boxes, np.float64).reshape(-1, 4),
            det_scores=np.asarray(det_scores, np.float64).reshape(-1),
            det_classes=np.asarray(det_classes, np.int64).reshape(-1),
            gt_boxes=gt_boxes,
            gt_classes=np.asarray(gt_classes, np.int64).reshape(-1),
            gt_difficult=np.asarray(gt_difficult, bool).reshape(-1),
        ))

    def evaluate(self) -> dict:
        aps = {}
        for ci, cname in enumerate(self.class_names):
            if self.subset is not None and cname not in self.subset:
                continue
            scores, tps, fps = [], [], []
            npos = 0
            for img in self._images:
                gsel = img["gt_classes"] == ci
                gt = img["gt_boxes"][gsel]
                diff = img["gt_difficult"][gsel]
                npos += int((~diff).sum())
                dsel = img["det_classes"] == ci
                db = img["det_boxes"][dsel]
                ds = img["det_scores"][dsel]
                order = np.argsort(-ds)
                db, ds = db[order], ds[order]
                matched = np.zeros(len(gt), bool)
                for d in range(len(db)):
                    iou = bbox_iou_matrix(db[d:d + 1], gt)[0] if len(gt) else []
                    j = int(np.argmax(iou)) if len(gt) else -1
                    ok = j >= 0 and iou[j] >= self.iou_thresh
                    scores.append(ds[d])
                    if ok and diff[j]:
                        tps.append(0)
                        fps.append(0)  # difficult: ignored
                    elif ok and not matched[j]:
                        matched[j] = True
                        tps.append(1)
                        fps.append(0)
                    else:
                        tps.append(0)
                        fps.append(1)
            if npos == 0:
                continue
            order = np.argsort(-np.asarray(scores))
            tp = np.cumsum(np.asarray(tps)[order])
            fp = np.cumsum(np.asarray(fps)[order])
            recall = tp / npos
            precision = tp / np.maximum(tp + fp, 1e-12)
            aps[cname] = voc_ap(recall, precision, self.use_07) * 100
        mAP = float(np.mean(list(aps.values()))) if aps else float("nan")
        return {"bbox": {"AP50": mAP, "per_class": aps}}
