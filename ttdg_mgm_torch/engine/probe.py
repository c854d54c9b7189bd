"""Pseudo-label quality diagnostics.

Counterpart of ``ttdg_mgm_tpu/engine/probe.py`` (the reference's
``OpenMatchTrainerProbe``): statistics of the teacher's pseudo-labels
against ground truth (counts, true and false positives by IoU, classes),
their size distribution and how well their scores separate matched from
unmatched boxes.  Host-side NumPy on padded ``(B, K, ...)`` arrays (NumPy
or CPU tensors).
"""

from __future__ import annotations

import numpy as np

from ttdg_mgm_torch.evaluation.coco_eval import bbox_iou_matrix


def _valid(x, valid, b):
    return np.asarray(x[b])[np.asarray(valid[b], bool)]


def probe_pseudo_labels(pseudo_boxes, pseudo_classes, pseudo_valid, gt_boxes, gt_classes,
                        gt_valid, *, iou_thresh: float = 0.5) -> dict:
    """Counts of pseudo-boxes and GT boxes, true positives (best IoU at or
    above ``iou_thresh``), false positives, true positives of the right
    class; precision, class accuracy and pseudo-boxes per image."""
    stats = {"num_pseudo": 0.0, "num_gt": 0.0, "true_pos": 0.0, "false_pos": 0.0,
             "cls_correct": 0.0}
    B = len(pseudo_boxes)
    for b in range(B):
        pb, pc = _valid(pseudo_boxes, pseudo_valid, b), _valid(pseudo_classes, pseudo_valid, b)
        gb, gc = _valid(gt_boxes, gt_valid, b), _valid(gt_classes, gt_valid, b)
        stats["num_pseudo"] += len(pb)
        stats["num_gt"] += len(gb)
        if len(pb) == 0 or len(gb) == 0:
            stats["false_pos"] += len(pb)
            continue
        iou = bbox_iou_matrix(pb.astype(np.float64), gb.astype(np.float64))
        best, arg = iou.max(axis=1), iou.argmax(axis=1)
        tp = best >= iou_thresh
        stats["true_pos"] += float(tp.sum())
        stats["false_pos"] += float((~tp).sum())
        stats["cls_correct"] += float((tp & (pc == gc[arg])).sum())
    stats["precision"] = stats["true_pos"] / max(stats["num_pseudo"], 1.0)
    stats["cls_accuracy"] = stats["cls_correct"] / max(stats["true_pos"], 1.0)
    stats["avg_pseudo_per_image"] = stats["num_pseudo"] / max(B, 1)
    return stats


def probe_size_distribution(boxes, valid, *, bins=(32.0, 96.0)) -> dict:
    """Counts of small, medium and large boxes by the square root of their
    area (edges ``bins``), and the mean size."""
    sizes = []
    for b in range(len(boxes)):
        bx = _valid(boxes, valid, b)
        if len(bx):
            areas = np.clip(bx[:, 2] - bx[:, 0], 0, None) * np.clip(bx[:, 3] - bx[:, 1], 0, None)
            sizes.extend(np.sqrt(areas).tolist())
    sizes = np.asarray(sizes)
    return {"num_boxes": float(len(sizes)), "small": float((sizes < bins[0]).sum()),
            "medium": float(((sizes >= bins[0]) & (sizes < bins[1])).sum()),
            "large": float((sizes >= bins[1]).sum()),
            "mean_size": float(sizes.mean()) if len(sizes) else 0.0}


def probe_ood_accuracy(pseudo_scores, pseudo_valid, pseudo_boxes, gt_boxes, gt_valid, *,
                       iou_thresh: float = 0.5) -> dict:
    """In- and out-of-distribution pseudo-boxes (matched to a GT box at
    ``iou_thresh`` or not): their mean scores, counts, and the AUC of the
    score between them (P(in > out), ties half)."""
    ins, outs = [], []
    for b in range(len(pseudo_boxes)):
        pb, ps = _valid(pseudo_boxes, pseudo_valid, b), _valid(pseudo_scores, pseudo_valid, b)
        gb = _valid(gt_boxes, gt_valid, b)
        if len(pb) == 0:
            continue
        if len(gb) == 0:
            outs.extend(ps.tolist())
            continue
        matched = bbox_iou_matrix(pb.astype(np.float64),
                                  gb.astype(np.float64)).max(axis=1) >= iou_thresh
        ins.extend(ps[matched].tolist())
        outs.extend(ps[~matched].tolist())
    auc = 0.5
    if ins and outs:
        a, o = np.asarray(ins)[:, None], np.asarray(outs)[None, :]
        auc = float((a > o).mean() + 0.5 * (a == o).mean())
    return {"mean_score_in": float(np.mean(ins)) if ins else 0.0,
            "mean_score_out": float(np.mean(outs)) if outs else 0.0,
            "score_auc": auc, "num_in": float(len(ins)), "num_out": float(len(outs))}
