"""The numbers that decide ``correct``: how far the program's outputs lie
from the plain reference's.

* :func:`loss_gap`: the largest relative gap of a step's loss.
* :func:`worst_leaf`: the gap between the program's norm of a leaf and the
  reference's (not the norm of their difference), over the larger of the
  reference's norm of that leaf and the median leaf's, at the worst leaf;
  :func:`median_leaf`, the same at the median leaf.
  Leaves whose reference gradient is nought to rounding (under a thousandth
  of the median leaf's, :func:`moving_leaves`) are left out: they move by
  round-off alone.
* :func:`score_distance`, :func:`score_gap` and :func:`mask_gap`: a
  batch's detections, image by image: the mean gap between the two score
  distributions (their quantile functions'; one detection that a last bit
  lets through top-k or NMS on one side moves it by a share only), the
  widest gap between the two sorted score lists, and the share
  of the reference's top detections whose pasted mask the program's
  matching detection (same class, box IoU at least 0.5) does not reproduce
  (one minus the masks' IoU; 1 without a match).
"""

from __future__ import annotations

import numpy as np
import torch

#: the reference's top detections per image that :func:`mask_gap` follows
TOP_MASKS = 10


def loss_gap(prog: list, ref: list) -> float:
    return max(abs(p - r) / max(abs(r), 1e-12) for p, r in zip(prog, ref, strict=True))


def _norms(d: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in d.items()}


def moving_leaves(ref_grad: dict, weight_decay: float, p0: dict) -> set:
    """The leaves whose raw reference gradient (the first momentum less the
    weight decay's share) is at least a thousandth of the median leaf's."""
    raw = _norms({k: g - weight_decay * p0[k] for k, g in ref_grad.items()})
    med = float(np.median(list(raw.values())))
    return {k for k, v in raw.items() if v >= 1e-3 * med}


def leaf_gaps(prog: dict, ref: dict, keep: set) -> list:
    """``[(leaf, gap)]`` of the leaves in ``keep``, the widest first."""
    pn, rn = _norms({k: prog[k] for k in keep}), _norms({k: ref[k] for k in keep})
    med = float(np.median(list(rn.values())))
    gaps = {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keep}
    return sorted(gaps.items(), key=lambda kv: -kv[1])


def worst_leaf(prog: dict, ref: dict, keep: set) -> float:
    return leaf_gaps(prog, ref, keep)[0][1]


def median_leaf(prog: dict, ref: dict, keep: set) -> float:
    """The median leaf's gap (the steady reading where a few small leaves'
    later steps are noise)."""
    return float(np.median([g for _, g in leaf_gaps(prog, ref, keep)]))


def change(params: dict, p0: dict) -> dict:
    return {k: v - p0[k] for k, v in params.items()}


def score_gap(prog: dict, ref: dict) -> float:
    """The widest gap between the sorted score lists of each image; 1 for an
    image one side lacks."""
    gap = 0.0
    for image_id, r in ref.items():
        p = prog.get(image_id)
        if p is None:
            return 1.0
        sp, sr = np.sort(p["scores"])[::-1], np.sort(r["scores"])[::-1]
        n = max(len(sp), len(sr))
        sp = np.pad(sp, (0, n - len(sp)))
        sr = np.pad(sr, (0, n - len(sr)))
        gap = max(gap, float(np.abs(sp - sr).max()) if n else 0.0)
    return gap


#: quantiles :func:`score_distance` compares (exact for lists of up to 100
#: scores, and of any length that divides it)
QUANTILES = (np.arange(1000) + 0.5) / 1000


def score_distance(prog: dict, ref: dict) -> float:
    """The largest, over the images, mean gap between the two sides' score
    distributions (the 1-Wasserstein distance of the empirical ones); 1
    for an image one side lacks or holds no score of."""
    gap = 0.0
    for image_id, r in ref.items():
        p = prog.get(image_id)
        if p is None:
            return 1.0
        sp, sr = np.asarray(p["scores"], np.float64), np.asarray(r["scores"], np.float64)
        if not len(sp) and not len(sr):
            continue
        if not len(sp) or not len(sr):
            return 1.0
        qp = np.quantile(sp, QUANTILES, method="inverted_cdf")
        qr = np.quantile(sr, QUANTILES, method="inverted_cdf")
        gap = max(gap, float(np.abs(qp - qr).mean()))
    return gap


def _box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    area = lambda x: np.clip(x[:, 2:] - x[:, :2], 0, None).prod(-1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def mask_gap(prog: dict, ref: dict) -> float:
    misses = []
    for image_id, r in ref.items():
        p = prog.get(image_id)
        if p is None:
            return 1.0
        top = np.argsort(-r["scores"], kind="stable")[:TOP_MASKS]
        iou = _box_iou(r["boxes"][top], p["boxes"]) if len(p["boxes"]) else None
        for row, i in enumerate(top):
            if iou is None:
                misses.append(1.0)
                continue
            cand = np.where(p["classes"] == r["classes"][i], iou[row], -1.0)
            j = int(np.argmax(cand))
            if cand[j] < 0.5:
                misses.append(1.0)
                continue
            a, b = r["masks"][i].astype(bool), p["masks"][j].astype(bool)
            union = np.logical_or(a, b).sum()
            misses.append(1.0 - (np.logical_and(a, b).sum() / union if union else 1.0))
    return float(np.mean(misses)) if misses else 0.0
