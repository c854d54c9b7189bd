"""Mask pasting: per-detection ``M x M`` mask probabilities -> binary masks
over the whole image, on the tensors' device.

Semantics of ``ttdg_mgm_tpu/ops/mask_paste.py:paste_masks_np`` (d2
``_do_paste_mask``): image pixel ``(y + 0.5)`` maps to mask coordinate
``(y + 0.5 - y1) / box_h * M - 0.5``, sampled bilinearly with zeros outside
the ``M x M`` grid, then ``>= threshold``; only the window ``[floor(y1),
ceil(y2) + 1) x [floor(x1), ceil(x2) + 1)`` (clamped to the image) is
written.  Bilinear sampling with zero padding is separable, so a box's
window is ``Wy @ mask @ Wx^T`` with ``Wy (h, M)`` and ``Wx (w, M)`` holding
each pixel's two interpolation weights; it is computed in float64, as the
NumPy version computes it.  Plain PyTorch: no TPU kernel computes this.
"""

from __future__ import annotations

import math

import torch


def _axis_weights(coords: torch.Tensor, M: int) -> torch.Tensor:
    """``(n, M)`` bilinear weights of the sample positions ``coords`` on an
    axis of ``M`` cells, zero outside it."""
    c0 = torch.floor(coords)
    frac = coords - c0
    rows = torch.arange(coords.shape[0], device=coords.device)
    w = torch.zeros((coords.shape[0], M), dtype=coords.dtype, device=coords.device)
    for idx, wt in ((c0, 1.0 - frac), (c0 + 1.0, frac)):
        ok = (idx >= 0) & (idx < M)
        w.index_put_((rows[ok], idx[ok].long()), wt[ok], accumulate=True)
    return w


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int, width: int,
                threshold: float = 0.5) -> torch.Tensor:
    """masks ``(K, M, M)`` probabilities, boxes ``(K, 4)`` xyxy in image
    pixels -> ``(K, height, width)`` uint8 on the masks' device."""
    K, M = masks.shape[0], masks.shape[-1]
    dev = masks.device
    out = torch.zeros((K, height, width), dtype=torch.uint8, device=dev)
    probs = masks.to(torch.float64)
    boxes = boxes.detach().to("cpu", torch.float32)
    # box sides in the boxes' own precision, as the NumPy version takes them
    sides = (boxes[:, 2:] - boxes[:, :2]).tolist()
    for k, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
        y0i, y1i = max(math.floor(y1), 0), min(math.ceil(y2) + 1, height)
        x0i, x1i = max(math.floor(x1), 0), min(math.ceil(x2) + 1, width)
        if y1i <= y0i or x1i <= x0i:
            continue
        w, h = max(sides[k][0], 1e-6), max(sides[k][1], 1e-6)
        ys = (torch.arange(y0i, y1i, dtype=torch.float64, device=dev) + 0.5 - y1) / h * M - 0.5
        xs = (torch.arange(x0i, x1i, dtype=torch.float64, device=dev) + 0.5 - x1) / w * M - 0.5
        v = _axis_weights(ys, M) @ probs[k] @ _axis_weights(xs, M).T
        out[k, y0i:y1i, x0i:x1i] = (v >= threshold).to(torch.uint8)
    return out
