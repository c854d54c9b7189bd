"""Box arithmetic: area, IoU, clipping, encode/decode and anchors.

Counterpart of ``ttdg_mgm_tpu/ops/boxes.py`` (detectron2 ``Box2BoxTransform``
and ``DefaultAnchorGenerator`` semantics).  Boxes are xyxy float32 tensors
``(..., 4)``.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# d2 Box2BoxTransform scale clamp: log(1000 / 16)
SCALE_CLAMP = math.log(1000.0 / 16.0)


def box_area(boxes):
    w = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    h = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    return w * h


def pairwise_iou(boxes1, boxes2):
    """IoU matrix ``(..., N, M)`` between ``(..., N, 4)`` and ``(..., M, 4)``."""
    a1 = box_area(boxes1)
    a2 = box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = a1[..., :, None] + a2[..., None, :] - inter
    return torch.where(inter > 0, inter / union.clamp(min=1e-12),
                       torch.zeros((), dtype=inter.dtype, device=inter.device))


def clip_boxes(boxes, height, width):
    """Clamp xyxy boxes to ``[0, width] x [0, height]``; ``height``/``width``
    are Python numbers or tensors broadcastable to ``boxes[..., 0]``."""
    h = torch.as_tensor(height, dtype=boxes.dtype, device=boxes.device)
    w = torch.as_tensor(width, dtype=boxes.dtype, device=boxes.device)
    zero = boxes.new_zeros(())
    lim = [w, h, w, h]
    return torch.stack(
        [torch.minimum(torch.maximum(boxes[..., i], zero), lim[i]) for i in range(4)],
        dim=-1)


def encode_boxes(src_boxes, target_boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """d2 ``Box2BoxTransform.get_deltas``: (dx, dy, dw, dh) of target wrt src."""
    sw = src_boxes[..., 2] - src_boxes[..., 0]
    sh = src_boxes[..., 3] - src_boxes[..., 1]
    scx = src_boxes[..., 0] + 0.5 * sw
    scy = src_boxes[..., 1] + 0.5 * sh
    tw = target_boxes[..., 2] - target_boxes[..., 0]
    th = target_boxes[..., 3] - target_boxes[..., 1]
    tcx = target_boxes[..., 0] + 0.5 * tw
    tcy = target_boxes[..., 1] + 0.5 * th
    wx, wy, ww, wh = weights
    eps = 1e-8
    dx = wx * (tcx - scx) / sw.clamp(min=eps)
    dy = wy * (tcy - scy) / sh.clamp(min=eps)
    dw = ww * torch.log(tw.clamp(min=eps) / sw.clamp(min=eps))
    dh = wh * torch.log(th.clamp(min=eps) / sh.clamp(min=eps))
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(deltas, boxes, weights=(1.0, 1.0, 1.0, 1.0)):
    """d2 ``Box2BoxTransform.apply_deltas`` with the log-space clamp."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + 0.5 * w
    cy = boxes[..., 1] + 0.5 * h
    wx, wy, ww, wh = weights
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = (deltas[..., 2] / ww).clamp(max=SCALE_CLAMP)
    dh = (deltas[..., 3] / wh).clamp(max=SCALE_CLAMP)
    pcx = dx * w + cx
    pcy = dy * h + cy
    pw = torch.exp(dw) * w
    ph = torch.exp(dh) * h
    return torch.stack(
        [pcx - 0.5 * pw, pcy - 0.5 * ph, pcx + 0.5 * pw, pcy + 0.5 * ph], dim=-1)


def cell_anchors(sizes: Sequence[float], aspect_ratios: Sequence[float],
                 device=None):
    """d2 ``generate_cell_anchors``: zero-centred anchors ``(A, 4)`` for one
    level, sizes-major then ratios."""
    out = []
    for size in sizes:
        area = float(size) ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            out.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return torch.tensor(out, dtype=torch.float32, device=device)


def grid_anchors(feat_h: int, feat_w: int, stride: int, cell, offset: float = 0.0):
    """Anchors for one level, ``(H*W*A, 4)`` in (H, W, A) order; d2 default
    offset 0.0 (anchor centres at ``stride * i``)."""
    dev = cell.device
    shifts_x = (torch.arange(feat_w, dtype=torch.float32, device=dev) + offset) * stride
    shifts_y = (torch.arange(feat_h, dtype=torch.float32, device=dev) + offset) * stride
    sx = shifts_x[None, :].expand(feat_h, feat_w).reshape(-1)
    sy = shifts_y[:, None].expand(feat_h, feat_w).reshape(-1)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)
    return (shifts[:, None, :] + cell[None, :, :]).reshape(-1, 4)
