"""Graph-node sampling from FPN features (the "graph generator").

Counterpart of ``ttdg_mgm_tpu/graph/node_sampler.py``: FCOS-style
location-to-box assignment per level with size-of-interest buckets, strided
subsampling of the positive locations (``step = num_pos // sample_dist``),
and compaction into a fixed capacity per level, then across levels.  Nodes,
labels and their order equal the JAX package's exactly; node features keep
their gradient.
"""

from __future__ import annotations

from typing import Sequence

import torch

INF = 1.0e8

SIZES_OF_INTEREST = ((-1.0, 64.0), (64.0, 128.0), (128.0, 256.0), (256.0, 512.0),
                     (512.0, INF))
STRIDES = (4, 8, 16, 32, 64)


def _compact(feats, labels, sel, cap: int):
    """Selected rows (bool ``sel`` over P rows) into the first ``cap``
    slots, order kept, overflow dropped.  Returns ``(feats (cap, C),
    labels (cap,), mask (cap,))``."""
    idx = torch.nonzero(sel, as_tuple=True)[0][:cap]
    n = idx.shape[0]
    out_f = feats.new_zeros((cap, feats.shape[1]))
    out_f = torch.cat([feats[idx], out_f[n:]], dim=0)
    out_l = torch.zeros(cap, dtype=torch.int32, device=feats.device)
    out_l[:n] = labels[idx]
    out_m = torch.arange(cap, device=feats.device) < n
    return out_f, out_l, out_m


def _assign_level(feat, boxes, classes, box_mask, stride, size_lo, size_hi):
    """FCOS assignment for one level of one image: ``feat (H, W, C)``,
    boxes ``(K, 4)``.  Returns flattened ``(P, C)`` features and ``(P,)``
    labels (class + 1, 0 = background)."""
    H, W, C = feat.shape
    dev = feat.device
    xs = torch.arange(W, dtype=torch.float32, device=dev) * stride + stride // 2
    ys = torch.arange(H, dtype=torch.float32, device=dev) * stride + stride // 2
    x = xs[None, :].expand(H, W).reshape(-1)
    y = ys[:, None].expand(H, W).reshape(-1)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    ltrb = torch.stack([x[:, None] - x1[None, :], y[:, None] - y1[None, :],
                        x2[None, :] - x[:, None], y2[None, :] - y[:, None]], dim=-1)
    in_box = ltrb.amin(dim=-1) > 0
    max_reg = ltrb.amax(dim=-1)
    cared = (max_reg >= size_lo) & (max_reg <= size_hi)
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    a = torch.where(in_box & cared & box_mask[None, :], area[None, :],
                    torch.full((), INF, device=dev))
    min_area, argmin = a.min(dim=1)
    labels = torch.where(min_area >= INF, torch.zeros((), dtype=torch.int32, device=dev),
                         (classes[argmin] + 1).to(torch.int32))
    return feat.reshape(-1, C), labels


def _sample_image(feats, boxes, classes, box_mask, sample_dist, cap_per_level,
                  strides, sizes):
    per_level = []
    for lvl, feat in enumerate(feats):
        flat, labels = _assign_level(feat, boxes, classes, box_mask, strides[lvl],
                                     sizes[lvl][0], sizes[lvl][1])
        pos = labels > 0
        num_pos = int(pos.sum())
        rank = torch.cumsum(pos.to(torch.int32), 0) - 1
        step = num_pos // sample_dist
        sel = pos & ((step <= 1) | (rank % max(step, 1) == 0))
        per_level.append(_compact(flat, labels, sel, cap_per_level))
    f = torch.cat([p[0] for p in per_level], dim=0)
    lab = torch.cat([p[1] for p in per_level], dim=0)
    m = torch.cat([p[2] for p in per_level], dim=0)
    return _compact(f, lab, m, len(feats) * cap_per_level)


class PrototypeComputation:
    """``__call__(features, boxes, classes, box_mask)``: features NHWC levels
    ``[(B, H_l, W_l, C)]`` (p2..p6), boxes ``(B, K, 4)``, classes ``(B, K)``
    0-based, box_mask ``(B, K)``.  Returns ``nodes (B, M, C), labels (B, M),
    mask (B, M)`` with ``M = num_levels * cap_per_level``."""

    def __init__(self, num_classes: int, sample_dist: int = 10, cap_per_level: int = 20,
                 strides: Sequence[int] = STRIDES, sizes: Sequence = SIZES_OF_INTEREST):
        self.num_classes = num_classes
        self.sample_dist = sample_dist
        self.cap_per_level = cap_per_level
        self.strides = tuple(strides)
        self.sizes = tuple(tuple(s) for s in sizes)

    def __call__(self, features, boxes, classes, box_mask):
        outs = [
            _sample_image([f[b] for f in features], boxes[b], classes[b], box_mask[b],
                          self.sample_dist, self.cap_per_level, self.strides, self.sizes)
            for b in range(boxes.shape[0])
        ]
        return tuple(torch.stack([o[i] for o in outs]) for i in range(3))
