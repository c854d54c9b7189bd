"""Region Proposal Network (detectron2 semantics).

Counterpart of ``ttdg_mgm_tpu/models/rpn.py``: ``RPNHead``,
``level_anchors`` and ``generate_proposals`` -- per-level top-k, decode,
clip, per-level NMS, merge by score -- on fixed capacities with validity
masks, and the training losses (``match_anchors``, ``subsample_indices``,
``subsample_labels``, ``rpn_losses``).  Scores flatten per level in (H, W, A)
order, as the anchors do, so top-k ties break as in the JAX package.

The JAX losses draw their sampling uniforms from ``jax.random`` inside;
here the caller hands them in as a tensor, so both packages can be fed the
same numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ttdg_mgm_torch.ops.boxes import (cell_anchors, clip_boxes, decode_boxes, encode_boxes,
                                      grid_anchors, pairwise_iou)
from ttdg_mgm_torch.ops.nms import nms_mask, stable_topk

ANCHOR_SIZES = ((32,), (64,), (128,), (256,), (512,))
ANCHOR_RATIOS = (0.5, 1.0, 2.0)
FPN_STRIDES = (4, 8, 16, 32, 64)


class RPNHead(nn.Module):
    """Shared 3x3 conv + 1x1 objectness / 4A deltas (d2 ``StandardRPNHead``).
    Takes NCHW levels; returns NHWC ``(B, H, W, A)`` logits and
    ``(B, H, W, 4A)`` deltas per level."""

    def __init__(self, channels: int = 256, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = nn.Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats):
        logits, regs = [], []
        for f in feats:
            t = F.relu(self.conv(f))
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1))
            regs.append(self.anchor_deltas(t).permute(0, 2, 3, 1))
        return logits, regs


def level_anchors(feat_shapes, strides=FPN_STRIDES, sizes=ANCHOR_SIZES,
                  ratios=ANCHOR_RATIOS, device=None):
    """Anchors per level for feature shapes ``[(H, W), ...]``: ``(H*W*A, 4)``."""
    return [grid_anchors(h, w, stride, cell_anchors(size, ratios, device=device))
            for (h, w), stride, size in zip(feat_shapes, strides, sizes)]


def generate_proposals(logits, regs, anchors, image_sizes, *, pre_nms_topk: int = 1000,
                       post_nms_topk: int = 1000, nms_thresh: float = 0.7):
    """d2 ``find_top_rpn_proposals`` on fixed capacities.

    logits: list of ``(B, H, W, A)``; regs: list of ``(B, H, W, 4A)``;
    anchors: list of ``(H*W*A, 4)``; image_sizes ``(B, 2)`` valid (h, w).
    Returns ``(boxes (B, K, 4), scores (B, K), valid (B, K))``, K =
    ``post_nms_topk``, sorted by score, detached: d2 treats proposals as
    fixed, and the box and mask losses would otherwise back-propagate into
    the box decode through the pool's sampling coordinates.
    """
    B = logits[0].shape[0]
    K = pre_nms_topk
    h = image_sizes[:, 0:1]
    w = image_sizes[:, 1:2]
    lvl_boxes, lvl_scores, lvl_valid = [], [], []
    for lgt, rgs, anc in zip(logits, regs, anchors):
        score = lgt.reshape(B, -1)
        delta = rgs.reshape(B, -1, 4)
        k = min(K, score.shape[1])
        top_s, idx = stable_topk(score, k)
        d = torch.gather(delta, 1, idx[..., None].expand(B, k, 4))
        boxes = clip_boxes(decode_boxes(d, anc[idx]), h, w)
        valid = ((boxes[..., 2] - boxes[..., 0]) > 0) & ((boxes[..., 3] - boxes[..., 1]) > 0)
        pad = K - k
        if pad:
            boxes = F.pad(boxes, (0, 0, 0, pad))
            top_s = F.pad(top_s, (0, pad), value=-1.0e30)
            valid = F.pad(valid, (0, pad))
        lvl_boxes.append(boxes)
        lvl_scores.append(top_s)
        lvl_valid.append(valid)
    sb = torch.stack(lvl_boxes, 1)   # (B, L, K, 4)
    ss = torch.stack(lvl_scores, 1)  # (B, L, K)
    sv = torch.stack(lvl_valid, 1)
    keep = nms_mask(sb, ss, sv, iou_threshold=nms_thresh)
    all_boxes = sb.reshape(B, -1, 4)
    all_scores = torch.where(keep, ss, torch.full_like(ss, -1.0e30)).reshape(B, -1)
    top_s, idx = stable_topk(all_scores, post_nms_topk)
    v = top_s > -1.0e29
    boxes = torch.gather(all_boxes, 1, idx[..., None].expand(*idx.shape, 4))
    zero = torch.zeros((), device=boxes.device)
    return (torch.where(v[..., None], boxes, zero).detach(),
            torch.where(v, top_s, zero).detach(), v)


def match_anchors(anchors, gt_boxes, gt_valid, *, low_thresh: float = 0.3,
                  high_thresh: float = 0.7):
    """d2 Matcher with ``allow_low_quality_matches``, batched over images.

    anchors ``(N, 4)``; gt_boxes ``(B, G, 4)``; gt_valid ``(B, G)``.  Returns
    ``(labels (B, N), matched_gt (B, N))``: labels 1 positive, 0 negative,
    -1 ignored; matched_gt the argmax GT index of every anchor."""
    iou = pairwise_iou(anchors, gt_boxes)  # (B, N, G)
    iou = torch.where(gt_valid[:, None, :], iou, torch.full((), -1.0, device=iou.device))
    best, matched = iou.max(dim=-1)
    one = torch.ones((), dtype=torch.int64, device=iou.device)
    labels = torch.where(best >= high_thresh, one,
                         torch.where(best < low_thresh, 0 * one, -one))
    # low-quality matches: for each GT, the anchors that reach its best IoU
    best_per_gt = iou.max(dim=1, keepdim=True).values  # (B, 1, G)
    lq = ((iou == best_per_gt) & (best_per_gt > 0) & gt_valid[:, None, :]).any(dim=-1)
    labels = torch.where(lq, one, labels)
    no_gt = ~gt_valid.any(dim=-1, keepdim=True)
    return torch.where(no_gt, 0 * one, labels), matched


def subsample_indices(labels, uniforms, num_samples: int = 256,
                      positive_fraction: float = 0.5):
    """d2 ``subsample_labels`` as compact index sets: a uniform random subset
    of the positives, up to ``num_samples * positive_fraction``, negatives
    fill the rest.  labels, uniforms ``(B, N)``.  Returns ``(pos_idx (B,
    P), pos_take (B, P), neg_idx (B, S), neg_take (B, S))``; the ``take``
    masks flag the live slots."""
    num_pos_target = int(num_samples * positive_fraction)
    pos = labels == 1
    neg = labels == 0
    minus = torch.full((), -1.0, device=labels.device)
    _, pos_idx = stable_topk(torch.where(pos, uniforms, minus), num_pos_target)
    num_pos = pos.sum(dim=-1, keepdim=True).clamp(max=num_pos_target)
    pos_take = torch.arange(num_pos_target, device=labels.device) < num_pos
    _, neg_idx = stable_topk(torch.where(neg, uniforms, minus), num_samples)
    num_neg = torch.minimum(num_samples - num_pos, neg.sum(dim=-1, keepdim=True))
    neg_take = torch.arange(num_samples, device=labels.device) < num_neg
    return pos_idx, pos_take, neg_idx, neg_take


def subsample_labels(labels, uniforms, num_samples: int = 256,
                     positive_fraction: float = 0.5):
    """Mask-shaped view of :func:`subsample_indices`: ``(sampled (B, N),
    positive (B, N))`` bool."""
    pos_idx, pos_take, neg_idx, neg_take = subsample_indices(labels, uniforms, num_samples,
                                                             positive_fraction)
    n = labels.shape[1]
    buf = torch.zeros((labels.shape[0], n + 1), dtype=torch.bool, device=labels.device)
    buf.scatter_(1, torch.where(pos_take, pos_idx, n), True)  # column n takes the dropped
    pos_sel = buf[:, :n].clone()
    buf.scatter_(1, torch.where(neg_take, neg_idx, n), True)
    sel = buf[:, :n]
    return sel, pos_sel


def _bce(o, t: float):
    o = o.clamp(-30.0, 30.0)
    return o.clamp(min=0.0) - o * t + torch.log1p(torch.exp(-o.abs()))


def rpn_losses(logits, regs, anchors, gt_boxes, gt_valid, uniforms, *,
               batch_size_per_image: int = 256, positive_fraction: float = 0.5):
    """d2 RPN losses: BCE objectness and L1 (smooth-l1 with beta 0) on the
    deltas of the sampled anchors, normalised by ``B * batch_size_per_image``.

    logits: list of ``(B, H, W, A)``; regs: list of ``(B, H, W, 4A)``;
    anchors: list of ``(H*W*A, 4)``; gt_boxes ``(B, G, 4)``; gt_valid ``(B,
    G)``; uniforms ``(B, N)`` in [0, 1), one per anchor, for the sampling."""
    B = logits[0].shape[0]
    anc = torch.cat(anchors, dim=0)
    flat_logits = torch.cat([l.reshape(B, -1) for l in logits], dim=1)
    flat_regs = torch.cat([r.reshape(B, -1, 4) for r in regs], dim=1)
    labels, matched = match_anchors(anc, gt_boxes, gt_valid)
    pos_idx, pos_take, neg_idx, neg_take = subsample_indices(
        labels, uniforms, batch_size_per_image, positive_fraction)
    # only the sampled anchors enter the losses: gather them first
    gt_idx = torch.gather(matched, 1, pos_idx)
    gt_sel = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(*gt_idx.shape, 4))
    gt_deltas = encode_boxes(anc[pos_idx], gt_sel)
    reg_sel = torch.gather(flat_regs, 1, pos_idx[..., None].expand(*pos_idx.shape, 4))
    zero = torch.zeros((), device=anc.device)
    box_l = torch.where(pos_take[..., None], (reg_sel - gt_deltas).abs(), zero).sum()
    obj_l = (torch.where(pos_take, _bce(torch.gather(flat_logits, 1, pos_idx), 1.0), zero).sum()
             + torch.where(neg_take, _bce(torch.gather(flat_logits, 1, neg_idx), 0.0),
                           zero).sum())
    norm = B * batch_size_per_image
    return {"loss_rpn_cls": obj_l / norm, "loss_rpn_loc": box_l / norm}
