"""ROI heads: box head and predictor, mask head, the per-image detection
inference, and the training side (proposal labelling and sampling, the
Fast R-CNN and mask losses, the GT-mask crop).

Counterpart of ``ttdg_mgm_tpu/models/roi_heads.py`` (d2 ``StandardROIHeads``
numerics: class-specific box regression with (10, 10, 5, 5) weights, score
0.05, class-aware NMS 0.5, top-100).  Heads take pooled features in the
package's NHWC layout ``(N, P, P, C)``; the box head flattens them as d2 does,
``(C, P, P)``, so d2 ``fc1`` weights load unchanged.  The training functions
take a leading batch dimension where the JAX ones are vmapped per image, and
take their sampling uniforms as a tensor.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ttdg_mgm_torch.models.layers import Conv2d, ConvTranspose2d, Linear, NormConv2d, conv_norm
from ttdg_mgm_torch.ops.boxes import clip_boxes, decode_boxes, encode_boxes, pairwise_iou
from ttdg_mgm_torch.ops.nms import compact_batched_nms_mask, compact_rows, stable_topk
from ttdg_mgm_torch.ops.roi_align import mask_roi_align

BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


class BoxHead(nn.Module):
    """FastRCNNConvFCHead: ``num_conv`` x (3x3 conv ``conv{k}``, without bias
    and with ``norm`` when it is set, + relu), flatten, ``num_fc`` x (fc +
    relu)."""

    def __init__(self, in_channels: int, pool: int = 7, fc_dim: int = 1024, num_fc: int = 2,
                 num_conv: int = 0, conv_dim: int = 256, norm: str = ""):
        super().__init__()
        self.num_fc = num_fc
        self.num_conv = num_conv
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"conv{i + 1}", NormConv2d(c, conv_dim, 3, padding=1, bias=not norm,
                                                       norm=conv_norm(norm, conv_dim)))
            c = conv_dim
        dim = c * pool * pool
        for i in range(num_fc):
            self.add_module(f"fc{i + 1}", Linear(dim, fc_dim))
            dim = fc_dim

    def forward(self, x):  # (N, P, P, C)
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{i + 1}")(x))
        x = x.reshape(x.shape[0], -1)
        for i in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{i + 1}")(x))
        return x


class BoxPredictor(nn.Module):
    """cls_score (classes + 1) and class-specific bbox_pred (4 per class)."""

    def __init__(self, in_dim: int, num_classes: int):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1)
        self.bbox_pred = Linear(in_dim, num_classes * 4)

    def forward(self, x):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead: ``num_conv`` x (3x3 conv + relu; without bias
    and with ``norm`` when it is set), 2x2 deconv + relu, 1x1 predictor.
    ``(N, 14, 14, C)`` -> logits ``(N, classes, 28, 28)``."""

    def __init__(self, in_channels: int, num_classes: int, channels: int = 256,
                 num_conv: int = 4, norm: str = ""):
        super().__init__()
        self.num_conv = num_conv
        c = in_channels
        for i in range(num_conv):
            self.add_module(f"mask_fcn{i + 1}", NormConv2d(c, channels, 3, padding=1,
                                                           bias=not norm,
                                                           norm=conv_norm(norm, channels)))
            c = channels
        self.deconv = ConvTranspose2d(c, channels, 2, stride=2)
        self.predictor = Conv2d(channels, num_classes, 1)

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for i in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{i + 1}")(x))
        x = F.relu(self.deconv(x))
        return self.predictor(x)


def roi_box_inference(scores, deltas, prop_boxes, prop_valid, image_sizes, *,
                      num_classes: int, score_thresh: float = 0.05,
                      nms_thresh: float = 0.5, topk: int = 100):
    """d2 ``fast_rcnn_inference``, batched over images.

    scores ``(B, K, C+1)`` logits; deltas ``(B, K, 4C)``; prop_boxes
    ``(B, K, 4)``; prop_valid ``(B, K)``; image_sizes ``(B, 2)``.  Returns
    ``(boxes (B, topk, 4), scores, classes, valid)`` sorted by score.
    """
    B, K = scores.shape[:2]
    nc = num_classes
    probs = torch.softmax(scores, dim=-1)[..., :nc]
    deltas = deltas.reshape(B, K, nc, 4)
    boxes = decode_boxes(deltas, prop_boxes[:, :, None, :].expand(B, K, nc, 4),
                         BBOX_REG_WEIGHTS)
    boxes = clip_boxes(boxes, image_sizes[:, 0, None, None], image_sizes[:, 1, None, None])
    flat_boxes = boxes.reshape(B, K * nc, 4)
    flat_scores = probs.reshape(B, K * nc)
    flat_cls = torch.arange(nc, device=scores.device).repeat(K)[None].expand(B, K * nc)
    flat_valid = prop_valid.repeat_interleave(nc, dim=1) & (flat_scores > score_thresh)
    keep = compact_batched_nms_mask(flat_boxes, flat_scores, flat_cls, flat_valid,
                                    iou_threshold=nms_thresh)
    top_s, idx = stable_topk(torch.where(keep, flat_scores, torch.full_like(flat_scores, -1.0e30)),
                             topk)
    v = top_s > -1.0e29
    zero = torch.zeros((), device=scores.device)
    out_boxes = torch.gather(flat_boxes, 1, idx[..., None].expand(B, topk, 4))
    out_cls = torch.gather(flat_cls, 1, idx)
    return (torch.where(v[..., None], out_boxes, zero), torch.where(v, top_s, zero),
            torch.where(v, out_cls, torch.zeros((), dtype=out_cls.dtype, device=zero.device)),
            v)


def label_and_sample_proposals(proposals, prop_valid, gt_boxes, gt_classes, gt_valid,
                               uniforms, *, num_classes: int, batch_size_per_image: int = 512,
                               positive_fraction: float = 0.25, iou_thresh: float = 0.5,
                               append_gt: bool = True):
    """d2 ``label_and_sample_proposals``, batched, ``S = batch_size_per_image``
    static output rows per image.

    proposals ``(B, K, 4)``, prop_valid ``(B, K)``; gt ``(B, G, ...)``;
    uniforms ``(B, K + G)`` in [0, 1).  Appends the GT boxes to the proposals
    (valid when ``append_gt``), matches at IoU 0.5 (no low-quality matches),
    samples foreground and background by a masked random ranking and keeps
    the selected rows in their order.  Returns ``(boxes (B, S, 4), classes
    (B, S), matched_gt (B, S), fg (B, S), valid (B, S))``; class
    ``num_classes`` is background."""
    boxes = torch.cat([proposals, gt_boxes], dim=1)
    valid = torch.cat([prop_valid, gt_valid if append_gt else torch.zeros_like(gt_valid)], dim=1)
    iou = pairwise_iou(boxes, gt_boxes)
    iou = torch.where(gt_valid[:, None, :] & valid[:, :, None], iou,
                      torch.full((), -1.0, device=iou.device))
    best, matched = iou.max(dim=-1)
    fg = (best >= iou_thresh) & valid
    bg = (best < iou_thresh) & valid
    cls = torch.where(fg, torch.gather(gt_classes.long(), 1, matched),
                      torch.full((), num_classes, device=fg.device))
    S = batch_size_per_image
    num_fg_target = int(S * positive_fraction)

    def ranks(mask):
        order = torch.argsort(torch.where(mask, uniforms, torch.full((), 2.0, device=mask.device)),
                              dim=1, stable=True)
        ar = torch.arange(order.shape[1], device=order.device).expand_as(order)
        return torch.empty_like(order).scatter_(1, order, ar)

    num_fg = fg.sum(dim=1, keepdim=True).clamp(max=num_fg_target)
    fg_sel = fg & (ranks(fg) < num_fg)
    bg_sel = bg & (ranks(bg) < S - num_fg)
    sel = fg_sel | bg_sel
    (out_boxes, out_cls, out_matched, out_fg), n_sel = compact_rows(
        sel, S, (boxes, 0.0), (cls, num_classes), (matched, 0), (fg_sel, False))
    out_valid = torch.arange(S, device=sel.device) < n_sel[:, None]
    return out_boxes, out_cls, out_matched, out_fg & out_valid, out_valid


def fast_rcnn_losses(scores, deltas, prop_boxes, gt_boxes_matched, classes, fg, valid, *,
                     num_classes: int, cls_loss_type: str = "CrossEntropy"):
    """d2 ``FastRCNNOutputs`` losses per image (smooth-l1 with beta 0, so L1)
    with the reference's cross-entropy / focal switch (focal gamma 1.5).
    scores ``(B, S, C+1)``, deltas ``(B, S, 4C)``, the rest ``(B, S, ...)``.
    Returns ``{"loss_cls": (B,), "loss_box_reg": (B,)}``."""
    zero = torch.zeros((), device=scores.device)
    n_valid = valid.to(torch.float32).sum(dim=-1).clamp(min=1.0)
    logz = torch.logsumexp(scores, dim=-1)
    ce = logz - torch.gather(scores, -1, classes.long()[..., None])[..., 0]
    if cls_loss_type == "FocalLoss":
        p = torch.exp(-ce)
        ce = (1.0 - p) ** 1.5 * ce
    loss_cls = torch.where(valid, ce, zero).sum(dim=-1) / n_valid
    gt_deltas = encode_boxes(prop_boxes, gt_boxes_matched, BBOX_REG_WEIGHTS)
    B, S = classes.shape
    deltas = deltas.reshape(B, S, num_classes, 4)
    cls_idx = classes.long().clamp(0, num_classes - 1)
    sel = torch.gather(deltas, 2, cls_idx[..., None, None].expand(B, S, 1, 4))[:, :, 0]
    l1 = (sel - gt_deltas).abs().sum(dim=-1)
    loss_box = torch.where(fg, l1, zero).sum(dim=-1) / n_valid
    return {"loss_cls": loss_cls, "loss_box_reg": loss_box}


def mask_loss(mask_logits, classes, gt_masks28, fg):
    """BCE-with-logits on the GT class's channel over the foreground
    proposals, per image (d2 ``mask_rcnn_loss``).  mask_logits ``(B, S,
    classes, 28, 28)`` (the port's mask-head layout), classes ``(B, S)``,
    gt_masks28 ``(B, S, 28, 28)``, fg ``(B, S)``.  Returns ``(B,)``."""
    B, S, C = mask_logits.shape[:3]
    cls_idx = classes.long().clamp(0, C - 1)
    idx = cls_idx[:, :, None, None, None].expand(B, S, 1, *mask_logits.shape[3:])
    x = torch.gather(mask_logits, 2, idx)[:, :, 0].clamp(-30.0, 30.0)
    t = gt_masks28.to(torch.float32)
    bce = x.clamp(min=0.0) - x * t + torch.log1p(torch.exp(-x.abs()))
    per = bce.mean(dim=(2, 3))
    n_fg = fg.to(torch.float32).sum(dim=-1).clamp(min=1.0)
    return torch.where(fg, per, torch.zeros((), device=per.device)).sum(dim=-1) / n_fg


def crop_gt_masks(gt_masks, matched_gt, boxes, out_size: int = 28):
    """Crop and resize each proposal's GT bitmask to ``(B, S, 28, 28)``,
    binarised at 0.5 (d2 ``BitMasks.crop_and_resize``: ROIAlign with
    ``aligned=True`` on the adaptive grid).  gt_masks ``(B, G, Hm, Wm)``,
    matched_gt ``(B, S)``, boxes ``(B, S, 4)`` in mask-canvas coordinates."""
    B, S = matched_gt.shape
    Hm, Wm = gt_masks.shape[-2:]
    idx = matched_gt.long()[:, :, None, None].expand(B, S, Hm, Wm)
    masks = torch.gather(gt_masks, 1, idx).to(torch.float32).reshape(B * S, Hm, Wm)
    out = mask_roi_align(masks, boxes.reshape(B * S, 4), output_size=out_size, sampling_ratio=0)
    return out.reshape(B, S, out_size, out_size) >= 0.5
