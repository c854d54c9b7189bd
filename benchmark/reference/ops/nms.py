"""Fixed-capacity, masked non-maximum suppression.

Counterpart of ``ttdg_mgm_tpu/ops/nms.py``: a keep-mask over ``K`` boxes
(order unchanged), computed as the fixpoint of ``keep <- valid & ~any(kept
higher-ranked suppressor with IoU > thresh)``, which is exactly the greedy
torchvision result.  Boxes rank by score with a stable sort, so equal scores
break towards the lower index, as ``jnp.argsort`` does.  Leading batch
dimensions are solved together.
"""

from __future__ import annotations

import torch

from reference.ops.boxes import pairwise_iou

NEG = -1.0e30


def nms_mask(boxes, scores, valid, *, iou_threshold: float = 0.5):
    """boxes ``(..., K, 4)``, scores ``(..., K)``, valid ``(..., K)`` bool ->
    keep ``(..., K)`` bool."""
    K = boxes.shape[-2]
    order = torch.argsort(-torch.where(valid, scores, torch.full_like(scores, NEG)),
                          dim=-1, stable=True)
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)
    iou = pairwise_iou(b, b)
    idx = torch.arange(K, device=boxes.device)
    tri = idx[:, None] < idx[None, :]
    # sup[j, i]: ranked box j suppresses ranked box i when j is kept
    sup = (iou > iou_threshold) & tri & v[..., :, None]
    supf = sup.to(torch.float32)
    keep = v
    for _ in range(K):
        killed = torch.einsum("...ji,...j->...i", supf, keep.to(torch.float32)) > 0
        new = v & ~killed
        if torch.equal(new, keep):
            break
        keep = new
    out = torch.zeros_like(valid)
    return out.scatter(-1, order, keep)


def batched_nms_mask(boxes, scores, class_ids, valid, *, iou_threshold: float = 0.5):
    """Class-aware keep-mask (d2 ``batched_nms``): boxes of different classes
    are offset apart so they never overlap.  Shapes as in :func:`nms_mask`."""
    zero = boxes.new_zeros(())
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(-2, -1),
                                                               keepdim=True) + 1.0
    offset = class_ids.to(boxes.dtype)[..., None] * max_coord
    return nms_mask(boxes + offset, scores, valid, iou_threshold=iou_threshold)


def compact_batched_nms_mask(boxes, scores, class_ids, valid, *, iou_threshold: float):
    """:func:`batched_nms_mask` over ``(B, N)`` candidates, solved apart for
    each image and class on its valid candidates only (d2's
    ``fast_rcnn_inference_single_image`` filters by score before NMS).

    The boxes are first offset by class as the dense solve offsets them
    (``class * max_coord``, ``max_coord`` one above the largest valid
    coordinate), so boxes of different classes never overlap there and a
    box is suppressed only within its class.  Each (image, class) row then
    takes its valid candidates, in index order, into as many slots as the
    fullest row has; ``nms_mask`` solves the rows together and the
    keep-mask is scattered back.  The result equals the dense solve's bit
    for bit: within a class the candidates keep their order (so the stable
    sort breaks ties alike) and their offset boxes (so every IoU is the
    same number), and invalid slots neither keep nor suppress.  The dense
    solve builds ``N x N`` matrices (20,000 x 20,000 per image at 1000
    proposals and 20 classes); this one ``classes x cap x cap``, ``cap`` at
    most the proposal count."""
    B, N = valid.shape
    keep = torch.zeros((B, N + 1), dtype=torch.bool, device=valid.device)
    if N == 0 or not bool(valid.any()):
        return keep[:, :N]
    max_coord = torch.where(valid[..., None], boxes, boxes.new_zeros(())).amax(
        dim=(-2, -1), keepdim=True) + 1.0
    boxes = boxes + class_ids.to(boxes.dtype)[..., None] * max_coord
    C = int(class_ids.max()) + 1
    classes = torch.arange(C, device=valid.device)
    sel = (valid[:, None, :] & (class_ids[:, None, :] == classes[None, :, None])).reshape(B * C, N)
    cap = int(sel.sum(dim=1).max())

    def rows(x):
        return x[:, None].expand(B, C, *x.shape[1:]).reshape(B * C, *x.shape[1:])

    pos = torch.arange(N, device=valid.device).expand(B * C, N)
    (c_boxes, c_scores, c_pos), n = compact_rows(sel, cap, (rows(boxes), 0.0),
                                                 (rows(scores), 0.0), (pos, N))
    c_valid = torch.arange(cap, device=valid.device)[None, :] < n[:, None]
    c_keep = nms_mask(c_boxes, c_scores, c_valid, iou_threshold=iou_threshold)
    return keep.scatter(1, c_pos.reshape(B, C * cap), c_keep.reshape(B, C * cap))[:, :N]


def compact_rows(sel, cap: int, *values):
    """Move the rows of each image where ``sel (B, N)`` holds, in order, to
    the front of ``cap`` slots; slots past them keep each value's fill.
    ``values`` are ``(x (B, N, ...), fill)`` pairs; returns the compacted
    tensors ``(B, cap, ...)`` and the count of live slots ``(B,)``."""
    B = sel.shape[0]
    order = torch.cumsum(sel.to(torch.int64), dim=1) - 1
    slot = torch.where(sel & (order < cap), order, torch.full_like(order, cap))
    bidx = torch.arange(B, device=sel.device)[:, None].expand_as(slot)
    out = []
    for x, fill in values:
        buf = torch.full((B, cap + 1) + tuple(x.shape[2:]), fill, dtype=x.dtype, device=x.device)
        buf[bidx, slot] = x  # slot ``cap`` collects the rows left out
        out.append(buf[:, :cap])
    return out, sel.sum(dim=1).clamp(max=cap)


def topk_after_nms(boxes, scores, keep, k: int):
    """Compact kept boxes to the top ``k`` by score.  Returns ``(boxes (k, 4),
    scores (k,), indices (k,), valid (k,))``."""
    masked = torch.where(keep, scores, torch.full_like(scores, NEG))
    top_scores, idx = stable_topk(masked, k)
    out_valid = top_scores > -1.0e29
    out_boxes = torch.where(out_valid[..., None],
                            torch.gather(boxes, -2, idx[..., None].expand(*idx.shape, 4)),
                            boxes.new_zeros(()))
    return out_boxes, torch.where(out_valid, top_scores, scores.new_zeros(())), idx, out_valid


def stable_topk(x, k: int):
    """``jax.lax.top_k`` semantics on the last axis: descending values, equal
    values in ascending index order."""
    order = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, order), order
