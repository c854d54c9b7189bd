"""Matching losses: ``BCEFocalLoss`` (the loss of the TTA path) and the
permutation losses of the graph-matching literature.

Counterpart of ``ttdg_mgm_tpu/graph/losses.py``.  The losses take explicit
validity masks instead of ragged slices, and reduce over the valid entries,
rows or problems as the JAX package does; all are differentiable by
autograd except where a discrete assignment enters as data
(:func:`ilp_attention_loss`).
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-6


class BCEFocalLoss:
    """Binary focal cross-entropy on probabilities, masked mean over the
    last two dims:
    ``-alpha (1-p)^g t log p - (1-alpha) p^g (1-t) log(1-p)``."""

    def __init__(self, gamma: float = 2.0, alpha: float = 0.25):
        self.gamma = gamma
        self.alpha = alpha

    def __call__(self, p, target, mask=None):
        p = p.to(torch.float32).clamp(EPS, 1.0 - EPS)
        t = target.to(torch.float32)
        loss = (-self.alpha * (1.0 - p) ** self.gamma * t * torch.log(p)
                - (1.0 - self.alpha) * p ** self.gamma * (1.0 - t) * torch.log(1.0 - p))
        if mask is None:
            mask = torch.ones_like(loss, dtype=torch.bool)
        zero = torch.zeros((), device=loss.device)
        total = torch.where(mask, loss, zero).sum(dim=(-2, -1))
        return total / mask.to(torch.float32).sum(dim=(-2, -1)).clamp(min=1.0)


def _zero(x):
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _masked_mean(x, mask):
    """Mean of ``x`` over ``mask``: over every entry together."""
    denom = mask.to(torch.float32).sum().clamp(min=1.0)
    return torch.where(mask, x, _zero(x)).sum() / denom


def permutation_loss(pred_dsmat, gt_perm, mask=None, gamma: float = 2.0, alpha: float = 0.25):
    """BCE-focal permutation loss: ``pred_dsmat`` and ``gt_perm`` ``(...,
    N1, N2)`` in [0, 1], ``mask`` bool of the same shape; the mean over the
    valid entries of the whole batch."""
    p = pred_dsmat.to(torch.float32).clamp(EPS, 1.0 - EPS)
    t = gt_perm.to(torch.float32)
    loss = (-alpha * (1.0 - p) ** gamma * t * torch.log(p)
            - (1.0 - alpha) * p ** gamma * (1.0 - t) * torch.log(1.0 - p))
    if mask is None:
        mask = torch.ones_like(loss, dtype=torch.bool)
    return _masked_mean(loss, mask)


def cross_entropy_perm_loss(pred_dsmat, gt_perm, row_mask=None):
    """Cross-entropy between permutations: ``-sum_j gt log(pred)`` per row,
    averaged over the valid rows (``row_mask (..., N1)``)."""
    p = pred_dsmat.to(torch.float32).clamp(EPS, 1.0)
    ll = -(gt_perm * torch.log(p)).sum(dim=-1)
    if row_mask is None:
        row_mask = torch.ones(ll.shape, dtype=torch.bool, device=ll.device)
    return _masked_mean(ll, row_mask)


def hamming_loss(pred_perm, gt_perm, mask=None):
    """Hamming distance ``sum(pred (1 - gt) + gt (1 - pred))`` per problem,
    averaged over the problems."""
    x = pred_perm * (1.0 - gt_perm) + gt_perm * (1.0 - pred_perm)
    if mask is not None:
        x = torch.where(mask, x, _zero(x))
    return x.sum(dim=(-2, -1)).mean()


def _valid_rows(mask, shape):
    """The valid source rows of the whole batch: rows with a valid entry,
    or every row without ``mask``."""
    if mask is None:
        return float(np.prod(shape[:-1]))
    return mask.any(dim=-1).sum().clamp(min=1)


def inner_product_loss(pred, gt_perm, mask=None):
    """``-sum(pred * gt) / valid rows``."""
    x = pred * gt_perm
    if mask is not None:
        x = torch.where(mask, x, _zero(x))
    return -x.sum() / _valid_rows(mask, pred.shape)


def offset_loss(d_pred, d_gt, grad_mask=None, norm=None, epsilon: float = 1e-5):
    """Robust displacement loss
    ``sum(sqrt(||(d_pred - d_gt) / norm||^2 * mask + eps)) / d_pred.shape[0]``."""
    x = d_pred - d_gt
    if norm is not None:
        x = x / norm
    sq = torch.square(x)
    if grad_mask is not None:
        sq = sq * grad_mask
    return torch.sqrt(sq.sum(dim=-1) + epsilon).sum() / d_pred.shape[0]


def focal_perm_loss(pred_dsmat, gt_perm, mask=None, gamma: float = 0.0):
    """Focal permutation loss without ``alpha``, summed over the batch and
    divided by the valid source rows."""
    p = pred_dsmat.to(torch.float32).clamp(EPS, 1.0 - EPS)
    t = gt_perm.to(torch.float32)
    loss = -((1.0 - p) ** gamma) * t * torch.log(p) - (p ** gamma) * (1.0 - t) * torch.log(1.0 - p)
    if mask is not None:
        loss = torch.where(mask, loss, _zero(loss))
    return loss.sum() / _valid_rows(mask, pred_dsmat.shape)


def displacement(s, p_src, p_tgt, ns=None):
    """Displacement ``d = S @ P_tgt - P_src`` between matched point sets
    (``s (..., N1, N2)``, ``p_src (..., N1, 2)``, ``p_tgt (..., N2, 2)``) and
    the gradient mask of the rows below ``ns (...,)`` (None without ``ns``)."""
    d = torch.matmul(s, p_tgt) - p_src
    if ns is None:
        return d, None
    idx = torch.arange(p_src.shape[-2], device=p_src.device)
    ns = torch.as_tensor(ns, device=p_src.device)
    grad_mask = (idx < ns[..., None]).to(p_src.dtype)[..., None]
    return d, grad_mask.expand(p_src.shape)


def ilp_attention_loss(pred_dsmat, gt_perm, src_ns=None, tgt_ns=None):
    """ILP attention loss: BCE restricted to the union of the discretised
    prediction and the ground-truth assignment, over the valid rows.  The
    discretisation is the exact LAP of ``p + 1`` on the host
    (``ops/lap.py:hungarian_auto``), entering as data (no gradient)."""
    from reference.ops.lap import hungarian_auto

    p = pred_dsmat.to(torch.float32).clamp(EPS, 1.0 - EPS)
    t = gt_perm.to(torch.float32)
    if p.dim() == 2:
        p, t = p[None], t[None]
    b, n1, n2 = p.shape
    dev = p.device
    src_ns = (torch.full((b,), n1, dtype=torch.int32, device=dev) if src_ns is None
              else torch.as_tensor(src_ns, device=dev))
    tgt_ns = (torch.full((b,), n2, dtype=torch.int32, device=dev) if tgt_ns is None
              else torch.as_tensor(tgt_ns, device=dev))
    dis = hungarian_auto(p.detach() + 1.0, src_ns, tgt_ns)
    ali = torch.clamp(dis + t, max=1.0)
    valid = ((torch.arange(n1, device=dev)[None, :, None] < src_ns[:, None, None])
             & (torch.arange(n2, device=dev)[None, None, :] < tgt_ns[:, None, None]))
    bce = -(t * torch.log(p) + (1.0 - t) * torch.log(1.0 - p)) * ali
    bce = torch.where(valid, bce, _zero(bce))
    return bce.sum() / src_ns.sum().to(torch.float32).clamp(min=1.0)


def concat_matrix(mats, indices, num_blocks: int):
    """The symmetric joint matrix of ``num_blocks`` square blocks of side
    ``M`` from ``mats (P, M, M)``: block ``k`` at ``indices[k] = (row,
    col)`` and its transpose at ``(col, row)``, later blocks over earlier
    ones, zero elsewhere."""
    mats = torch.as_tensor(mats)
    M = mats.shape[-1]
    big = torch.zeros((num_blocks * M, num_blocks * M), dtype=mats.dtype, device=mats.device)
    for k, (r, c) in enumerate(indices):
        big[r * M:(r + 1) * M, c * M:(c + 1) * M] = mats[k]
        big[c * M:(c + 1) * M, r * M:(r + 1) * M] = mats[k].T
    return big
