"""Supervised contrastive loss (SupCon; SimCLR without labels).

Counterpart of ``ttdg_mgm_tpu/graph/contrastive.py:sup_con_loss``: a
multi-view contrastive loss whose positives are given by labels or by a
mask.  Neither package's active path calls it.
"""

from __future__ import annotations

import torch


def sup_con_loss(features, labels=None, mask=None, *, temperature: float = 0.07,
                 base_temperature: float = 0.07, contrast_mode: str = "all"):
    """features ``(B, V, D)`` L2-normalised views; labels ``(B,)`` or a
    positives mask ``(B, B)``, not both (neither: each sample's own views).
    ``contrast_mode`` ``"one"`` anchors on the first view, ``"all"`` on
    every view.  Returns the scalar loss."""
    B, V, D = features.shape
    dev = features.device
    if labels is not None and mask is not None:
        raise ValueError("Cannot define both labels and mask")
    if labels is None and mask is None:
        pos = torch.eye(B, dtype=torch.float32, device=dev)
    elif labels is not None:
        labels = labels.reshape(-1, 1)
        pos = (labels == labels.T).to(torch.float32)
    else:
        pos = mask.to(torch.float32)

    contrast = features.transpose(0, 1).reshape(V * B, D)
    if contrast_mode == "one":
        anchor, a_count = features[:, 0], 1
    elif contrast_mode == "all":
        anchor, a_count = contrast, V
    else:
        raise ValueError(f"Unknown mode: {contrast_mode}")

    logits = anchor @ contrast.T / temperature
    logits = logits - logits.amax(dim=1, keepdim=True)
    pos = pos.repeat(a_count, V)
    self_mask = 1.0 - torch.eye(B * a_count, B * V, dtype=torch.float32, device=dev)
    pos = pos * self_mask
    exp_logits = torch.exp(logits) * self_mask
    log_prob = logits - torch.log(exp_logits.sum(dim=1, keepdim=True))
    mean_log_prob_pos = (pos * log_prob).sum(dim=1) / pos.sum(dim=1).clamp(min=1e-12)
    return (-(temperature / base_temperature) * mean_log_prob_pos).mean()
