"""Supervised universe learning: the matching loss of source training.

Counterpart of ``ttdg_mgm_tpu/graph/universe.py`` (reference ``G_Universe``
and ``U_sup``): a learnable universe ``U (univ, D)`` is matched against each
image's graph nodes; the loss pulls the Sinkhorn-normalised node-to-universe
scores towards the HiPPI fixed point.

Padded-block layout: nodes ``(G, M, D)`` with each graph's valid nodes
first.  The HiPPI target is detached; gradients flow through the attention,
the scores and into ``U`` (also through its Frobenius regulariser).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.graph.attention import MultiHeadAttention
from reference.graph.solvers import hippi
from reference.ops.sinkhorn import sinkhorn_masked

#: the reference's adjacency scale: ``1 / (cos_similarity + 1e-8)`` with a
#: cosine term that is identically 0, so ``1e8`` (it cancels inside HiPPI's
#: log-domain projections)
ADJ_SCALE = 1.0e8


class GUniverse(nn.Module):
    """Node-set self-attention -> ``(scores (..., M, univ), adjacency (..., M,
    M))``.  The reference's attention dropout stays off, as the JAX module's
    ``deterministic=True`` default leaves it."""

    def __init__(self, dim: int = 256, univ_size: int = 32):
        super().__init__()
        self.univ_size = univ_size
        self.g_gene = MultiHeadAttention(dim, 1)

    def forward(self, nodes, mask, U):
        node, edge = self.g_gene(nodes, mask)
        edge_d = edge * ADJ_SCALE
        scores = torch.einsum("...md,ud->...mu", node, U)
        zero = torch.zeros((), device=nodes.device)
        scores = torch.where(mask[..., None], scores, zero)
        edge_d = torch.where(mask[..., None, :] & mask[..., :, None], edge_d, zero)
        return scores, edge_d


def _one_hot_labels(labels, mask, num_classes: int):
    """Labels are class + 1 (0 = invalid); invalid rows give all-zero
    one-hots."""
    oh = F.one_hot((labels.long() - 1).clamp(min=0), num_classes).to(torch.float32)
    return torch.where((mask & (labels > 0))[..., None], oh, torch.zeros((), device=oh.device))


class USup(nn.Module):
    """Supervised universe matching loss: ``forward(nodes (G, M, D), labels
    (G, M), mask (G, M)) -> scalar``.  Owns the universe ``U``, which the
    TTA matcher reads detached."""

    def __init__(self, num_classes: int = 2, univ_size: int = 32, dim: int = 256, *,
                 sk_tau: float = 0.05, sk_iter: int = 20, hippi_iters: int = 50,
                 loss_w: float = 0.1, loss_lam: float = 1e-4):
        super().__init__()
        self.num_classes = num_classes
        self.univ_size = univ_size
        self.sk_tau = sk_tau
        self.sk_iter = sk_iter
        self.hippi_iters = hippi_iters
        self.loss_w = loss_w
        self.loss_lam = loss_lam
        self.U = nn.Parameter(torch.zeros(univ_size, dim))
        self.Net_U = GUniverse(dim, univ_size)
        #: HiPPI iterations of the last call
        self.last_hippi_steps = None

    def forward(self, nodes, labels, mask):
        G, M, _ = nodes.shape
        T = G * M
        scores, edges = self.Net_U(nodes, mask, self.U)
        # one global Sinkhorn over the (G*M, univ) scores: the valid rows are
        # the union of every graph's valid nodes
        row_mask = mask.reshape(T)
        U_ds = sinkhorn_masked(scores.reshape(T, self.univ_size), row_mask, tau=self.sk_tau,
                               max_iter=self.sk_iter)
        with torch.no_grad():
            # block-diagonal adjacency (diagonal not zeroed), the label-block
            # matrix Wl and HiPPI's input Wl^T A Wl
            A = torch.block_diag(*edges.detach().to(torch.float32))
            oh = _one_hot_labels(labels, mask, self.num_classes).reshape(T, self.num_classes)
            Wl = oh @ oh.T
            ms = mask.to(torch.int64).sum(dim=-1)
            target, self.last_hippi_steps = hippi(
                Wl.T @ A @ Wl, U_ds, ms, self.univ_size, max_iter=self.hippi_iters,
                sk_iter=self.sk_iter, return_steps=True)
        diff = torch.square(U_ds - target)
        denom = (row_mask.to(torch.float32).sum() * self.univ_size).clamp(min=1.0)
        mse = torch.where(row_mask[:, None], diff, torch.zeros((), device=diff.device)).sum() / denom
        return self.loss_w * mse + self.loss_lam * torch.sqrt(torch.sum(torch.square(self.U))
                                                              + 1e-12)
