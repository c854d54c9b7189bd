"""The cross-domain graph-matching head of the mean-teacher step.

Counterpart of ``ttdg_mgm_tpu/graph/cross_domain.py:CrossDomainGraphHead``
(the SIGMA-style ``GModule`` the reference defines but never wires):

* domain-guided node completion (``seed_project``): a class present in the
  other domain but missing here gets ``completion_nodes_per_class`` nodes
  drawn around its EMA center and pushed through a learned projection
  (a fixed block of slots per class, valid only where completion applies);
* intra-domain aggregation: ``intra_gcn`` (:class:`~reference.graph.gcn.MAGNN`)
  then ``intra_attention``, one head;
* cross-graph interaction: ``cross_attention`` over both node sets
  concatenated, split back in two;
* ``node_cls``: the cross-entropy of the enhanced nodes' classes;
* the EMA class centers (momentum 0.99, only seen classes move, no
  gradient), state the caller threads through;
* ``matching_affinity`` with a 20-iteration Sinkhorn (tau 0.05) over both
  node masks against the label-agreement matrix;
* the topology loss: :func:`~reference.graph.ot.proto_loss` from the
  new centers plus :func:`~reference.graph.ot.sinkhorn_distance`
  between the two node clouds.

Node sets are padded ``(M, D)`` with masks; labels are class + 1, 0 for
none.  The completion noise, ``jax.random.normal`` inside the JAX module,
is an input here (:meth:`CrossDomainGraphHead.draw_noise` draws it from a
``torch.Generator``): the same noise gives the JAX losses, the same seed
does not.
"""

from __future__ import annotations

import torch
from torch import nn

from reference.graph.affinity import Affinity
from reference.graph.attention import MultiHeadAttention
from reference.graph.gcn import MAGNN
from reference.graph.ot import proto_loss, sinkhorn_distance
from reference.ops.sinkhorn import sinkhorn_masked


def _masked_ce(logits, labels, mask):
    """Mean cross-entropy over the rows of ``mask`` (0 when none)."""
    ll = torch.logsumexp(logits, dim=-1) - logits.gather(1, labels[:, None].long())[:, 0]
    return torch.where(mask, ll, torch.zeros((), device=ll.device)).sum() / mask.sum().clamp(
        min=1).to(ll.dtype)


def update_centers(centers, nodes, labels, mask, momentum: float):
    """The EMA class centers after one batch of nodes: each class's mean
    node (invalid nodes count as class 0) moves its center by ``1 -
    momentum``; a class with no node keeps its center.  No gradient."""
    C1 = centers.shape[0]
    onehot = nn.functional.one_hot(torch.where(mask, labels, 0).long(), C1).to(nodes.dtype)
    n = onehot.sum(dim=0)
    batch = (onehot.T @ nodes) / n.clamp(min=1.0)[:, None]
    seen = (n > 0)[:, None]
    return torch.where(seen, momentum * centers + (1 - momentum) * batch, centers).detach()


class CrossDomainGraphHead(nn.Module):
    """``forward(src_nodes, src_labels, src_mask, tgt_nodes, tgt_labels,
    tgt_mask, centers=None, *, noise=None) -> (losses, new_centers)``."""

    def __init__(self, num_classes: int = 2, dim: int = 256, *, sk_tau: float = 0.05,
                 sk_iter: int = 20, center_momentum: float = 0.99,
                 completion_nodes_per_class: int = 4):
        super().__init__()
        self.num_classes = num_classes
        self.dim = dim
        self.sk_tau = sk_tau
        self.sk_iter = sk_iter
        self.center_momentum = center_momentum
        self.completion_nodes_per_class = completion_nodes_per_class
        self.seed_project = nn.Linear(dim, dim)
        self.intra_gcn = MAGNN(dim, dim)
        self.intra_attention = MultiHeadAttention(dim, 1)
        self.cross_attention = MultiHeadAttention(dim, 1)
        self.node_cls = nn.Linear(dim, num_classes + 1)
        self.matching_affinity = Affinity(dim)

    def noise_shape(self) -> tuple:
        """The completion noise: one draw per domain, ``(2, num_classes,
        completion_nodes_per_class, dim)``."""
        return (2, self.num_classes, self.completion_nodes_per_class, self.dim)

    def draw_noise(self, generator: torch.Generator | None = None, device=None):
        """Standard normal completion noise of :meth:`noise_shape`."""
        return torch.randn(self.noise_shape(), generator=generator, device=device)

    def _complete(self, nodes, labels, mask, other_labels, other_mask, centers, noise):
        H = self.completion_nodes_per_class
        classes = torch.arange(1, self.num_classes + 1, device=nodes.device)
        present_here = ((labels[None, :] == classes[:, None]) & mask[None, :]).any(dim=1)
        present_other = ((other_labels[None, :] == classes[:, None])
                         & other_mask[None, :]).any(dim=1)
        need = ~present_here & present_other
        seeds = centers[1:, None, :] + noise * 0.01
        seeds = self.seed_project(seeds.reshape(self.num_classes * H, self.dim))
        return (torch.cat([nodes, seeds]),
                torch.cat([labels, classes.repeat_interleave(H).to(labels.dtype)]),
                torch.cat([mask, need.repeat_interleave(H)]))

    def forward(self, src_nodes, src_labels, src_mask, tgt_nodes, tgt_labels, tgt_mask,
                centers=None, *, noise=None):
        """Node sets ``(M, D)`` float32, labels ``(M,)`` class + 1 (0
        invalid), masks ``(M,)`` bool; ``centers`` ``(num_classes + 1, D)``
        (zeros when None).  With ``noise`` (:meth:`noise_shape`), each
        domain is completed before matching, the source first.  Both node
        sets must have the same number of rows: the cross attention's
        output is split in half.  Returns ``({"loss_node_cls",
        "loss_cross_matching", "loss_topology"}, new_centers)``."""
        C1 = self.num_classes + 1
        if centers is None:
            centers = torch.zeros((C1, self.dim), device=src_nodes.device)
        if noise is not None:
            src_nodes, src_labels, src_mask = self._complete(
                src_nodes, src_labels, src_mask, tgt_labels, tgt_mask, centers, noise[0])
            tgt_nodes, tgt_labels, tgt_mask = self._complete(
                tgt_nodes, tgt_labels, tgt_mask, src_labels, src_mask, centers, noise[1])
        if src_nodes.shape[0] != tgt_nodes.shape[0]:
            raise ValueError(
                f"the cross-domain head splits its attended nodes in half: the source has "
                f"{src_nodes.shape[0]} node rows and the target {tgt_nodes.shape[0]} (equal "
                "labelled and unlabelled batches give equal counts)")

        src = self.intra_gcn(src_nodes[None], src_mask[None])[0]
        tgt = self.intra_gcn(tgt_nodes[None], tgt_mask[None])[0]
        src, _ = self.intra_attention(src, src_mask)
        tgt, _ = self.intra_attention(tgt, tgt_mask)

        enhanced, _ = self.cross_attention(torch.cat([src, tgt]), torch.cat([src_mask, tgt_mask]))
        src_e, tgt_e = enhanced.chunk(2)

        loss_cls = 0.5 * (
            _masked_ce(self.node_cls(src_e), src_labels, src_mask & (src_labels > 0))
            + _masked_ce(self.node_cls(tgt_e), tgt_labels, tgt_mask & (tgt_labels > 0)))

        new_centers = update_centers(centers, src_e, src_labels, src_mask, self.center_momentum)

        aff = self.matching_affinity(src_e, tgt_e)
        ds = sinkhorn_masked(aff, src_mask, tgt_mask, tau=self.sk_tau, max_iter=self.sk_iter)
        agree = ((src_labels[:, None] == tgt_labels[None, :]) & (src_labels > 0)[:, None]
                 & (tgt_labels > 0)[None, :]).to(torch.float32)
        pair_mask = src_mask[:, None] & tgt_mask[None, :]
        l1 = (ds - agree).abs()
        loss_match = torch.where(pair_mask, l1, torch.zeros((), device=l1.device)).sum() / \
            pair_mask.sum().clamp(min=1).to(l1.dtype)

        prop = torch.full((self.num_classes, 1), 1.0 / self.num_classes, device=tgt_e.device)
        t2p, p2t, _ = proto_loss(new_centers[1:], tgt_e, prop)
        ot_cost, _ = sinkhorn_distance(src_e[None], tgt_e[None])
        losses = {"loss_node_cls": loss_cls, "loss_cross_matching": loss_match,
                  "loss_topology": t2p + p2t + ot_cost.sum()}
        return losses, new_centers
