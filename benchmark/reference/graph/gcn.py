"""Graph convolution blocks of the cross-domain head.

Counterpart of ``ttdg_mgm_tpu/graph/gcn.py``:

* :class:`Feat2Graph`: the QK soft adjacency ``adj = L1-normalise((X Wq)
  (X Wk)^T)^2`` over valid node pairs, each row divided by its L1 mass
  floored at 1e-12;
* :class:`GraphConvolution`: ``adj @ (X W + b)`` (the bias before the
  aggregation, as the JAX layer; Kipf's reference layer adds it after), its
  weight drawn from normal(0.02);
* :class:`MAGNN`: three ReLU graph convolutions over one Feat2Graph
  adjacency plus the input, padded rows zeroed.

Parameter names follow the JAX modules (``graph.wq``, ``graph.wk``,
``gc1`` .. ``gc3``); a graph convolution keeps Kipf's ``weight`` ``(in,
out)`` and ``bias``.
"""

from __future__ import annotations

import torch
from torch import nn


class Feat2Graph(nn.Module):
    """``forward(x (..., M, D), mask (..., M)) -> (x, adj (..., M, M))``."""

    def __init__(self, num_feats: int = 256):
        super().__init__()
        self.wq = nn.Linear(num_feats, num_feats)
        self.wk = nn.Linear(num_feats, num_feats)

    def forward(self, x, mask=None):
        dot = torch.einsum("...md,...nd->...mn", self.wq(x), self.wk(x))
        sq = dot * dot
        if mask is not None:
            sq = torch.where(mask[..., None, :] & mask[..., :, None], sq,
                             torch.zeros((), device=sq.device))
        return x, sq / sq.abs().sum(dim=-1, keepdim=True).clamp(min=1e-12)


class GraphConvolution(nn.Module):
    """``forward(x (..., M, I), adj (..., M, M)) -> (..., M, O)``."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        nn.init.normal_(self.weight, std=0.02)

    def forward(self, x, adj):
        return torch.einsum("...mn,...nd->...md", adj, x @ self.weight + self.bias)


class MAGNN(nn.Module):
    """Three-layer residual GCN over a learned QK adjacency:
    ``forward(x (..., M, nfeat), mask (..., M)) -> (..., M, nfeat)``."""

    def __init__(self, nfeat: int = 256, nhid: int = 256):
        super().__init__()
        self.graph = Feat2Graph(nfeat)
        self.gc1 = GraphConvolution(nfeat, nhid)
        self.gc2 = GraphConvolution(nhid, nhid)
        self.gc3 = GraphConvolution(nhid, nfeat)

    def forward(self, x, mask=None):
        x_in = x
        x, adj = self.graph(x, mask)
        h = torch.relu(self.gc1(x, adj))
        h = torch.relu(self.gc2(h, adj))
        h = torch.relu(self.gc3(h, adj))
        out = h + x_in
        if mask is not None:
            out = torch.where(mask[..., None], out, torch.zeros((), device=out.device))
        return out
