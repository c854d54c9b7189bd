"""KNN-hypergraph neural network blocks (HGNN, Feng et al.).

Counterpart of ``ttdg_mgm_tpu/graph/hypergraph.py``: each node spawns one
hyperedge over its ``k`` nearest nodes (itself included), weighted
``exp(-d^2 / mean_d^2)``; the normalised hypergraph Laplacian
``G = Dv^-1/2 H De^-1 H^T Dv^-1/2`` (unit hyperedge weights); HGNN
convolutions ``G (x Theta)`` in a two-layer residual block.  Distance ties
pick the lower index (a stable sort), as JAX's does.  Parameter names:
``hgc1.theta`` and ``hgc2.theta``, ``nn.Linear`` layers
(``checkpoint/bridge.py:hypergraph_to_torch`` maps the JAX tree).
"""

from __future__ import annotations

import torch
from torch import nn


def knn_hypergraph_laplacian(x, k_neig: int = 10, *, prob: bool = True):
    """``G (N, N)`` of the nodes ``x (N, D)``."""
    n = x.shape[0]
    d2 = torch.square(x[:, None] - x[None, :]).sum(dim=-1)
    dist = torch.sqrt(d2.clamp(min=0.0))
    k = min(k_neig, n)
    idx = torch.argsort(dist, dim=1, stable=True)[:, :k]
    avg = dist.mean(dim=1, keepdim=True)
    w = torch.exp(-torch.square(dist) / torch.square(avg).clamp(min=1e-12))
    rows = torch.arange(n, device=x.device)[:, None].expand(n, k).reshape(-1)
    cols = idx.reshape(-1)
    H = torch.zeros((n, n), dtype=x.dtype, device=x.device)
    H = H.index_put((cols, rows), w[rows, cols] if prob else torch.ones_like(w[rows, cols]))
    dv = H.sum(dim=1)
    de = H.sum(dim=0)
    dv2 = 1.0 / torch.sqrt(dv.clamp(min=1e-12))
    inv_de = 1.0 / de.clamp(min=1e-12)
    return (dv2[:, None] * H) * inv_de[None, :] @ H.T * dv2[None, :]


class HGNNConv(nn.Module):
    """``G @ theta(x)``."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True):
        super().__init__()
        self.theta = nn.Linear(in_features, out_features, bias=use_bias)

    def forward(self, x, G):
        return G @ self.theta(x)


class HyperGraphBlock(nn.Module):
    """Two HGNN convolutions with a ReLU between and a residual:
    ``x + hgc2(relu(hgc1(x, G)), G)`` on ``x (N, dim)``, ``G`` the KNN
    hypergraph of ``x``.  ``dropout`` on the hidden layer when not
    ``deterministic``, its mask drawn from ``generator``."""

    def __init__(self, dim: int, hidden: int = 256, k_neig: int = 10, dropout: float = 0.0):
        super().__init__()
        self.k_neig = k_neig
        self.dropout = dropout
        self.hgc1 = HGNNConv(dim, hidden)
        self.hgc2 = HGNNConv(hidden, dim)

    def forward(self, x, *, deterministic: bool = True, generator=None):
        G = knn_hypergraph_laplacian(x, self.k_neig)
        h = torch.relu(self.hgc1(x, G))
        if self.dropout > 0 and not deterministic:
            if generator is None:
                raise ValueError("HyperGraphBlock's dropout draws from a given generator")
            keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - self.dropout
            h = torch.where(keep, h / (1.0 - self.dropout), torch.zeros((), device=h.device))
        return x + self.hgc2(h, G)
