"""Spectral clustering of a small similarity matrix (MGM-Mixture's outer
step).

Counterpart of ``ttdg_mgm_tpu/graph/spectral.py``: the graph Laplacian
(row-normalised by the degree and symmetrised when ``normalized``), its
eigendecomposition (``torch.linalg.eigh``), the ``cluster_num - 1``
eigenvectors after the first by ``|eigenvalue|``, then the 2-cluster sign
split or k-means (farthest-point start, 50 Lloyd steps).  Sorts and
arg-extrema break ties towards the lower index, as JAX's do.

The sign of an eigenvector is arbitrary, and ``torch`` and ``jnp`` may
return opposite ones, which swaps the labels of a 2-cluster split (an
entry that is exactly 0 joins cluster 0 under either sign); the result is
the same partition, and every consumer compares labels only with each
other (``clusters[:, None] == clusters[None, :]``).  k-means on the
eigenvectors is unchanged by their signs.
"""

from __future__ import annotations

import torch


def _sqdist(x, centers):
    return torch.square(x[:, None, :] - centers[None, :, :]).sum(dim=-1)


def _kmeans(x, k: int, iters: int = 50):
    """k-means: the point of largest norm, then each next center the point
    farthest from those chosen; ``iters`` Lloyd steps (an empty cluster's
    center goes to the origin); ``(n,)`` int32 labels."""
    first = int(torch.argmax(torch.square(x).sum(dim=-1)))
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    for i in range(1, k):
        unset = torch.where(torch.arange(k, device=x.device) >= i, 1e30, 0.0).to(x.dtype)
        d = torch.amin(_sqdist(x, centers) + unset[None, :], dim=1)
        centers[i] = x[int(torch.argmax(d))]
    for _ in range(iters):
        assign = torch.argmin(_sqdist(x, centers), dim=1)
        onehot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = onehot.sum(dim=0).clamp(min=1.0)
        centers = (onehot.T @ x) / counts[:, None]
    return torch.argmin(_sqdist(x, centers), dim=1).to(torch.int32)


@torch.no_grad()
def spectral_clustering(sim_matrix, cluster_num: int, *, normalized: bool = False):
    """``(n,)`` int32 cluster labels from an ``(n, n)`` similarity matrix,
    on its device."""
    sim = sim_matrix.to(torch.float32)
    deg = sim.sum(dim=-1)
    lap = torch.diag(deg) - sim
    if normalized:
        lap = lap / deg.clamp(min=1e-12)[:, None]
        lap = 0.5 * (lap + lap.T)
    e, v = torch.linalg.eigh(lap)
    order = torch.argsort(torch.abs(e), stable=True)
    feats = v[:, order[1:cluster_num]]
    if cluster_num == 2:
        return (feats[:, 0] > 0).to(torch.int32)
    return _kmeans(feats, cluster_num)
