"""Unsupervised multi-graph matching: the test-time-adaptation loss.

Counterpart of ``ttdg_mgm_tpu/graph/mgm.py:MGM3Unsup``: per-graph
self-attention adjacency, all-pairs learned affinity Sinkhorn-projected to
doubly-stochastic blocks, a GA-GM solve seeded by the frozen universe (no
gradient; the fused CUDA kernel on CUDA tensors), and a BCE-focal
consistency loss between the pairwise Sinkhorn blocks and the ``U_i U_j^T``
pseudo ground truth over all unordered graph pairs.

With ``num_clusters > 1`` (MGM-Mixture, a library option: no config key
sets it, in either package) the solve is ``graph/solvers.py:ga_gm_mixture``,
which also clusters the graphs, and the loss runs over the unordered pairs
within a cluster.
"""

from __future__ import annotations

import torch
from torch import nn

from ttdg_mgm_torch.graph.affinity import Affinity
from ttdg_mgm_torch.graph.attention import MultiHeadAttention
from ttdg_mgm_torch.graph.losses import BCEFocalLoss
from ttdg_mgm_torch.graph.solvers import ga_gm_mixture
from ttdg_mgm_torch.ops.gagm import ga_gm_fused
from ttdg_mgm_torch.ops.sinkhorn import sinkhorn_project
from ttdg_mgm_torch.utils.profiling import span


class MGM3Unsup(nn.Module):
    """``forward(nodes (G, M, D), labels (G, M), mask (G, M), U (univ, D))``
    -> scalar loss.  ``G >= 2``."""

    def __init__(self, num_classes: int = 2, univ_size: int = 32, dim: int = 256, *,
                 quad_weight: float = 0.5, cluster_quad_weight: float = 1.0,
                 sk_tau: float = 0.05, sk_iter: int = 20, mgm_iter: int = 200,
                 num_clusters: int = 1, lap_polish_iters: int = 200):
        super().__init__()
        self.num_classes = num_classes
        self.univ_size = univ_size
        self.quad_weight = quad_weight
        self.cluster_quad_weight = cluster_quad_weight
        self.num_clusters = num_clusters
        self.sk_tau = sk_tau
        self.sk_iter = sk_iter
        self.mgm_iter = mgm_iter
        self.lap_polish_iters = lap_polish_iters
        self.intra_domain_graph = MultiHeadAttention(dim, 1)
        self.node_affinity = Affinity(dim)
        #: steps per GA-GM round of the last solve (annealed rounds, finale;
        #: with clusters, one such list per pass)
        self.last_solver_steps = None
        #: the graphs' clusters of the last solve (with ``num_clusters > 1``)
        self.last_clusters = None
        #: valid nodes per graph in the last solve, ``(G,)`` int32 on the
        #: nodes' device (read it with ``.tolist()``: that waits for it)
        self.last_node_counts = None

    def build_problem(self, nodes, labels, mask, U):
        """GA-GM inputs from raw nodes: adjacency ``A (T, T)``, joint
        doubly-stochastic ``Wds (T, T)``, its ``(G, G, M, M)`` block view and
        pair validity (the loss inputs), seed ``U0 (T, univ)``, ``ms (G,)``."""
        G, M, D = nodes.shape
        T = G * M
        ms = mask.to(torch.int32).sum(dim=-1)
        _, adj = self.intra_domain_graph(nodes, mask)
        eye = torch.eye(M, dtype=torch.bool, device=nodes.device)
        adj = torch.where(eye[None], torch.zeros((), device=adj.device), adj)
        A = torch.block_diag(*adj.to(torch.float32))
        aff = self.node_affinity(nodes[:, None].expand(G, G, M, D),
                                 nodes[None, :].expand(G, G, M, D))
        ds = sinkhorn_project(aff, ms[:, None].expand(G, G), ms[None, :].expand(G, G),
                              tau=self.sk_tau, max_iter=self.sk_iter)
        pair_valid = mask[:, None, :, None] & mask[None, :, None, :]
        ds = torch.where(pair_valid, ds, torch.zeros((), device=ds.device))
        # pair (i, j) comes from the lower triangle: (i, j) for i >= j, else
        # the transpose of (j, i)
        g = torch.arange(G, device=nodes.device)
        lower = (g[:, None] >= g[None, :])[:, :, None, None]
        ds_sym = torch.where(lower, ds, ds.transpose(-1, -2).transpose(0, 1))
        Wds = ds_sym.permute(0, 2, 1, 3).reshape(T, T)
        U0 = torch.einsum("gmd,ud->gmu", nodes, U)
        U0 = torch.where(mask[..., None], U0, torch.zeros((), device=U0.device))
        return A, Wds, ds_sym, pair_valid, U0.reshape(T, self.univ_size), ms

    def forward(self, nodes, labels, mask, U):
        G, M, _ = nodes.shape
        A, Wds, ds_sym, pair_valid, U0, ms = self.build_problem(nodes, labels, mask, U)
        g = torch.arange(G, device=nodes.device)
        pair_sel = g[:, None] < g[None, :]
        if self.num_clusters > 1:
            U_b, clusters, trace = ga_gm_mixture(
                A, Wds, U0, ms, self.univ_size, self.num_clusters,
                quad_weight=self.quad_weight, cluster_quad_weight=self.cluster_quad_weight,
                mgm_iter=self.mgm_iter, sk_iter=self.sk_iter)
            self.last_solver_steps = trace["steps"]
            self.last_clusters = clusters.tolist()
            # pairs within a cluster only
            pair_sel = pair_sel & (clusters[:, None] == clusters[None, :])
        else:
            # the span holds the solve's one wait on the device (its steps)
            with span("step.gagm"):
                U_b, steps = ga_gm_fused(
                    A.detach(), Wds.detach(), U0.detach(), ms, self.univ_size,
                    quad_weight=self.quad_weight, mgm_iter=self.mgm_iter,
                    sk_iter=self.sk_iter, sk_tau0=0.1, sk_gamma=0.5, min_tau=1e-2, tol=1e-3,
                    lap_iter_cap=self.lap_polish_iters, return_steps=True)
            self.last_solver_steps = steps
        self.last_node_counts = ms
        Ug = U_b.reshape(G, M, self.univ_size)
        gt = torch.einsum("imu,jnu->ijmn", Ug, Ug).clamp(0.0, 1.0)
        losses = BCEFocalLoss()(ds_sym, gt, pair_valid)
        n_pairs = pair_sel.to(torch.float32).sum().clamp(min=1.0)
        return torch.where(pair_sel, losses, torch.zeros((), device=losses.device)).sum() / n_pairs
