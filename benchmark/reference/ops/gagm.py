"""The GA-GM solver of the TTA path, plain: ``graph/solvers.py:ga_gm``
(annealed Sinkhorn rounds, then the exact LAP finale) under the name and
arguments the matching module calls.  Frozen copy of the port's plain
version; the CUDA kernel is not here."""

from __future__ import annotations

import torch

from reference.graph.solvers import ga_gm


def ga_gm_fused(A, W, U0, ms, n_univ: int, *, quad_weight: float = 1.0,
                mgm_iter: int = 200, sk_iter: int = 20, sk_tau0: float = 0.1,
                sk_gamma: float = 0.5, min_tau: float = 1e-2, tol: float = 1e-3,
                lap_iter_cap: int = 200, return_steps: bool = False):
    """GA-GM with the exact-LAP finale on float32 ``A``, ``W``, ``U0``;
    with ``return_steps`` also the steps taken per round."""
    for name, t in (("A", A), ("W", W), ("U0", U0)):
        if t.dtype != torch.float32:
            raise ValueError(f"ga_gm_fused: {name} must be float32, got {t.dtype}")
    return ga_gm(A, W, U0, ms, n_univ, quad_weight=quad_weight, mgm_iter=mgm_iter,
                 sk_iter=sk_iter, sk_tau0=sk_tau0, sk_gamma=sk_gamma, min_tau=min_tau, tol=tol,
                 hung_iter_cap=lap_iter_cap, return_steps=return_steps)
