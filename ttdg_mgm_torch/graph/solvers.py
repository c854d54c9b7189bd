"""Multi-graph-matching solvers: HiPPI, and Graduated-Assignment
multi-graph matching (GA-GM) in plain PyTorch, the plain version of the
fused CUDA solver (``ops/gagm.py``, ``csrc/gagm.cu``).

Counterpart of ``ttdg_mgm_tpu/graph/solvers.py`` (single-cluster path).
Joint matrices over ``G`` graphs of at most ``M`` nodes are ``(G*M, G*M)`` /
``(G*M, U)`` with each graph's valid nodes first in its block; the solvers
run without gradients.  Loops and stop tests run on the host, as Python
control flow over device tensors (one host synchronisation per iteration);
the terminal Hungarian round uses the host JV LAP of ``ops/lap.py``.
HiPPI's projections run the batched Sinkhorn kernel on CUDA tensors
(``ops/sinkhorn.py:sinkhorn_batched``); GA-GM's use the plain Sinkhorn.
"""

from __future__ import annotations

import torch

from ttdg_mgm_torch.ops.lap import hungarian_auto
from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched, sinkhorn_project


def _fro(x):
    return torch.sqrt(torch.sum(torch.square(x)))


def anneal_taus(sk_tau0: float, sk_gamma: float, min_tau: float):
    """The static temperature schedule: tau0, tau0*gamma, ... until the first
    value at or below ``min_tau`` (inclusive)."""
    taus = []
    t = sk_tau0
    while True:
        taus.append(t)
        if t > min_tau:
            t *= sk_gamma
        else:
            break
    return taus


def _project_blocks(V, ms, n_univ, *, tau, sk_iter, exact_hungarian: bool = False,
                    solve=sinkhorn):
    """Project each graph's ``(M, U)`` block of ``V (G, M, U)``: a
    rectangular Sinkhorn through ``solve``, or the exact LAP when
    ``exact_hungarian``."""
    nu = torch.full_like(ms, n_univ)
    if exact_hungarian:
        out = hungarian_auto(V, ms, nu)
    else:
        out = sinkhorn_project(V, ms, nu, tau=tau, max_iter=sk_iter, solve=solve)
    m = V.shape[-2]
    row_valid = torch.arange(m, device=V.device)[None, :] < ms[:, None]
    return torch.where(row_valid[..., None], out, torch.zeros((), device=V.device))


@torch.no_grad()
def hippi(W, U0, ms, n_univ: int, *, max_iter: int = 50, sk_iter: int = 20,
          sk_tau: float = 1.0 / 200.0, tol: float = 1e-5, return_steps: bool = False):
    """Higher-order Projected Power Iteration (ICCV'19).

    W ``(G*M, G*M)`` joint similarity; U0 ``(G*M, U)``; ms ``(G,)`` valid
    node counts.  Iterates ``V = (WU) (U^T (WU))`` and the per-graph Sinkhorn
    projection until ``||U - U_last|| < tol`` or ``max_iter`` steps.
    Returns ``(G*M, U)`` float32, and with ``return_steps`` the steps taken.
    """
    W = W.detach().to(torch.float32)
    U = U0.detach().to(torch.float32)
    ms = ms.to(torch.int64)
    G = ms.shape[0]
    T = W.shape[0]
    M = T // G
    i, diff = 0, float("inf")
    while i < max_iter and diff >= tol:
        WU = W @ U
        V = WU @ (U.T @ WU)
        # exact-rescale overflow guard: the projection depends on V / tau
        # only, so dividing both by c is the identity; c > 1 only when V
        # nears the float32 ceiling (the universe learner's 1e8 adjacency
        # scale, cubed)
        c = torch.clamp(torch.max(torch.abs(V)) / 1e30, min=1.0)
        U_new = _project_blocks((V / c).reshape(G, M, n_univ), ms, n_univ, tau=sk_tau / c,
                                sk_iter=sk_iter, solve=sinkhorn_batched).reshape(T, n_univ)
        diff = float(_fro(U_new - U))
        U = U_new
        i += 1
    return (U, i) if return_steps else U


def _gagm_round(A, W, U0, ms, n_univ, *, tau, sk_iter, max_iter, tol, quad_weight,
                num_graphs, M, exact_hungarian: bool = False):
    """One projector round of the GA power iteration; returns ``(U, steps)``."""
    T = num_graphs * M
    dev = U0.device

    def power_step(U):
        UUt = U @ U.T
        V = (A @ (UUt @ A)) @ U * (quad_weight * 2.0) + W @ U
        V = V / num_graphs
        # exact-rescale overflow guard: identity unless V nears the f32 ceiling
        c = torch.clamp(torch.max(torch.abs(V)) / 1e30, min=1.0)
        U_new = _project_blocks(
            (V / c).reshape(num_graphs, M, n_univ), ms, n_univ, tau=tau / c,
            sk_iter=sk_iter, exact_hungarian=exact_hungarian).reshape(T, n_univ)
        if num_graphs == 2:
            # graph 0 pinned to the identity in the 2-graph case
            r = torch.arange(M, device=dev)[:, None]
            c2 = torch.arange(n_univ, device=dev)[None, :]
            eye = ((r == c2) & (r < ms[0])).to(U_new.dtype)
            U_new = torch.cat([eye, U_new[M:]], dim=0)
        return U_new

    U, lastU = U0, torch.zeros_like(U0)
    i = 0
    while i < max_iter:
        U_new = power_step(U)
        i += 1
        done = bool((_fro(U_new - U) < tol) | (_fro(U_new - lastU) == 0.0))
        U, lastU = U_new, U
        if done:
            break
    return U, i


@torch.no_grad()
def ga_gm(A, W, U0, ms, n_univ: int, *, quad_weight: float = 1.0,
          mgm_iter: int = 200, sk_iter: int = 20, sk_tau0: float = 0.1,
          sk_gamma: float = 0.5, min_tau: float = 1e-2, tol: float = 1e-3,
          hung_iter_cap: int = 200, return_steps: bool = False):
    """GA-GM, single cluster: annealed Sinkhorn rounds, then a terminal
    round projected by the exact LAP, capped at ``hung_iter_cap``.

    A ``(G*M, G*M)`` block-diagonal adjacency; W ``(G*M, G*M)``; U0
    ``(G*M, U)``; ms ``(G,)`` int.  Returns ``(G*M, U)`` float32, and with
    ``return_steps`` also the list of steps taken per round.
    """
    A = A.detach().to(torch.float32)
    W = W.detach().to(torch.float32)
    U = U0.detach().to(torch.float32)
    ms = ms.to(torch.int64)
    G = ms.shape[0]
    M = A.shape[0] // G
    kw = dict(quad_weight=quad_weight, sk_iter=sk_iter, max_iter=mgm_iter, tol=tol,
              num_graphs=G, M=M)
    taus = anneal_taus(sk_tau0, sk_gamma, min_tau)
    steps = []
    for tau in taus:
        U, n = _gagm_round(A, W, U, ms, n_univ, tau=tau, **kw)
        steps.append(n)
    U, n = _gagm_round(A, W, U, ms, n_univ, tau=taus[-1], exact_hungarian=True,
                       **{**kw, "max_iter": hung_iter_cap})
    steps.append(n)
    return (U, steps) if return_steps else U


@torch.no_grad()
def final_hungarian_round(A, W, U, ms, n_univ: int, *, quad_weight: float = 1.0,
                          mgm_iter: int = 200, sk_iter: int = 20, tau: float = 1e-2,
                          tol: float = 1e-3):
    """The terminal Hungarian round alone (exact LAP projection)."""
    ms = ms.to(torch.int64)
    G = ms.shape[0]
    M = A.shape[0] // G
    U, _ = _gagm_round(A.detach().float(), W.detach().float(), U.detach().float(), ms,
                       n_univ, tau=tau, sk_iter=sk_iter, max_iter=mgm_iter, tol=tol,
                       quad_weight=quad_weight, num_graphs=G, M=M, exact_hungarian=True)
    return U
