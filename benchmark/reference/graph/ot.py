"""Entropic optimal transport between node clouds, and the prototype
transport loss: the topology terms of the cross-domain head.

Counterpart of ``ttdg_mgm_tpu/graph/ot.py``:

* :func:`sinkhorn_distance`: log-domain Sinkhorn on the squared-L2 cost
  with uniform marginals, ``eps``-regularised, the cost scaled by 0.001.
  It runs ``max_iter`` iterations with a ``done`` flag, as the JAX
  ``fori_loop``: the iteration where the mean row change first falls below
  0.1 still applies its update, later ones do not.  The flag stays on the
  device (no host sync, no early exit), so the loop costs ``max_iter``
  iterations whatever the data.
* :func:`proto_loss` with :class:`ProtoLossState`: the bidirectional
  prototype-feature transport loss (PCT), the class proportions threaded
  by the caller.
"""

from __future__ import annotations

import torch


def sinkhorn_distance(x, y, *, eps: float = 0.01, max_iter: int = 100):
    """x ``(..., P1, D)``, y ``(..., P2, D)`` -> (cost ``(...)``, plan
    ``(..., P1, P2)``).  The cost is the broadcast squared difference summed
    over ``D`` (not ``torch.cdist``, whose matmul form rounds otherwise)."""
    C = ((x[..., :, None, :] - y[..., None, :, :]).abs() ** 2).sum(dim=-1)
    p1, p2 = C.shape[-2], C.shape[-1]
    batch = C.shape[:-2]
    mu = torch.full(batch + (p1,), 1.0 / p1, dtype=torch.float32, device=C.device)
    nu = torch.full(batch + (p2,), 1.0 / p2, dtype=torch.float32, device=C.device)
    log_mu, log_nu = torch.log(mu + 1e-8), torch.log(nu + 1e-8)

    def M(u, v):
        return (-C + u[..., :, None] + v[..., None, :]) / eps

    u, v = torch.zeros_like(mu), torch.zeros_like(nu)
    done = torch.zeros((), dtype=torch.bool, device=C.device)
    for _ in range(max_iter):
        u_new = eps * (log_mu - torch.logsumexp(M(u, v), dim=-1)) + u
        v_new = eps * (log_nu - torch.logsumexp(M(u_new, v).transpose(-1, -2), dim=-1)) + v
        err = (u_new - u).abs().sum(dim=-1).mean()
        u = torch.where(done, u, u_new)
        v = torch.where(done, v, v_new)
        done = done | (err < 1e-1)
    pi = torch.exp(M(u, v))
    cost = (pi * C).sum(dim=(-2, -1)) * 0.001
    return cost, pi


class ProtoLossState:
    """The running class proportions of :func:`proto_loss` ``(K, 1)``,
    uniform at the start."""

    def __init__(self, num_classes: int, device=None):
        self.prop = torch.full((num_classes, 1), 1.0 / num_classes, device=device)


def proto_loss(mu_s, f_t, prop, *, nav_t: float = 1.0, beta: float = 0.01,
               s_par: float = 0.5):
    """Prototype-feature bidirectional transport loss (PCT): class
    prototypes ``mu_s`` ``(K, F)``, target features ``f_t`` ``(M, F)``,
    running class proportions ``prop`` ``(K, 1)``.  Returns ``(t2p, p2t,
    new_prop)``; ``new_prop`` carries no gradient."""
    eps = 1e-6
    sim = mu_s @ f_t.T
    old_logits = sim.detach() / nav_t + torch.log(prop + eps)
    s_dist_old = torch.softmax(old_logits, dim=0)
    new_prop = (1.0 - beta) * prop + beta * s_dist_old.mean(dim=1, keepdim=True)

    new_logits = sim / nav_t + torch.log(new_prop + eps)
    s_dist = torch.softmax(new_logits, dim=0)
    t_dist = torch.softmax(sim / nav_t, dim=1)

    xn = mu_s / torch.linalg.vector_norm(mu_s, dim=1, keepdim=True).clamp(min=1e-12)
    yn = f_t / torch.linalg.vector_norm(f_t, dim=1, keepdim=True).clamp(min=1e-12)
    cost = 1.0 - xn @ yn.T
    t2p = (s_par * cost * s_dist).sum(dim=0).mean()
    p2t = (((1.0 - s_par) * cost * t_dist).sum(dim=1) * new_prop[:, 0]).sum()
    return t2p, p2t, new_prop
