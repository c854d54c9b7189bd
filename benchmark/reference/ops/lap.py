"""Linear assignment: the Jonker-Volgenant shortest-augmenting-path solve.

Counterpart of ``ttdg_mgm_tpu/ops/lap.py`` with the same recurrence and the
same first-index tie-breaks, so assignments agree exactly.  The solve is
sequential and tiny (at most tens of rows), so it runs on the host in
float32 NumPy; the CUDA GA-GM kernel (``csrc/gagm.cu``) carries its own
device copy of the recurrence.

``hungarian(s, n1, n2)`` MAXIMISES the score over the valid ``n1 x n2``
sub-matrix and returns a 0/1 matrix of the full physical shape.
"""

from __future__ import annotations

import numpy as np
import torch

_INF = np.float32(1.0e30)


def _lap_single(cost: np.ndarray, n1: int, n2: int, stats: dict | None = None) -> np.ndarray:
    """JV minimisation on one ``(NR, NC)`` float32 cost matrix with ``n1``
    valid rows (``n1 <= n2``) and ``n2`` valid columns.  Returns col4row
    ``(NR,)``, -1 for unassigned rows.  ``stats["search_steps"]``, when
    given, grows by the search steps taken (columns added to a tree)."""
    cost = np.asarray(cost, np.float32)
    nr, nc = cost.shape
    cost = np.where(np.arange(nc)[None, :] < n2, cost, _INF).astype(np.float32)
    u = np.zeros(nr, np.float32)
    v = np.zeros(nc, np.float32)
    p = np.full(nc, -1, np.int64)  # p[j]: row assigned to column j
    for i in range(min(n1, nr)):
        minv = np.full(nc, _INF, np.float32)
        way = np.full(nc, -1, np.int64)
        used = np.zeros(nc, bool)
        used_row = np.zeros(nr, bool)  # rows of the used columns
        i0, j_prev, steps = i, -1, 0
        while True:
            cur = np.where(used, _INF, cost[i0] - u[i0] - v)
            better = cur < minv
            minv = np.where(better, cur, minv)
            way = np.where(better, j_prev, way)
            reach = np.where(used, _INF, minv)
            j1 = int(np.argmin(reach))
            delta = reach[j1]
            u = np.where(used_row, u + delta, u)
            u[i] += delta
            v = np.where(used, v - delta, v)
            minv = np.where(used, minv, minv - delta)
            used[j1] = True
            nxt = int(p[j1])
            if nxt >= 0:
                used_row[nxt] = True
            steps += 1
            if nxt < 0 or steps >= nc:
                j_free = j1
                if stats is not None:
                    stats["search_steps"] = stats.get("search_steps", 0) + steps
                break
            i0, j_prev = nxt, j1
        # augment along the predecessor chain back to the root row i
        j, steps = j_free, 0
        while True:
            jp = int(way[j])
            p[j] = i if jp < 0 else p[max(jp, 0)]
            steps += 1
            if jp < 0 or steps >= nc:
                break
            j = jp
    col4row = np.full(nr, -1, np.int64)
    for j in range(nc):
        if p[j] >= 0:
            col4row[p[j]] = j
    col4row[min(n1, nr):] = -1
    return col4row


def _assign(s: np.ndarray, n1: int, n2: int) -> np.ndarray:
    """0/1 maximising assignment of one ``(NR, NC)`` score matrix."""
    nr, nc = s.shape
    col4row = _lap_single(-s, n1, n2)
    out = np.zeros((nr, nc), np.float32)
    rows = np.nonzero(col4row >= 0)[0]
    out[rows, col4row[rows]] = 1.0
    return out


def hungarian(s: torch.Tensor, n1=None, n2=None) -> torch.Tensor:
    """Maximise ``sum(s * X)`` over 0/1 assignments, batched over leading
    dims; requires ``n1 <= n2`` per instance."""
    return _batched(s, n1, n2, orient_auto=False)


def hungarian_auto(s: torch.Tensor, n1=None, n2=None) -> torch.Tensor:
    """Orientation-robust :func:`hungarian`: instances with ``n1 > n2`` are
    solved transposed, assigning every column (scipy's rectangular rule)."""
    return _batched(s, n1, n2, orient_auto=True)


def lap_slots_to_nodes(V: torch.Tensor, ms, stats: dict | None = None) -> torch.Tensor:
    """The LAP as the fused GA-GM kernel (``csrc/gagm.cu``) poses it, on the
    host: for each graph of ``V (G, M, U)`` the ``U`` universe slots are the
    rows and assign to node columns, whatever the orientation; the
    ``max(M, U) - ms`` node-less columns cost ``2 max|V[:ms]| + 1000``, so a
    slot takes one only when every node is taken.  Returns the 0/1 matrix
    ``(G, M, U)``, rows at or past ``ms`` zero.

    Its optimum is :func:`hungarian_auto`'s.  When ``ms < U`` the duals here
    carry the dummy cost (about 1000), so on scores closer than float32
    resolves at that magnitude the two may round to different assignments;
    this function repeats the kernel's arithmetic operation by operation and
    is what the kernel is held against bit for bit.  ``stats``, when given,
    collects the search steps of all graphs (``_lap_single``)."""
    host = V.detach().to("cpu", torch.float32).numpy()
    G, M, U = host.shape
    counts = np.asarray(torch.as_tensor(ms).cpu()).reshape(-1)
    n = max(M, U)
    out = np.zeros((G, M, U), np.float32)
    for g in range(G):
        m = int(counts[g])
        dmax = np.float32(np.abs(host[g, :m]).max()) if m > 0 else np.float32(0.0)
        dc = np.float32(2.0) * dmax + np.float32(1000.0)
        ct = np.full((U, n), dc, np.float32)
        ct[:, :m] = -host[g, :m].T
        col4row = _lap_single(ct, U, n, stats)
        for r in range(U):
            if 0 <= col4row[r] < m:
                out[g, col4row[r], r] = 1.0
    return torch.from_numpy(out).to(V.device)


def _batched(s, n1, n2, *, orient_auto: bool):
    batch_shape = s.shape[:-2]
    nr, nc = s.shape[-2], s.shape[-1]
    host = s.detach().to("cpu", torch.float32).reshape(-1, nr, nc).numpy()
    cnt = host.shape[0]
    a1 = (np.full(cnt, nr) if n1 is None
          else np.broadcast_to(np.asarray(torch.as_tensor(n1).cpu()), batch_shape).reshape(-1))
    a2 = (np.full(cnt, nc) if n2 is None
          else np.broadcast_to(np.asarray(torch.as_tensor(n2).cpu()), batch_shape).reshape(-1))
    n = max(nr, nc)
    out = np.zeros((cnt, nr, nc), np.float32)
    for k in range(cnt):
        r, c = int(a1[k]), int(a2[k])
        if orient_auto:
            sq = np.zeros((n, n), np.float32)
            sq[:nr, :nc] = host[k]
            if r <= c:
                res = _assign(sq, r, c)
            else:
                res = _assign(np.ascontiguousarray(sq.T), c, r).T
            out[k] = res[:nr, :nc]
        else:
            out[k] = _assign(host[k], r, c)
    return torch.from_numpy(out).reshape(s.shape).to(s.device)


def hungarian_scipy(s, n1=None, n2=None) -> np.ndarray:
    """The exact assignment by SciPy (``linear_sum_assignment`` on ``-s``),
    maximising ``sum(s * X)`` over each ``(n1, n2)`` corner of ``s (B, N1,
    N2)`` or ``(N1, N2)``; returns the 0/1 float32 NumPy matrix."""
    import scipy.optimize as opt

    s = np.asarray(s)
    squeeze = s.ndim == 2
    if squeeze:
        s = s[None]
    b, nr, nc = s.shape
    n1 = [nr] * b if n1 is None else np.asarray(n1).reshape(-1)
    n2 = [nc] * b if n2 is None else np.asarray(n2).reshape(-1)
    out = np.zeros_like(s, dtype=np.float32)
    for i in range(b):
        r, c = opt.linear_sum_assignment(-s[i, :n1[i], :n2[i]])
        out[i, r, c] = 1.0
    return out[0] if squeeze else out
