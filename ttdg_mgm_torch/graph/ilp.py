"""Exact linear assignment as an integer program (optional Gurobi).

Counterpart of ``ttdg_mgm_tpu/graph/ilp.py``: a 0/1 assignment of a
possibly rectangular score matrix with at most one match per row and per
column, by ``gurobipy`` when it is installed, and otherwise by SciPy's
exact assignment (``ops/lap.py:hungarian_scipy``), which is the same
optimum for the pure assignment problem.
"""

from __future__ import annotations

import numpy as np


def ilp_solver(cost: np.ndarray, n1: int | None = None, n2: int | None = None,
               maximize: bool = True) -> np.ndarray:
    """0/1 float32 assignment matrix of ``cost (N1, N2)`` over its ``(n1,
    n2)`` corner, maximising (or minimising) the total."""
    try:
        import gurobipy as gp
        from gurobipy import GRB
    except ImportError:
        from ttdg_mgm_torch.ops.lap import hungarian_scipy

        s = cost if maximize else -cost
        return hungarian_scipy(s, [n1] if n1 else None, [n2] if n2 else None)
    nr, nc = cost.shape
    n1 = nr if n1 is None else n1
    n2 = nc if n2 is None else n2
    m = gp.Model()
    m.Params.OutputFlag = 0
    x = m.addVars(n1, n2, vtype=GRB.BINARY)
    m.setObjective(gp.quicksum(cost[i, j] * x[i, j] for i in range(n1) for j in range(n2)),
                   GRB.MAXIMIZE if maximize else GRB.MINIMIZE)
    for i in range(n1):
        m.addConstr(gp.quicksum(x[i, j] for j in range(n2)) <= 1)
    for j in range(n2):
        m.addConstr(gp.quicksum(x[i, j] for i in range(n1)) <= 1)
    m.optimize()
    out = np.zeros_like(cost, dtype=np.float32)
    for i in range(n1):
        for j in range(n2):
            if x[i, j].X > 0.5:
                out[i, j] = 1.0
    return out
