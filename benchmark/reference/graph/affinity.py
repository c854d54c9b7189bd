"""Learned pairwise node affinity.

Counterpart of ``ttdg_mgm_tpu/graph/affinity.py``, with the reference's
parameter names (``project_sr``, ``project_tg``, ``fc_M`` = Linear, ReLU,
Linear).  The first ``fc_M`` layer acts on ``[X_i ; Y_j]``, so it is applied
as its X half plus its Y half and a broadcast add, never materialising the
concatenated pairs.
"""

from __future__ import annotations

import torch
from torch import nn


class Affinity(nn.Module):
    """``forward(X (..., N1, D), Y (..., N2, D)) -> (..., N1, N2)``."""

    def __init__(self, d: int = 256, hidden: int = 512):
        super().__init__()
        self.d = d
        self.project_sr = nn.Linear(d, d, bias=False)
        self.project_tg = nn.Linear(d, d, bias=False)
        self.fc_M = nn.Sequential(nn.Linear(2 * d, hidden), nn.ReLU(), nn.Linear(hidden, 1))
        for m in (self.project_sr, self.project_tg, self.fc_M[0], self.fc_M[2]):
            nn.init.normal_(m.weight, std=0.01)
            if m.bias is not None:
                nn.init.zeros_(m.bias)

    def forward(self, X, Y):
        X = self.project_sr(X)
        Y = self.project_tg(Y)
        w0 = self.fc_M[0].weight
        hx = X @ w0[:, : self.d].T + self.fc_M[0].bias
        hy = Y @ w0[:, self.d:].T
        h = torch.relu(hx[..., :, None, :] + hy[..., None, :, :])
        return self.fc_M[2](h)[..., 0]
