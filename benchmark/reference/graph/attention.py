"""Node-set self-attention whose attention matrix is the graph adjacency.

Counterpart of ``ttdg_mgm_tpu/graph/attention.py``: per-head linear Q/K/V,
masked softmax attention (masked keys at -1e30), output projection, residual
plus LayerNorm (eps 1e-5).  No dropout: the JAX module runs deterministic on
the TTA path, so a dropout layer here would change the result.
"""

from __future__ import annotations

import torch
from torch import nn

NEG_INF = -1.0e30


class MultiHeadAttention(nn.Module):
    """``forward(nodes (..., M, D), mask (..., M)) -> (nodes', adjacency)``."""

    def __init__(self, model_dim: int = 256, num_heads: int = 1):
        super().__init__()
        self.model_dim = model_dim
        self.num_heads = num_heads
        dh = model_dim // num_heads
        self.linear_q = nn.Linear(model_dim, dh * num_heads)
        self.linear_k = nn.Linear(model_dim, dh * num_heads)
        self.linear_v = nn.Linear(model_dim, dh * num_heads)
        self.linear_final = nn.Linear(dh * num_heads, model_dim)
        self.layer_norm = nn.LayerNorm(model_dim, eps=1e-5)

    def forward(self, nodes, mask=None):
        H = self.num_heads
        dh = self.model_dim // H

        def split(x):  # (..., M, H*Dh) -> (..., H, M, Dh)
            return x.reshape(*x.shape[:-1], H, dh).movedim(-2, -3)

        q, k, v = (split(f(nodes)) for f in (self.linear_q, self.linear_k, self.linear_v))
        logits = torch.einsum("...md,...nd->...mn", q, k) * (dh ** -0.5)
        if mask is not None:
            logits = torch.where(mask[..., None, None, :], logits,
                                 torch.full((), NEG_INF, device=logits.device))
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        attn = e / e.sum(dim=-1, keepdim=True)
        ctx = torch.einsum("...mn,...nd->...md", attn, v)
        ctx = ctx.movedim(-3, -2).reshape(*nodes.shape[:-1], dh * H)
        out = self.layer_norm(nodes + self.linear_final(ctx))
        attn = attn.mean(dim=-3)
        if mask is not None:
            zero = torch.zeros((), device=out.device)
            out = torch.where(mask[..., None], out, zero)
            attn = torch.where(mask[..., None, :] & mask[..., :, None], attn, zero)
        return out, attn
