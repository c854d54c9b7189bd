"""Log-domain Sinkhorn with static shapes and validity masks.

Counterpart of ``ttdg_mgm_tpu/ops/sinkhorn.py`` (pygmtools numerics):
``log_s = s / tau``, optional dummy rows at log value -100, ``max_iter``
alternating row/column logsumexp normalisations starting with the rows,
invalid entries exactly 0.

* :func:`sinkhorn`, :func:`sinkhorn_masked`: plain differentiable PyTorch
  (the TTA loss and the universe learner back-propagate through them);
* :func:`sinkhorn_batched`: the batched Sinkhorn kernel ``csrc/sinkhorn.cu``
  (replacing ``ttdg_mgm_tpu/ops/pallas/sinkhorn_pallas.py:sinkhorn_pallas``)
  on CUDA tensors without gradient, :func:`sinkhorn` on CPU tensors;
* :func:`sinkhorn_project`: the orientation-robust projection; its caller
  picks the solve (HiPPI's projection passes :func:`sinkhorn_batched`);
* :func:`sinkhorn_auto`: the orientation-robust projection of square
  matrices, both orientations solved and selected per instance;
* :func:`gumbel_sinkhorn`: Sinkhorn samples of Gumbel-perturbed scores, the
  uniforms given or drawn from a given generator.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30  # stand-in for -inf that keeps the arithmetic NaN-free
DUMMY_LOG_VALUE = -100.0


def _masked_logsumexp(x, dim: int):
    """logsumexp that returns NEG_INF (not NaN) for all-masked slices."""
    m = x.amax(dim=dim, keepdim=True)
    live = m > NEG_INF / 2
    m_safe = torch.where(live, m, torch.zeros((), dtype=x.dtype, device=x.device))
    s = torch.exp(x - m_safe).sum(dim=dim, keepdim=True)
    out = m_safe + torch.log(s.clamp(min=1e-38))
    return torch.where(live, out, torch.full((), NEG_INF, dtype=x.dtype, device=x.device))


def _counts(n, batch_shape, full: int, device):
    if n is None:
        return torch.full(batch_shape, full, dtype=torch.int32, device=device)
    return torch.as_tensor(n, dtype=torch.int32, device=device).broadcast_to(batch_shape)


def sinkhorn(s, nrows=None, ncols=None, *, tau=1.0, max_iter: int = 10,
             dummy_row: bool = False):
    """Doubly-stochastic projection of ``s`` ``(..., N1, N2)`` with
    per-instance valid counts; rows/columns beyond them come back as 0.
    With ``dummy_row`` rows ``[nrows, ncols)`` act as dummy rows (needs
    ``nrows <= ncols``)."""
    batch_shape = s.shape[:-2]
    n1, n2 = s.shape[-2], s.shape[-1]
    dev = s.device
    orig_dtype = s.dtype
    s = s.to(torch.float32)
    nr = _counts(nrows, batch_shape, n1, dev)[..., None, None]
    nc = _counts(ncols, batch_shape, n2, dev)[..., None, None]
    row_ids = torch.arange(n1, device=dev)[:, None]
    col_ids = torch.arange(n2, device=dev)[None, :]
    valid_row = row_ids < nr
    valid_col = col_ids < nc
    real = valid_row & valid_col
    neg = torch.full((), NEG_INF, device=dev)
    log_s = s / tau
    if dummy_row:
        dummy = (row_ids >= nr) & (row_ids < nc) & valid_col
        live = (row_ids < torch.maximum(nr, nc)) & valid_col
        log_s = torch.where(real, log_s, torch.where(
            dummy, torch.full((), DUMMY_LOG_VALUE, device=dev), neg))
    else:
        live = real
        log_s = torch.where(real, log_s, neg)
    log_s = torch.where(live, log_s, neg)
    for i in range(max_iter):
        dim = -1 if i % 2 == 0 else -2
        log_s = log_s - _masked_logsumexp(log_s, dim)
        log_s = torch.where(live, log_s, neg)
    return torch.exp(torch.where(real, log_s, neg)).to(orig_dtype)


def sinkhorn_masked(s, row_mask, col_mask=None, *, tau: float = 1.0, max_iter: int = 10):
    """Sinkhorn over explicit (possibly non-contiguous) row and column
    masks, no dummy rows: an entry is live where its row and its column
    are (every column without ``col_mask``); rows and columns alternately
    normalised over live entries (rows first), the others exactly 0.  The
    universe learner's one global Sinkhorn over its padded-block score
    matrix takes the row mask alone; the cross-domain head's matching both."""
    dev = s.device
    if col_mask is None:
        live = row_mask[..., :, None].expand(s.shape)
    else:
        live = row_mask[..., :, None] & col_mask[..., None, :]
    neg = torch.full((), NEG_INF, device=dev)
    log_s = torch.where(live, s.to(torch.float32) / tau, neg)
    for i in range(max_iter):
        log_s = log_s - _masked_logsumexp(log_s, -1 if i % 2 == 0 else -2)
        log_s = torch.where(live, log_s, neg)
    return torch.exp(torch.where(live, log_s, neg)).to(s.dtype)


def sinkhorn_batched(s, nrows=None, ncols=None, *, tau=1.0, max_iter: int = 10,
                     dummy_row: bool = False):
    """:func:`sinkhorn` on a ``(N, n1, n2)`` float32 batch, no gradient
    (the port's kernel D, here its plain version)."""
    if s.dtype != torch.float32:
        raise ValueError(f"sinkhorn_batched: s must be float32, got {s.dtype}")
    with torch.no_grad():
        return sinkhorn(s, nrows, ncols, tau=tau, max_iter=max_iter, dummy_row=dummy_row)


def sinkhorn_project(s, nrows=None, ncols=None, *, tau=1.0, max_iter: int = 10,
                     solve=sinkhorn):
    """Orientation-robust projection on a rectangular ``(..., N1, N2)``:
    instances with more valid rows than columns are solved transposed (both
    orientations in one batched solve, selected per instance).  ``solve``
    is :func:`sinkhorn` or :func:`sinkhorn_batched`, called once on the
    ``(N, n, n)`` stack of both orientations."""
    batch_shape = s.shape[:-2]
    n1, n2 = s.shape[-2], s.shape[-1]
    dev = s.device
    nrows = _counts(nrows, batch_shape, n1, dev)
    ncols = _counts(ncols, batch_shape, n2, dev)
    n = max(n1, n2)
    sq = torch.nn.functional.pad(s, (0, n - n2, 0, n - n1))
    both = torch.stack([sq, sq.transpose(-1, -2)], dim=0)
    rows_b = torch.stack([nrows, ncols], dim=0)
    cols_b = torch.stack([ncols, nrows], dim=0)
    solved = solve(both.reshape(-1, n, n), rows_b.reshape(-1), cols_b.reshape(-1), tau=tau,
                   max_iter=max_iter, dummy_row=True).reshape(both.shape)
    out = torch.where((nrows <= ncols)[..., None, None], solved[0],
                      solved[1].transpose(-1, -2))
    return out[..., :n1, :n2]


def sinkhorn_auto(s, nrows=None, ncols=None, *, tau: float = 1.0, max_iter: int = 10):
    """Sinkhorn with dummy rows on square ``s (..., n, n)`` whatever the
    orientation: instances with ``nrows <= ncols`` are solved as they are,
    the others transposed (both solved, selected per instance)."""
    if s.shape[-1] != s.shape[-2]:
        raise ValueError(f"sinkhorn_auto takes square matrices, got {tuple(s.shape)}")
    batch_shape = s.shape[:-2]
    n = s.shape[-1]
    nrows = _counts(nrows, batch_shape, n, s.device)
    ncols = _counts(ncols, batch_shape, n, s.device)
    fwd = sinkhorn(s, nrows, ncols, tau=tau, max_iter=max_iter, dummy_row=True)
    bwd = sinkhorn(s.transpose(-1, -2), ncols, nrows, tau=tau, max_iter=max_iter,
                   dummy_row=True).transpose(-1, -2)
    return torch.where((nrows <= ncols)[..., None, None], fwd, bwd)


def gumbel_sinkhorn(s, uniforms=None, nrows=None, ncols=None, *, generator=None,
                    tau: float = 1.0, max_iter: int = 10, sample_num: int = 5,
                    dummy_row: bool = False):
    """``sample_num`` Sinkhorn projections of ``s + g`` stacked on a new
    leading axis, ``g = -log(-log(u + 1e-20) + 1e-20)`` Gumbel noise from
    uniforms ``u``: the given ``uniforms (sample_num, *s.shape)``, or drawn
    on ``s``'s device from ``generator`` (random draws are inputs: the
    JAX package draws them from its key, ``jax.random.split(key,
    sample_num)``)."""
    if uniforms is None:
        if generator is None:
            raise ValueError("gumbel_sinkhorn needs its uniforms or a generator to draw them")
        uniforms = torch.rand((sample_num, *s.shape), generator=generator, device=s.device,
                              dtype=torch.float32)
    if uniforms.shape[1:] != s.shape:
        raise ValueError(f"uniforms {tuple(uniforms.shape)} do not match scores "
                         f"{tuple(s.shape)}")
    g = -torch.log(-torch.log(uniforms + 1e-20) + 1e-20)
    return torch.stack([sinkhorn(s + g[k], nrows, ncols, tau=tau, max_iter=max_iter,
                                 dummy_row=dummy_row) for k in range(uniforms.shape[0])])
