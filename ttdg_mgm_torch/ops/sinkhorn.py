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
  picks the solve (HiPPI's projection passes :func:`sinkhorn_batched`).
"""

from __future__ import annotations

import torch

from ttdg_mgm_torch.ops import _cuda

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


def sinkhorn_masked(s, row_mask, *, tau: float = 1.0, max_iter: int = 10):
    """Sinkhorn over an explicit (possibly non-contiguous) row mask, every
    column valid, no dummy rows: rows and columns alternately normalised
    over valid entries (rows first), invalid rows exactly 0.  The universe
    learner's one global Sinkhorn over its padded-block score matrix."""
    dev = s.device
    live = row_mask[..., :, None].expand(s.shape)
    neg = torch.full((), NEG_INF, device=dev)
    log_s = torch.where(live, s.to(torch.float32) / tau, neg)
    for i in range(max_iter):
        log_s = log_s - _masked_logsumexp(log_s, -1 if i % 2 == 0 else -2)
        log_s = torch.where(live, log_s, neg)
    return torch.exp(torch.where(live, log_s, neg)).to(s.dtype)


def sinkhorn_batched(s, nrows=None, ncols=None, *, tau=1.0, max_iter: int = 10,
                     dummy_row: bool = False, _generic: bool = False):
    """:func:`sinkhorn` on a ``(N, n1, n2)`` float32 batch, no gradient:
    the CUDA kernel on CUDA tensors, the plain version on CPU tensors.
    ``tau`` is a number or a one-element tensor on ``s``'s device.  The
    kernel keeps a matrix of up to 64 x 64 in registers and a larger one in
    shared memory; ``_generic`` sends a small one down the second path too
    (for checks of that path)."""
    if s.device.type == "cpu":
        return sinkhorn(s, nrows, ncols, tau=tau, max_iter=max_iter, dummy_row=dummy_row)
    dev = s.device
    if dev.type != "cuda":
        raise ValueError(f"sinkhorn_batched runs on CPU or CUDA tensors, got {dev}")
    if s.dim() != 3:
        raise ValueError(f"sinkhorn_batched takes (N, n1, n2), got {tuple(s.shape)}")
    if torch.is_grad_enabled() and s.requires_grad:
        raise ValueError("sinkhorn_batched has no backward: detach its input")
    N, n1, n2 = s.shape
    s = s.contiguous()
    _cuda.require_cuda_f32("s", s, dev)
    nr = _counts(nrows, (N,), n1, dev).contiguous()
    nc = _counts(ncols, (N,), n2, dev).contiguous()
    if isinstance(tau, torch.Tensor):
        t = tau.detach().to(device=dev, dtype=torch.float32).reshape(1).contiguous()
    else:
        t = torch.full((1,), float(tau), dtype=torch.float32, device=dev)
    out = torch.empty_like(s)
    if N == 0:
        return out
    err = _cuda.lib().ttdg_sinkhorn(s.data_ptr(), nr.data_ptr(), nc.data_ptr(), t.data_ptr(),
                                    N, n1, n2, int(max_iter), int(dummy_row), int(_generic),
                                    out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "sinkhorn kernel")
    sinkhorn_batched.launches += 1
    return out


#: kernel launches since the count was last reset (plain CPU calls not counted)
sinkhorn_batched.launches = 0


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
