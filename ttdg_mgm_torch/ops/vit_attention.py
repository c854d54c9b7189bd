"""Attention with ViTDet's decomposed relative-position bias (kernel F).

For each slice ``b`` (a batch entry, or a window, times a head), query
``i`` and key ``j`` of ``N = Kh * Kw`` tokens on a ``Kh x Kw`` grid (key
``j`` at row ``j // Kw``, column ``j % Kw``)::

    s_ij = scale * q_i . k_j + rel_h[b, i, j // Kw] + rel_w[b, i, j % Kw]
    out_i = sum_j softmax_j(s_i.) v_j

which is detectron2's ``Attention.forward`` with ``add_decomposed_rel_pos``
(``rel_h`` and ``rel_w`` are its einsums of the unscaled ``q``; they, and
their gradients into ``q`` and the position tables, stay plain PyTorch in
``models/vit.py``).

* :func:`vit_attention`: on CUDA tensors the hand-written kernel
  ``csrc/vit_attention.cu`` (forward and backward, online softmax in
  float32, no ``N x N`` matrix in memory, no atomics: the same bits in
  every run), through :class:`VitAttention`; on CPU tensors the plain
  version.  The kernel takes ``q``, ``k``, ``v`` in bfloat16 (the ViT's
  compute dtype) with head size 64, and ``rel_h``, ``rel_w`` in float32.
* :func:`vit_attention_plain`: plain PyTorch, the scores in float32.

No TPU kernel computes this: the JAX package has no attention over image
tokens.  Launches are counted on :class:`VitAttention` (``launches``: one
per forward, two per backward; a tracer may wrap :func:`vit_attention`);
while the tracer is on, the counters
``vit_attention.launches`` and ``vit_attention.tokens.{window,global}.
{forward,backward}`` (query tokens; a slice of ``N`` below 1024 is a
window) go to the open spans (``utils/profiling.py``): the forward's to
the caller's, the backward's to the span ``vit_attention.backward`` it
opens (autograd runs a CUDA backward in a thread of its own).
"""

from __future__ import annotations

import torch

from ttdg_mgm_torch.ops import _cuda
from ttdg_mgm_torch.utils.profiling import count, span

HEAD_DIM = 64
#: slices of fewer tokens than this are windows in the token counters
GLOBAL_TOKENS = 1024


def vit_attention_plain(q, k, v, rel_h, rel_w, scale: float):
    """``q``, ``k``, ``v`` ``(BH, N, D)``, ``rel_h (BH, N, Kh)``, ``rel_w
    (BH, N, Kw)`` with ``N = Kh * Kw`` -> ``(BH, N, D)`` in ``q``'s dtype;
    the scores, softmax and product in float32."""
    BH, N, _ = q.shape
    Kh, Kw = rel_h.shape[-1], rel_w.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = (s.view(BH, N, Kh, Kw) + rel_h.float()[..., :, None]
         + rel_w.float()[..., None, :]).view(BH, N, N)
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def _count(N: int, BH: int, direction: str, launches: int) -> None:
    VitAttention.launches += launches
    count("vit_attention.launches", launches)
    kind = "window" if N < GLOBAL_TOKENS else "global"
    count(f"vit_attention.tokens.{kind}.{direction}", BH * N)


def _check(q, k, v, rel_h, rel_w) -> tuple:
    dev = q.device
    BH, N, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"vit_attention's kernel takes head size {HEAD_DIM}, got {D}")
    Kh, Kw = rel_h.shape[-1], rel_w.shape[-1]
    if Kh * Kw != N or not (0 < Kh <= 64 and 0 < Kw <= 64):
        raise ValueError(f"vit_attention's kernel takes N = Kh * Kw with Kh, Kw <= 64, got "
                         f"N={N}, Kh={Kh}, Kw={Kw}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != (BH, N, D):
            raise ValueError(f"{name} must be {(BH, N, D)}, got {tuple(t.shape)}")
        _cuda.require_cuda(name, t, dev, torch.bfloat16)
    for name, t, w in (("rel_h", rel_h, Kh), ("rel_w", rel_w, Kw)):
        if tuple(t.shape) != (BH, N, w):
            raise ValueError(f"{name} must be {(BH, N, w)}, got {tuple(t.shape)}")
        _cuda.require_cuda_f32(name, t, dev)
    return BH, N, Kh, Kw


class VitAttention(torch.autograd.Function):
    """Kernel F's forward and backward as one autograd node over ``(q, k,
    v, rel_h, rel_w)``."""

    #: kernel launches since the count was last reset
    launches = 0

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale: float):
        q, k, v, rel_h, rel_w = (t.contiguous() for t in (q, k, v, rel_h, rel_w))
        BH, N, Kh, Kw = _check(q, k, v, rel_h, rel_w)
        dev = q.device
        out = torch.empty_like(q)
        lse = torch.empty((BH, N), dtype=torch.float32, device=dev)
        err = _cuda.lib().ttdg_vit_attn_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), BH, N,
            Kh, Kw, float(scale), out.data_ptr(), lse.data_ptr(), _cuda.stream_ptr(dev))
        _cuda.check(err, "vit_attention forward kernel")
        _count(N, BH, "forward", 1)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.scale = float(scale)
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, rel_h, rel_w, out, lse = ctx.saved_tensors
        grad = grad.to(torch.bfloat16).contiguous()
        BH, N, Kh, Kw = _check(q, k, v, rel_h, rel_w)
        dev = q.device
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
        delta = torch.empty((BH, N), dtype=torch.float32, device=dev)
        with span("vit_attention.backward"):
            err = _cuda.lib().ttdg_vit_attn_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), grad.data_ptr(),
                lse.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), BH, N, Kh, Kw, ctx.scale,
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), drel_h.data_ptr(),
                drel_w.data_ptr(), delta.data_ptr(), _cuda.stream_ptr(dev))
            _cuda.check(err, "vit_attention backward kernels")
            _count(N, BH, "backward", 2)
        return dq, dk, dv, drel_h, drel_w, None


def vit_attention(q, k, v, rel_h, rel_w, scale: float):
    """The attention of the module docstring: kernel F on CUDA tensors
    (which raises on anything it does not take), the plain version on CPU
    tensors."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, rel_h, rel_w, scale)
    if q.device.type != "cuda":
        raise ValueError(f"vit_attention runs on CPU or CUDA tensors, got {q.device}")
    return VitAttention.apply(q, k, v, rel_h, rel_w, scale)
