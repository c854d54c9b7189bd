"""The multi-level ROI pool and its backward: CUDA kernels
``csrc/roi_pool.cu`` and ``csrc/roi_pool_backward.cu`` with their plain
PyTorch versions ``ops/roi_align.py:multilevel_roi_align`` and
``multilevel_roi_align_backward``.

* :func:`multilevel_roi_pool` replaces the JAX package's forward-only
  windowed Pallas pooler
  (``ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py:multilevel_roi_align_windowed``)
  on the pools of the TTA path and of inference; callers pool under
  ``torch.no_grad()``.
* :func:`multilevel_roi_pool_train` replaces its differentiable training
  pooler (``multilevel_roi_align_windowed_train``): a
  ``torch.autograd.Function`` whose forward is the pool kernel and whose
  backward is :func:`multilevel_roi_pool_backward`, the gather-ordered
  backward kernel (deterministic: every gradient element is the sum of the
  same terms in ROI order).  No gradient reaches the ROIs, as in the JAX
  package.

On CPU tensors the plain versions run; on CUDA tensors the kernels launch
(or the call raises).  Each kernel wrapper counts its launches, float32
and bfloat16 apart (``launches``, ``launches_bf16``).  A wrapper
starts no device work but its kernels (the backward's C entry launches a
small plan kernel, each ROI's level and pixel footprint, before its gather
kernel; :func:`roi_footprints_device` returns that plan for checks against
``ops/roi_align.py:roi_footprints``).  Both compute the sample geometry
themselves (``csrc/roi_geometry.cuh``, the device copy of
``ops/roi_align.py:roi_geometry``; :func:`roi_geometry_device` returns it for
checks).  The ROIs must be contiguous float32 and the channel count a
multiple of 4 (of 8 for bfloat16 levels).

Both kernels take float32 or bfloat16 levels (the bf16 compute policy).
In bfloat16 they have the TPU kernels' semantics, with plain versions
``ops/roi_align.py:multilevel_roi_align_bf16`` and
``multilevel_roi_align_backward_bf16``: bf16-rounded interpolation weights,
float32 sums, one rounding of each output to bfloat16.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ttdg_mgm_torch.ops import _cuda
from ttdg_mgm_torch.ops.roi_align import (ADAPTIVE_CAP, multilevel_roi_align,
                                          multilevel_roi_align_backward,
                                          multilevel_roi_align_backward_bf16,
                                          multilevel_roi_align_bf16)

__all__ = ["multilevel_roi_pool", "multilevel_roi_pool_backward", "multilevel_roi_pool_train",
           "multilevel_roi_align", "roi_footprints_device", "roi_geometry_device"]

#: sample slots per axis (``P * m``) the kernels hold (``csrc/roi_geometry.cuh``)
MAX_AXIS_SAMPLES = 64
#: element types the kernels take, with their code in the C entry points
#: and the channel multiple their loads need
DTYPES = {torch.float32: (0, 4), torch.bfloat16: (1, 8)}


def plan_words(P: int, sampling_ratio: int) -> int:
    """32-bit words per ROI of the backward's plan (``csrc/roi_pool_backward.cu``:
    a 4-word ``HitTest``, a 12-word ``RoiPlan`` header, then ``P * m``
    samples per axis of 4 words each)."""
    m = sampling_ratio if sampling_ratio > 0 else ADAPTIVE_CAP
    return 16 + 8 * P * m


def _kernel_args(name, tensors, level_shapes, rois, C: int, P: int, strides,
                 sampling_ratio: int, min_level: int):
    """Validate a kernel call and lay out its C arguments: the four level
    pointers and shapes (the last level repeated), ``C, R, K``, the ROIs, the
    four strides, ``min_level, P``, the sampling ratio and the element
    type's code.  ``tensors`` are the levels (forward) or their gradients
    (backward), all float32 or all bfloat16.  The kernels compute the sample
    geometry themselves, so no device work happens here."""
    dev = rois.device
    if not 1 <= len(tensors) <= 4:
        raise ValueError(f"{name} takes one to four levels")
    _cuda.require_cuda_f32("rois", rois, dev)
    if rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"rois must be (B, K, 4), got {tuple(rois.shape)}")
    dtype = tensors[0].dtype
    if dtype not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16 levels, got {dtype}")
    code, mult = DTYPES[dtype]
    if C % mult != 0 or C > 1024:
        raise ValueError(f"{name} takes a channel count that is a multiple of {mult} for "
                         f"{dtype}, at most 1024 (16-byte loads), got {C}")
    m = sampling_ratio if sampling_ratio > 0 else ADAPTIVE_CAP
    if sampling_ratio < 0 or P * m > MAX_AXIS_SAMPLES:
        raise ValueError(f"{name} takes at most {MAX_AXIS_SAMPLES} samples per axis, got "
                         f"P={P} x {m}")
    B, K = rois.shape[:2]
    for i, (t, (h, w)) in enumerate(zip(tensors, level_shapes)):
        _cuda.require_cuda(f"level {i}", t, dev, dtype)
        if tuple(t.shape) != (B, h, w, C):
            raise ValueError(f"level {i} must be {(B, h, w, C)}, got {tuple(t.shape)}")
    ptrs, hw, st = [], [], []
    for i in range(4):
        j = min(i, len(tensors) - 1)
        ptrs.append(tensors[j].data_ptr())
        hw += list(level_shapes[j])
        st.append(float(strides[j]))
    return [*ptrs, len(tensors), *hw, C, B * K, K, rois.data_ptr(), *st, int(min_level), P,
            int(sampling_ratio), code]


def roi_geometry_device(rois: torch.Tensor, num_levels: int, *, strides=(4, 8, 16, 32),
                        output_size: int = 7, sampling_ratio: int = 0, min_level: int = 2):
    """The sample geometry as the kernels compute it (``csrc/roi_geometry.cuh``),
    for checks against its plain version ``ops/roi_align.py:roi_geometry``:
    rois ``(R, 4)`` float32 on a CUDA device -> ``(level (R,) int32, ys, wy,
    xs, wx (R, P*m), m)``."""
    dev = rois.device
    if dev.type != "cuda":
        raise ValueError(f"roi_geometry_device runs on CUDA tensors, got {dev}")
    _cuda.require_cuda_f32("rois", rois, dev)
    R = rois.shape[0]
    m = sampling_ratio if sampling_ratio > 0 else ADAPTIVE_CAP
    level = torch.empty((R,), dtype=torch.int32, device=dev)
    geo = [torch.empty((R, output_size * m), dtype=torch.float32, device=dev) for _ in range(4)]
    st = [float(strides[min(i, num_levels - 1)]) for i in range(4)]
    err = _cuda.lib().ttdg_roi_geometry(num_levels, *st, int(min_level), output_size,
                                        int(sampling_ratio), R, rois.data_ptr(),
                                        level.data_ptr(), *(t.data_ptr() for t in geo),
                                        _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_geometry kernel")
    return (level, *geo, m)


def roi_footprints_device(rois: torch.Tensor, level_shapes, *, strides=(4, 8, 16, 32),
                          output_size: int = 7, sampling_ratio: int = 0, min_level: int = 2):
    """Each ROI's level and inclusive pixel footprint as the backward kernel's
    plan computes them (``csrc/roi_pool_backward.cu:roi_plan_kernel``), for
    checks against its plain version ``ops/roi_align.py:roi_footprints``:
    rois ``(R, 4)`` float32 on a CUDA device -> ``(level, y0, y1, x0, x1)``,
    each ``(R,)`` int32."""
    dev = rois.device
    if dev.type != "cuda":
        raise ValueError(f"roi_footprints_device runs on CUDA tensors, got {dev}")
    _cuda.require_cuda_f32("rois", rois, dev)
    R = rois.shape[0]
    L = len(level_shapes)
    words = plan_words(output_size, sampling_ratio)
    plan = torch.empty((R, words), dtype=torch.int32, device=dev)
    # the headers of the rows after the R four-word HitTests: words 4..8
    rows = plan.view(-1)[4 * R:].view(R, words - 4)
    if R == 0:
        return tuple(rows[:, 4:9].unbind(1))
    hw, st = [], []
    for i in range(4):
        j = min(i, L - 1)
        hw += [int(v) for v in level_shapes[j]]
        st.append(float(strides[j]))
    err = _cuda.lib().ttdg_roi_plan(L, *hw, *st, int(min_level), output_size,
                                    int(sampling_ratio), R, rois.data_ptr(), plan.data_ptr(),
                                    _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_plan kernel")
    return tuple(rows[:, 4:9].unbind(1))


def multilevel_roi_pool(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                        strides=(4, 8, 16, 32), output_size: int = 7,
                        sampling_ratio: int = 0, min_level: int = 2):
    """FPN ROIAlign: feats ``[(B, H_l, W_l, C)]`` NHWC float32 or bfloat16
    (up to four levels), rois ``(B, K, 4)`` float32 -> ``(B, K, P, P, C)`` in
    the levels' dtype."""
    if rois.device.type == "cpu":
        plain = multilevel_roi_align_bf16 if feats[0].dtype == torch.bfloat16 else \
            multilevel_roi_align
        return plain(feats, rois, strides=strides, output_size=output_size,
                     sampling_ratio=sampling_ratio, min_level=min_level)
    dev = rois.device
    if dev.type != "cuda":
        raise ValueError(f"multilevel_roi_pool runs on CPU or CUDA tensors, got {dev}")
    B, K = rois.shape[:2]
    C = feats[0].shape[-1]
    P = output_size
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    args = _kernel_args("multilevel_roi_pool", feats, shapes, rois, C, P, strides,
                        sampling_ratio, min_level)
    out = torch.empty((B, K, P, P, C), dtype=feats[0].dtype, device=dev)
    if B * K == 0:
        return out
    err = _cuda.lib().ttdg_roi_pool(*args, out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_pool kernel")
    if feats[0].dtype == torch.bfloat16:
        multilevel_roi_pool.launches_bf16 += 1
    else:
        multilevel_roi_pool.launches += 1
    return out


def multilevel_roi_pool_backward(grad: torch.Tensor, level_shapes, rois: torch.Tensor, *,
                                 strides=(4, 8, 16, 32), sampling_ratio: int = 0,
                                 min_level: int = 2):
    """Feature gradient of :func:`multilevel_roi_pool`: grad ``(B, K, P, P,
    C)`` float32 or bfloat16 -> ``[(B, H_l, W_l, C)]`` per level, in the
    cotangent's dtype.  On CUDA tensors the gather kernel writes every
    element of the level gradients once (they are not zeroed first), each a
    float32 sum in ROI order rounded once, so two calls give the same
    bits."""
    if grad.device.type == "cpu":
        plain = multilevel_roi_align_backward_bf16 if grad.dtype == torch.bfloat16 else \
            multilevel_roi_align_backward
        return plain(grad, level_shapes, rois, strides=strides,
                     sampling_ratio=sampling_ratio, min_level=min_level)
    dev = grad.device
    if dev.type != "cuda":
        raise ValueError(f"multilevel_roi_pool_backward runs on CPU or CUDA tensors, got {dev}")
    B, K, P = rois.shape[0], rois.shape[1], grad.shape[2]
    C = grad.shape[-1]
    if grad.dtype not in DTYPES:
        raise ValueError(f"grad must be float32 or bfloat16, got {grad.dtype}")
    _cuda.require_cuda("grad", grad, dev, grad.dtype)
    if tuple(grad.shape) != (B, K, P, P, C):
        raise ValueError(f"grad must be {(B, K, P, P, C)}, got {tuple(grad.shape)}")
    shapes = [tuple(s) for s in level_shapes]
    out = [torch.empty((B, h, w, C), dtype=grad.dtype, device=dev) for h, w in shapes]
    args = _kernel_args("multilevel_roi_pool_backward", out, shapes, rois, C, P, strides,
                        sampling_ratio, min_level)
    if B * K == 0:
        return [t.zero_() for t in out]
    plan = torch.empty((B * K, plan_words(P, sampling_ratio)), dtype=torch.int32, device=dev)
    err = _cuda.lib().ttdg_roi_pool_backward(*args, plan.data_ptr(), grad.data_ptr(),
                                             _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_pool_backward kernel")
    if grad.dtype == torch.bfloat16:
        multilevel_roi_pool_backward.launches_bf16 += 1
    else:
        multilevel_roi_pool_backward.launches += 1
    return out


class _TrainPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rois, cfg, *feats):
        strides, P, ratio, min_level = cfg
        ctx.cfg = cfg
        ctx.shapes = [(f.shape[1], f.shape[2]) for f in feats]
        ctx.dtype = feats[0].dtype
        ctx.save_for_backward(rois)
        return multilevel_roi_pool(feats, rois, strides=strides, output_size=P,
                                   sampling_ratio=ratio, min_level=min_level)

    @staticmethod
    def backward(ctx, grad):
        strides, _, ratio, min_level = ctx.cfg
        (rois,) = ctx.saved_tensors
        # the cotangent in the features' dtype (the TPU kernel's g.astype)
        grads = multilevel_roi_pool_backward(grad.to(ctx.dtype).contiguous(), ctx.shapes, rois,
                                             strides=strides, sampling_ratio=ratio,
                                             min_level=min_level)
        return (None, None, *grads)


def multilevel_roi_pool_train(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                              strides=(4, 8, 16, 32), output_size: int = 7,
                              sampling_ratio: int = 0, min_level: int = 2):
    """Differentiable :func:`multilevel_roi_pool` for the training pools:
    gradients reach ``feats`` through :func:`multilevel_roi_pool_backward`;
    ``rois`` get none."""
    cfg = (tuple(strides), output_size, sampling_ratio, min_level)
    return _TrainPool.apply(rois.detach().contiguous(), cfg, *feats)


#: kernel launches on float32 and on bfloat16 tensors since the counts were
#: last reset (plain CPU calls not counted)
multilevel_roi_pool.launches = 0
multilevel_roi_pool.launches_bf16 = 0
multilevel_roi_pool_backward.launches = 0
multilevel_roi_pool_backward.launches_bf16 = 0
