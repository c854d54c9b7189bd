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
  backward is :func:`multilevel_roi_pool_backward`, the scatter-accumulate
  kernel.  No gradient reaches the ROIs, as in the JAX package.

On CPU tensors the plain versions run; on CUDA tensors the kernels launch
(or the call raises).  Each kernel wrapper counts its launches.  A wrapper
starts no device work but its kernel (and, for the backward, the zeroing of
the level gradients): both kernels compute the sample geometry themselves
(``csrc/roi_geometry.cuh``, the device copy of
``ops/roi_align.py:roi_geometry``; :func:`roi_geometry_device` returns it for
checks).  The ROIs must be contiguous float32 and the channel count a
multiple of 4.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ttdg_mgm_torch.ops import _cuda
from ttdg_mgm_torch.ops.roi_align import (ADAPTIVE_CAP, multilevel_roi_align,
                                          multilevel_roi_align_backward)

__all__ = ["multilevel_roi_pool", "multilevel_roi_pool_backward", "multilevel_roi_pool_train",
           "multilevel_roi_align", "roi_geometry_device"]

#: sample slots per axis (``P * m``) the kernels hold (``csrc/roi_geometry.cuh``)
MAX_AXIS_SAMPLES = 64


def _kernel_args(name, tensors, level_shapes, rois, C: int, P: int, strides,
                 sampling_ratio: int, min_level: int):
    """Validate a kernel call and lay out its C arguments: the four level
    pointers and shapes (the last level repeated), ``C, R, K``, the ROIs, the
    four strides, ``min_level, P`` and the sampling ratio.  ``tensors`` are
    the levels (forward) or their gradients (backward).  The kernels compute
    the sample geometry themselves, so no device work happens here."""
    dev = rois.device
    if not 1 <= len(tensors) <= 4:
        raise ValueError(f"{name} takes one to four levels")
    _cuda.require_cuda_f32("rois", rois, dev)
    if rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(f"rois must be (B, K, 4), got {tuple(rois.shape)}")
    if C % 4 != 0 or C > 1024:
        raise ValueError(f"{name} takes a channel count that is a multiple of 4, at most "
                         f"1024 (16-byte loads), got {C}")
    m = sampling_ratio if sampling_ratio > 0 else ADAPTIVE_CAP
    if sampling_ratio < 0 or P * m > MAX_AXIS_SAMPLES:
        raise ValueError(f"{name} takes at most {MAX_AXIS_SAMPLES} samples per axis, got "
                         f"P={P} x {m}")
    B, K = rois.shape[:2]
    for i, (t, (h, w)) in enumerate(zip(tensors, level_shapes)):
        _cuda.require_cuda_f32(f"level {i}", t, dev)
        if tuple(t.shape) != (B, h, w, C):
            raise ValueError(f"level {i} must be {(B, h, w, C)}, got {tuple(t.shape)}")
    ptrs, hw, st = [], [], []
    for i in range(4):
        j = min(i, len(tensors) - 1)
        ptrs.append(tensors[j].data_ptr())
        hw += list(level_shapes[j])
        st.append(float(strides[j]))
    return [*ptrs, len(tensors), *hw, C, B * K, K, rois.data_ptr(), *st, int(min_level), P,
            int(sampling_ratio)]


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


def multilevel_roi_pool(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                        strides=(4, 8, 16, 32), output_size: int = 7,
                        sampling_ratio: int = 0, min_level: int = 2):
    """FPN ROIAlign: feats ``[(B, H_l, W_l, C)]`` NHWC float32 (up to four
    levels), rois ``(B, K, 4)`` -> ``(B, K, P, P, C)``."""
    if rois.device.type == "cpu":
        return multilevel_roi_align(feats, rois, strides=strides, output_size=output_size,
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
    out = torch.empty((B, K, P, P, C), dtype=torch.float32, device=dev)
    if B * K == 0:
        return out
    err = _cuda.lib().ttdg_roi_pool(*args, out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_pool kernel")
    multilevel_roi_pool.launches += 1
    return out


def multilevel_roi_pool_backward(grad: torch.Tensor, level_shapes, rois: torch.Tensor, *,
                                 strides=(4, 8, 16, 32), sampling_ratio: int = 0,
                                 min_level: int = 2):
    """Feature gradient of :func:`multilevel_roi_pool`: grad ``(B, K, P, P,
    C)`` -> ``[(B, H_l, W_l, C)]`` per level.  On CUDA tensors the atomic
    scatter kernel adds into zeroed level gradients, so the last bits of a
    sum change from run to run."""
    if grad.device.type == "cpu":
        return multilevel_roi_align_backward(grad, level_shapes, rois, strides=strides,
                                             sampling_ratio=sampling_ratio,
                                             min_level=min_level)
    dev = grad.device
    if dev.type != "cuda":
        raise ValueError(f"multilevel_roi_pool_backward runs on CPU or CUDA tensors, got {dev}")
    B, K, P = rois.shape[0], rois.shape[1], grad.shape[2]
    C = grad.shape[-1]
    _cuda.require_cuda_f32("grad", grad, dev)
    if tuple(grad.shape) != (B, K, P, P, C):
        raise ValueError(f"grad must be {(B, K, P, P, C)}, got {tuple(grad.shape)}")
    shapes = [tuple(s) for s in level_shapes]
    out = [torch.zeros((B, h, w, C), dtype=torch.float32, device=dev) for h, w in shapes]
    args = _kernel_args("multilevel_roi_pool_backward", out, shapes, rois, C, P, strides,
                        sampling_ratio, min_level)
    if B * K == 0:
        return out
    err = _cuda.lib().ttdg_roi_pool_backward(*args, grad.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_pool_backward kernel")
    multilevel_roi_pool_backward.launches += 1
    return out


class _TrainPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rois, cfg, *feats):
        strides, P, ratio, min_level = cfg
        ctx.cfg = cfg
        ctx.shapes = [(f.shape[1], f.shape[2]) for f in feats]
        ctx.save_for_backward(rois)
        return multilevel_roi_pool(feats, rois, strides=strides, output_size=P,
                                   sampling_ratio=ratio, min_level=min_level)

    @staticmethod
    def backward(ctx, grad):
        strides, _, ratio, min_level = ctx.cfg
        (rois,) = ctx.saved_tensors
        grads = multilevel_roi_pool_backward(grad.contiguous(), ctx.shapes, rois,
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


#: kernel launches since the count was last reset (plain CPU calls not counted)
multilevel_roi_pool.launches = 0
multilevel_roi_pool_backward.launches = 0
