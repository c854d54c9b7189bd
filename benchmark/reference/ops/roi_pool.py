"""The multi-level ROI pool, plain: ``ops/roi_align.py``'s float32 and
bf16 versions under the names the model calls (the port's kernels A and C
are not here).  The training pool differentiates through the plain
backward, as the port's autograd function does through kernel C."""

from __future__ import annotations

from typing import Sequence

import torch

from reference.ops.roi_align import (multilevel_roi_align, multilevel_roi_align_backward,
                                     multilevel_roi_align_backward_bf16,
                                     multilevel_roi_align_bf16)


def multilevel_roi_pool(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                        strides=(4, 8, 16, 32), output_size: int = 7,
                        sampling_ratio: int = 0, min_level: int = 2):
    plain = multilevel_roi_align_bf16 if feats[0].dtype == torch.bfloat16 else \
        multilevel_roi_align
    return plain(feats, rois, strides=strides, output_size=output_size,
                 sampling_ratio=sampling_ratio, min_level=min_level)


def multilevel_roi_pool_backward(grad: torch.Tensor, level_shapes, rois: torch.Tensor, *,
                                 strides=(4, 8, 16, 32), sampling_ratio: int = 0,
                                 min_level: int = 2):
    plain = multilevel_roi_align_backward_bf16 if grad.dtype == torch.bfloat16 else \
        multilevel_roi_align_backward
    return plain(grad, level_shapes, rois, strides=strides, sampling_ratio=sampling_ratio,
                 min_level=min_level)


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
        grads = multilevel_roi_pool_backward(grad.to(ctx.dtype).contiguous(), ctx.shapes, rois,
                                             strides=strides, sampling_ratio=ratio,
                                             min_level=min_level)
        return (None, None, *grads)


def multilevel_roi_pool_train(feats: Sequence[torch.Tensor], rois: torch.Tensor, *,
                              strides=(4, 8, 16, 32), output_size: int = 7,
                              sampling_ratio: int = 0, min_level: int = 2):
    cfg = (tuple(strides), output_size, sampling_ratio, min_level)
    return _TrainPool.apply(rois.detach().contiguous(), cfg, *feats)
