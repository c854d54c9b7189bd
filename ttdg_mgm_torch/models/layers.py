"""Convolution and dense layers with a compute dtype: the bf16 compute
policy of the JAX package (``compute_dtype="bfloat16"``), site by site.

A flax layer built with ``dtype=jnp.bfloat16`` keeps its parameters in
float32, casts its input, kernel and bias to bfloat16 and returns bfloat16.
These layers do the same when their ``compute_dtype`` is set (by
:func:`set_compute_dtype`), and are the plain torch layers when it is None.
The casts are differentiable, so the float32 parameters receive float32
gradients.  ``torch.autocast`` is not used: its operator lists would cast
other operations than the JAX package casts (the graph modules' products,
for one) and keep others in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _cast(t, dtype):
    return None if t is None else t.to(dtype)


class ComputeDtype:
    """A layer that computes in ``compute_dtype`` when it is set."""

    compute_dtype: torch.dtype | None = None


class Conv2d(ComputeDtype, nn.Conv2d):
    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return self._conv_forward(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class NormConv2d(Conv2d):
    """detectron2's ``Conv2d``: a convolution with an optional ``norm``
    child, applied after it."""

    def __init__(self, *args, norm: nn.Module | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.norm = norm

    def forward(self, x):
        x = super().forward(x)
        return x if self.norm is None else self.norm(x)


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), _cast(self.bias, dt),
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(ComputeDtype, nn.Linear):
    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class LayerNorm(ComputeDtype, nn.LayerNorm):
    """LayerNorm over the last dimension, computed in float32 and returned in
    the compute dtype (a flax ``LayerNorm(dtype=bfloat16)`` also takes its
    statistics in float32)."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class LayerNorm2d(LayerNorm):
    """detectron2's channel ``LayerNorm`` of NCHW maps (``get_norm("LN")``:
    eps 1e-6), as :class:`LayerNorm` over the channels."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__(channels, eps=eps)

    def forward(self, x):
        return super().forward(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)


def conv_norm(norm: str, channels: int) -> nn.Module | None:
    """The norm module of a convolution (``"LN"``, or ``""`` for none)."""
    if norm == "LN":
        return LayerNorm2d(channels)
    if norm:
        raise ValueError(f"norm must be 'LN' or '', got {norm!r}")
    return None


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> None:
    """Set the compute dtype of every :class:`ComputeDtype` layer under
    ``module`` (these layers and ``resnet.FrozenBatchNorm2d``)."""
    for m in module.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype
