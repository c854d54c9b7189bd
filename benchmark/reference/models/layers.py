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


def _cast(t, dtype, fp8: bool = False):
    if t is None:
        return None
    t = t.to(dtype)
    return _fp8_round(t) if fp8 else t


def _fp8_round(t):
    """``t`` rounded to float8 e4m3 under one scale from its largest
    magnitude (the benchmark's control, one step below bf16)."""
    scale = t.detach().abs().amax().float().clamp(min=1e-12) / 448.0
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


class ComputeDtype:
    """A layer that computes in ``compute_dtype`` when it is set; with
    ``fp8`` its inputs and weights are rounded to float8 first."""

    compute_dtype: torch.dtype | None = None
    fp8: bool = False


class Conv2d(ComputeDtype, nn.Conv2d):
    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        q = self.fp8
        return self._conv_forward(_cast(x, dt, q), _cast(self.weight, dt, q), _cast(self.bias, dt))


class ConvTranspose2d(ComputeDtype, nn.ConvTranspose2d):
    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        q = self.fp8
        return F.conv_transpose2d(_cast(x, dt, q), _cast(self.weight, dt, q), _cast(self.bias, dt),
                                  self.stride, self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(ComputeDtype, nn.Linear):
    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        q = self.fp8
        return F.linear(_cast(x, dt, q), _cast(self.weight, dt, q), _cast(self.bias, dt))


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> None:
    """Set the compute dtype of every :class:`ComputeDtype` layer under
    ``module`` (these layers and ``resnet.FrozenBatchNorm2d``)."""
    for m in module.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype


def set_fp8(module: nn.Module) -> None:
    """Round the inputs and weights of every convolution and dense layer
    under ``module`` that has a compute dtype to float8 (the control)."""
    for m in module.modules():
        if isinstance(m, (Conv2d, ConvTranspose2d, Linear)):
            m.fp8 = True
