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


def set_compute_dtype(module: nn.Module, dtype: torch.dtype | None) -> None:
    """Set the compute dtype of every :class:`ComputeDtype` layer under
    ``module`` (these layers and ``resnet.FrozenBatchNorm2d``)."""
    for m in module.modules():
        if isinstance(m, ComputeDtype):
            m.compute_dtype = dtype
