"""Image-level domain discriminator with gradient reversal.

Counterpart of ``ttdg_mgm_tpu/models/discriminator.py``: ``FCDiscriminatorImg``,
a 3-conv patch classifier over one feature map (the ``dis_type`` level),
with d2's names ``conv1``, ``conv2`` and ``classifier``, and
:func:`grad_reverse`, the identity whose backward negates and scales the
incoming gradient.  The convolutions take a compute dtype
(``models/layers.py``), as the JAX module's ``dtype=``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.models.layers import Conv2d


class _GradReverse(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale: float):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return -ctx.scale * g, None


def grad_reverse(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """``x`` in the forward pass; the gradient ``-scale * g`` backward."""
    return _GradReverse.apply(x, scale)


class FCDiscriminatorImg(nn.Module):
    """conv3x3 (in -> C/2) -> LeakyReLU 0.2 -> conv3x3 (C/2 -> C/4) ->
    LeakyReLU 0.2 -> conv3x3 (C/4 -> 1), on NCHW maps.  ``channels`` sets
    the widths as the JAX module's ``channels`` does; ``in_channels`` is the
    width of the feature it reads (flax infers it from the input)."""

    def __init__(self, in_channels: int, channels: int = 256):
        super().__init__()
        self.conv1 = Conv2d(in_channels, channels // 2, 3, padding=1)
        self.conv2 = Conv2d(channels // 2, channels // 4, 3, padding=1)
        self.classifier = Conv2d(channels // 4, 1, 3, padding=1)

    def forward(self, x):
        x = F.leaky_relu(self.conv1(x), 0.2)
        x = F.leaky_relu(self.conv2(x), 0.2)
        return self.classifier(x)
