"""ResNet bottleneck trunk with detectron2 semantics (caffe-style).

Counterpart of ``ttdg_mgm_tpu/models/resnet.py``: FrozenBatchNorm affines,
the stride on the first 1x1 conv of each stage (``STRIDE_IN_1X1``), explicit
torch padding, ``freeze_at`` stages cut from the graph.  Parameter names are
d2's (``stem.conv1``, ``res2.0.conv1.norm``, ...), so a d2 state dict loads
as it is.  NCHW inside; callers convert at the package's NHWC boundary.
Under the bf16 compute policy (``layers.set_compute_dtype``) every conv and
every FrozenBatchNorm runs in bfloat16, as in ``ttdg_mgm_tpu/models/resnet.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ttdg_mgm_torch.models import layers

STAGE_BLOCKS = {14: (1, 1, 1, 1), 26: (2, 2, 2, 2), 50: (3, 4, 6, 3),
                101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


class FrozenBatchNorm2d(layers.ComputeDtype, nn.Module):
    """d2 ``FrozenBatchNorm2d``: ``y = x * scale + shift`` from fixed buffers,
    ``scale = weight / sqrt(running_var + eps)``.  With a compute dtype, the
    scale and shift are cast to it and applied in it (the JAX
    ``FrozenBatchNorm(dtype=bf16)``), so the activations and their gradients
    stay bfloat16 along the trunk."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features) - eps)

    def forward(self, x):
        scale = self.weight * (self.running_var + self.eps).rsqrt()
        shift = self.bias - self.running_mean * scale
        if self.compute_dtype is not None:
            x, scale, shift = (x.to(self.compute_dtype), scale.to(self.compute_dtype),
                               shift.to(self.compute_dtype))
        return x * scale[None, :, None, None] + shift[None, :, None, None]


#: d2 ``Conv2d``: a convolution with an optional ``norm`` child
Conv2d = layers.NormConv2d


class BottleneckBlock(nn.Module):
    def __init__(self, in_channels: int, bottleneck_channels: int, out_channels: int,
                 stride: int = 1, has_shortcut: bool = False):
        super().__init__()
        if has_shortcut:
            self.shortcut = Conv2d(in_channels, out_channels, 1, stride=stride, bias=False,
                                   norm=FrozenBatchNorm2d(out_channels))
        else:
            self.shortcut = None
        self.conv1 = Conv2d(in_channels, bottleneck_channels, 1, stride=stride, bias=False,
                            norm=FrozenBatchNorm2d(bottleneck_channels))
        self.conv2 = Conv2d(bottleneck_channels, bottleneck_channels, 3, padding=1,
                            bias=False, norm=FrozenBatchNorm2d(bottleneck_channels))
        self.conv3 = Conv2d(bottleneck_channels, out_channels, 1, bias=False,
                            norm=FrozenBatchNorm2d(out_channels))

    def forward(self, x):
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        sc = x if self.shortcut is None else self.shortcut(x)
        return F.relu(out + sc)


class BasicStem(nn.Module):
    def __init__(self, in_channels: int = 3, out_channels: int = 64):
        super().__init__()
        self.conv1 = Conv2d(in_channels, out_channels, 7, stride=2, padding=3, bias=False,
                            norm=FrozenBatchNorm2d(out_channels))

    def forward(self, x):
        x = F.relu(self.conv1(x))
        return F.max_pool2d(x, 3, stride=2, padding=1)


class ResNet(nn.Module):
    """Bottleneck trunk returning ``{"res2": ..., "res5": ...}`` (NCHW).

    ``stage_width`` is res2's output width (stages double from it);
    ``freeze_at`` (d2 ``BACKBONE.FREEZE_AT``) detaches the stem and stages
    ``res2 .. res{freeze_at}``, so their backward never runs.
    """

    def __init__(self, stage_blocks: Sequence[int] = (3, 4, 6, 3), stage_width: int = 256,
                 freeze_at: int = 0):
        super().__init__()
        self.freeze_at = freeze_at
        self.stem = BasicStem(3, 64)
        self.stage_names = []
        in_ch = 64
        for idx, n in enumerate(stage_blocks):
            out_ch = stage_width * 2 ** idx
            mid_ch = (stage_width // 4) * 2 ** idx
            blocks = [BottleneckBlock(in_ch if b == 0 else out_ch, mid_ch, out_ch,
                                      stride=2 if (b == 0 and idx > 0) else 1,
                                      has_shortcut=b == 0)
                      for b in range(n)]
            name = f"res{idx + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)
            in_ch = out_ch

    def forward(self, x):
        x = self.stem(x)
        if self.freeze_at >= 1:
            x = x.detach()
        outs = {}
        for idx, name in enumerate(self.stage_names):
            x = getattr(self, name)(x)
            if self.freeze_at >= idx + 2:
                x = x.detach()
            outs[name] = x
        return outs
