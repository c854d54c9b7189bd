"""Feature Pyramid Network and ViTDet's simple feature pyramid (detectron2
semantics).

Counterpart of ``ttdg_mgm_tpu/models/fpn.py``: 1x1 laterals, nearest 2x
top-down upsampling, 3x3 outputs, ``p6`` a stride-2 1x1 max pool of ``p5``.
Named as d2's FPN backbone (``bottom_up``, ``fpn_lateral{i}``,
``fpn_output{i}``).  NCHW inside; the convs run in the compute dtype.

The upsampling is a broadcast, as the JAX package's ``_upsample_nearest_2x``
is, and ``p6`` a strided slice (a 1x1 max pool is the identity on the
pixels it keeps): both have backward passes that are plain sums, which
give the same bits in every run, where ``F.interpolate``'s backward on CUDA
adds with atomics.

:class:`SimpleFeaturePyramid` is detectron2's for ViTDet: ``p2 .. p5`` from
the trunk's last map alone (two 2x2 deconvolutions with a channel
LayerNorm and GELU between them, one deconvolution, the map itself, a 2x2
max pool), each then a 1x1 and a 3x3 convolution without bias, each with a
channel LayerNorm; ``p6`` as :class:`FPN`'s.  Named as detectron2's
(``net``, ``simfp_{2..5}.{i}``).
"""

from __future__ import annotations

from torch import nn

from ttdg_mgm_torch.models.layers import (Conv2d, ConvTranspose2d, LayerNorm2d, NormConv2d,
                                          conv_norm)
from ttdg_mgm_torch.utils.profiling import span


def upsample_nearest_2x(x):
    """``(B, C, H, W) -> (B, C, 2H, 2W)``, each pixel repeated 2 x 2."""
    B, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(B, C, H, 2, W, 2).reshape(B, C, 2 * H, 2 * W)


class FPN(nn.Module):
    """The pyramid over ``bottom_up``, a trunk returning ``res2 .. res5`` of
    widths ``in_channels`` (``models/resnet.py:ResNet`` or
    ``models/vgg.py:VGG16FPNBackbone``)."""

    def __init__(self, bottom_up: nn.Module, in_channels, out_channels: int = 256):
        super().__init__()
        self.bottom_up = bottom_up
        for i, c in zip(range(2, 6), in_channels):
            self.add_module(f"fpn_lateral{i}", Conv2d(c, out_channels, 1))
            self.add_module(f"fpn_output{i}", Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, x):
        feats = self.bottom_up(x)
        laterals = [getattr(self, f"fpn_lateral{i}")(feats[f"res{i}"]) for i in range(2, 6)]
        merged = [None] * 4
        merged[3] = laterals[3]
        for i in (2, 1, 0):
            up = upsample_nearest_2x(merged[i + 1])
            up = up[:, :, : laterals[i].shape[2], : laterals[i].shape[3]]
            merged[i] = laterals[i] + up
        outs = {f"p{i + 2}": getattr(self, f"fpn_output{i + 2}")(merged[i]) for i in range(4)}
        outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs


class SimpleFeaturePyramid(nn.Module):
    """The pyramid over ``net`` (``models/vit.py:ViT``), a trunk returning
    ``{"last_feat": (B, C, H, W)}`` at stride 16, with convolutions normed
    by ``norm`` (``"LN"``).  Spans: ``backbone.vit`` (the trunk) and
    ``backbone.pyramid``."""

    def __init__(self, net: nn.Module, out_channels: int = 256, norm: str = "LN"):
        super().__init__()
        self.net = net
        dim = net.out_channels
        for stage, layers, width in (
                (2, [ConvTranspose2d(dim, dim // 2, 2, stride=2), LayerNorm2d(dim // 2),
                     nn.GELU(), ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)], dim // 4),
                (3, [ConvTranspose2d(dim, dim // 2, 2, stride=2)], dim // 2),
                (4, [], dim),
                (5, [nn.MaxPool2d(2, 2)], dim)):
            layers = layers + [
                NormConv2d(width, out_channels, 1, bias=not norm,
                           norm=conv_norm(norm, out_channels)),
                NormConv2d(out_channels, out_channels, 3, padding=1, bias=not norm,
                           norm=conv_norm(norm, out_channels))]
            self.add_module(f"simfp_{stage}", nn.Sequential(*layers))

    def forward(self, x):
        with span("backbone.vit"):
            feat = self.net(x)["last_feat"]
        with span("backbone.pyramid"):
            outs = {f"p{i}": getattr(self, f"simfp_{i}")(feat) for i in range(2, 6)}
            outs["p6"] = outs["p5"][:, :, ::2, ::2]
        return outs
