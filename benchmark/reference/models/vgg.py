"""VGG-16-BN trunk, the alternative to the ResNet (``MODEL.BACKBONE.NAME
build_vgg_backbone``).

Counterpart of ``ttdg_mgm_tpu/models/vgg.py``: 13 ``3x3`` convolutions with
a bias, each followed by a ``FrozenBatchNorm2d`` and a ReLU, and a 2x2/2 max
pool after each of the 5 blocks; the outputs after pools 2-5 are the
stride-4 to stride-32 stages of widths 128, 256, 512 and 512.

Parameter names follow torchvision's ``vgg16_bn.features``: the convs at
``features.{0, 3, 7, ...}`` (:data:`CONV_IDX`), each norm at the next index
with d2's four buffers, so a torchvision checkpoint maps by index
(``checkpoint/bridge.py:vgg16bn_to_d2``).  NCHW inside.

The trunk always computes in float32.  The JAX model builds it without a
``dtype`` (``ttdg_mgm_tpu/models/rcnn.py:146-149``), so under the bf16
policy flax's ``Conv`` promotes the bf16-rounded input and its float32
kernel to float32; here the input is upcast and the layers are plain
(``layers.set_compute_dtype`` leaves them alone, see ``rcnn.py``).  The
FPN then casts ``res2 .. res5`` to its compute dtype.
"""

from __future__ import annotations

from torch import nn

from reference.models.resnet import FrozenBatchNorm2d

#: VGG-16 configuration "D": channels per conv, "M" a max pool
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M")
#: ``features`` indices of the 13 convs (each norm follows at +1)
CONV_IDX = (0, 3, 7, 10, 14, 17, 20, 24, 27, 30, 34, 37, 40)
#: the widths of ``res2 .. res5`` (the outputs after pools 2-5)
STAGE_CHANNELS = (128, 256, 512, 512)


class VGG16Backbone(nn.Module):
    """``x (B, 3, H, W)`` -> ``{"vgg2": ..., "vgg5": ...}``, float32 NCHW;
    ``vgg{s}`` is the output of the ``s``-th max pool (stride ``2**s``)."""

    def __init__(self):
        super().__init__()
        layers: list[nn.Module] = []
        in_ch = 3
        for v in VGG16:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), FrozenBatchNorm2d(v),
                           nn.ReLU()]
                in_ch = v
        self.features = nn.Sequential(*layers)

    def forward(self, x):
        x = x.float()
        outs, stage = {}, 0
        for m in self.features:
            x = m(x)
            if isinstance(m, nn.MaxPool2d):
                stage += 1
                if stage >= 2:
                    outs[f"vgg{stage}"] = x
        return outs


class VGG16FPNBackbone(VGG16Backbone):
    """The trunk the FPN reads (reference ``build_vgg_backbone``'s FPN
    wrapper): the same stages under the ResNet's names ``res2 .. res5``."""

    def forward(self, x):
        feats = super().forward(x)
        return {f"res{i}": feats[f"vgg{i}"] for i in range(2, 6)}
