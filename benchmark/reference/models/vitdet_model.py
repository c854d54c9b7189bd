"""The plain reference of ViTDet-B Mask R-CNN, after detectron2's code.

Li, Mao, Girshick, He, "Exploring Plain Vision Transformer Backbones for
Object Detection" (ECCV 2022); detectron2's ``modeling/backbone/vit.py``
(``ViT``, ``Block``, ``Attention``, ``window_partition``,
``window_unpartition``, ``get_rel_pos``, ``add_decomposed_rel_pos``,
``get_abs_pos``, ``SimpleFeaturePyramid``) and
``projects/ViTDet/configs/COCO/mask_rcnn_vitdet_b_100ep.py`` (two RPN convs,
a box head of four LN convs and one dense layer, LN in the mask head's
convs, LN in the pyramid's convs, which have no bias).  The rest of the
detector (proposals, pools, box and mask heads' predictors, the graph
matching) is ``reference/models/rcnn.py:MaskRCNN``'s, whose trunk, pyramid,
RPN head, box head and mask head this model replaces.

Dense attention: the ``N x N`` scores held whole, the relative positions
gathered from their tables by index, the position embedding resized with
``F.interpolate`` (bicubic, ``align_corners=False``).  Convolution and
dense layers are ``reference/models/layers.py``'s, so the float8 control
reaches them.

Departures from detectron2, each the program's as well:

* the bf16 compute policy of the port (``models/layers.py``): dense and
  convolution layers and the residual stream in bf16; the LayerNorms, the
  attention's scores, softmax and product, and the relative-position terms
  in float32 (from the bf16 ``q``, ``k``, ``v``); TF32 off
  (``reference/cell.py:build``);
* the input: the port's canvas (raw pixels padded with zeros, then
  normalised) cut or padded to the ``SQUARE_PAD`` square; detectron2 pads
  after normalising;
* no stochastic depth (``DROP_PATH_RATE`` must be 0.0);
* the optimizer's norm rule (``reference/solver/build.py``) freezes the
  LayerNorms the convolutions carry as ``norm``, as it freezes the
  ResNet's frozen norms.

Imports nothing of the program.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from reference.cell import model_kwargs
from reference.models.layers import (ComputeDtype, Conv2d, ConvTranspose2d, Linear,
                                     set_compute_dtype)
from reference.models.rcnn import COMPUTE_DTYPES, MaskRCNN


class LayerNorm(ComputeDtype, nn.LayerNorm):
    """``nn.LayerNorm`` over the last dimension in float32, returned in the
    compute dtype."""

    def forward(self, x):
        y = super().forward(x.float())
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class ChannelLayerNorm(LayerNorm):
    """detectron2's ``layers.LayerNorm`` of NCHW maps (eps 1e-6), in
    float32."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-6)

    def forward(self, x):
        x = x.float()
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        y = self.weight[:, None, None] * x + self.bias[:, None, None]
        return y if self.compute_dtype is None else y.to(self.compute_dtype)


class NormConv2d(Conv2d):
    """detectron2's ``Conv2d(norm=LayerNorm)``: no bias, the norm after."""

    def __init__(self, cin: int, cout: int, k: int, padding: int = 0):
        super().__init__(cin, cout, k, padding=padding, bias=False)
        self.norm = ChannelLayerNorm(cout)

    def forward(self, x):
        return self.norm(super().forward(x))


def get_rel_pos(q_size: int, k_size: int, rel_pos):
    """detectron2's ``get_rel_pos`` for tables of ``2 max(q, k) - 1`` rows."""
    q_coords = torch.arange(q_size, device=rel_pos.device)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=rel_pos.device)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


def add_decomposed_rel_pos(attn, q, rel_pos_h, rel_pos_w, q_size, k_size):
    """detectron2's ``add_decomposed_rel_pos``."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    Rh = get_rel_pos(q_h, k_h, rel_pos_h)
    Rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw)
    attn = (attn.view(B, q_h, q_w, k_h, k_w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(B, q_h * q_w, k_h * k_w)
    return attn


def window_partition(x, window_size: int):
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h > 0 or pad_w > 0:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.view(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows, window_size: int, pad_hw, hw):
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.view(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, Hp, Wp, -1)
    if Hp > H or Wp > W:
        x = x[:, :H, :W, :].contiguous()
    return x


def get_abs_pos(abs_pos, hw):
    """detectron2's ``get_abs_pos`` with a class token."""
    h, w = hw
    abs_pos = abs_pos[:, 1:]
    size = int(abs_pos.shape[1] ** 0.5)
    new = F.interpolate(abs_pos.reshape(1, size, size, -1).permute(0, 3, 1, 2), size=(h, w),
                        mode="bicubic", align_corners=False)
    return new.permute(0, 2, 3, 1)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size):
        super().__init__()
        self.num_heads = num_heads
        head_dim = dim // num_heads
        self.scale = head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=True)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head_dim))

    def forward(self, x):
        B, H, W, _ = x.shape
        qkv = self.qkv(x).reshape(B, H * W, 3, self.num_heads, -1).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, B * self.num_heads, H * W, -1).float().unbind(0)
        attn = (q * self.scale) @ k.transpose(-2, -1)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (H, W), (H, W))
        attn = attn.softmax(dim=-1)
        x = (attn @ v).view(B, self.num_heads, H, W, -1).permute(0, 2, 3, 1, 4)
        return self.proj(x.reshape(B, H, W, -1).to(qkv.dtype))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    def __init__(self, dim, num_heads, mlp_ratio, window_size, input_size):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads,
                              input_size if window_size == 0 else (window_size, window_size))
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.window_size = window_size

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            H, W = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, (H, W))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ViT(ComputeDtype, nn.Module):
    def __init__(self, img_size, patch_size, embed_dim, depth, num_heads, mlp_ratio,
                 window_size, window_block_indexes, pretrain_img_size):
        super().__init__()
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        n = (pretrain_img_size // patch_size) ** 2 + 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        grid = img_size // patch_size
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size if i in window_block_indexes else 0, (grid, grid))
            for i in range(depth))
        self.out_channels = embed_dim

    def forward(self, x):
        x = self.patch_embed(x)
        pos = get_abs_pos(self.pos_embed, (x.shape[1], x.shape[2]))
        x = x + (pos if self.compute_dtype is None else pos.to(self.compute_dtype))
        for blk in self.blocks:
            x = blk(x)
        return {"last_feat": x.permute(0, 3, 1, 2)}


class SimpleFeaturePyramid(nn.Module):
    def __init__(self, net: ViT, out_channels: int):
        super().__init__()
        self.net = net
        dim = net.out_channels
        stages = {2: ([ConvTranspose2d(dim, dim // 2, 2, stride=2), ChannelLayerNorm(dim // 2),
                       nn.GELU(), ConvTranspose2d(dim // 2, dim // 4, 2, stride=2)], dim // 4),
                  3: ([ConvTranspose2d(dim, dim // 2, 2, stride=2)], dim // 2),
                  4: ([], dim),
                  5: ([nn.MaxPool2d(kernel_size=2, stride=2)], dim)}
        for stage, (layers, width) in stages.items():
            layers = layers + [NormConv2d(width, out_channels, 1),
                               NormConv2d(out_channels, out_channels, 3, padding=1)]
            self.add_module(f"simfp_{stage}", nn.Sequential(*layers))

    def forward(self, x):
        feat = self.net(x)["last_feat"]
        outs = {f"p{s}": getattr(self, f"simfp_{s}")(feat) for s in range(2, 6)}
        outs["p6"] = F.max_pool2d(outs["p5"], kernel_size=1, stride=2, padding=0)
        return outs


class RPNHead(nn.Module):
    """detectron2's ``StandardRPNHead`` with ``conv_dims=[-1, -1]``."""

    def __init__(self, channels: int, num_convs: int, num_anchors: int = 3):
        super().__init__()
        self.conv = nn.Sequential()
        for k in range(num_convs):
            self.conv.add_module(f"conv{k}", Conv2d(channels, channels, 3, padding=1))
        self.objectness_logits = Conv2d(channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(channels, num_anchors * 4, 1)

    def forward(self, feats):
        logits, regs = [], []
        for f in feats:
            t = f
            for conv in self.conv:
                t = F.relu(conv(t))
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1))
            regs.append(self.anchor_deltas(t).permute(0, 2, 3, 1))
        return logits, regs


class ConvFCBoxHead(nn.Module):
    """detectron2's ``FastRCNNConvFCHead`` with LN convs: (N, P, P, C) ->
    (N, fc_dim)."""

    def __init__(self, channels: int, num_conv: int, conv_dim: int, num_fc: int, fc_dim: int,
                 pool: int = 7):
        super().__init__()
        c = channels
        for k in range(num_conv):
            self.add_module(f"conv{k + 1}", NormConv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        d = c * pool * pool
        for k in range(num_fc):
            self.add_module(f"fc{k + 1}", Linear(d, fc_dim))
            d = fc_dim
        self.num_conv, self.num_fc = num_conv, num_fc

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for k in range(self.num_conv):
            x = F.relu(getattr(self, f"conv{k + 1}")(x))
        x = torch.flatten(x, start_dim=1)
        for k in range(self.num_fc):
            x = F.relu(getattr(self, f"fc{k + 1}")(x))
        return x


class LNMaskHead(nn.Module):
    """detectron2's ``MaskRCNNConvUpsampleHead`` with ``conv_norm="LN"``."""

    def __init__(self, channels: int, num_classes: int, conv_dim: int, num_conv: int):
        super().__init__()
        c = channels
        for k in range(num_conv):
            self.add_module(f"mask_fcn{k + 1}", NormConv2d(c, conv_dim, 3, padding=1))
            c = conv_dim
        self.deconv = ConvTranspose2d(c, conv_dim, 2, stride=2)
        self.predictor = Conv2d(conv_dim, num_classes, 1)
        self.num_conv = num_conv

    def forward(self, x):
        x = x.permute(0, 3, 1, 2)
        for k in range(self.num_conv):
            x = F.relu(getattr(self, f"mask_fcn{k + 1}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class ViTDetRCNN(MaskRCNN):
    """``MaskRCNN`` with ViTDet's trunk, pyramid, RPN head, box head and mask
    head, and its input on the ``square_pad`` square."""

    def __init__(self, cfg):
        kw = model_kwargs(cfg)
        # a small ResNet stands in while the shared parts are built, then the
        # trunk and heads are ViTDet's
        super().__init__(**{**kw, "resnet_depth": 14, "resnet_width": 16})
        v = cfg.MODEL.VIT
        if v.DROP_PATH_RATE != 0.0:
            raise ValueError("the reference takes DROP_PATH_RATE 0.0")
        self.square_pad = v.SQUARE_PAD
        C = cfg.MODEL.FPN.OUT_CHANNELS
        self.backbone = SimpleFeaturePyramid(
            ViT(v.SQUARE_PAD, v.PATCH_SIZE, v.EMBED_DIM, v.DEPTH, v.NUM_HEADS, v.MLP_RATIO,
                v.WINDOW_SIZE, tuple(v.WINDOW_BLOCK_INDEXES), v.PRETRAIN_IMG_SIZE), C)
        self.proposal_generator.rpn_head = RPNHead(C, len(cfg.MODEL.RPN.CONV_DIMS))
        b, m = cfg.MODEL.ROI_BOX_HEAD, cfg.MODEL.ROI_MASK_HEAD
        self.roi_heads.box_head = ConvFCBoxHead(C, b.NUM_CONV, b.CONV_DIM, b.NUM_FC, b.FC_DIM)
        self.roi_heads.mask_head = LNMaskHead(C, kw["num_classes"], m.CONV_DIM, m.NUM_CONV)
        dt = COMPUTE_DTYPES[kw["compute_dtype"]]
        for mod in (self.backbone, self.proposal_generator, self.roi_heads):
            set_compute_dtype(mod, dt)

    def _normalize(self, images):
        S = self.square_pad
        H, W = images.shape[1:3]
        images = images[:, :S, :S]
        if H < S or W < S:
            images = F.pad(images, (0, 0, 0, max(S - W, 0), 0, max(S - H, 0)))
        return super()._normalize(images)


def build_model(cfg):
    return ViTDetRCNN(cfg)


def init_rules(model) -> dict:
    """The leaves weights.py's rules by module type leave out or rule
    otherwise: the position embedding and the relative-position tables
    truncated normal (std 0.02, at 2 std; the tables are not detectron2's
    zeros, so the relative path is tested), the RPN convs normal(0.01)
    (detectron2's ``StandardRPNHead`` init)."""
    rules = {}
    for name, _ in model.named_parameters():
        if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w")):
            rules[name] = ("normal", 0.02, 0.0, 2.0)
        elif name.startswith("proposal_generator.rpn_head.conv.") and name.endswith(".weight"):
            rules[name] = ("normal", 0.01, 0.0, None)
    return rules
