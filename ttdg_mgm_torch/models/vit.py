"""The plain ViT backbone of ViTDet (detectron2's ``modeling/backbone/vit.py``).

Li, Mao, Girshick, He, "Exploring Plain Vision Transformer Backbones for
Object Detection" (ECCV 2022).  ViT-B: width 768, 12 blocks of 12 heads of
64, MLP ratio 4 with exact GELU, patch 16, ``qkv`` with bias, LayerNorm eps
1e-6, no final norm.  The blocks of ``window_block_indexes`` attend inside
``window_size x window_size`` windows of the token grid, zero-padded to a
multiple of the window (the padded tokens are attended to without a mask,
as in detectron2: ``qkv``'s bias makes their keys and values non-zero); the
others attend over the whole grid.  Every block adds decomposed relative
positions (``add_decomposed_rel_pos``: ``rel_h = einsum(q, Rh)`` on the
unscaled ``q``, added to the scaled scores).  The absolute position
embedding, pretrained at ``pretrain_img_size / patch_size`` per side with a
class token, is resized bicubically to the token grid in every pass.

Names are detectron2's (``net.patch_embed.proj``, ``net.pos_embed``,
``net.blocks.{i}.{norm1,attn.qkv,attn.proj,attn.rel_pos_h,attn.rel_pos_w,
norm2,mlp.fc1,mlp.fc2}``), so its checkpoints load by name.

Numerics, under the bf16 compute policy (``models/layers.py``): the
residual stream, the dense layers and the attention's q, k, v and output
are in the compute dtype; the LayerNorms, the relative-position terms and
the attention's softmax (kernel F, ``ops/vit_attention.py``) in float32.
Two departures from detectron2 keep every run's bits the same on CUDA: the
position embedding's bicubic resize (``align_corners=False``) is two fixed
``(out, in)`` matrices applied by products, and the gathers of the
relative-position tables (``get_rel_pos``) are products with fixed one-hot
matrices; ``F.interpolate``'s and the gather's backward passes add with
atomics.  Stochastic depth (``drop_path_rate``) is not implemented: a
non-zero rate raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ttdg_mgm_torch.models.layers import ComputeDtype, Conv2d, LayerNorm, Linear
from ttdg_mgm_torch.ops import vit_attention as attention_op


def bicubic_matrix(n_in: int, n_out: int) -> torch.Tensor:
    """``(n_out, n_in)`` float32 weights of PyTorch's bicubic resize along
    one axis (``align_corners=False``, A = -0.75, reads past the border
    clamped to it), in float64 first."""
    A = -0.75

    def near(x):        # |x| <= 1
        return ((A + 2) * x - (A + 3)) * x * x + 1

    def far(x):         # 1 < |x| < 2
        return ((A * x - 5 * A) * x + 8 * A) * x - 4 * A

    m = torch.zeros((n_out, n_in), dtype=torch.float64)
    scale = n_in / n_out
    for o in range(n_out):
        src = (o + 0.5) * scale - 0.5
        i0 = math.floor(src)
        t = src - i0
        for off, w in ((-1, far(t + 1)), (0, near(t)), (1, near(1 - t)), (2, far(2 - t))):
            m[o, min(max(i0 + off, 0), n_in - 1)] += w
    return m.float()


def rel_pos_onehot(size: int) -> torch.Tensor:
    """``(size * size, 2 size - 1)`` one-hot rows: row ``i * size + j``
    picks table row ``i - j + size - 1`` (detectron2's ``get_rel_pos`` for
    equal query and key sizes)."""
    i = torch.arange(size)[:, None]
    j = torch.arange(size)[None, :]
    idx = (i - j + size - 1).reshape(-1)
    return F.one_hot(idx, 2 * size - 1).float()


def window_partition(x, ws: int):
    """``(B, H, W, C)`` -> ``(B * nW, ws, ws, C)`` windows of the grid
    zero-padded to multiples of ``ws``, and the padded ``(Hp, Wp)``."""
    B, H, W, C = x.shape
    ph, pw = (ws - H % ws) % ws, (ws - W % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    Hp, Wp = H + ph, W + pw
    x = x.view(B, Hp // ws, ws, Wp // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C), (Hp, Wp)


def window_unpartition(windows, ws: int, pad_hw, hw):
    """The inverse of :func:`window_partition`, the padding cut off."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // ws // ws)
    x = windows.view(B, Hp // ws, Wp // ws, ws, ws, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, Hp, Wp, -1)[:, :H, :W].contiguous()


class Attention(nn.Module):
    """Multi-head attention with decomposed relative positions over an
    ``(B, H, W, C)`` grid of ``input_size`` (the tables' size); the core is
    kernel F (``ops/vit_attention.py:vit_attention``, looked up on its module
    at each call, so a tracer can wrap it)."""

    def __init__(self, dim: int, num_heads: int, input_size):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = Linear(dim, dim * 3, bias=True)
        self.proj = Linear(dim, dim)
        h, w = input_size
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * h - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * w - 1, self.head_dim))
        self.register_buffer("onehot_h", rel_pos_onehot(h), persistent=False)
        self.register_buffer("onehot_w", rel_pos_onehot(w), persistent=False)

    def forward(self, x):
        B, H, W, C = x.shape
        nh, hd = self.num_heads, self.head_dim
        qkv = self.qkv(x).reshape(B, H * W, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(B * nh, H * W, hd) for t in qkv.unbind(0))
        Rh = (self.onehot_h @ self.rel_pos_h).view(H, H, hd)
        Rw = (self.onehot_w @ self.rel_pos_w).view(W, W, hd)
        r_q = q.float().view(B * nh, H, W, hd)
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, Rh).reshape(B * nh, H * W, H)
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, Rw).reshape(B * nh, H * W, W)
        out = attention_op.vit_attention(q, k, v, rel_h, rel_w, self.scale)
        out = out.view(B, nh, H, W, hd).permute(0, 2, 3, 1, 4).reshape(B, H, W, C)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """A pre-norm transformer block, windowed when ``window_size > 0``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, window_size: int,
                 input_size):
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads,
                              (window_size, window_size) if window_size > 0 else input_size)
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
    def __init__(self, patch_size: int, in_chans: int, embed_dim: int):
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):               # NCHW -> NHWC
        return self.proj(x).permute(0, 2, 3, 1)


class ViT(ComputeDtype, nn.Module):
    """The trunk: NCHW input (a square of ``img_size``) -> ``{"last_feat":
    (B, embed_dim, img_size / patch, img_size / patch)}``.  Its
    ``compute_dtype`` (set with the model's) is the residual stream's."""

    def __init__(self, *, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, mlp_ratio: float = 4.0,
                 window_size: int = 14, window_block_indexes=(0, 1, 3, 4, 6, 7, 9, 10),
                 pretrain_img_size: int = 224,
                 drop_path_rate: float = 0.0):
        super().__init__()
        if drop_path_rate != 0.0:
            raise ValueError(f"drop_path_rate {drop_path_rate}: stochastic depth is not "
                             "implemented (MODEL.VIT.DROP_PATH_RATE must be 0.0)")
        self.patch_embed = PatchEmbed(patch_size, 3, embed_dim)
        grid = img_size // patch_size
        pre = pretrain_img_size // patch_size
        self.pos_embed = nn.Parameter(torch.zeros(1, pre * pre + 1, embed_dim))
        self.register_buffer("pos_interp", bicubic_matrix(pre, grid), persistent=False)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, mlp_ratio,
                  window_size if i in window_block_indexes else 0, (grid, grid))
            for i in range(depth))
        self.out_channels = embed_dim

    def abs_pos(self, hw):
        """The position embedding without its class token, resized to the
        ``(h, w)`` token grid: ``(1, h, w, C)`` float32."""
        pre = self.pos_interp.shape[1]
        if tuple(hw) != (self.pos_interp.shape[0],) * 2:
            raise ValueError(f"the ViT's token grid is {tuple(hw)}, built for "
                             f"{self.pos_interp.shape[0]} square (MODEL.VIT.SQUARE_PAD)")
        p = self.pos_embed[0, 1:].view(pre, pre, -1)
        m = self.pos_interp
        return torch.einsum("oi,ijc,pj->opc", m, p, m)[None]

    def forward(self, x):
        x = self.patch_embed(x)
        pos = self.abs_pos(x.shape[1:3])
        x = x + (pos if self.compute_dtype is None else pos.to(self.compute_dtype))
        for blk in self.blocks:
            x = blk(x)
        return {"last_feat": x.permute(0, 3, 1, 2)}


def init_vit_(vit: ViT, generator: torch.Generator) -> None:
    """detectron2's ViT init for the leaves the module-type rules do not
    cover: the position embedding truncated normal (std 0.02, at 2 std),
    the relative-position tables zero (``rel_pos_zero_init``)."""
    with torch.no_grad():
        p = vit.pos_embed
        p.copy_(torch.nn.init.trunc_normal_(torch.empty_like(p, device="cpu"), 0.0, 0.02,
                                            -0.04, 0.04, generator=generator))
        for blk in vit.blocks:
            blk.attn.rel_pos_h.zero_()
            blk.attn.rel_pos_w.zero_()

