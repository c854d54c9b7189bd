"""Multi-level FPN ROIAlign, plain PyTorch: the plain version of the CUDA ROI
pool and its backward (``ops/roi_pool.py``, ``csrc/roi_pool.cu``,
``csrc/roi_pool_backward.cu``).

Counterpart of ``ttdg_mgm_tpu/ops/roi_align.py``, the semantics of record of
the JAX package's windowed Pallas pooler.  d2 ``ROIAlign(aligned=True)``:
coordinates shift by half a pixel, each output bin averages a grid of
bilinear samples, samples outside ``[-1, H]`` contribute zero and in-range
coordinates clamp to the border.  ``sampling_ratio=0`` is d2's adaptive grid
(``ceil(bin)`` samples per ROI and axis) on a static budget of
``ADAPTIVE_CAP`` sample slots per bin and axis; surplus slots weigh 0.

The geometry helpers (:func:`assign_fpn_levels`, :func:`_axis_samples`,
:func:`roi_geometry`) are shared with the CUDA kernels' wrappers, so kernel
and plain version agree up to summation order.  Also here: the pool's
feature gradient (:func:`multilevel_roi_align_backward`, the plain version
of the CUDA backward kernel), each ROI's pixel footprint
(:func:`roi_footprints`, the plain version of that kernel's plan) and
:func:`mask_roi_align`, the GT-mask crop of the mask loss.
"""

from __future__ import annotations

import torch

#: static per-axis sample budget for the adaptive (``sampling_ratio=0``) grid
ADAPTIVE_CAP = 4


def _axis_samples(b0, bin_sz, P: int, n: int, cap: int = ADAPTIVE_CAP):
    """Sample positions and per-sample weights along one axis.

    b0 ``(K,)`` ROI start (shifted, level coordinates); bin_sz ``(K,)``.
    Returns ``(pos (K, P*m), w (K, P*m), m)`` with ``m = n`` (fixed grid,
    weight 1/n) or ``m = cap`` for ``n == 0`` (adaptive: ``ceil(bin)``
    samples at the exact adaptive positions, surplus slots weight 0).
    """
    m = n if n > 0 else cap
    dev = b0.device
    ar = torch.arange(P * m, dtype=torch.float32, device=dev)
    i = ar % m
    p = torch.div(ar, m, rounding_mode="floor")
    if n > 0:
        frac = ((i + 0.5) / m)[None, :]
        w = torch.full((b0.shape[0], P * m), 1.0 / m, dtype=torch.float32, device=dev)
    else:
        nd = torch.ceil(bin_sz.clamp(min=0.0)).clamp(1.0, float(m))[:, None]
        frac = (torch.minimum(i[None, :], nd - 1.0) + 0.5) / nd
        w = torch.where(i[None, :] < nd, 1.0 / nd, torch.zeros((), device=dev))
    pos = b0[:, None] + bin_sz[:, None] * (p[None, :] + frac)
    return pos, w, m


def assign_fpn_levels(rois, *, min_level: int = 2, max_level: int = 5,
                      canonical_size: float = 224.0, canonical_level: int = 4):
    """d2 ``assign_boxes_to_levels``: ``(K,)`` int level indices in
    ``[min_level, max_level]``."""
    area = (rois[:, 2] - rois[:, 0]).clamp(min=0.0) * (rois[:, 3] - rois[:, 1]).clamp(min=0.0)
    lvl = torch.floor(canonical_level + torch.log2(torch.sqrt(area) / canonical_size + 1e-8))
    return lvl.clamp(min_level, max_level).to(torch.int32)


def roi_geometry(rois, level_shapes, *, strides=(4, 8, 16, 32),
                 output_size: int = 7, sampling_ratio: int = 0, min_level: int = 2):
    """Per-ROI level and sample grid, shared by the plain pooler and the CUDA
    kernel's wrapper.

    rois ``(R, 4)`` image coordinates; level_shapes ``[(H_l, W_l)]``.
    Returns ``(level (R,) int32 in [0, L), ys (R, P*m), wy (R, P*m),
    xs (R, P*m), wx (R, P*m), m)`` in the assigned level's pixel grid.
    """
    P = output_size
    L = len(level_shapes)
    levels = assign_fpn_levels(rois, min_level=min_level,
                               max_level=min_level + L - 1) - min_level
    inv = 1.0 / torch.tensor(strides[:L], dtype=torch.float32, device=rois.device)
    scale = inv[levels.long()]
    b = rois * scale[:, None] - 0.5  # aligned=True half-pixel shift
    bin_w = (b[:, 2] - b[:, 0]) / P
    bin_h = (b[:, 3] - b[:, 1]) / P
    ys, wy, m = _axis_samples(b[:, 1], bin_h, P, sampling_ratio)
    xs, wx, _ = _axis_samples(b[:, 0], bin_w, P, sampling_ratio)
    return levels, ys, wy, xs, wx, m


def _axis_span(pos, w, size):
    """Inclusive ``(lo, hi)`` ``(R,)`` int32 span of the clamped bilinear
    corners of the samples ``pos``/``w`` ``(R, S)`` that carry weight on an
    axis of ``size`` ``(R, 1)`` pixels; ``(0, -1)`` where none does."""
    lim = size.to(torch.float32)
    ok = (w > 0) & (pos > -1.0) & (pos < lim)
    c0 = torch.floor(torch.minimum(pos.clamp(min=0.0), lim - 1))
    c1 = torch.minimum(c0 + 1, lim - 1)
    big = torch.iinfo(torch.int32).max
    lo = torch.where(ok, c0.to(torch.int32), big).amin(1)
    hi = torch.where(ok, c1.to(torch.int32), -1).amax(1)
    return torch.where(hi < 0, torch.zeros_like(lo), lo), hi


def roi_footprints(rois, level_shapes, *, strides=(4, 8, 16, 32), output_size: int = 7,
                   sampling_ratio: int = 0, min_level: int = 2):
    """Each ROI's level and inclusive pixel footprint: the plan the gather
    backward kernel (``csrc/roi_pool_backward.cu``) works from, which tiles
    of which level an ROI's gradient can reach.

    rois ``(R, 4)``; level_shapes ``[(H_l, W_l)]``.  Returns ``(level, y0,
    y1, x0, x1)``, each ``(R,)`` int32: ``[y0, y1] x [x0, x1]`` is the span
    of the bilinear corners of the samples that carry weight (so the ROI's
    gradient is zero outside it), ``y0 > y1`` or ``x0 > x1`` when no sample
    on that axis does.
    """
    levels, ys, wy, xs, wx, _ = roi_geometry(rois, level_shapes, strides=strides,
                                             output_size=output_size,
                                             sampling_ratio=sampling_ratio, min_level=min_level)
    lv = levels.long()
    Hs = torch.tensor([h for h, _ in level_shapes], device=rois.device)[lv][:, None]
    Ws = torch.tensor([w for _, w in level_shapes], device=rois.device)[lv][:, None]
    y0, y1 = _axis_span(ys, wy, Hs)
    x0, x1 = _axis_span(xs, wx, Ws)
    return levels, y0, y1, x0, x1


def _bilinear_corners(off, H, W, yy, xx):
    """The four bilinear corners of level-pixel coordinates ``yy, xx (R, S)``
    in a flattened pyramid; ``off``/``H``/``W`` ``(R, 1)`` per ROI.  Returns
    ``([row index (R*S,)] * 4, [weight (R*S, 1)] * 4, valid (R*S, 1))``:
    samples outside ``[-1, H] x [-1, W]`` are invalid, in-range coordinates
    clamp to the border."""
    Hf = H.to(torch.float32)
    Wf = W.to(torch.float32)
    valid = (yy > -1.0) & (yy < Hf) & (xx > -1.0) & (xx < Wf)
    y = torch.minimum(yy.clamp(min=0.0), Hf - 1)
    x = torch.minimum(xx.clamp(min=0.0), Wf - 1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    y1 = torch.minimum(y0 + 1, Hf - 1)
    x1 = torch.minimum(x0 + 1, Wf - 1)
    ly = (y - y0).reshape(-1, 1)
    lx = (x - x0).reshape(-1, 1)

    def idx(yi, xi):
        return (off + yi.long() * W + xi.long()).reshape(-1)

    rows = [idx(y0, x0), idx(y0, x1), idx(y1, x0), idx(y1, x1)]
    wts = [(1 - ly) * (1 - lx), (1 - ly) * lx, ly * (1 - lx), ly * lx]
    return rows, wts, valid.reshape(-1, 1)


def _pyramid_layout(level_shapes, levels, B: int, K: int, device):
    """Per-ROI ``(off, H, W)`` ``(B*K, 1, 1)`` of the assigned level in one
    flat ``(sum_l B*H_l*W_l, C)`` pyramid, and the level row counts."""
    sizes = [B * h * w for h, w in level_shapes]
    offs = torch.tensor([sum(sizes[:i]) for i in range(len(sizes))], device=device)
    Hs = torch.tensor([h for h, _ in level_shapes], device=device)
    Ws = torch.tensor([w for _, w in level_shapes], device=device)
    lv = levels.long()
    bidx = torch.arange(B * K, device=device) // K
    off = (offs[lv] + bidx * Hs[lv] * Ws[lv])[:, None, None]
    return off, Hs[lv][:, None, None], Ws[lv][:, None, None], sizes


def multilevel_roi_align(feats, rois, *, strides=(4, 8, 16, 32),
                         output_size: int = 7, sampling_ratio: int = 0,
                         min_level: int = 2):
    """FPN pooler over levels p2..p5, batched.

    feats: sequence of NHWC levels ``(B, H_l, W_l, C)``; rois ``(B, K, 4)``.
    Returns ``(B, K, P, P, C)``.  Each ROI samples its d2-assigned level only.
    """
    B, K = rois.shape[:2]
    P = output_size
    C = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    levels, ys, wy, xs, wx, m = roi_geometry(
        rois.reshape(B * K, 4), shapes, strides=strides, output_size=P,
        sampling_ratio=sampling_ratio, min_level=min_level)
    # one flat (sum_l B*H_l*W_l, C) pyramid; each bilinear corner is one row
    flat = torch.cat([f.reshape(-1, C) for f in feats], dim=0)
    off, H, W, _ = _pyramid_layout(shapes, levels, B, K, rois.device)
    S = P * m
    R = B * K
    # only the sample slots of the adaptive grid that carry weight are
    # gathered; the others stay zero in the (R*S*S, C) samples, so each bin
    # sums the same terms as over the whole grid
    swgt = (wy[:, :, None] * wx[:, None, :]).reshape(-1)
    live = torch.nonzero(swgt > 0).squeeze(1)
    roi = live // (S * S)
    sy = (live // S) % S
    sx = live % S
    rows, wts, valid = _bilinear_corners(off.reshape(R)[roi], H.reshape(R)[roi],
                                         W.reshape(R)[roi], ys[roi, sy], xs[roi, sx])
    v = sum(flat[r] * w for r, w in zip(rows, wts))
    v = torch.where(valid, v, v.new_zeros(()))
    samples = flat.new_zeros((R * S * S, C))
    samples[live] = v * swgt[live, None]
    out = samples.reshape(R, P, m, P, m, C).sum(dim=(2, 4))
    return out.reshape(B, K, P, P, C)


def multilevel_roi_align_backward(grad, level_shapes, rois, *, strides=(4, 8, 16, 32),
                                  sampling_ratio: int = 0, min_level: int = 2):
    """Feature gradient of :func:`multilevel_roi_align`: the plain version of
    the CUDA backward kernel (``csrc/roi_pool_backward.cu``).

    grad ``(B, K, P, P, C)`` cotangent of the pool; level_shapes
    ``[(H_l, W_l)]``; rois ``(B, K, 4)``.  Returns ``[(B, H_l, W_l, C)]``:
    each valid sample's bilinear-weighted cotangent ``index_add_``-ed into
    its four corners.  No gradient reaches the ROIs.
    """
    B, K, P = rois.shape[0], rois.shape[1], grad.shape[2]
    C = grad.shape[-1]
    levels, ys, wy, xs, wx, m = roi_geometry(
        rois.reshape(B * K, 4), level_shapes, strides=strides, output_size=P,
        sampling_ratio=sampling_ratio, min_level=min_level)
    off, H, W, sizes = _pyramid_layout(level_shapes, levels, B, K, rois.device)
    S = P * m
    yy = ys[:, :, None].expand(B * K, S, S)
    xx = xs[:, None, :].expand(B * K, S, S)
    rows, wts, valid = _bilinear_corners(off, H, W, yy, xx)
    swgt = (wy[:, :, None] * wx[:, None, :]).reshape(-1, 1)
    g = grad.reshape(B * K, P, 1, P, 1, C).expand(B * K, P, m, P, m, C).reshape(-1, C)
    g = torch.where(valid, g * swgt, g.new_zeros(()))
    flat = grad.new_zeros((sum(sizes), C))
    for r, w in zip(rows, wts):
        flat.index_add_(0, r, g * w)
    parts = torch.split(flat, sizes, dim=0)
    return [t.reshape(B, h, w, C) for t, (h, w) in zip(parts, level_shapes)]


def _interp_matrix(coords, weights, size: int, n: int):
    """Per-ROI separable bilinear interpolation matrix.

    coords ``(S, P*n)`` sample positions along one axis of a ``size``-wide
    canvas, weights ``(S, P*n)`` per-sample bin-average weights (from
    :func:`_axis_samples`); returns ``(S, P, size)`` where row ``p`` holds
    the weighted bilinear weights of that output bin's ``n`` sample slots.
    Out-of-range samples (``[-1, size]`` exclusion) get all-zero weights;
    in-range coordinates clamp to the border."""
    valid = (coords > -1.0) & (coords < size)
    c = coords.clamp(0.0, size - 1)
    c0 = torch.floor(c)
    c1 = torch.minimum(c0 + 1, torch.full((), size - 1.0, device=c.device))
    frac = c - c0
    iota = torch.arange(size, dtype=torch.float32, device=c.device)
    m = ((iota == c0[..., None]) * (1.0 - frac)[..., None]
         + (iota == c1[..., None]) * frac[..., None])  # (S, P*n, size)
    m = torch.where(valid[..., None], m * weights[..., None], m.new_zeros(()))
    s, pn, _ = m.shape
    return m.reshape(s, pn // n, n, size).sum(dim=2)


def mask_roi_align(masks, rois, *, output_size: int = 28, sampling_ratio: int = 2):
    """ROIAlign (``aligned=True``) on single-channel canvases as two batched
    products.

    masks ``(S, H, W)`` float; rois ``(S, 4)`` xyxy in canvas coordinates
    (one box per mask).  Returns ``(S, output_size, output_size)``: the
    sampling of :func:`multilevel_roi_align` with ``C = 1``, computed as
    ``Ry @ M @ Cx^T`` with per-ROI separable interpolation matrices
    (``ttdg_mgm_tpu/ops/roi_align.py:mask_roi_align``)."""
    H, W = masks.shape[-2:]
    P = output_size
    b = rois - 0.5
    bin_w = (b[:, 2] - b[:, 0]) / P
    bin_h = (b[:, 3] - b[:, 1]) / P
    ys, wy, m = _axis_samples(b[:, 1], bin_h, P, sampling_ratio)
    xs, wx, _ = _axis_samples(b[:, 0], bin_w, P, sampling_ratio)
    ry = _interp_matrix(ys, wy, H, m)  # (S, P, H)
    cx = _interp_matrix(xs, wx, W, m)  # (S, P, W)
    return torch.matmul(torch.matmul(ry, masks.to(ry.dtype)), cx.transpose(1, 2))
