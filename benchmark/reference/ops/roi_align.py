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


def _axis_taps(pos, w, size, P: int, m: int):
    """One axis of the separable pool as taps: each bin's distinct pixels
    with their summed weights, as the CUDA kernels build them
    (``csrc/roi_pool.cu``, ``csrc/roi_pool_backward.cu``).

    pos, w ``(R, P*m)`` samples (:func:`roi_geometry`), size ``(R, 1)`` the
    axis's pixel count.  Each sample puts ``w * (1 - frac)`` on its lower
    clamped corner and ``w * frac`` on its upper one (zero when out of
    range); a pixel's weight in a bin is the sum of its terms in sample
    order, each product and sum rounded to float32, then the sum rounded to
    bfloat16 (the TPU kernel's ``ry``/``cx`` cast to the feature dtype).
    Returns ``(pix (R, P, 2m) int64, wt (R, P, 2m) float32)``: the corners
    in sample order, the last entry of each pixel carrying its bf16-valued
    sum and the others 0."""
    R = pos.shape[0]
    lim = size.to(torch.float32)
    valid = (pos > -1.0) & (pos < lim)
    c = torch.minimum(pos.clamp(min=0.0), lim - 1)
    c0 = torch.floor(c)
    c1 = torch.minimum(c0 + 1, lim - 1)
    frac = c - c0
    wv = torch.where(valid, w, torch.zeros((), device=pos.device))
    pix = torch.stack([c0, c1], dim=-1).reshape(R, P, 2 * m).long()
    terms = torch.stack([wv * (1.0 - frac), wv * frac], dim=-1).reshape(R, P, 2 * m)
    zero = torch.zeros_like(terms[..., 0])
    sums = torch.zeros_like(terms)
    for k in range(2 * m):
        # the pixel's terms in sample order, the sum kept on its last entry
        acc = zero
        last = torch.ones_like(valid[:, :P])
        for j in range(2 * m):
            same = pix[..., j] == pix[..., k]
            acc = acc + torch.where(same, terms[..., j], zero)
            if j > k:
                last = last & ~same
        sums[..., k] = torch.where(last, acc, zero)
    return pix, sums.to(torch.bfloat16).to(torch.float32)


def _tap_pairs(rois, level_shapes, strides, P: int, sampling_ratio: int, min_level: int,
               B: int, K: int):
    """The nonzero terms of the bf16 pool, ``out[r, p, q] = sum_ij wy[r, p,
    i] * wx[r, q, j] * f[l_r][y_i, x_j]`` over bf16-rounded tap weights:
    ``(row into the flat pyramid, output row r*P*P + p*P + q, weight)``,
    each ``(N,)``, and the level row counts."""
    levels, ys, wy, xs, wx, m = roi_geometry(
        rois.reshape(B * K, 4), level_shapes, strides=strides, output_size=P,
        sampling_ratio=sampling_ratio, min_level=min_level)
    off, H, W, sizes = _pyramid_layout(level_shapes, levels, B, K, rois.device)
    R = B * K
    py, ty = _axis_taps(ys, wy, H.reshape(R, 1), P, m)
    px, tx = _axis_taps(xs, wx, W.reshape(R, 1), P, m)
    T = 2 * m
    wgt = ty[:, :, None, :, None] * tx[:, None, :, None, :]  # (R, P, P, T, T), exact
    live = torch.nonzero(wgt.reshape(-1) != 0).squeeze(1)
    r = live // (P * P * T * T)
    p = (live // (P * T * T)) % P
    q = (live // (T * T)) % P
    i = (live // T) % T
    j = live % T
    rows = off.reshape(R)[r] + py[r, p, i] * W.reshape(R)[r] + px[r, q, j]
    return rows, (r * P + p) * P + q, wgt.reshape(-1)[live], sizes


def multilevel_roi_align_bf16(feats, rois, *, strides=(4, 8, 16, 32), output_size: int = 7,
                              sampling_ratio: int = 0, min_level: int = 2):
    """The pool on bfloat16 levels, with the TPU kernel's bf16 semantics
    (``ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py:_pool_kernel``): each
    bin's per-axis interpolation weights summed in float32 and rounded to
    bfloat16, the contraction accumulated in float32, the output rounded to
    bfloat16 once.  The plain version of the bf16 variant of
    ``csrc/roi_pool.cu``.  feats ``[(B, H_l, W_l, C)]`` bfloat16, rois
    ``(B, K, 4)`` float32 -> ``(B, K, P, P, C)`` bfloat16."""
    B, K = rois.shape[:2]
    P = output_size
    C = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    rows, outs, wgt, _ = _tap_pairs(rois, shapes, strides, P, sampling_ratio, min_level, B, K)
    flat = torch.cat([f.reshape(-1, C) for f in feats], dim=0)
    out = torch.zeros((B * K * P * P, C), dtype=torch.float32, device=rois.device)
    out.index_add_(0, outs, flat[rows].to(torch.float32) * wgt[:, None])
    return out.to(torch.bfloat16).reshape(B, K, P, P, C)


def multilevel_roi_align_backward_bf16(grad, level_shapes, rois, *, strides=(4, 8, 16, 32),
                                       sampling_ratio: int = 0, min_level: int = 2):
    """Feature gradient of :func:`multilevel_roi_align_bf16`: grad ``(B, K, P,
    P, C)`` bfloat16 -> ``[(B, H_l, W_l, C)]`` bfloat16, every element the
    float32 sum of its terms (the bf16-rounded tap weights times the
    cotangent) rounded to bfloat16 once.  The plain version of the bf16
    variant of ``csrc/roi_pool_backward.cu``."""
    B, K, P = rois.shape[0], rois.shape[1], grad.shape[2]
    C = grad.shape[-1]
    shapes = [tuple(s) for s in level_shapes]
    rows, outs, wgt, sizes = _tap_pairs(rois, shapes, strides, P, sampling_ratio, min_level,
                                        B, K)
    g = grad.reshape(-1, C)
    flat = torch.zeros((sum(sizes), C), dtype=torch.float32, device=grad.device)
    flat.index_add_(0, rows, g[outs].to(torch.float32) * wgt[:, None])
    parts = torch.split(flat.to(torch.bfloat16), sizes, dim=0)
    return [t.reshape(B, h, w, C) for t, (h, w) in zip(parts, shapes)]


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
