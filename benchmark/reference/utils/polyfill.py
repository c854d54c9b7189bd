"""OpenCV's ``fillPoly`` in NumPy, bit for bit.

``fill_poly(mask, rings, value)`` equals ``cv2.fillPoly(mask, rings, value)``
with the default line type (8-connected) and no shift, on a 2-D uint8
``mask`` and int32 ``(n, 2)`` rings of ``(x, y)`` vertices.  It follows
OpenCV's ``imgproc/src/drawing.cpp``:

* every ring's edges are drawn as 8-connected Bresenham lines
  (``LineIterator`` from left to right, clipped to the canvas by
  ``clipLine``), horizontal edges included;
* every non-horizontal edge of every ring goes into one edge table, live
  on the scanlines ``[y0, y1)``, its x at ``y0`` in 16.16 fixed point and
  its step per scanline ``dx = (x1 - x0) / (y1 - y0)`` truncated toward
  zero, from the vertices themselves (no half-pixel offset); an edge that
  leaves the canvas takes its end points from ``clipLine``, and one that
  ``clipLine`` shrinks to a single row keeps its own rows with the clipped
  x (so an edge that only touches the canvas holds its fill on the
  border column);
* on each scanline the live edges' x, sorted, are taken in pairs, and the
  pixels whose centres lie in each pair's closed span are set: from
  ``ceil(x_a)`` to ``floor(x_b)``, clipped to the canvas, when the span
  meets it.

So several rings in one call are filled by the even-odd rule over all of
their edges together: where two rings overlap, the overlap is a hole (its
outline drawn), and a ring inside another cuts a hole.  These rules were
found by holding the function against OpenCV 5.0.0 on random rings
(convex, concave, self-touching, overlapping, off the canvas).
"""

from __future__ import annotations

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT


def _trunc_div(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def clip_line(w: int, h: int, p1, p2):
    """OpenCV's ``clipLine(Size, pt1, pt2)``: ``(inside, p1, p2)`` with the
    end points moved onto the canvas as OpenCV moves them (also when the
    line misses it)."""
    x1, y1 = p1
    x2, y2 = p2
    right, bottom = w - 1, h - 1
    if w <= 0 or h <= 0:
        return False, (x1, y1), (x2, y2)

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _outside(w: int, h: int, p) -> bool:
    return not (0 <= p[0] < w and 0 <= p[1] < h)


def line_points(w: int, h: int, p1, p2):
    """The pixels of OpenCV's 8-connected ``Line(img, p1, p2)``: ``(xs,
    ys)`` int64 arrays, on the canvas."""
    if _outside(w, h, p1) or _outside(w, h, p2):
        ok, p1, p2 = clip_line(w, h, p1, p2)
        if not ok:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
    (x1, y1), (x2, y2) = p1, p2
    if x2 < x1:  # left to right
        (x1, y1), (x2, y2) = (x2, y2), (x1, y1)
    dx, dy = x2 - x1, y2 - y1
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    dmaj, dmin = (dy, dx) if vert else (dx, dy)
    i = np.arange(dmaj + 1, dtype=np.int64)
    # Bresenham from err = dmaj - 2 dmin: the minor axis has moved k_i =
    # floor((2 dmin i + dmaj - 1) / (2 dmaj)) steps after i major steps
    k = (2 * dmin * i + dmaj - 1) // (2 * dmaj) if dmaj else np.zeros_like(i)
    if vert:
        return x1 + k, y1 + sy * i
    return x1 + i, y1 + sy * k


def _edge(w: int, h: int, p0, p1):
    """The fill's edge of ``p0 -> p1`` (OpenCV's ``CollectPolyEdges``):
    ``(y0, y1, x, dx)`` with ``x`` at scanline ``y0`` in 16.16 fixed point,
    or None for a horizontal edge."""
    if p0[1] == p1[1]:
        return None
    c0 = [p0[0] << XY_SHIFT, p0[1]]
    c1 = [p1[0] << XY_SHIFT, p1[1]]
    if _outside(w, h, p0) or _outside(w, h, p1):
        _, t0, t1 = clip_line(w, h, p0, p1)
        if t0[1] != t1[1]:
            c0 = [t0[0] << XY_SHIFT, t0[1]]
            c1 = [t1[0] << XY_SHIFT, t1[1]]
        else:  # clipped to one row: the clipped x over the edge's own rows
            c0 = [t0[0] << XY_SHIFT, p0[1]]
            c1 = [t1[0] << XY_SHIFT, p1[1]]
    dx = _trunc_div(c1[0] - c0[0], c1[1] - c0[1])
    if p0[1] < p1[1]:
        return p0[1], p1[1], c0[0] + (p0[1] - c0[1]) * dx, dx
    return p1[1], p0[1], c1[0] + (p1[1] - c1[1]) * dx, dx


def fill_poly(mask: np.ndarray, rings, value: int = 1) -> np.ndarray:
    """Fill ``rings`` (each an int ``(n, 2)`` array of ``(x, y)``) into the
    2-D uint8 ``mask`` in place, as ``cv2.fillPoly(mask, rings, value)``;
    returns ``mask``."""
    h, w = mask.shape
    edges = []
    for ring in rings:
        pts = [(int(x), int(y)) for x, y in np.asarray(ring).reshape(-1, 2)]
        prev = pts[-1]
        for cur in pts:
            xs, ys = line_points(w, h, prev, cur)
            mask[ys, xs] = value
            e = _edge(w, h, prev, cur)
            if e is not None:
                edges.append(e)
            prev = cur
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    y0, y1, x0, dx = e.T
    x_end = x0 + (y1 - y0) * dx
    if (y1.max() < 0 or y0.min() >= h or max(x0.max(), x_end.max()) < 0
            or min(x0.min(), x_end.min()) >= (w << XY_SHIFT)):
        return mask
    lo, hi = max(int(y0.min()), 0), min(int(y1.max()), h)
    if lo >= hi:
        return mask
    ys = np.arange(lo, hi, dtype=np.int64)[:, None]
    live = (ys >= y0) & (ys < y1)
    big = np.iinfo(np.int64).max
    x = np.where(live, x0 + (ys - y0) * dx, big)
    x = np.sort(x, axis=1)
    n = live.sum(axis=1)
    left, right = x[:, 0::2], x[:, 1::2]
    pairs = np.arange(left.shape[1])[None, :] < (n[:, None] // 2)
    if right.shape[1] < left.shape[1]:
        right = np.concatenate([right, np.full((right.shape[0], 1), big)], axis=1)
    xa = (np.minimum(left, right) + XY_ONE - 1) >> XY_SHIFT
    xb = np.maximum(left, right) >> XY_SHIFT
    ok = pairs & (xa < w) & (xb >= 0)
    xa = np.clip(xa, 0, w - 1)
    xb = np.clip(xb, 0, w - 1)
    row = np.broadcast_to(np.arange(hi - lo)[:, None], ok.shape)
    diff = np.zeros((hi - lo, w + 1), np.int32)
    np.add.at(diff, (row[ok], xa[ok]), 1)
    np.add.at(diff, (row[ok], xb[ok] + 1), -1)
    span = np.cumsum(diff[:, :w], axis=1) > 0
    mask[lo:hi][span] = value
    return mask
