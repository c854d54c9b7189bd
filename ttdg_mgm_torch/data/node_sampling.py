"""Host-side point samplers of binary masks (graph-node seeding from
masks), in NumPy.

Counterpart of ``ttdg_mgm_tpu/data/node_sampling.py``: points spaced
along the outer boundary (optionally moved inwards), on a regular interior
grid, and on a ring around the centroid.  The boundary comes from
:func:`find_external_contours`, this module's own copy of what
``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_NONE)`` returns, point
for point and in OpenCV's order (the JAX package stacks OpenCV's contours,
so the samples index into that order).  It is Suzuki and Abe's border
following as OpenCV's ``contours.cpp`` runs it on an 8-bit image:

* the mask (nonzero is 1) is padded by one pixel of 0, so the image frame
  is inside the traced region and the points come back in image
  coordinates;
* a raster scan (row by row, left to right) starts an outer border at a
  pixel of 1 after a 0, unless the last border pixel met on that row holds
  a positive mark (it lies inside a traced outer border: with
  ``RETR_EXTERNAL`` only borders not nested in another component's hole
  are kept, and holes are never traced);
* from the start it looks for the first nonzero neighbour clockwise from
  the left neighbour (none: a single pixel), then follows the border
  counter-clockwise (down the left side first), searching each next pixel
  counter-clockwise from the one after the pixel it came from, writing
  every pixel it stands on, until it is back at the start about to repeat
  its first move;
* it marks each border pixel as it goes: ``-126`` where its right
  neighbour was searched and found 0, else ``2`` if it was still ``1``;
* OpenCV returns the contours in the reverse of the order it found them.
"""

from __future__ import annotations

import numpy as np

from ttdg_mgm_torch.utils.rle import polygons_to_mask

#: OpenCV's chain directions 0-7: right, up-right, up, up-left, left,
#: down-left, down, down-right, as (dx, dy)
_DX = (1, 1, 0, -1, -1, -1, 0, 1)
_DY = (0, -1, -1, -1, 0, 1, 1, 1)
_RIGHT_BOUND = -126  # 2 | -128 as int8
_VISITED = 2


def _follow(img: np.ndarray, x0: int, y0: int) -> list:
    """Trace the outer border starting at ``(x0, y0)`` of the padded int8
    image ``img``, marking it; returns its points (padded coordinates)."""
    s = s_end = 4
    while True:
        s = (s - 1) & 7
        x1, y1 = x0 + _DX[s], y0 + _DY[s]
        if img[y1, x1] != 0 or s == s_end:
            break
    if s == s_end:  # a single pixel
        img[y0, x0] = _RIGHT_BOUND
        return [(x0, y0)]
    pts = []
    x3, y3 = x0, y0
    while True:
        s_end = s
        while s < 15:
            s += 1
            x4, y4 = x3 + _DX[s & 7], y3 + _DY[s & 7]
            if img[y4, x4] != 0:
                break
        s &= 7
        if 1 <= s <= s_end:  # the right neighbour was searched: a right bound
            img[y3, x3] = _RIGHT_BOUND
        elif img[y3, x3] == 1:
            img[y3, x3] = _VISITED
        pts.append((x3, y3))
        if x4 == x0 and y4 == y0 and x3 == x1 and y3 == y1:
            return pts
        x3, y3 = x4, y4
        s = (s + 4) & 7


def find_external_contours(mask: np.ndarray) -> list:
    """The outer borders of the nonzero regions of the 2-D ``mask`` not
    nested in another region's hole: a list of ``(N, 2)`` int64 ``(x, y)``
    arrays, as ``cv2.findContours(mask, cv2.RETR_EXTERNAL,
    cv2.CHAIN_APPROX_NONE)`` gives them."""
    h, w = mask.shape
    img = np.zeros((h + 2, w + 2), np.int8)
    img[1:-1, 1:-1] = np.asarray(mask) != 0
    found = []
    for y in np.flatnonzero(img.any(axis=1)):
        y = int(y)
        row = img[y]
        x, prev, lnbd = 1, 0, 0
        while x < w + 1:
            rest = np.flatnonzero(row[x:w + 1] != prev)
            if rest.size == 0:
                break
            x += int(rest[0])
            p = int(row[x])
            start = prev == 0 and p == 1
            if start and row[lnbd] <= 0:
                found.append(_follow(img, x, y))
                prev = int(row[x])  # the start pixel's new mark
                x += 1
                continue
            if not start and p == 0 and prev >= 1 and prev & -2:
                lnbd = x - 1  # a hole's border (not traced)
            prev = p
            if prev & -2:
                lnbd = x
            x += 1
    return [np.asarray(c, np.int64).reshape(-1, 2) - 1 for c in reversed(found)]


def boundary_points(mask: np.ndarray) -> np.ndarray:
    """Ordered ``(x, y)`` int64 points ``(N, 2)`` on the outer boundary of a
    binary mask (every external contour, in OpenCV's order); ``(0, 2)``
    for an empty mask."""
    mask = np.ascontiguousarray(np.asarray(mask).astype(np.uint8))
    if not mask.any():
        return np.zeros((0, 2), np.int64)
    contours = find_external_contours(mask)
    if not contours:
        return np.zeros((0, 2), np.int64)
    return np.vstack(contours).astype(np.int64)


def sample_boundary(mask: np.ndarray, num_samples: int = 10, inward_offset: float = 0.0,
                    uniform: bool = True, rng: np.random.Generator | None = None) -> list:
    """Points on (or just inside) the mask boundary: ``uniform`` spaces them
    evenly along the boundary's order, else they are drawn without
    replacement from ``rng``; ``inward_offset`` moves each towards the
    image centre by that many pixels."""
    pts = boundary_points(mask)
    if len(pts) == 0:
        return []
    h, w = mask.shape
    pts = pts.astype(np.float64)
    if inward_offset:
        center = np.asarray([w // 2, h // 2], np.float64)
        d = pts - center
        norm = np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-12)
        pts = pts - inward_offset * d / norm
        pts = np.clip(pts, 0, [w - 1, h - 1])
    if uniform:
        idx = np.linspace(0, len(pts) - 1, num_samples).astype(np.int64)
    else:
        rng = rng or np.random.default_rng()
        idx = rng.choice(len(pts), size=min(num_samples, len(pts)), replace=False)
    return [(int(x), int(y)) for x, y in pts[idx]]


def sample_grid(mask: np.ndarray, grid_size: int = 20) -> list:
    """The lattice points of step ``grid_size`` that fall inside the mask."""
    h, w = mask.shape
    gx, gy = np.meshgrid(np.arange(0, w, grid_size), np.arange(0, h, grid_size))
    gx, gy = gx.ravel(), gy.ravel()
    inside = mask[gy, gx].astype(bool)
    return [(int(x), int(y)) for x, y in zip(gx[inside], gy[inside])]


def sample_centroid_ring(mask: np.ndarray, num_samples: int = 10, radius: float = 10.0) -> list:
    """Points on a ring of ``radius`` around the mask's centroid, kept where
    they land inside the image and the mask."""
    m = mask.astype(np.float64)
    total = m.sum()
    if total == 0:
        return []
    ys, xs = np.nonzero(m)
    cx = float((xs * m[ys, xs]).sum() / total)
    cy = float((ys * m[ys, xs]).sum() / total)
    h, w = mask.shape
    out = []
    for i in range(num_samples):
        ang = 2.0 * np.pi * i / num_samples
        x = int(cx + radius * np.cos(ang))
        y = int(cy + radius * np.sin(ang))
        if 0 <= x < w and 0 <= y < h and mask[y, x]:
            out.append((x, y))
    return out


def sample_polygon_instances(polygon_masks, image_height: int, image_width: int,
                             num_boundary: int = 10, num_centroid: int = 5,
                             centroid_radius: float = 10.0):
    """Boundary and centroid-ring samples of each polygon instance (its
    rings rasterised by ``utils/rle.py:polygons_to_mask``); returns
    ``(boundary_samples, centroid_samples)``, flat lists of ``(x, y)``."""
    all_boundary, all_centroid = [], []
    for polys in polygon_masks:
        m = polygons_to_mask(polys, image_height, image_width)
        all_boundary.extend(sample_boundary(m, num_samples=num_boundary))
        all_centroid.extend(sample_centroid_ring(m, num_samples=num_centroid,
                                                 radius=centroid_radius))
    return all_boundary, all_centroid
