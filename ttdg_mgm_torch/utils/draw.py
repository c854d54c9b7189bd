"""The rasterizers the visualizer needs, in NumPy: OpenCV's rectangle and a
bitmap label font.

:func:`rectangle` equals ``cv2.rectangle(img, p1, p2, color, thickness)``
of OpenCV 5.0.0 with the default 8-connected line type, for thickness 1
and 2, pixel for pixel, clipped at the image's edges, with the corners in
either order and for boxes of zero width or height.  OpenCV draws the
rectangle as a closed polyline of its four sides (``drawing.cpp:PolyLine``),
each side a ``ThickLine``:

* thickness 1: the side's 8-connected line (``utils/polyfill.py:line_points``);
* thickness ``t > 1``: the convex quad ``p0 +- dp, p1 -+ dp`` with ``dp`` the
  side's normal of length ``(t + (t & 1)) / 2`` in 16.16 fixed point, filled,
  then a round cap (a filled ``Circle`` of radius ``(t + 1) // 2``) at the
  side's end point, so once at every corner.  A side of zero length has no
  quad, only its cap.

A rectangle's sides are axis-aligned, so ``dp`` is a whole number of pixels
and each quad is an integer rectangle; OpenCV's ``fillPoly`` rule
(``utils/polyfill.py:fill_poly``) fills such a quad exactly as its
``FillConvexPoly`` does.  At thickness 2 each side becomes a band 3 pixels
wide centred on it, and the plus-shaped caps of radius 1 leave each outer
corner pixel unset.

:func:`put_label` is not OpenCV's ``putText``: OpenCV 5's ``putText``
draws anti-aliased TrueType glyphs, a font the port cannot carry.  The
label is drawn in one colour, without anti-aliasing, from :data:`FONT_5X7`,
the classic 5 x 7 dot-matrix font of printable ASCII (lower-case
descenders raised into the cell, so every glyph sits on the baseline),
each glyph stretched to 6 x 10 pixels (rows ``GLYPH_ROWS``, columns
``GLYPH_COLS`` of the 5 x 7 cell), for a cap height of 10 pixels, the
height ``FONT_HERSHEY_SIMPLEX`` has at scale 0.5.  As in ``putText``,
``org`` is the bottom-left corner of the text: the glyphs' bottom row is
``org``'s row.
"""

from __future__ import annotations

import numpy as np

from ttdg_mgm_torch.utils.polyfill import fill_poly, line_points

#: printable ASCII from ``" "`` (0x20) to ``"~"`` (0x7e): five column bytes
#: per glyph, bit 0 the top row and bit 6 the baseline row
FONT_5X7 = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462"
    "3649552250" "0005030000" "001c224100" "0041221c00" "14083e0814" "08083e0808"
    "0050300000" "0808080808" "0060600000" "2010080402" "3e5149453e" "00427f4000"
    "4261514946" "2141454b31" "1814127f10" "2745454539" "3c4a494930" "0171090503"
    "3649494936" "064949291e" "0036360000" "0056360000" "0814224100" "1414141414"
    "0041221408" "0201510906" "3249794136" "7e1111117e" "7f49494936" "3e41414122"
    "7f4141221c" "7f49494941" "7f09090901" "3e4149497a" "7f0808087f" "00417f4100"
    "2040413f01" "7f08142241" "7f40404040" "7f020c027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "4649494931" "01017f0101" "3f4040403f"
    "1f2040201f" "3f4038403f" "6314081463" "0708700807" "6151494543" "007f414100"
    "0204081020" "0041417f00" "0402010204" "4040404040" "0001020400" "2054545478"
    "7f48444438" "3844444420" "384444487f" "3854545418" "087e090102" "0c5252523e"
    "7f08040478" "00447d4000" "2040443d00" "7f10284400" "00417f4000" "7c04180478"
    "7c08040478" "3844444438" "7c14141408" "081414187c" "7c08040408" "4854545420"
    "043f444020" "3c4040207c" "1c2040201c" "3c4030403c" "4428102844" "0c5050503c"
    "4464544c44" "0008364100" "00007f0000" "0041360800" "0804081008")
#: the 5 x 7 cell's row and column under each pixel row and column of a drawn glyph
GLYPH_ROWS = (0, 1, 1, 2, 3, 3, 4, 5, 5, 6)
GLYPH_COLS = (0, 1, 2, 2, 3, 4)
CAP_HEIGHT = len(GLYPH_ROWS)
#: pixels from one glyph's left edge to the next's
ADVANCE = len(GLYPH_COLS) + 1


def _glyph(ch: str) -> np.ndarray:
    """The ``(CAP_HEIGHT, len(GLYPH_COLS))`` bool bitmap of ``ch``; a
    character outside printable ASCII is drawn as ``?``."""
    code = ord(ch)
    if not 0x20 <= code <= 0x7e:
        code = ord("?")
    cols = FONT_5X7[(code - 0x20) * 5:(code - 0x1f) * 5]
    cell = np.array([[(c >> r) & 1 for c in cols] for r in range(7)], bool)
    return cell[np.ix_(GLYPH_ROWS, GLYPH_COLS)]


def label_box(text: str, org):
    """``(x0, y0, x1, y1)``, inclusive: the band :func:`put_label` draws
    ``text`` in, from ``org`` up by :data:`CAP_HEIGHT` rows and right by
    ``len(text)`` advances."""
    x, y = int(org[0]), int(org[1])
    return x, y - CAP_HEIGHT + 1, x + ADVANCE * len(text) - 1, y


def put_label(img: np.ndarray, text: str, org, color) -> np.ndarray:
    """Draw ``text`` into ``img`` (``(H, W)`` or ``(H, W, C)``) in place in
    the one colour ``color``, its bottom-left corner at ``org`` ``(x, y)``,
    clipped to the image; returns ``img``."""
    h, w = img.shape[:2]
    x0, y0, _, _ = label_box(text, org)
    for i, ch in enumerate(text):
        ys, xs = np.nonzero(_glyph(ch))
        ys, xs = ys + y0, xs + x0 + i * ADVANCE
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color
    return img


def circle(img: np.ndarray, center, radius: int, color) -> None:
    """OpenCV's filled ``Circle`` (``drawing.cpp``, ``fill = 1``): the
    midpoint circle's spans, clipped to the image."""
    h, w = img.shape[:2]
    cx, cy = center
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, xa, xb in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                          (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= y < h and xa < w and xb >= 0:
                img[y, max(xa, 0):min(xb, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _side(img: np.ndarray, p0, p1, color, thickness: int) -> None:
    """One side of a rectangle as OpenCV's ``ThickLine`` with the end cap
    only (``PolyLine``'s flags for a closed polyline)."""
    h, w = img.shape[:2]
    if thickness <= 1:
        xs, ys = line_points(w, h, p0, p1)
        img[ys, xs] = color
        return
    # |dp| = ((t << 15) + (t & 1) * 2**15) / 2**16 pixels on an axis-aligned side
    half = (thickness + (thickness & 1)) >> 1
    if p0 != p1:
        if p0[1] == p1[1]:
            ring = [(p0[0], p0[1] - half), (p0[0], p0[1] + half),
                    (p1[0], p1[1] + half), (p1[0], p1[1] - half)]
        else:
            ring = [(p0[0] - half, p0[1]), (p0[0] + half, p0[1]),
                    (p1[0] + half, p1[1]), (p1[0] - half, p1[1])]
        xs = [p[0] for p in ring]
        ys = [p[1] for p in ring]
        # fill in a window of the quad's extent on the image (the quad's
        # pixels off the image are clipped either way)
        wx0, wx1 = max(min(xs), 0), min(max(xs), w - 1)
        wy0, wy1 = max(min(ys), 0), min(max(ys), h - 1)
        if wx0 <= wx1 and wy0 <= wy1:
            win = np.zeros((wy1 - wy0 + 1, wx1 - wx0 + 1), np.uint8)
            fill_poly(win, [np.asarray([(x - wx0, y - wy0) for x, y in ring], np.int64)])
            iy, ix = np.nonzero(win)
            img[iy + wy0, ix + wx0] = color
    circle(img, p1, (thickness + 1) >> 1, color)


def rectangle(img: np.ndarray, p1, p2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle(img, p1, p2, color, thickness)`` in place on an
    ``(H, W)`` or ``(H, W, C)`` uint8 image, corners ``(x, y)`` in whole
    pixels; returns ``img``."""
    if thickness < 1:
        raise ValueError(f"rectangle draws outlines of thickness >= 1, got {thickness}")
    (x1, y1), (x2, y2) = (int(p1[0]), int(p1[1])), (int(p2[0]), int(p2[1]))
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    color = np.asarray(color, img.dtype)
    prev = pts[-1]
    for cur in pts:
        _side(img, prev, cur, color, thickness)
        prev = cur
    return img
