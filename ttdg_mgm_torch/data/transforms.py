"""Host-side geometry transforms of the loaders: d2 ``ResizeShortestEdge``
(bilinear) and the horizontal flip, with boxes and polygons following.

This package's own copy of the geometry of ``ttdg_mgm_tpu/data/transforms.py``.
Two differences, both on inputs where the result stays the same or the JAX
package raises:

* :func:`resize_shortest_edge` resizes with ``data/resample.py``, which
  equals the JAX package's Pillow ``Image.resize(..., BILINEAR)`` bit for
  bit, and returns the image itself when the target size equals its size
  (Pillow returns an equal copy);
* RLE segmentations (dicts) pass through :func:`scale_annotations`
  unchanged, since they stay in the original image's coordinates and are
  decoded there; the JAX package's ``scale_annotations`` iterates the dict's
  keys as polygon rings and raises ``ValueError`` (``ROADMAP.md`` Queue 3).
  :func:`hflip` passes them through unchanged too (the JAX package's takes
  polygons only); the sample's ``"flipped"`` flag then tells
  ``data/loader.py:pack_batch`` to mirror the mask it resizes from the RLE
  within its valid width, as the image was mirrored after its resize.

The strong augmentation of the mean-teacher loader is not ported.
"""

from __future__ import annotations

import numpy as np

from ttdg_mgm_torch.data.resample import resize_bilinear


def resize_shortest_edge_size(h: int, w: int, short: int, max_size: int):
    """d2 ResizeShortestEdge target ``(newh, neww)``, with d2's arithmetic
    (``get_output_shape``): the short side is exactly ``short`` and rounding
    is half-up ``int(x + 0.5)``."""
    scale = short / min(h, w)
    if h < w:
        newh, neww = short, scale * w
    else:
        newh, neww = scale * h, short
    if max(newh, neww) > max_size:
        s2 = max_size / max(newh, neww)
        newh, neww = newh * s2, neww * s2
    return int(newh + 0.5), int(neww + 0.5)


def resize_shortest_edge(img: np.ndarray, short: int, max_size: int):
    """d2 ResizeShortestEdge (bilinear).  Returns ``(resized, (sy, sx))``."""
    h, w = img.shape[:2]
    nh, nw = resize_shortest_edge_size(h, w, short, max_size)
    if (nh, nw) == (h, w):
        return img, (1.0, 1.0)
    return resize_bilinear(img, (nh, nw)), (nh / h, nw / w)


def hflip(img, boxes, polygons):
    w = img.shape[1]
    img = img[:, ::-1]
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x1
    flipped = []
    for segs in polygons:
        if isinstance(segs, dict):
            flipped.append(segs)
            continue
        out = []
        for p in segs or []:
            p = np.asarray(p, np.float64).copy()
            p[0::2] = w - p[0::2]
            out.append(p.tolist())
        flipped.append(out)
    return np.ascontiguousarray(img), boxes, flipped


def scale_annotations(boxes, polygons, sy: float, sx: float):
    if boxes is not None and len(boxes):
        boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
    scaled = []
    for segs in polygons:
        if isinstance(segs, dict):
            scaled.append(segs)
            continue
        out = []
        for p in segs or []:
            p = np.asarray(p, np.float64).copy()
            p[0::2] *= sx
            p[1::2] *= sy
            out.append(p.tolist())
        scaled.append(out)
    return boxes, scaled
