"""Host-side transforms of the loaders: d2 ``ResizeShortestEdge``
(bilinear) and the horizontal flip, with boxes and polygons following, and
the mean-teacher loader's strong augmentation.

This package's own copy of ``ttdg_mgm_tpu/data/transforms.py``.
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

The strong augmentation (:func:`build_strong_augmentation`) runs the
Pillow operations of the JAX package's through ``data/enhance.py``, bit for
bit, and draws from its ``RandomState`` in the JAX package's order, so the
same seed gives the same images.
"""

from __future__ import annotations

import numpy as np

from reference.data import enhance
from reference.data.resample import resize_bilinear


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


# -- strong augmentation (photometric only, geometry preserved) -------------

def _hue(img: np.ndarray, shift: float) -> np.ndarray:
    hsv = enhance.rgb_to_hsv(img).astype(np.int16)
    hsv[..., 0] = (hsv[..., 0] + int(shift * 255)) % 256
    return enhance.hsv_to_rgb(hsv.astype(np.uint8))


def _color_jitter(img: np.ndarray, rng) -> np.ndarray:
    """torchvision ``ColorJitter(0.4, 0.4, 0.4, 0.1)``: brightness, contrast,
    saturation and hue, in an order drawn from ``rng``."""
    b, c, s = (rng.uniform(0.6, 1.4) for _ in range(3))
    hshift = rng.uniform(-0.1, 0.1)
    ops = [lambda im: enhance.brightness(im, b), lambda im: enhance.contrast(im, c),
           lambda im: enhance.color(im, s), lambda im: _hue(im, hshift)]
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def _random_erase(arr: np.ndarray, rng, scale, ratio, value=None) -> np.ndarray:
    """torchvision ``RandomErasing`` in place: up to 10 draws of a rectangle
    of ``scale`` of the area and aspect ``ratio``; the first that fits is
    filled with ``value`` or random bytes."""
    h, w = arr.shape[:2]
    for _ in range(10):
        area = rng.uniform(*scale) * h * w
        r = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        eh = int(round(np.sqrt(area * r)))
        ew = int(round(np.sqrt(area / r)))
        if eh < h and ew < w and eh > 0 and ew > 0:
            y = rng.randint(0, h - eh)
            x = rng.randint(0, w - ew)
            if value is None:
                arr[y:y + eh, x:x + ew] = rng.randint(0, 256, (eh, ew, arr.shape[2]))
            else:
                arr[y:y + eh, x:x + ew] = value
            return arr
    return arr


def build_strong_augmentation(seed: int | None = None):
    """The reference's ``build_strong_augmentation``: ColorJitter with
    probability 0.8, grayscale 0.2, Gaussian blur (sigma from U[0.1, 2])
    0.5, then three random erasings (0.7, 0.5, 0.3, each with its scales
    and ratios).  Returns ``strong(img) -> img`` on ``(H, W, 3)`` uint8
    images, drawing from one ``np.random.RandomState(seed)``; the input is
    not modified."""
    rng = np.random.RandomState(seed)

    def strong(img: np.ndarray) -> np.ndarray:
        if rng.rand() < 0.8:
            img = _color_jitter(img, rng)
        if rng.rand() < 0.2:
            img = enhance.gray_to_rgb(enhance.to_gray(img))
        if rng.rand() < 0.5:
            img = enhance.gaussian_blur(img, rng.uniform(0.1, 2.0))
        arr = np.array(img)
        if rng.rand() < 0.7:
            arr = _random_erase(arr, rng, (0.05, 0.2), (0.3, 3.3))
        if rng.rand() < 0.5:
            arr = _random_erase(arr, rng, (0.02, 0.2), (0.1, 6.0))
        if rng.rand() < 0.3:
            arr = _random_erase(arr, rng, (0.02, 0.2), (0.05, 8.0))
        return arr

    return strong
