"""Pillow's bilinear resize in NumPy, bit for bit.

``resize_bilinear(img, (nh, nw))`` equals
``np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR))`` on
uint8 images of shape ``(H, W)`` (mode ``L``) and ``(H, W, C)`` (``RGB``),
which is what the JAX package's loader runs on the host.  It follows
Pillow's ``libImaging/Resample.c`` (``ImagingResample``):

* per output pixel, the triangle filter centred at ``in0 + (x + 0.5) *
  scale`` over the input pixels ``[int(center - support + 0.5), int(center
  + support + 0.5))``, where ``support`` is the filter's 1.0 widened by the
  scale when downsampling; coefficients in double, normalised by their
  sum taken in order;
* coefficients held in fixed point with 22 fraction bits
  (``int(0.5 + k * 2**22)``), the sum started at ``2**21`` (half-up
  rounding) and shifted down by 22, clipped to 0..255;
* a horizontal pass over only the rows the vertical pass reads, into a
  uint8 image, then the vertical pass; an axis that keeps its size is not
  resampled, and an image that keeps both is returned as it is.

No Python loop runs over pixels: each pass loops over the filter's few
taps only.
"""

from __future__ import annotations

import math

import numpy as np

#: fixed-point fraction bits of the 8-bit resampler (``32 - 8 - 2``)
PRECISION_BITS = 22


def _coeffs(in_size: int, out_size: int):
    """``(xmin (out,), xmax (out,), k (out, ksize) int64)``: each output
    pixel's first input pixel, its span and its fixed-point weights (zero
    past the span), as
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` compute them for
    the box ``(0, in_size)``."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    w = np.zeros((out_size, ksize), np.float64)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):
        t = np.abs(((x + xmin) - center + 0.5) * ss)
        wx = np.where((t < 1.0) & (x < xmax), 1.0 - t, 0.0)
        w[:, x] = wx
        ww = ww + wx
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    one = float(1 << PRECISION_BITS)
    k = np.where(w < 0, (-0.5 + w * one), (0.5 + w * one)).astype(np.int64)
    return xmin, xmax, k


def _pass(img: np.ndarray, axis: int, out_size: int, xmin, k) -> np.ndarray:
    """One separable pass along ``axis`` of a uint8 image.  The sums fit in
    int32 (at most 255 times the weights' sum, about ``2**30``)."""
    in_size = img.shape[axis]
    src = np.ascontiguousarray(np.moveaxis(img, axis, 0))
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    bshape = (out_size,) + (1,) * (src.ndim - 1)
    k = k.astype(np.int32)
    for x in range(k.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        acc += src[idx] * k[:, x].reshape(bshape)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bilinear(img: np.ndarray, size) -> np.ndarray:
    """``img`` uint8 ``(H, W)`` or ``(H, W, C)`` resized to ``size = (nh,
    nw)`` as Pillow's ``Image.resize((nw, nh), Image.BILINEAR)``."""
    if img.dtype != np.uint8:
        raise TypeError(f"resize_bilinear takes uint8 images, got {img.dtype}")
    nh, nw = int(size[0]), int(size[1])
    h, w = img.shape[:2]
    if nh < 1 or nw < 1:
        raise ValueError(f"resize_bilinear: target size {size} is empty")
    if (nh, nw) == (h, w):
        return img
    ymin, ymax, ky = _coeffs(h, nh)
    out = img
    if nw != w:
        # only the rows the vertical pass reads
        first, last = (int(ymin[0]), int(ymin[-1] + ymax[-1])) if nh != h else (0, h)
        xmin, _, kx = _coeffs(w, nw)
        out = _pass(img[first:last], 1, nw, xmin, kx)
        ymin = ymin - first
    if nh != h:
        out = _pass(out, 0, nh, ymin, ky)
    return np.ascontiguousarray(out)
