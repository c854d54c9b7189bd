"""NumPy copies of the Pillow image operations of the strong augmentation.

Each function takes and returns ``(H, W, 3)`` uint8 RGB (or ``(H, W)`` for
the ``L`` image) and gives the bits Pillow 12.1.0 gives, with Pillow's own
arithmetic:

* :func:`blend` is ``Image.blend`` (``libImaging/Blend.c``): ``in1 + alpha *
  (in2 - in1)`` in float32, truncated, clipped to [0, 255] only when alpha
  lies outside [0, 1]; ``ImageEnhance.Brightness``, ``Contrast`` and
  ``Color`` are blends against a degenerate image (:func:`brightness`,
  :func:`contrast`, :func:`color`);
* :func:`to_gray` is ``convert("L")``: fixed-point luma ``(19595 R + 38470 G
  + 7471 B + 0x8000) >> 16``;
* :func:`rgb_to_hsv` and :func:`hsv_to_rgb` are ``convert("HSV")`` and
  ``Image.fromarray(hsv, "HSV").convert("RGB")`` (``libImaging/Convert.c``),
  with its mix of float32 and double steps;
* :func:`gaussian_blur` is ``ImageFilter.GaussianBlur(radius)``: not a
  Gaussian, but three passes of an extended box filter along the rows, then
  three along the columns (``libImaging/BoxBlur.c``), each pass in 24-bit
  fixed point with edge pixels repeated and its result rounded to uint8.

Nothing here imports Pillow.
"""

from __future__ import annotations

import math

import numpy as np

_F32 = np.float32
#: box-filter passes per axis of Pillow's ``GaussianBlur``
PASSES = 3


def blend(im1: np.ndarray, im2: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(im1, im2, alpha)`` on uint8 arrays of one shape."""
    a = _F32(alpha)
    a1 = im1.astype(np.int32)
    out = a1.astype(_F32) + a * (im2.astype(np.int32) - a1).astype(_F32)
    if 0 <= a <= 1:
        return out.astype(np.uint8)
    # float -> uint8 truncates; values at or beyond the ends clip
    return np.where(out <= 0, 0, np.where(out >= 255, 255, out)).astype(np.uint8)


def to_gray(img: np.ndarray) -> np.ndarray:
    """``convert("L")`` of an RGB image: ``(H, W)`` uint8."""
    rgb = img.astype(np.uint32)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def gray_to_rgb(gray: np.ndarray) -> np.ndarray:
    """``convert("RGB")`` of an ``L`` image."""
    return np.repeat(gray[..., None], 3, axis=-1)


def brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(factor)``: a blend from black."""
    return blend(np.zeros_like(img), img, factor)


def contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(factor)``: a blend from the gray
    image at the luma's mean, rounded half up (``ImageStat`` sums the
    histogram in a Python float)."""
    hist = np.bincount(to_gray(img).reshape(-1), minlength=256)
    total = 0.0
    for v, n in enumerate(hist.tolist()):
        total += v * n
    mean = int(total / hist.sum() + 0.5) if hist.sum() else 0
    return blend(np.full_like(img, mean), img, factor)


def color(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(factor)``: a blend from the image's
    own gray."""
    return blend(gray_to_rgb(to_gray(img)), img, factor)


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``convert("HSV")`` of an RGB image (Pillow's ``rgb2hsv_row``)."""
    rgb = img.astype(np.int32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.max(-1)
    minc = rgb.min(-1)
    flat = maxc == minc
    cr = (maxc - minc).astype(_F32)
    safe_cr = np.where(flat, _F32(1), cr)
    s = cr / np.where(maxc == 0, _F32(1), maxc.astype(_F32))
    rc = (maxc - r).astype(_F32) / safe_cr
    gc = (maxc - g).astype(_F32) / safe_cr
    bc = (maxc - b).astype(_F32) / safe_cr
    # h is a float; the 2.0 and 4.0 branches add in double, then store
    h = np.where(r == maxc, (bc - gc).astype(np.float64),
                 np.where(g == maxc,
                          2.0 + rc.astype(np.float64) - bc.astype(np.float64),
                          4.0 + gc.astype(np.float64) - rc.astype(np.float64))).astype(_F32)
    h = np.fmod(h.astype(np.float64) / 6.0 + 1.0, 1.0).astype(_F32)
    uh = np.clip((h.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    us = np.clip((s.astype(np.float64) * 255.0).astype(np.int64), 0, 255)
    out = np.stack([np.where(flat, 0, uh), np.where(flat, 0, us), maxc], -1)
    return out.astype(np.uint8)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``convert("RGB")`` of an HSV image (Pillow's ``hsv2rgb``)."""
    h = hsv[..., 0].astype(_F32)
    s = hsv[..., 1]
    v = hsv[..., 2].astype(_F32)
    # (float)h * 6.0 / 255.0 is double arithmetic; floor, then stored as int
    h6 = h.astype(np.float64) * 6.0 / 255.0
    i = np.floor(h6).astype(np.int64)
    f = (h6 - i.astype(_F32).astype(np.float64)).astype(_F32)
    fs = (s.astype(_F32).astype(np.float64) / 255.0).astype(_F32)
    vd = v.astype(np.float64)
    fsd, fd = fs.astype(np.float64), f.astype(np.float64)
    # C round(): half away from zero (the values are never negative)
    p = np.clip(np.floor(vd * (1.0 - fsd) + 0.5), 0, 255).astype(np.uint8)
    q = np.clip(np.floor(vd * (1.0 - (fs * f).astype(np.float64)) + 0.5), 0, 255).astype(np.uint8)
    t = np.clip(np.floor(vd * (1.0 - (fsd * (1.0 - fd))) + 0.5), 0, 255).astype(np.uint8)
    vu = hsv[..., 2]
    k = i % 6
    table = [(vu, t, p), (q, vu, p), (p, vu, t), (p, q, vu), (t, p, vu), (vu, p, q)]
    out = np.zeros(hsv.shape, np.uint8)
    for case, chans in enumerate(table):
        sel = k == case
        for c in range(3):
            out[..., c] = np.where(sel, chans[c], out[..., c])
    gray = s == 0
    return np.where(gray[..., None], vu[..., None], out)


def _box_radius(sigma: float) -> float:
    """Pillow's ``_gaussian_blur_radius``: the extended box filter's radius
    for a Gaussian of ``sigma`` over ``PASSES`` passes (float32 with double
    steps where Pillow takes them)."""
    r = _F32(sigma)
    sigma2 = _F32(r * r / _F32(PASSES))
    L = _F32(math.sqrt(12.0 * float(sigma2) + 1.0))
    l = _F32(math.floor((float(L) - 1.0) / 2.0))
    a = _F32((_F32(2) * l + _F32(1)) * (l * (l + _F32(1)) - _F32(3) * sigma2))
    a = _F32(a / (_F32(6) * (sigma2 - (l + _F32(1)) * (l + _F32(1)))))
    return _F32(l + a)


def _box_pass(x: np.ndarray, radius: np.float32) -> np.ndarray:
    """One extended box filter along axis 1 of ``(R, N, C)`` uint8
    (``ImagingHorizontalBoxBlur``): the window ``[x - r, x + r]`` at weight
    ``ww`` and its two outer neighbours at ``fw``, edge pixels repeated,
    ``(sum + 2^23) >> 24``."""
    r = int(radius)
    ww = int(_F32(1 << 24) / (radius * _F32(2) + _F32(1)))
    fw = ((1 << 24) - (2 * r + 1) * ww) // 2
    n = x.shape[1]
    src = x.astype(np.int64)
    idx = np.clip(np.arange(-r - 1, n + r + 1), 0, n - 1)
    padded = src[:, idx]
    csum = np.concatenate([np.zeros_like(padded[:, :1]), np.cumsum(padded, axis=1)], axis=1)
    # inner window of output j spans padded[j + 1 : j + 2r + 2]
    inner = csum[:, 2 * r + 2:2 * r + 2 + n] - csum[:, 1:1 + n]
    outer = padded[:, :n] + padded[:, 2 * r + 2:2 * r + 2 + n]
    # at most 255 * 2^24 + 2^23: Pillow's UINT32 sums never wrap
    return ((inner * ww + outer * fw + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """``img.filter(ImageFilter.GaussianBlur(radius=sigma))``."""
    if sigma == 0:
        return img.copy()
    radius = _box_radius(sigma)
    out = img
    if radius != 0:
        for _ in range(PASSES):
            out = _box_pass(out, radius)
        out = out.transpose(1, 0, 2)
        for _ in range(PASSES):
            out = _box_pass(out, radius)
        out = np.ascontiguousarray(out.transpose(1, 0, 2))
    return out
