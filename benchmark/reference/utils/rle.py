"""COCO mask codec: run-length encoding (RLE) and polygons, in NumPy.

This package's own copy of ``ttdg_mgm_tpu/utils/rle.py``:

* **compressed RLE**: the LEB128-like base-48 ASCII encoding of column-major
  run lengths (the first run counts zeros);
* **uncompressed RLE**: ``{"counts": [...], "size": [h, w]}``;
* **polygons**: a list of flat ``[x0, y0, x1, y1, ...]`` rings, rasterized
  as the JAX package's OpenCV ``fillPoly`` does, by this package's NumPy
  copy of it (``utils/polyfill.py``; no OpenCV).
"""

from __future__ import annotations

import numpy as np

from reference.utils.polyfill import fill_poly


def rle_decode(rle: dict) -> np.ndarray:
    """Decode {"size": [h, w], "counts": str|list} -> (h, w) uint8 mask."""
    h, w = rle["size"]
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _decode_counts_string(
            counts.decode("ascii") if isinstance(counts, bytes) else counts
        )
    counts = np.asarray(counts, dtype=np.int64)
    vals = np.zeros(len(counts), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, counts)
    flat = np.pad(flat, (0, h * w - len(flat)))
    return flat.reshape(w, h).T  # column-major


def rle_encode(mask: np.ndarray) -> dict:
    """Encode (h, w) binary mask -> compressed RLE dict."""
    h, w = mask.shape
    flat = np.asfortranarray(mask.astype(np.uint8)).T.reshape(-1)
    # run-length in column-major order, first run is zeros
    diffs = np.nonzero(np.diff(flat))[0] + 1
    boundaries = np.concatenate([[0], diffs, [h * w]])
    counts = np.diff(boundaries).tolist()
    if flat[0] == 1:
        counts = [0] + counts
    return {"size": [h, w], "counts": _encode_counts_string(counts)}


def _decode_counts_string(s: str) -> list:
    """COCO's modified-LEB128: 6-bit groups, offset 48, sign-extended, with
    every run after the second stored as a delta from two runs back."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * (k + 1))
            k += 1
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def _encode_counts_string(counts: list) -> str:
    out = []
    for idx, c in enumerate(counts):
        x = int(c)
        if idx > 2:
            x -= int(counts[idx - 2])
        more = True
        while more:
            c5 = x & 0x1F
            x >>= 5
            more = not ((x == 0 and not (c5 & 0x10)) or (x == -1 and (c5 & 0x10)))
            if more:
                c5 |= 0x20
            out.append(chr(c5 + 48))
    return "".join(out)


def polygons_to_mask(polygons, height: int, width: int) -> np.ndarray:
    """Rasterize a COCO polygon ring list -> ``(h, w)`` uint8 mask, as the
    JAX package's ``cv2.fillPoly`` on the rings' rounded int32 vertices
    (``utils/polyfill.py``, bit for bit): the outlines are drawn and the
    rings filled together by the even-odd rule, so where two rings overlap
    the overlap is a hole, not a union."""
    mask = np.zeros((height, width), np.uint8)
    pts = [
        np.round(np.asarray(p, np.float64).reshape(-1, 2)).astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        fill_poly(mask, pts, 1)
    return mask


def segmentation_to_mask(segm, height: int, width: int) -> np.ndarray:
    """Any COCO segmentation (polygons / RLE dict) -> binary mask.
    Mirrors reference ``dice_metric.py:94-107`` dispatch."""
    if isinstance(segm, list):
        return polygons_to_mask(segm, height, width)
    if isinstance(segm, dict):
        counts = segm["counts"]
        if isinstance(counts, list):
            return rle_decode({"size": segm["size"], "counts": counts})
        return rle_decode(segm)
    raise TypeError(f"unsupported segmentation type: {type(segm)}")
