"""A PNG decoder in zlib and NumPy, so the test path reads the datasets'
PNG images with no Pillow.

:func:`decode_png` reads 8-bit, non-interlaced images of colour type 0
(gray), 2 (RGB) and 6 (RGBA), with every one of the five scanline filters,
and returns the ``(H, W, 3)`` uint8 RGB array that Pillow's
``Image.open(path).convert("RGB")`` gives (gray replicated, alpha dropped).
PNG is lossless, so the two agree bit for bit.  Any other PNG raises
:class:`UnsupportedPNG`; ``data/loader.py:load_image`` then reads it with
Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: channels per colour type the decoder reads
_CHANNELS = {0: 1, 2: 3, 6: 4}


class UnsupportedPNG(ValueError):
    pass


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: ``raw`` is ``H`` rows of a filter byte
    and ``W * bpp`` filtered bytes; returns ``(H, W, bpp)`` uint8."""
    rows = raw.reshape(H, 1 + W * bpp)
    kinds = rows[:, 0]
    filt = rows[:, 1:].reshape(H, W, bpp)
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    out = np.empty((H, W, bpp), np.uint8)
    if not np.isin(kinds, (3, 4)).any():
        # None, Sub and Up rows: each row at once
        prior = np.zeros((W, bpp), np.uint8)
        for y in range(H):
            k = kinds[y]
            if k == 0:
                out[y] = filt[y]
            elif k == 1:
                out[y] = np.cumsum(filt[y], axis=0, dtype=np.uint8)
            else:
                out[y] = filt[y] + prior
            prior = out[y]
        return out
    # Average and Paeth rows depend on the pixel to the left, the one above
    # and the one above-left: reconstruct by anti-diagonals, each at once
    rec = np.zeros((H + 1, W + 1, bpp), np.int32)
    f32 = filt.astype(np.int32)
    k32 = kinds.astype(np.int32)
    for t in range(H + W - 1):
        y = np.arange(max(0, t - W + 1), min(H, t + 1))
        x = t - y
        a = rec[y + 1, x]
        b = rec[y, x + 1]
        c = rec[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = k32[y][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[y + 1, x + 1] = (f32[y, x] + pred) & 0xFF
    out[:] = rec[1:, 1:]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W, 3)`` uint8 RGB."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise UnsupportedPNG(f"PNG of bit depth {depth}, colour type {ctype}, "
                             f"interlace {interlace}")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < H * (1 + W * bpp):
        raise ValueError("PNG image data is truncated")
    pix = _unfilter(raw[:H * (1 + W * bpp)], H, W, bpp)
    if bpp == 1:
        return np.repeat(pix, 3, axis=2)
    return np.ascontiguousarray(pix[..., :3])
