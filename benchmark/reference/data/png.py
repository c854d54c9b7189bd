"""A PNG decoder in zlib and NumPy, so the test path reads the datasets'
PNG images with no Pillow.

:func:`decode_png` reads every PNG the standard defines: colour types 0
(gray, 1/2/4/8/16 bits), 2 (RGB, 8/16), 3 (palette, 1/2/4/8), 4 (gray and
alpha, 8/16) and 6 (RGBA, 8/16), with every one of the five scanline
filters, non-interlaced or Adam7-interlaced.  It returns the ``(H, W, 3)``
uint8 RGB array that Pillow's ``Image.open(path).convert("RGB")`` gives,
with Pillow's own rules, which are not all scalings:

* gray below 8 bits is scaled to 0..255 (``v * 255 // (2**d - 1)``);
* 16-bit gray is clipped to 255 (Pillow's ``I;16`` to ``RGB``), while
  16-bit RGB, RGBA and gray-with-alpha keep each sample's high byte;
* alpha and ``tRNS`` are dropped, palette indices past the ``PLTE`` entries
  give black.

PNG is lossless, so the two agree bit for bit.  A file that is not a valid
PNG of those kinds raises :class:`UnsupportedPNG` or ``ValueError``; there
is no other decoder behind it.

:func:`encode_png` writes 8-bit gray or RGB images (the visualizer's dumps,
``utils/visualize.py``): one ``IDAT`` chunk, every scanline with the Up
filter, deflated by zlib.  :func:`decode_png` and OpenCV's ``imread`` read
its files back bit for bit.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples per pixel, and the bit depths the standard allows, per colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
#: Adam7 passes: first column and row, column and row steps
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


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


def _samples(pix: np.ndarray, W: int, depth: int, ch: int) -> np.ndarray:
    """Unfiltered rows ``(h, rowbytes)`` -> samples ``(h, W, ch)`` (uint8,
    or uint16 at 16 bits)."""
    h = pix.shape[0]
    if depth == 8:
        return pix[:, :W * ch].reshape(h, W, ch)
    if depth == 16:  # big-endian
        hi = pix[:, 0:2 * W * ch:2].astype(np.uint16)
        return ((hi << 8) | pix[:, 1:2 * W * ch:2]).reshape(h, W, ch)
    bits = np.unpackbits(pix, axis=1)[:, :W * ch * depth].reshape(h, W * ch, depth)
    vals = (bits * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(axis=2)
    return vals.astype(np.uint8).reshape(h, W, ch)


def _to_rgb(samples: np.ndarray, depth: int, ctype: int, palette) -> np.ndarray:
    """Samples ``(H, W, ch)`` -> ``(H, W, 3)`` uint8 as Pillow's
    ``convert("RGB")``."""
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        if palette is not None:
            lut[:len(palette)] = palette
        return lut[samples[..., 0]]
    if depth == 16:
        s8 = (np.minimum(samples, 255) if ctype == 0 else samples >> 8).astype(np.uint8)
    elif depth < 8:
        s8 = samples * np.uint8(255 // ((1 << depth) - 1))
    else:
        s8 = samples
    if ctype in (0, 4):
        return np.repeat(s8[..., :1], 3, axis=2)
    return np.ascontiguousarray(s8[..., :3])


def _decode_image(raw: np.ndarray, W: int, H: int, depth: int, ctype: int):
    """One non-interlaced image (or one Adam7 pass) from the front of
    ``raw``: ``(samples (H, W, ch), bytes used)``."""
    ch = _CHANNELS[ctype]
    rowbytes = (W * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    n = H * (1 + rowbytes)
    if raw.size < n:
        raise ValueError("PNG image data is truncated")
    pix = _unfilter(raw[:n], H, rowbytes // bpp, bpp).reshape(H, rowbytes)
    return _samples(pix, W, depth, ch), n


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> ``(H, W, 3)`` uint8 RGB."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file")
    header, idat, palette = None, [], None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)[:256]
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or interlace not in (0, 1):
        raise UnsupportedPNG(f"PNG of bit depth {depth}, colour type {ctype}, "
                             f"interlace {interlace}")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace == 0:
        samples, _ = _decode_image(raw, W, H, depth, ctype)
    else:
        samples = np.zeros((H, W, _CHANNELS[ctype]), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (W - x0 + dx - 1) // dx, (H - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            sub, used = _decode_image(raw[pos:], pw, ph, depth, ctype)
            samples[y0::dy, x0::dx] = sub
            pos += used
    return _to_rgb(samples, depth, ctype, palette)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(img: np.ndarray) -> bytes:
    """PNG bytes of ``img``: ``(H, W)`` or ``(H, W, 1)`` uint8 gray, or
    ``(H, W, 3)`` uint8 RGB.  Each scanline carries the Up filter (its
    difference to the line above, modulo 256), the whole deflated by zlib."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, got {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 3) images, got {img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(h, -1)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 arithmetic wraps modulo 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
