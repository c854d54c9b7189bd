"""A BMP decoder in NumPy, equal to Pillow's.

:func:`decode_bmp` returns the ``(H, W, 3)`` uint8 RGB array that
``PIL.Image.open(path).convert("RGB")`` (Pillow 12.1.0) gives, bit for bit,
for the BMP files Pillow opens (``BmpImagePlugin``): the core (OS/2 1.x),
``BITMAPINFOHEADER``, V2, V3, OS/2 2.x, V4 and V5 headers; 1, 4 and 8 bits
with a palette, 16 bits (5-5-5, and ``BI_BITFIELDS`` 5-6-5 or 5-5-5), 24
bits and 32 bits (``BI_RGB``, and the ``BI_BITFIELDS`` masks Pillow
lists); RLE8 and RLE4 with their escapes; rows bottom-up or top-down.

It keeps Pillow's own rules, read from Pillow, where they are not the
format's:

* a palette of exact grays (``(i, i, i)`` at index ``i``, or black and
  white for two colours) is dropped, and the pixel data read as 8-bit gray
  (or 1-bit for two colours) whatever the file's depth, as Pillow maps a
  file it opens by name: ``W`` bytes from each row's start, running into
  the next row where the file's rows are shorter;
* 5-bit fields widen as ``v * 255 // 31`` and 6-bit ones as ``v * 255 //
  63``; alpha is dropped;
* Pillow's RLE decoder reads a delta escape's two offset bytes and then
  takes the next two bytes as the offsets, and reads ``n // 2`` bytes for
  an absolute run of ``n`` 4-bit pixels (one pixel short for odd ``n``);
  both are kept, so a file Pillow misreads is misread the same way, and
  RLE data that stops short of the image raises as it does in Pillow.

Other compressions (JPEG, PNG inside BMP), other depths and other
bitfield masks raise ``ValueError`` naming the file and the variant.
"""

from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"BM"

_HEADERS = (12, 40, 52, 56, 64, 108, 124)
_RAW, _RLE8, _RLE4, _BITFIELDS = 0, 1, 2, 3
#: Pillow's raw mode of each bitfield layout (``BmpImagePlugin.MASK_MODES``)
_MASK_MODES = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}
_BIT_MODES = {1: "P;1", 4: "P;4", 8: "P", 16: "BGR;15", 24: "BGR", 32: "BGRX"}


def _header(data: bytes, name: str):
    """Pillow's reading of the headers (``BmpImageFile._bitmap``)."""
    if len(data) < 18:
        raise ValueError(f"{name}: truncated BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (size,) = struct.unpack("<I", data[14:18])
    if size not in _HEADERS:
        raise ValueError(f"{name}: BMP header of {size} bytes is not supported")
    h = data[18:14 + size]
    if len(h) < size - 4:
        raise ValueError(f"{name}: truncated BMP header")
    pos = 14 + size
    if size == 12:
        w, ht, _, bits = struct.unpack("<HHHH", h[:8])
        info = dict(width=w, height=ht, bits=bits, compression=_RAW, colors=0, padding=3,
                    top_down=False)
    else:
        flip = h[7] == 0xFF
        w, ht, _, bits, comp = struct.unpack("<IIHHI", h[:16])
        (colors,) = struct.unpack("<I", h[28:32])
        info = dict(width=w, height=2 ** 32 - ht if flip else ht, bits=bits, compression=comp,
                    colors=colors, padding=4, top_down=flip)
        if comp == _BITFIELDS:
            if len(h) >= 48:
                n = 4 if len(h) >= 52 else 3
                masks = struct.unpack(f"<{n}I", h[36:36 + 4 * n])
            else:
                masks = struct.unpack("<3I", data[pos:pos + 12])
                pos += 12
            info["masks"] = tuple(masks) + (0,) * (4 - len(masks))
    if info["colors"] == 0:
        info["colors"] = 1 << info["bits"]
    if offset == 14 + size and info["bits"] <= 8:
        offset += 4 * info["colors"]
    info["offset"], info["palette_at"] = offset, pos
    return info


def _kind(info, name):
    """The raw mode of the pixel data, or raises naming the variant."""
    bits, comp = info["bits"], info["compression"]
    if bits not in _BIT_MODES:
        raise ValueError(f"{name}: BMP of {bits} bits per pixel is not supported")
    if comp == _BITFIELDS:
        masks = info["masks"]
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _MASK_MODES:
            raise ValueError(f"{name}: BMP bitfields {[hex(m) for m in masks]} at {bits} bits "
                             "are not supported")
        return _MASK_MODES[key]
    if comp in (_RAW, _RLE8, _RLE4):
        return _BIT_MODES[bits]
    kind = {4: "JPEG", 5: "PNG"}.get(comp, f"compression {comp}")
    raise ValueError(f"{name}: BMP with {kind} compression is not supported")


def _rle(data: bytes, at: int, W: int, H: int, rle4: bool, name: str) -> np.ndarray:
    """Pillow's ``BmpRleDecoder``: one index per pixel, in file row order."""
    out, x, need, n = bytearray(), 0, W * H, len(data)
    while len(out) < need:
        if at + 2 > n:
            break
        count, byte = data[at], data[at + 1]
        at += 2
        if count:                                     # a run of one value (two for RLE4)
            if x + count > W:
                count = max(0, W - x)
            if rle4:
                pair = bytes([byte >> 4, byte & 15])
                out += (pair * ((count + 1) // 2))[:count]
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:                               # end of line
            out += bytes(-len(out) % W)
            x = 0
        elif byte == 1:                               # end of bitmap
            break
        elif byte == 2:                               # delta, as Pillow reads it
            if at + 2 > n:
                break
            at += 2
            right, up = data[at:at + 2] + bytes(2 - len(data[at:at + 2]))
            at += 2
            out += bytes(right + up * W)
            x = len(out) % W
        else:                                         # absolute run of `byte` pixels
            take = byte // 2 if rle4 else byte
            chunk = data[at:at + take]
            at += len(chunk)
            if rle4:
                nib = np.frombuffer(chunk, np.uint8)
                out += np.stack([nib >> 4, nib & 15], 1).tobytes()
            else:
                out += chunk
            if len(chunk) < take:
                break
            x += byte
            at += at % 2                              # word alignment in the file
    if len(out) < need:
        raise ValueError(f"{name}: BMP RLE data ends after {len(out)} of {need} pixels")
    return np.frombuffer(bytes(out[:need]), np.uint8).reshape(H, W)


def _rows(data: bytes, at: int, W: int, H: int, bits: int, name: str) -> np.ndarray:
    """Uncompressed pixel data: ``(H, stride)`` bytes in file row order."""
    stride = ((W * bits + 31) >> 3) & ~3
    raw = np.frombuffer(data[at:at + stride * H], np.uint8)
    if raw.size < stride * H:
        raise ValueError(f"{name}: truncated BMP pixel data")
    return raw.reshape(H, stride)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """BMP bytes -> ``(H, W, 3)`` uint8 RGB, as Pillow's
    ``Image.open(...).convert("RGB")``.  ``name`` labels the errors."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a BMP file")
    info = _header(data, name)
    W, H, bits, comp = info["width"], info["height"], info["bits"], info["compression"]
    if not W or not H:
        raise ValueError(f"{name}: BMP of size {W} x {H}")
    raw_mode = _kind(info, name)
    gray = None
    lut = None
    if raw_mode.startswith("P"):
        colors, pad = info["colors"], info["padding"]
        if not 0 < colors <= 65536:
            raise ValueError(f"{name}: BMP palette of {colors} colours is not supported")
        at = info["palette_at"]
        pal = data[at:at + pad * colors]
        want = (0, 255) if colors == 2 else range(colors)
        if all(pal[i * pad:i * pad + 3] == bytes([v]) * 3 for i, v in enumerate(want)):
            gray = "1" if colors == 2 else "L"
        else:
            pal = pal[:pad * min(colors, 256)]
            ent = np.frombuffer(pal[:len(pal) // pad * pad], np.uint8).reshape(-1, pad)[:, 2::-1]
            lut = np.zeros((256, 3), np.uint8)
            lut[:len(ent)] = ent
    at = info["offset"]
    if comp in (_RLE8, _RLE4):
        if gray == "1":
            raise ValueError(f"{name}: RLE BMP with a black-and-white palette is not supported")
        idx = _rle(data, at, W, H, comp == _RLE4, name)
        img = np.repeat(idx[..., None], 3, axis=2) if gray else lut[idx]
    elif gray:
        rows = _rows(data, at, W, H, bits, name)
        if gray == "1":
            v = np.unpackbits(rows, axis=1)[:, :W] * np.uint8(255)
        else:
            # Pillow maps a file it opens by name (``Image.core.map_buffer``):
            # row y is the W bytes from y * stride, into the next row where W
            # is longer than the stride, and zeros past the file's end
            stride = rows.shape[1]
            ext = np.frombuffer(data[at:at + stride * (H - 1) + W], np.uint8)
            ext = np.concatenate([ext, np.zeros(stride * (H - 1) + W - ext.size, np.uint8)])
            v = ext[np.arange(H)[:, None] * stride + np.arange(W)]
        img = np.repeat(v[..., None], 3, axis=2)
    else:
        rows = _rows(data, at, W, H, bits, name)
        if raw_mode.startswith("P"):
            if bits == 8:
                idx = rows[:, :W]
            else:
                v = np.unpackbits(rows, axis=1).reshape(H, -1, bits)
                idx = (v * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(2)
                idx = idx[:, :W].astype(np.uint8)
            img = lut[idx]
        elif bits == 16:
            px = rows[:, :2 * W].view("<u2").astype(np.int64)
            if raw_mode == "BGR;16":
                r, g, b = (px >> 11) & 31, (px >> 5) & 63, px & 31
                g = g * 255 // 63
            else:
                r, g, b = (px >> 10) & 31, (px >> 5) & 31, px & 31
                g = g * 255 // 31
            img = np.stack([r * 255 // 31, g, b * 255 // 31], -1).astype(np.uint8)
        else:
            n = bits // 8
            px = rows[:, :n * W].reshape(H, W, n)
            img = px[..., [raw_mode.index(ch) for ch in "RGB"]]
    if not info["top_down"]:
        img = img[::-1]
    return np.ascontiguousarray(img)
