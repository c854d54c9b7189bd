"""A TIFF decoder in zlib and NumPy, equal to Pillow's.

:func:`decode_tiff` returns the ``(H, W, 3)`` uint8 RGB array that
``PIL.Image.open(path).convert("RGB")`` (Pillow 12.1.0) gives, bit for bit,
for the first image of a classic TIFF file (as Pillow opens frame 0):

* either byte order (``II*\\0``, ``MM\\0*``), strips or tiles,
  ``PlanarConfiguration`` 1 (chunky) or 2 (one plane per sample);
* compression none (1), PackBits (32773), LZW (5: MSB-first codes of 9 to
  12 bits with libtiff's early change, vectorised below) and Deflate (8 and
  32946, through zlib), with the horizontal predictor (2) at 8 and 16 bits
  on LZW and Deflate, where libtiff applies it;
* unsigned samples of photometric 0 (WhiteIsZero) and 1 (BlackIsZero) at
  1, 2, 4, 8 and 16 bits, gray with an alpha sample, 2 (RGB) at 8 and 16
  bits with or without unassociated or unspecified extra samples, and 3
  (palette) at 1, 2, 4 and 8 bits with its 16-bit colormap;
* the ``Orientation`` tag, which Pillow applies when it loads a TIFF.

Pillow's own rules, read from Pillow (``TiffImagePlugin.OPEN_INFO`` and
what ``convert("RGB")`` makes of each mode), not from the standard:

* gray below 8 bits is scaled to 0..255 (``v * 255 // (2**d - 1)``), and
  inverted under WhiteIsZero;
* 16-bit gray is clipped to 255 (``I;16`` to ``RGB``), under WhiteIsZero too
  (Pillow does not invert it, and opens no big-endian WhiteIsZero 16-bit
  file); 16-bit RGB keeps each sample's high byte;
* a colormap entry keeps its high byte (``value // 256``);
* alpha and other extra samples are dropped.

What Pillow opens but this decoder does not raises ``ValueError`` naming the
file and the variant: JPEG-in-TIFF (6, 7), CCITT and other compressions,
YCbCr, CMYK, CIELab, signed-integer and floating-point samples, associated
(premultiplied) alpha, fill order 2, the floating-point predictor (3),
old-style LZW and BigTIFF.  Nothing falls back to another decoder.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURES = (b"II*\x00", b"MM\x00*")

#: TIFF tags read here
_W, _H, _BPS, _COMPRESSION, _PHOTO, _FILLORDER = 256, 257, 258, 259, 262, 266
_STRIP_OFFSETS, _ORIENTATION, _SPP, _ROWS_PER_STRIP, _STRIP_COUNTS = 273, 274, 277, 278, 279
_PLANAR, _PREDICTOR, _COLORMAP = 284, 317, 320
_TILE_W, _TILE_H, _TILE_OFFSETS, _TILE_COUNTS = 322, 323, 324, 325
_EXTRA, _SAMPLE_FORMAT = 338, 339
#: field type -> (struct code, bytes), for the integer types
_TYPES = {1: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 13: ("I", 4)}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
_OTHER_COMPRESSIONS = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                       6: "old-style JPEG-in-TIFF", 7: "JPEG-in-TIFF", 34712: "JPEG 2000",
                       34887: "LERC", 34925: "LZMA", 50000: "Zstandard", 50001: "WebP"}
_PHOTOS = {0: "WhiteIsZero", 1: "BlackIsZero", 2: "RGB", 3: "palette", 4: "transparency mask",
           5: "CMYK", 6: "YCbCr", 8: "CIELab", 9: "ICCLab", 10: "ITULab", 32844: "LogL",
           32845: "LogLuv"}


#: the sample layouts decoded: ``(photometric, bits, samples per pixel, extra
#: samples)``, those of Pillow's ``OPEN_INFO`` with unsigned samples and no
#: associated alpha (Pillow has no big-endian WhiteIsZero 16-bit entry)
_LAYOUTS = {
    *((p, b, 1, ()) for p in (0, 1) for b in (1, 2, 4, 8, 16)), (1, 8, 2, (2,)),
    (2, 8, 3, ()), (2, 8, 4, ()), (2, 8, 4, (0,)), (2, 8, 4, (2,)), (2, 8, 4, (999,)),
    (2, 8, 5, (0, 0)), (2, 8, 5, (2, 0)), (2, 8, 6, (0, 0, 0)), (2, 8, 6, (2, 0, 0)),
    (2, 16, 3, ()), (2, 16, 4, ()), (2, 16, 4, (0,)), (2, 16, 4, (2,)),
    *((3, b, 1, ()) for b in (1, 2, 4, 8)), (3, 8, 2, (0,)), (3, 8, 2, (2,)),
}


class UnsupportedTIFF(ValueError):
    pass


# -- LZW (libtiff's tif_lzw.c) -----------------------------------------------------

_CLEAR, _EOI, _FIRST = 256, 257, 258
#: at most this many codes between two Clear codes (libtiff's table, CSIZE)
_MAX_RUN = 4095 + 1024 - _FIRST + 1
#: the width of the k-th code after a Clear code: 9 bits up to the entry
#: 510, then 10, 11 and 12 (the table grows by one entry per code from the
#: second, and the width grows one code early)
_WIDTHS = np.full(_MAX_RUN, 12, np.int64)
_WIDTHS[:1790] = 11
_WIDTHS[:766] = 10
_WIDTHS[:254] = 9
_STARTS = np.concatenate([[0], np.cumsum(_WIDTHS)[:-1]])


def _lzw_codes(buf: bytes, name: str):
    """The codes of one LZW-coded chunk, split at its Clear codes: a list of
    int64 arrays, one per run of codes between Clear codes (Clear and EOI
    removed)."""
    if buf[:2] == b"\x00\x01":
        raise UnsupportedTIFF(f"{name}: old-style (LSB-first) TIFF LZW is not supported")
    b = np.frombuffer(buf + b"\x00\x00\x00", np.uint8).astype(np.int64)
    win = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]  # 24 bits from each byte offset
    nbits = 8 * len(buf)
    runs, pos = [], 0
    while True:
        p = pos + _STARTS
        ok = p + _WIDTHS <= nbits
        p, w = p[ok], _WIDTHS[ok]
        codes = (win[p >> 3] >> (24 - w - (p & 7))) & ((1 << w) - 1)
        stop = np.flatnonzero(codes >= _CLEAR)
        stop = stop[codes[stop] <= _EOI]
        end = int(stop[0]) if len(stop) else len(codes)
        if end == _MAX_RUN:
            raise ValueError(f"{name}: corrupt TIFF LZW data (the code table overflows)")
        if end:
            runs.append(codes[:end])
        if end == len(codes) or codes[end] == _EOI:
            return runs
        pos = int(p[end] + w[end])


def _lzw_resolve(runs, name: str):
    """The bytes that the runs of codes ``runs`` (from :func:`_lzw_codes`)
    stand for, concatenated, and the count of bytes of each run.  The entry
    that code ``k`` of a run adds is the string of code ``k - 1`` and the
    first byte of its own, which is the output from the start of code
    ``k - 1``'s string, one byte longer: every output byte is a literal or
    a copy of an earlier one, and pointer jumping resolves the copies in
    ``log2`` of the longest chain's passes."""
    codes = np.concatenate(runs).astype(np.int32)
    n = len(codes)
    offs = np.cumsum([0] + [len(r) for r in runs[:-1]])
    mark = np.zeros(n, np.int32)
    mark[offs] = np.diff(np.concatenate([[0], offs]))
    first = np.cumsum(mark, dtype=np.int32)              # each code's run's start
    lit = codes < _CLEAR
    idx = np.arange(n, dtype=np.int32)
    ref = first + codes - _FIRST
    if np.any(~lit & (ref >= idx)):
        raise ValueError(f"{name}: corrupt TIFF LZW data (a code not yet in the table)")
    ref[lit] = idx[lit]
    # string lengths: 1 for a literal, one more than the referenced code's
    length = (~lit).astype(np.int32)
    _jump(ref.copy(), np.flatnonzero(~lit), length)
    length += 1
    pos = np.zeros(n + 1, np.int64)
    np.cumsum(length, out=pos[1:])
    # each byte of a copy starts as the same byte of the referenced string
    src = np.arange(pos[-1], dtype=np.int32)
    src += np.repeat((pos[ref] - pos[:-1]).astype(np.int32), length)
    _jump(src, np.flatnonzero(np.repeat(~lit, length)))
    owner = np.repeat(codes, length)
    return owner[src].astype(np.uint8), np.add.reduceat(length, offs)


def _jump(par: np.ndarray, active: np.ndarray, depth=None) -> None:
    """Pointer jumping in place: each ``par[i]`` becomes the root its chain
    ends at (a root points at itself; ``active`` holds the entries that are
    not roots), and with ``depth`` (1 at the entries of ``active``, 0 at the
    roots) each ``depth[i]`` becomes the length of ``i``'s chain.  Only the
    entries not yet pointing at a root are touched on each pass."""
    while active.size:
        p = par[active]
        if depth is not None:
            depth[active] += depth[p]
        pp = par[p]
        par[active] = pp
        active = active[pp != p]


def _lzw_chunks(bufs, name: str):
    """The decompressed bytes of each LZW-coded chunk of ``bufs``: every
    chunk's codes first, then one resolution for all of them."""
    runs, per = [], []
    for buf in bufs:
        r = _lzw_codes(buf, name)
        runs += r
        per.append(len(r))
    if not runs:
        return [np.zeros(0, np.uint8) for _ in bufs]
    flat, run_bytes = _lzw_resolve(runs, name)
    ends = np.concatenate([[0], np.cumsum(run_bytes)])[np.cumsum(per)]
    return np.split(flat, ends[:-1])


def _packbits(buf: bytes, size: int) -> bytes:
    out, i, n = bytearray(), 0, len(buf)
    while i < n and len(out) < size:
        h = buf[i]
        if h < 128:
            out += buf[i + 1:i + 2 + h]
            i += 2 + h
        elif h > 128:
            out += buf[i + 1:i + 2] * (257 - h)
            i += 2
        else:
            i += 1
    return bytes(out[:size])


# -- the file's structure ------------------------------------------------------------

def _ifd(data: bytes, name: str):
    """The first image file directory's integer tags: ``{tag: tuple}``, and
    the byte order's struct prefix."""
    order = "<" if data[:2] == b"II" else ">"
    (off,) = struct.unpack(order + "I", data[4:8])
    if off + 2 > len(data):
        raise ValueError(f"{name}: truncated TIFF file")
    (count,) = struct.unpack(order + "H", data[off:off + 2])
    tags = {}
    for e in range(count):
        at = off + 2 + 12 * e
        tag, typ, n = struct.unpack(order + "HHI", data[at:at + 8])
        if typ not in _TYPES:
            continue
        code, size = _TYPES[typ]
        where = at + 8
        if n * size > 4:
            (where,) = struct.unpack(order + "I", data[at + 8:at + 12])
        if where + n * size > len(data):
            raise ValueError(f"{name}: truncated TIFF tag {tag}")
        tags[tag] = struct.unpack(f"{order}{n}{code}", data[where:where + n * size])
    return tags, order


def _one(tags, tag, default=None):
    v = tags.get(tag)
    return default if v is None else v[0]


def _kind(tags, order, name):
    """Pillow's reading of the tags (``TiffImagePlugin._setup``): returns
    the photometric interpretation, the bits of each sample, the samples
    per pixel and the compression, or raises naming what this decoder does
    not read."""
    comp = _one(tags, _COMPRESSION, 1)
    if comp not in _COMPRESSIONS:
        kind = _OTHER_COMPRESSIONS.get(comp, f"compression {comp}")
        raise UnsupportedTIFF(f"{name}: {kind} TIFF is not supported; uncompressed, PackBits, "
                              "LZW and Deflate are")
    photo = _one(tags, _PHOTO, 0)
    if photo not in (0, 1, 2, 3):
        raise UnsupportedTIFF(f"{name}: {_PHOTOS.get(photo, f'photometric {photo}')} TIFF is "
                              "not supported; gray, RGB and palette are")
    fmt = tags.get(_SAMPLE_FORMAT, (1,))
    if any(f != 1 for f in fmt):
        what = "floating-point" if 3 in fmt else "signed-integer"
        raise UnsupportedTIFF(f"{name}: TIFF with {what} samples is not supported; unsigned "
                              "integer samples are")
    if _one(tags, _FILLORDER, 1) != 1:
        raise UnsupportedTIFF(f"{name}: TIFF with fill order 2 (LSB first) is not supported")
    extra = tags.get(_EXTRA, ())
    spp = _one(tags, _SPP, 1)
    bps = tags.get(_BPS, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp or len(set(bps)) != 1:
        raise UnsupportedTIFF(f"{name}: TIFF with bits per sample {bps} and {spp} samples per "
                              "pixel is not supported")
    bits = bps[0]
    if 1 in extra:
        raise UnsupportedTIFF(f"{name}: TIFF with associated (premultiplied) alpha is not "
                              "supported")
    if (photo, bits, spp, extra) not in _LAYOUTS or (photo, bits, order) == (0, 16, ">"):
        raise UnsupportedTIFF(f"{name}: {_PHOTOS[photo]} TIFF with {spp} samples of {bits} bits "
                              f"and extra samples {extra} is not supported")
    return photo, bits, spp, comp


def _chunks(tags, H, W, spp, planar, name):
    """Each chunk of image data: ``(offset, byte count, plane, y, x, rows,
    columns)``, strips or tiles."""
    if _TILE_OFFSETS in tags:
        tw, th = _one(tags, _TILE_W), _one(tags, _TILE_H)
        if not tw or not th:
            raise ValueError(f"{name}: tiled TIFF without its tile size")
        offsets, counts = tags[_TILE_OFFSETS], tags.get(_TILE_COUNTS)
        across, down = -(-W // tw), -(-H // th)
        where = [(p, ty * th, tx * tw, th, tw) for p in range(spp if planar == 2 else 1)
                 for ty in range(down) for tx in range(across)]
    elif _STRIP_OFFSETS in tags:
        rps = min(_one(tags, _ROWS_PER_STRIP, H), H) or H
        offsets, counts = tags[_STRIP_OFFSETS], tags.get(_STRIP_COUNTS)
        n = -(-H // rps)
        where = [(p, s * rps, 0, min(rps, H - s * rps), W)
                 for p in range(spp if planar == 2 else 1) for s in range(n)]
    else:
        raise ValueError(f"{name}: TIFF without strip or tile offsets")
    if counts is None or len(offsets) < len(where) or len(counts) < len(where):
        raise ValueError(f"{name}: TIFF with {len(offsets)} chunk offsets and "
                         f"{0 if counts is None else len(counts)} byte counts for "
                         f"{len(where)} chunks")
    return [(offsets[i], counts[i], *w) for i, w in enumerate(where)]


# -- samples ---------------------------------------------------------------------------

def _unpack(raw: np.ndarray, rows: int, cols: int, nsamp: int, bits: int, big: bool):
    """Decompressed chunk bytes -> samples ``(rows, cols, nsamp)``: uint8
    (below 8 bits, each row starting on a byte), or uint16 read in the
    file's byte order."""
    if bits == 16:
        return raw.view(">u2" if big else "<u2").astype(np.uint16).reshape(rows, cols, nsamp)
    if bits == 8:
        return raw.reshape(rows, cols, nsamp)
    rowbytes = (cols * nsamp * bits + 7) // 8
    b = np.unpackbits(raw.reshape(rows, rowbytes), axis=1)[:, :cols * nsamp * bits]
    b = b.reshape(rows, cols * nsamp, bits)
    vals = (b * (1 << np.arange(bits - 1, -1, -1, dtype=np.uint8))).sum(axis=2)
    return vals.astype(np.uint8).reshape(rows, cols, nsamp)


def _decompress(buf: bytes, comp: int, size: int, name: str) -> np.ndarray:
    if comp == 1:
        out = buf
    elif comp == 32773:
        out = _packbits(buf, size)
    else:
        try:
            out = zlib.decompressobj().decompress(buf, size)
        except zlib.error as e:
            raise ValueError(f"{name}: corrupt TIFF Deflate data ({e})") from None
    return np.frombuffer(out, np.uint8)


def _samples(data: bytes, tags, order, name, H, W, bits, spp, comp):
    """The image's samples ``(H, W, spp)``, uint8 or (at 16 bits) uint16."""
    planar = _one(tags, _PLANAR, 1)
    pred = _one(tags, _PREDICTOR, 1) if comp in (5, 8, 32946) else 1
    if pred not in (1, 2) or pred == 2 and bits not in (8, 16):
        raise UnsupportedTIFF(f"{name}: TIFF predictor {pred} at {bits} bits is not supported; "
                              "the horizontal predictor at 8 and 16 bits is")
    nsamp = 1 if planar == 2 else spp
    chunks = _chunks(tags, H, W, spp, planar, name)
    bufs = [data[off:off + count] for off, count, *_ in chunks]
    if comp == 5:
        raws = _lzw_chunks(bufs, name)
    else:
        raws = [_decompress(b, comp, rows * ((cols * nsamp * bits + 7) // 8), name)
                for b, (_, _, _, _, _, rows, cols) in zip(bufs, chunks)]
    dtype = np.uint16 if bits == 16 else np.uint8
    out = np.zeros((H, W, spp), dtype)
    for raw, (off, _, p, y, x, rows, cols) in zip(raws, chunks):
        size = rows * ((cols * nsamp * bits + 7) // 8)
        if len(raw) < size:
            raise ValueError(f"{name}: the TIFF chunk at byte {off} holds {len(raw)} of its "
                             f"{size} bytes")
        s = _unpack(np.ascontiguousarray(raw[:size]), rows, cols, nsamp, bits, order == ">")
        if pred == 2:
            s = np.cumsum(s, axis=1, dtype=dtype)
        h, w = min(rows, H - y), min(cols, W - x)
        if planar == 2:
            out[y:y + h, x:x + w, p] = s[:h, :w, 0]
        else:
            out[y:y + h, x:x + w] = s[:h, :w]
    return out


def _to_rgb(s: np.ndarray, photo: int, bits: int, colormap) -> np.ndarray:
    """Samples -> ``(H, W, 3)`` uint8, as Pillow's mode for them and its
    ``convert("RGB")``."""
    if photo == 3:
        n = 1 << bits
        cmap = np.asarray(colormap, np.int64)
        if len(cmap) < 3 * n:
            raise ValueError(f"palette TIFF with a colormap of {len(cmap)} values for {n} "
                             "colours")
        lut = (cmap[:3 * n].reshape(3, n).T // 256).astype(np.uint8)
        return lut[s[..., 0]]
    if photo == 2:
        return np.ascontiguousarray((s[..., :3] >> 8 if bits == 16 else s[..., :3]).astype(
            np.uint8))
    g = s[..., 0]
    if bits == 16:
        g8 = np.minimum(g, 255).astype(np.uint8)
    else:
        g8 = g * np.uint8(255 // ((1 << bits) - 1))
        if photo == 0:
            g8 = 255 - g8
    return np.repeat(g8[..., None], 3, axis=2)


#: Pillow's ``ImageOps.exif_transpose`` of each orientation
_ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a[::-1, ::-1].transpose(1, 0, 2), 8: lambda a: np.rot90(a, 1)}


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """TIFF bytes -> ``(H, W, 3)`` uint8 RGB of the first image, as
    Pillow's ``Image.open(...).convert("RGB")``.  ``name`` labels the
    errors."""
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        raise UnsupportedTIFF(f"{name}: BigTIFF is not supported; classic TIFF is")
    if not data.startswith(SIGNATURES):
        raise ValueError(f"{name}: not a TIFF file")
    tags, order = _ifd(data, name)
    W, H = _one(tags, _W), _one(tags, _H)
    if not W or not H:
        raise ValueError(f"{name}: TIFF without its image size")
    photo, bits, spp, comp = _kind(tags, order, name)
    if photo == 3 and _COLORMAP not in tags:
        raise ValueError(f"{name}: palette TIFF without a colormap")
    s = _samples(data, tags, order, name, H, W, bits, spp, comp)
    rgb = _to_rgb(s, photo, bits, tags.get(_COLORMAP))
    turn = _ORIENT.get(_one(tags, _ORIENTATION, 1))
    return np.ascontiguousarray(turn(rgb)) if turn else rgb
