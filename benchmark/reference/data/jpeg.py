"""A JPEG decoder in Python and NumPy, equal to Pillow's.

:func:`decode_jpeg` returns the ``(H, W, 3)`` uint8 RGB array that
``PIL.Image.open(path).convert("RGB")`` (Pillow 12.1.0) gives, bit for bit,
on sequential (SOF0, or SOF1 at 8 bits) and progressive (SOF2) Huffman-coded
JPEG files with 8-bit samples: one component (gray), three (YCbCr, or RGB
when an Adobe marker or the component ids say so) or four (CMYK: Adobe
transform 0, or no Adobe marker), chroma sampled 4:4:4, 4:2:2, 4:2:0,
4:4:0 or 4:1:1, with or without restart markers.  It follows libjpeg-turbo,
which Pillow links, at its defaults:

* progressive scans as ``jdphuff.c`` decodes them (DC first and
  refinement, AC first and refinement with end-of-band runs and successive
  approximation), each adding to the component's coefficient array;
* the integer "islow" inverse DCT of ``jidctint.c`` (13-bit constants, two
  passes with 2 extra bits between them) and its output range-limit table,
  which wraps as libjpeg's does;
* "fancy" chroma upsampling (``jdsample.c``: ``h2v1_fancy_upsample``,
  ``h2v2_fancy_upsample`` and ``h1v2_fancy_upsample``, triangle weights 3/4
  and 1/4 per axis, edges replicated; plain replication when a chroma row
  is at most 2 samples, and ``int_upsample``'s replication for 4:1:1);
* the fixed-point YCbCr -> RGB tables of ``jdcolor.c`` (16 fraction bits);
  CMYK samples inverted (Pillow's ``CMYK;I``, the Adobe convention) and
  converted by Pillow's ``cmyk2rgb``.

Arithmetic-coded, lossless, hierarchical and 12-bit files, YCCK (Adobe
transform 2), other chroma samplings, and progressive files whose scans
leave low coefficient bits unrefined (where libjpeg smooths the blocks,
``jdcoefct.c``, not ported) raise :class:`UnsupportedJPEG` naming the file
and the variant; nothing falls back to another decoder.  The Huffman
decoding runs in Python over a table of 16-bit prefixes, one symbol at a
time; dequantisation, the inverse DCT (all blocks at once), the upsampling
and the colour conversion are NumPy.
"""

from __future__ import annotations

import array
import re
import struct

import numpy as np

SIGNATURE = b"\xff\xd8\xff"

#: position in the 8x8 block (row-major) of each zigzag index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
    27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
    51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_SOF_NAMES = {0xC3: "lossless", 0xC5: "differential sequential",
              0xC6: "differential progressive", 0xC7: "differential lossless",
              0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
              0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential",
              0xCE: "arithmetic-coded differential progressive",
              0xCF: "arithmetic-coded differential lossless"}


class UnsupportedJPEG(ValueError):
    pass


# -- entropy decoding ----------------------------------------------------------

def _huffman_lut(counts, symbols):
    """A table over every 16-bit prefix: ``length << 8 | symbol`` of the code
    that starts it, or 0 where no code does."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo:lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _segments(data: bytes, start: int):
    """The entropy-coded segments of the scan starting at ``start``, split at
    restart markers and unstuffed, and the offset of the marker that ends
    the scan."""
    segs, pos = [], start
    for m in re.finditer(rb"\xff+([^\x00\xff])", data[start:]):
        code = m.group(1)[0]
        end = start + m.start()
        segs.append(data[pos:end].replace(b"\xff\x00", b"\xff"))
        pos = start + m.end()
        if not 0xD0 <= code <= 0xD7:
            return segs, end
    raise ValueError("JPEG scan without an end marker")


def _windows(seg: bytes):
    """For each byte offset of ``seg``, the 64 bits starting there (zeros
    past its end), as Python ints."""
    b = np.frombuffer(seg + b"\x00" * 24, np.uint8).astype(np.uint64)
    n = len(seg) + 16
    w = np.zeros(n, np.uint64)
    for i in range(8):
        w |= b[i:i + n] << np.uint64(56 - 8 * i)
    return w.tolist()


def _decode_scan(segments, comps, mcus, blocks_of, restart: int):
    """Huffman-decode one scan into each component's coefficient array
    (``comp["coef"]``, an ``array('i')`` of 64 zigzag-ordered entries per
    block).  ``mcus`` is the MCU count, ``blocks_of(mcu)`` the list of
    ``(component, block index)`` the MCU holds, in order."""
    per_seg = restart if restart else mcus
    mcu = 0
    for seg in segments:
        if mcu >= mcus:
            break
        W = _windows(seg)
        nbits = 8 * len(seg)
        pos = 0
        preds = [0] * len(comps)
        for _ in range(min(per_seg, mcus - mcu)):
            for ci, blk in blocks_of(mcu):
                c = comps[ci]
                dc_lut, ac_lut, coef = c["dc_lut"], c["ac_lut"], c["coef"]
                base = blk * 64
                # DC
                w = W[pos >> 3]
                e = dc_lut[(w >> (48 - (pos & 7))) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG data: bad Huffman code")
                pos += e >> 8
                s = e & 0xFF
                diff = 0
                if s:
                    w = W[pos >> 3]
                    v = (w >> (64 - s - (pos & 7))) & ((1 << s) - 1)
                    pos += s
                    diff = v if v >> (s - 1) else v - (1 << s) + 1
                preds[ci] += diff
                coef[base] = preds[ci]
                # AC
                k = 1
                while k < 64:
                    w = W[pos >> 3]
                    e = ac_lut[(w >> (48 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("corrupt JPEG data: bad Huffman code")
                    pos += e >> 8
                    rs = e & 0xFF
                    s = rs & 15
                    r = rs >> 4
                    if s:
                        k += r
                        w = W[pos >> 3]
                        v = (w >> (64 - s - (pos & 7))) & ((1 << s) - 1)
                        pos += s
                        if k < 64:
                            coef[base + k] = v if v >> (s - 1) else v - (1 << s) + 1
                        k += 1
                    elif r == 15:
                        k += 16
                    else:
                        break
            mcu += 1
        if pos > nbits + 64:
            raise ValueError("corrupt JPEG data: scan runs past its segment")


def _decode_progressive_scan(segments, comps, mcus, blocks_of, restart: int, ss: int, se: int,
                             ah: int, al: int):
    """Huffman-decode one scan of a progressive file into the coefficient
    arrays, as ``jdphuff.c`` does: a DC first scan (the DC difference
    shifted left by ``al``), a DC refinement scan (one bit per block), an
    AC first scan of the band ``ss..se`` with end-of-band runs, or an AC
    refinement scan (a new coefficient of value +-2**al per coded symbol,
    and a correction bit for each coefficient already nonzero that the
    symbol's zero run or the end-of-band run passes).  ``blocks_of`` and
    ``mcus`` as in :func:`_decode_scan`; the DC predictors and the
    end-of-band run restart at each restart marker."""
    per_seg = restart if restart else mcus
    p1, m1 = 1 << al, -1 << al
    mcu = 0
    for seg in segments:
        if mcu >= mcus:
            break
        W = _windows(seg)
        nbits = 8 * len(seg)
        pos = 0
        preds = [0] * len(comps)
        eobrun = 0
        for _ in range(min(per_seg, mcus - mcu)):
            for ci, blk in blocks_of(mcu):
                c = comps[ci]
                coef = c["coef"]
                base = blk * 64
                if ss == 0 and ah == 0:          # DC first
                    w = W[pos >> 3]
                    e = c["dc_lut"][(w >> (48 - (pos & 7))) & 0xFFFF]
                    if not e:
                        raise ValueError("corrupt JPEG data: bad Huffman code")
                    pos += e >> 8
                    s = e & 0xFF
                    diff = 0
                    if s:
                        w = W[pos >> 3]
                        v = (w >> (64 - s - (pos & 7))) & ((1 << s) - 1)
                        pos += s
                        diff = v if v >> (s - 1) else v - (1 << s) + 1
                    preds[ci] += diff
                    coef[base] = preds[ci] << al
                elif ss == 0:                    # DC refinement
                    if (W[pos >> 3] >> (63 - (pos & 7))) & 1:
                        coef[base] |= p1
                    pos += 1
                elif ah == 0:                    # AC first
                    if eobrun:
                        eobrun -= 1
                        continue
                    ac_lut = c["ac_lut"]
                    k = ss
                    while k <= se:
                        w = W[pos >> 3]
                        e = ac_lut[(w >> (48 - (pos & 7))) & 0xFFFF]
                        if not e:
                            raise ValueError("corrupt JPEG data: bad Huffman code")
                        pos += e >> 8
                        r, s = (e & 0xFF) >> 4, e & 15
                        if s:
                            k += r
                            w = W[pos >> 3]
                            v = (w >> (64 - s - (pos & 7))) & ((1 << s) - 1)
                            pos += s
                            if k < 64:
                                coef[base + k] = (v if v >> (s - 1) else v - (1 << s) + 1) << al
                            k += 1
                        elif r == 15:
                            k += 16
                        else:
                            eobrun = 1 << r
                            if r:
                                w = W[pos >> 3]
                                eobrun += (w >> (64 - r - (pos & 7))) & ((1 << r) - 1)
                                pos += r
                            eobrun -= 1
                            break
                else:                            # AC refinement
                    ac_lut = c["ac_lut"]
                    k = ss
                    if not eobrun:
                        while k <= se:
                            w = W[pos >> 3]
                            e = ac_lut[(w >> (48 - (pos & 7))) & 0xFFFF]
                            if not e:
                                raise ValueError("corrupt JPEG data: bad Huffman code")
                            pos += e >> 8
                            r, s = (e & 0xFF) >> 4, e & 15
                            if s:
                                s = p1 if (W[pos >> 3] >> (63 - (pos & 7))) & 1 else m1
                                pos += 1
                            elif r != 15:
                                eobrun = 1 << r
                                if r:
                                    w = W[pos >> 3]
                                    eobrun += (w >> (64 - r - (pos & 7))) & ((1 << r) - 1)
                                    pos += r
                                break
                            # pass the nonzero coefficients (a correction bit
                            # each) and r zero ones
                            while k <= se:
                                v = coef[base + k]
                                if v:
                                    if (W[pos >> 3] >> (63 - (pos & 7))) & 1 and not v & p1:
                                        coef[base + k] = v + (p1 if v >= 0 else m1)
                                    pos += 1
                                else:
                                    if r == 0:
                                        break
                                    r -= 1
                                k += 1
                            if s and k < 64:
                                coef[base + k] = s
                            k += 1
                    if eobrun:
                        # the rest of the band: a correction bit per nonzero
                        # coefficient, consecutive bits
                        nz = [i for i, v in enumerate(coef[base + k:base + se + 1]) if v]
                        n = len(nz)
                        if n:
                            if n <= 56:
                                bits = (W[pos >> 3] >> (64 - n - (pos & 7))) & ((1 << n) - 1)
                            else:  # two reads: a window holds 57 bits from any bit
                                h, q = n - 32, pos + 32
                                bits = ((W[pos >> 3] >> (32 - (pos & 7))) & 0xFFFFFFFF) << h \
                                    | (W[q >> 3] >> (64 - h - (q & 7))) & ((1 << h) - 1)
                            for j, i in enumerate(nz):
                                if bits >> (n - 1 - j) & 1:
                                    v = coef[base + k + i]
                                    if not v & p1:
                                        coef[base + k + i] = v + (p1 if v >= 0 else m1)
                            pos += n
                        eobrun -= 1
            mcu += 1
        if pos > nbits + 64:
            raise ValueError("corrupt JPEG data: scan runs past its segment")


# -- inverse DCT (jidctint.c) ------------------------------------------------------

_F = dict(c0_298631336=2446, c0_390180644=3196, c0_541196100=4433, c0_765366865=6270,
          c0_899976223=7373, c1_175875602=9633, c1_501321110=12299, c1_847759065=15137,
          c1_961570560=16069, c2_053119869=16819, c2_562915447=20995, c3_072711026=25172)
CONST_BITS, PASS1_BITS = 13, 2


def _idct_1d(x, shift: int):
    """One pass of ``jpeg_idct_islow`` over axis -2 of ``x`` (8 rows):
    returns the 8 outputs, each ``(sum + 2**(shift-1)) >> shift``."""
    f = _F
    z2, z3 = x[..., 2, :], x[..., 6, :]
    z1 = (z2 + z3) * f["c0_541196100"]
    tmp2 = z1 + z3 * -f["c1_847759065"]
    tmp3 = z1 + z2 * f["c0_765366865"]
    tmp0 = (x[..., 0, :] + x[..., 4, :]) << CONST_BITS
    tmp1 = (x[..., 0, :] - x[..., 4, :]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[..., 7, :], x[..., 5, :], x[..., 3, :], x[..., 1, :]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * f["c1_175875602"]
    t0 = t0 * f["c0_298631336"]
    t1 = t1 * f["c2_053119869"]
    t2 = t2 * f["c3_072711026"]
    t3 = t3 * f["c1_501321110"]
    z1 = z1 * -f["c0_899976223"]
    z2 = z2 * -f["c2_562915447"]
    z3 = z3 * -f["c1_961570560"] + z5
    z4 = z4 * -f["c0_390180644"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    r = 1 << (shift - 1)
    outs = [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]
    return np.stack([(o + r) >> shift for o in outs], axis=-2)


def _range_limit(v):
    """libjpeg's post-IDCT range-limit table, indexed by ``v & 1023``: ``v +
    128`` clipped to 0..255 for ``-384 <= v < 384``, wrapping beyond."""
    t = v & 1023
    return np.where(t < 128, t + 128, np.where(t < 512, 255, np.where(t < 896, 0, t - 896)))


def idct_islow(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Blocks ``(..., 64)`` of zigzag-ordered quantised coefficients and the
    zigzag-ordered table ``qt (64,)`` -> ``(..., 8, 8)`` uint8 samples, as
    ``jpeg_idct_islow``."""
    deq = np.zeros(coef.shape, np.int64)
    deq[..., ZIGZAG] = coef.astype(np.int64) * qt.astype(np.int64)
    x = deq.reshape(*coef.shape[:-1], 8, 8)           # [row u][column v]
    ws = _idct_1d(x, CONST_BITS - PASS1_BITS)          # columns: over rows u
    out = _idct_1d(np.swapaxes(ws, -1, -2), CONST_BITS + PASS1_BITS + 3)
    return _range_limit(np.swapaxes(out, -1, -2)).astype(np.uint8)


# -- upsampling (jdsample.c) and colour (jdcolor.c) -----------------------------

def _fancy_h2(cols):
    """``h2v1_fancy_upsample`` along the last axis of int arrays: ``(3 *
    nearer + further + 1 or 2) >> 2``, edges replicated."""
    left = np.concatenate([cols[..., :1], cols[..., :-1]], axis=-1)
    right = np.concatenate([cols[..., 1:], cols[..., -1:]], axis=-1)
    out = np.empty(cols.shape[:-1] + (2 * cols.shape[-1],), np.int64)
    out[..., 0::2] = (3 * cols + left + 1) >> 2
    out[..., 1::2] = (3 * cols + right + 2) >> 2
    return out


def _fancy_h2v2(p):
    """``h2v2_fancy_upsample``: column sums ``3 * nearer row + further row``,
    then ``(3 * nearer sum + further sum + 8 or 7) >> 4``, edges
    replicated."""
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    rows = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    rows[0::2] = 3 * p + up
    rows[1::2] = 3 * p + down
    left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int64)
    out[:, 0::2] = (3 * rows + left + 8) >> 4
    out[:, 1::2] = (3 * rows + right + 7) >> 4
    return out


def _fancy_v2(p):
    """``h1v2_fancy_upsample``: ``(3 * nearer row + further row + 1 or 2)
    >> 2``, edge rows replicated."""
    up = np.concatenate([p[:1], p[:-1]], axis=0)
    down = np.concatenate([p[1:], p[-1:]], axis=0)
    out = np.empty((2 * p.shape[0], p.shape[1]), np.int64)
    out[0::2] = (3 * p + up + 1) >> 2
    out[1::2] = (3 * p + down + 2) >> 2
    return out


#: the upsampling factors read: (1, 1), the fancy (2, 1), (2, 2) and (1, 2)
#: (4:4:0), and (4, 1) (4:1:1), which libjpeg's ``int_upsample`` replicates
_UPSAMPLED = ((1, 1), (2, 1), (2, 2), (1, 2), (4, 1))


def _upsample(plane: np.ndarray, fh: int, fv: int) -> np.ndarray:
    p = plane.astype(np.int64)
    if (fh, fv) == (1, 1):
        return p
    if (fh, fv) == (1, 2):
        return _fancy_v2(p)
    if (fh, fv) == (4, 1) or p.shape[1] <= 2:  # libjpeg replicates narrow chroma
        return np.repeat(np.repeat(p, fv, axis=0), fh, axis=1)
    if (fh, fv) == (2, 1):
        return _fancy_h2(p)
    return _fancy_h2v2(p)


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * 65536 + 0.5)  # noqa: E731 - libjpeg's FIX()
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """``ycc_rgb_convert``: int planes -> ``(H, W, 3)`` uint8."""
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def cmyk_to_rgb(c, m, y, k) -> np.ndarray:
    """Pillow's ``CMYK`` -> ``RGB`` (``cmyk2rgb`` of ``libImaging/Convert.c``):
    each channel ``255 - k`` less ``MULDIV255(ink, 255 - k)``, clipped."""
    nk = 255 - k

    def chan(v):
        t = v * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255)

    return np.stack([chan(c), chan(m), chan(y)], axis=-1).astype(np.uint8)


# -- markers -------------------------------------------------------------------------

def _read_markers(data: bytes, name: str):
    """Parse the markers up to and through the scans: returns the frame, the
    quantisation tables and each scan's components, tables and segments."""
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{name}: not a JPEG file")
    pos, qts, dc, ac = 2, {}, {}, {}
    frame, restart, adobe, jfif, scans = None, 0, None, False, []
    while pos < len(data):
        if data[pos] != 0xFF:
            raise ValueError(f"{name}: corrupt JPEG marker at byte {pos}")
        while pos < len(data) and data[pos] == 0xFF:
            pos += 1
        code = data[pos]
        pos += 1
        if code == 0xD9:
            break
        if code in (0x01,) or 0xD0 <= code <= 0xD7:
            continue
        (length,) = struct.unpack(">H", data[pos:pos + 2])
        body = data[pos + 2:pos + length]
        pos += length
        if code in _SOF_NAMES or code == 0xCC:
            kind = _SOF_NAMES.get(code, "arithmetic-coded")
            raise UnsupportedJPEG(f"{name}: {kind} JPEG (SOF marker 0x{code:02X}) is not "
                                  "supported; sequential and progressive Huffman JPEG are")
        if code in (0xC0, 0xC1, 0xC2):
            prec, H, W, nc = struct.unpack(">BHHB", body[:6])
            if prec != 8:
                raise UnsupportedJPEG(f"{name}: {prec}-bit JPEG is not supported (8-bit only)")
            if nc not in (1, 3, 4):
                raise UnsupportedJPEG(f"{name}: JPEG with {nc} components is not supported; "
                                      "gray, 3-component colour and CMYK are")
            comps = []
            for i in range(nc):
                cid, hv, tq = body[6 + 3 * i:9 + 3 * i]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = dict(H=H, W=W, comps=comps, progressive=code == 0xC2)
        elif code == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                fmt = ">64H" if pq else "64B"
                qts[tq] = np.array(struct.unpack(fmt, body[i + 1:i + 1 + n]), np.int64)
                i += 1 + n
        elif code == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1:i + 17])
                syms = list(body[i + 17:i + 17 + sum(counts)])
                (ac if tc else dc)[th] = _huffman_lut(counts, syms)
                i += 17 + sum(counts)
        elif code == 0xDD:
            (restart,) = struct.unpack(">H", body[:2])
        elif code == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif code == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif code == 0xDA:
            if frame is None:
                raise ValueError(f"{name}: JPEG scan before its frame header")
            ns = body[0]
            sel = []
            for i in range(ns):
                cid, t = body[1 + 2 * i:3 + 2 * i]
                ci = next((k for k, c in enumerate(frame["comps"]) if c["id"] == cid), None)
                if ci is None:
                    raise ValueError(f"{name}: JPEG scan of an unknown component {cid}")
                sel.append((ci, dc.get(t >> 4), ac.get(t & 15)))
            ss, se, a = body[1 + 2 * ns:4 + 2 * ns]
            segs, end = _segments(data, pos)
            scans.append(dict(comps=sel, segments=segs, restart=restart, ss=ss, se=se,
                              ah=a >> 4, al=a & 15))
            pos = end
    if frame is None or not scans:
        raise ValueError(f"{name}: JPEG without a frame or a scan")
    # libjpeg's colour space of a 3-component file: YCbCr under JFIF, else
    # the Adobe transform flag, else RGB for the component ids "R", "G", "B"
    ids = tuple(c["id"] for c in frame["comps"])
    rgb = not jfif and (adobe == 0 if adobe is not None else ids == (82, 71, 66))
    if len(ids) == 4 and adobe not in (None, 0):
        # libjpeg reads every other Adobe transform of 4 components as YCCK
        raise UnsupportedJPEG(f"{name}: YCCK JPEG (Adobe transform {adobe}) is not supported; "
                              "CMYK (transform 0) is")
    return frame, qts, scans, rgb


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes -> ``(H, W, 3)`` uint8 RGB, as Pillow's
    ``Image.open(...).convert("RGB")``.  ``name`` labels the errors."""
    frame, qts, scans, rgb = _read_markers(data, name)
    H, W, comps = frame["H"], frame["W"], frame["comps"]
    progressive = frame["progressive"]
    hmax = max(c["h"] for c in comps)
    vmax = max(c["v"] for c in comps)
    mx, my = -(-W // (8 * hmax)), -(-H // (8 * vmax))
    for c in comps:
        if (hmax // c["h"], vmax // c["v"]) not in _UPSAMPLED or \
                hmax % c["h"] or vmax % c["v"]:
            raise UnsupportedJPEG(f"{name}: chroma sampling {[(d['h'], d['v']) for d in comps]}"
                                  " is not supported; 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1 are")
        c["bw"], c["bh"] = mx * c["h"], my * c["v"]
        c["cw"], c["ch"] = -(-W * c["h"] // hmax), -(-H * c["v"] // vmax)
        c["coef"] = array.array("i", bytes(4 * 64 * c["bw"] * c["bh"]))
        c["coef_bits"] = [-1] * 64        # the last scan's Al of each coefficient
    for scan in scans:
        sel = scan["comps"]
        ss, se, ah, al = scan["ss"], scan["se"], scan["ah"], scan["al"]
        if not progressive:
            ss, se, ah, al = 0, 63, 0, 0
        elif ss > se or se > 63 or ss == 0 and se != 0 or ss > 0 and len(sel) != 1:
            raise ValueError(f"{name}: invalid progressive JPEG scan (Ss {ss}, Se {se}, "
                             f"{len(sel)} components)")
        for ci, dlut, alut in sel:
            if (ss == 0 and ah == 0 and dlut is None) or (se > 0 and alut is None):
                raise ValueError(f"{name}: JPEG scan without its Huffman table")
            comps[ci]["dc_lut"], comps[ci]["ac_lut"] = dlut, alut
            comps[ci]["coef_bits"][ss:se + 1] = [al] * (se + 1 - ss)
        order = [ci for ci, _, _ in sel]
        sub = [comps[ci] for ci in order]
        if len(sel) == 1:
            c = sub[0]
            nbx, nby = -(-c["cw"] // 8), -(-c["ch"] // 8)

            def blocks_of(m, nbx=nbx, bw=c["bw"]):
                return ((0, (m // nbx) * bw + m % nbx),)

            mcus = nbx * nby
        else:
            layout = [(k, dy, dx) for k, c in enumerate(sub)
                      for dy in range(c["v"]) for dx in range(c["h"])]

            def blocks_of(m, layout=layout, sub=sub):
                ym, xm = divmod(m, mx)
                return [(k, (ym * sub[k]["v"] + dy) * sub[k]["bw"] + xm * sub[k]["h"] + dx)
                        for k, dy, dx in layout]

            mcus = mx * my
        if progressive:
            _decode_progressive_scan(scan["segments"], sub, mcus, blocks_of, scan["restart"],
                                     ss, se, ah, al)
        else:
            _decode_scan(scan["segments"], sub, mcus, blocks_of, scan["restart"])
    if progressive and any(b != 0 for c in comps for b in c["coef_bits"][1:10]):
        # libjpeg then smooths the blocks' low frequencies (jdcoefct.c,
        # decompress_smooth_data), which is not ported
        left = {c["id"]: c["coef_bits"][:10] for c in comps if any(c["coef_bits"][1:10])}
        raise UnsupportedJPEG(f"{name}: progressive JPEG whose scans leave low coefficient bits "
                              f"unrefined (the last Al of coefficients 0-9 by component: {left}) "
                              "is not supported: libjpeg's block smoothing would apply")
    planes = []
    for c in comps:
        coef = np.frombuffer(c["coef"], np.int32).reshape(c["bh"], c["bw"], 64)
        if c["tq"] not in qts:
            raise ValueError(f"{name}: JPEG without quantisation table {c['tq']}")
        px = idct_islow(coef, qts[c["tq"]])              # (bh, bw, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(8 * c["bh"], 8 * c["bw"])[:c["ch"], :c["cw"]]
        planes.append(_upsample(plane, hmax // c["h"], vmax // c["v"])[:H, :W])
    if len(planes) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if len(planes) == 4:
        return cmyk_to_rgb(*(255 - p for p in planes))   # Pillow's "CMYK;I" raw mode
    if rgb:
        return np.stack(planes, axis=-1).astype(np.uint8)
    return ycc_to_rgb(*planes)
