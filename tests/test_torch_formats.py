"""The port's ``load_image`` against the JAX package's (Pillow 12.1.0's
``Image.open(path).convert("RGB")``), bit for bit, on every TIFF, BMP and
JPEG variant the port reads: files Pillow writes, files OpenCV writes
where Pillow cannot (restart markers, 4:1:1 and 4:4:0 chroma), and files
``chip_smoke.py``'s writers build where neither can (big-endian, tiled
and planar TIFF, PackBits and Deflate 32946, the predictor at 16 bits,
the BMP RLE escapes, the V4 and V5 headers, the 16- and 32-bit
bitfields); seeded NumPy images at odd sizes.  Then what stays refused, each with a named error, and the
committed fixtures of ``chip_smoke.py``'s phase 16 against their digests.
Only the tests import Pillow and OpenCV; the port imports neither."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import functools
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
from PIL import Image

import chip_smoke
from ttdg_mgm_torch.data.jpeg import UnsupportedJPEG
from ttdg_mgm_torch.data.loader import load_image
from ttdg_mgm_torch.data.tiff import UnsupportedTIFF
from ttdg_mgm_tpu.data.loader import load_image as jax_load_image

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "fixtures", "torch_formats")
SIZES = ((1, 1), (13, 19), (21, 10))


def _smooth(rng, h, w, ch=3):
    """Photograph-like content: smooth gradients and noise."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / (7 + 3 * c) + y / (11 + c)) for c in range(ch)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


def _same(tmp_path, data: bytes, name: str = "x"):
    """The port's and the JAX package's ``load_image`` on ``data`` agree bit
    for bit."""
    path = tmp_path / name
    path.write_bytes(data)
    want = jax_load_image(str(path))
    got = load_image(str(path))
    assert got.dtype == np.uint8 and got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_array_equal(got, want)


def _saved(im, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


# -- TIFF written here -------------------------------------------------------------

#: ``chip_smoke.py``'s TIFF writer, in strips of 5 rows so that even the
#: small sizes span several
tiff = functools.partial(chip_smoke.tiff_bytes, rps=5)


def _rgb_samples(rng, h, w, bits=8, spp=3):
    if bits == 8:
        return _smooth(rng, h, w, spp).astype(np.int64)
    return rng.integers(0, 1 << bits, (h, w, spp))


LAYOUTS = {"strips": dict(), "tiles": dict(tile=(16, 16)), "planar": dict(planar=2),
           "planar_tiles": dict(planar=2, tile=(16, 32))}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("comp", [1, 32773, 5, 8, 32946])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_tiff_rgb_layouts(tmp_path, order, comp, layout):
    """8-bit RGB in both byte orders, each compression, strips and tiles,
    chunky and planar, at odd sizes (partial strips and tiles)."""
    rng = np.random.default_rng([ord(order), comp, len(layout)])
    for h, w in SIZES + ((37, 53),):
        _same(tmp_path, tiff(_rgb_samples(rng, h, w), 2, 8, order, comp, **LAYOUTS[layout]))


@pytest.mark.parametrize("kind", ["rgb8", "rgb16", "gray16", "gray8"])
@pytest.mark.parametrize("comp", [5, 8])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_tiff_predictor(tmp_path, order, comp, kind):
    """The horizontal predictor at 8 and 16 bits on LZW and Deflate, in
    strips and in planar tiles; 16-bit RGB keeps each sample's high byte,
    16-bit gray is clipped to 255."""
    rng = np.random.default_rng([ord(order), comp, len(kind)])
    bits, spp = (16 if "16" in kind else 8), (3 if "rgb" in kind else 1)
    for h, w in SIZES:
        s = _rgb_samples(rng, h, w, bits, spp)
        if kind == "gray16":
            s = np.where(rng.random(s.shape) < 0.5, s % 300, s)  # both sides of 255
        photo = 2 if spp == 3 else 1
        _same(tmp_path, tiff(s, photo, bits, order, comp, pred=2))
        _same(tmp_path, tiff(s, photo, bits, order, comp, pred=2, planar=2, tile=(16, 16)))


@pytest.mark.parametrize("bits", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("photo", [0, 1], ids=["white_is_zero", "black_is_zero"])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_tiff_gray(tmp_path, order, photo, bits):
    """Bilevel and gray at every depth, WhiteIsZero and BlackIsZero,
    uncompressed and LZW (Pillow opens no big-endian WhiteIsZero 16-bit
    file: that case is a refusal in both)."""
    rng = np.random.default_rng([ord(order), photo, bits])
    for h, w in SIZES:
        s = rng.integers(0, 1 << bits, (h, w, 1))
        for comp in (1, 5):
            data = tiff(s, photo, bits, order, comp)
            if order == ">" and photo == 0 and bits == 16:
                (tmp_path / "x").write_bytes(data)
                with pytest.raises(Exception):
                    jax_load_image(str(tmp_path / "x"))
                with pytest.raises(UnsupportedTIFF, match="WhiteIsZero TIFF with 1 samples"):
                    load_image(str(tmp_path / "x"))
            else:
                _same(tmp_path, data)


@pytest.mark.parametrize("bits", [1, 2, 4, 8])
@pytest.mark.parametrize("order", ["<", ">"], ids=["II", "MM"])
def test_tiff_palette(tmp_path, order, bits):
    """Palette TIFF at 1, 2, 4 and 8 bits with a 16-bit colormap (Pillow
    keeps each entry's high byte), in strips and in tiles."""
    rng = np.random.default_rng([ord(order), bits])
    cmap = rng.integers(0, 65536, 3 * (1 << bits))
    for h, w in SIZES:
        s = rng.integers(0, 1 << bits, (h, w, 1))
        _same(tmp_path, tiff(s, 3, bits, order, 5, colormap=cmap))
        _same(tmp_path, tiff(s, 3, bits, order, 8, tile=(16, 16), colormap=cmap))


EXTRAS = {"rgba": (8, 4, (2,)), "rgbx": (8, 4, (0,)), "rgba_untagged": (8, 4, ()),
          "rgbax": (8, 5, (2, 0)), "rgbxx": (8, 5, (0, 0)), "rgba16": (16, 4, (2,)),
          "rgbx16": (16, 4, (0,)), "gray_alpha": (8, 2, (2,)), "palette_alpha": (8, 2, (2,))}


@pytest.mark.parametrize("kind", sorted(EXTRAS))
def test_tiff_extra_samples(tmp_path, kind):
    """Unassociated, unspecified and untagged extra samples are dropped."""
    bits, spp, extra = EXTRAS[kind]
    rng = np.random.default_rng(len(kind))
    photo = 1 if kind == "gray_alpha" else 3 if kind == "palette_alpha" else 2
    cmap = rng.integers(0, 65536, 768) if photo == 3 else None
    for h, w in SIZES:
        s = _rgb_samples(rng, h, w, bits, spp)
        _same(tmp_path, tiff(s, photo, bits, "<", 8, extra=extra, colormap=cmap))


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation(tmp_path, orientation):
    """The Orientation tag, which Pillow applies when it loads a TIFF."""
    rng = np.random.default_rng(orientation)
    _same(tmp_path, tiff(_rgb_samples(rng, 13, 19), 2, 8, orientation=orientation))


# -- TIFF written by Pillow ----------------------------------------------------------

PILLOW_TIFF_MODES = ["RGB", "L", "1", "P", "I;16", "RGBA", "LA"]


@pytest.mark.parametrize("mode", PILLOW_TIFF_MODES)
@pytest.mark.parametrize("comp", ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate"])
def test_tiff_written_by_pillow(tmp_path, comp, mode):
    """Files Pillow writes (through libtiff when compressed), with the
    horizontal predictor where libtiff applies it (LZW and Deflate at 8 and
    16 bits)."""
    rng = np.random.default_rng(len(mode) + 10 * len(comp))
    for h, w in SIZES + ((37, 53),):
        if mode == "I;16":
            im = Image.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
        elif mode == "P":
            im = Image.fromarray(_smooth(rng, h, w)).quantize(7)
        else:
            im = Image.fromarray(_smooth(rng, h, w)).convert(mode)
        _same(tmp_path, _saved(im, "TIFF", compression=comp))
        if comp in ("tiff_lzw", "tiff_adobe_deflate") and mode != "1":
            _same(tmp_path, _saved(im, "TIFF", compression=comp, tiffinfo={317: 2}))


def test_tiff_lzw_table_resets(tmp_path):
    """An LZW strip long enough to fill the code table several times (Clear
    codes mid-strip, every code width), of incompressible and of flat
    content."""
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (120, 150, 3))
    _same(tmp_path, tiff(noise, 2, 8, comp=5, rps=120))
    _same(tmp_path, _saved(Image.fromarray(noise.astype(np.uint8)), "TIFF",
                           compression="tiff_lzw"))
    _same(tmp_path, tiff(np.zeros((200, 300, 3), np.int64), 2, 8, comp=5, rps=200))


def test_chip_smoke_tiff_and_bmp_writers_read_back_by_pillow(tmp_path):
    """``chip_smoke.py``'s writers as its phases 10 and 16 call them: Pillow
    reads the uncompressed and the LZW TIFF (with the horizontal predictor)
    and the 24-bit BMP back to the array they were given, and so does the
    port."""
    rng = np.random.default_rng(1)
    img = _smooth(rng, 37, 61)
    for data in (chip_smoke.tiff_bytes(img), chip_smoke.tiff_bytes(img, comp=5, pred=2),
                 bmp(61, 37, 24, _rows(img[..., ::-1], 24))):
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")),
                                      img)
        (tmp_path / "x").write_bytes(data)
        np.testing.assert_array_equal(load_image(str(tmp_path / "x")), img)
    frame, _ = chip_smoke.polyp_frame_int((96, 130), 3)
    data = chip_smoke.tiff_bytes(frame, comp=5, pred=2)
    assert Image.open(io.BytesIO(data)).tag_v2[317] == 2
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), frame)


# -- BMP -------------------------------------------------------------------------------

bmp, _rows = chip_smoke.bmp_bytes, chip_smoke.bmp_rows


@pytest.mark.parametrize("mode", ["1", "L", "P", "P4", "RGB", "RGBA"])
def test_bmp_written_by_pillow(tmp_path, mode):
    rng = np.random.default_rng(len(mode))
    for h, w in SIZES + ((33, 65),):
        im = Image.fromarray(_smooth(rng, h, w))
        im = im.quantize(16 if mode == "P4" else 200) if mode.startswith("P") else im.convert(
            mode)
        _same(tmp_path, _saved(im, "BMP", **({"bits": 4} if mode == "P4" else {})))


BITFIELDS = {"565": (16, (0xF800, 0x7E0, 0x1F)), "555": (16, (0x7C00, 0x3E0, 0x1F)),
             "bgr24": (24, (0xFF0000, 0xFF00, 0xFF)),
             **{f"32_{i}": (32, m) for i, m in enumerate([
                 (0xFF0000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0x0),
                 (0xFF000000, 0xFF00, 0xFF, 0x0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                 (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                 (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0x0, 0x0, 0x0, 0x0)])}}


@pytest.mark.parametrize("kind,header", [
    (k, h) for k in sorted(BITFIELDS) for h in (40, 108, 124)
    if h > 40 or len(BITFIELDS[k][1]) == 3 or BITFIELDS[k][1][3] == 0])
def test_bmp_bitfields(tmp_path, kind, header):
    """``BI_BITFIELDS`` at 16, 24 and 32 bits with each mask layout Pillow
    reads, the masks after a 40-byte header (which has no alpha mask) or
    inside a V4 or V5 one."""
    bits, masks = BITFIELDS[kind]
    if header == 40:
        masks = masks[:3]
    rng = np.random.default_rng(bits + header)
    for h, w in SIZES:
        v = rng.integers(0, 65536, (h, w)) if bits == 16 else rng.integers(
            0, 256, (h, w, bits // 8))
        _same(tmp_path, bmp(w, h, bits, _rows(v, bits), 3, masks, header))


@pytest.mark.parametrize("header", [12, 40, 52, 56, 64, 108, 124])
@pytest.mark.parametrize("bits", [16, 24, 32])
def test_bmp_headers_and_depths(tmp_path, bits, header):
    """Uncompressed 16 (5-5-5), 24 and 32 bits under each header size,
    bottom-up and top-down; every 16-bit value once."""
    rng = np.random.default_rng(bits + header)
    for h, w in SIZES + ((256, 256),):
        v = (np.arange(65536).reshape(256, 256)[:h, :w] if bits == 16 and h == 256 else
             rng.integers(0, 65536, (h, w)) if bits == 16 else
             rng.integers(0, 256, (h, w, bits // 8)))
        for top_down in ((False,) if header == 12 else (False, True)):
            rows = _rows(v, bits)
            if top_down:
                stride = len(rows) // h
                rows = b"".join(rows[i * stride:(i + 1) * stride] for i in range(h - 1, -1, -1))
            _same(tmp_path, bmp(w, h, bits, rows, header=header, top_down=top_down))


@pytest.mark.parametrize("palette", ["colour", "short", "gray", "black_white"])
@pytest.mark.parametrize("bits", [1, 4, 8])
def test_bmp_palette(tmp_path, bits, palette):
    """1, 4 and 8 bits with a colour palette, one shorter than the indices,
    and Pillow's gray palettes (dropped, the data then read as 8-bit gray,
    or as 1-bit for black and white, whatever the file's depth: a 4-bit
    file's rows read as 8-bit rows of its width, each running into the
    next)."""
    rng = np.random.default_rng(bits + len(palette))
    n = 1 << bits
    colors = {"colour": n, "short": max(1, n // 2), "gray": n, "black_white": 2}[palette]
    if palette == "gray":
        ent = np.repeat(np.arange(colors)[:, None], 3, 1)
    elif palette == "black_white":
        ent = np.array([[0, 0, 0], [255, 255, 255]])
    else:
        ent = rng.integers(0, 256, (colors, 3))
    pal = np.concatenate([ent[:, ::-1], np.zeros((colors, 1), np.int64)], 1).astype(np.uint8)
    for h, w in ((1, 1), (13, 3), (21, 10)):
        v = rng.integers(0, n, (h, w))
        data = bmp(w, h, bits, _rows(v, bits), palette=pal.tobytes(), colors=colors)
        _same(tmp_path, data)


def _rle_encode(idx: np.ndarray, rle4: bool, rng) -> bytes:
    """RLE8 or RLE4 of index rows ``(h, w)``, bottom-up: runs of one value
    as encoded runs, and at random absolute runs of 3 or more pixels (an
    even count for RLE4) padded to a word; an end of line after each row,
    an end of bitmap at the end."""
    out = bytearray()
    for row in idx[::-1].astype(np.uint8):
        x, w = 0, len(row)
        while x < w:
            same = 1
            while x + same < w and same < 255 and row[x + same] == row[x]:
                same += 1
            n = int(rng.integers(1, min(w - x, 255) + 1))
            if same < 3 and n >= 3 and (not rle4 or n % 2 == 0):
                seg = row[x:x + n]
                body = bytes((seg[0::2] << 4) | seg[1::2]) if rle4 else bytes(seg)
                out += bytes([0, n]) + body + bytes(len(body) % 2)
                x += n
            else:
                v = int(row[x])
                out += bytes([same, v << 4 | v if rle4 else v])
                x += same
        out += b"\x00\x00"
    return bytes(out + b"\x00\x01")


@pytest.mark.parametrize("rle4", [False, True], ids=["rle8", "rle4"])
def test_bmp_rle(tmp_path, rle4):
    """RLE8 and RLE4 with encoded runs, absolute runs and their word
    padding, end of line and end of bitmap, on few-valued rows."""
    rng = np.random.default_rng(rle4)
    bits = 4 if rle4 else 8
    pal = rng.integers(0, 256, (1 << bits, 4)).astype(np.uint8)
    for h, w in SIZES + ((17, 40),):
        idx = rng.integers(0, 3, (h, w)) * 5
        idx[h // 2] = 7                                   # a row of one value
        data = _rle_encode(idx.astype(np.int64), rle4, rng)
        _same(tmp_path, bmp(w, h, bits, data, 2 if rle4 else 1, palette=pal.tobytes()))
        # the port's decode is the image the runs describe
        np.testing.assert_array_equal(load_image(str(tmp_path / "x")),
                                      pal[idx][..., 2::-1])


@pytest.mark.parametrize("case", ["delta", "odd_rle4_absolute", "short_row", "early_end"])
def test_bmp_rle_escapes_as_pillow_reads_them(tmp_path, case):
    """Where Pillow's RLE decoder departs from the format: a delta escape
    (Pillow takes the two bytes after its offsets as the offsets), an odd
    absolute run in RLE4 (Pillow reads one byte short), a row that ends
    before its width, and data that ends before the image (Pillow and the
    port both raise)."""
    pal = np.random.default_rng(7).integers(0, 256, (256, 4)).astype(np.uint8).tobytes()
    w, h = 6, 4
    rle4 = case == "odd_rle4_absolute"
    rows = {
        "delta": b"\x06\x01\x00\x00" + b"\x00\x02\x01\x01\x02\x00" + b"\x04\x03\x00\x00"
                 + b"\x06\x04\x00\x00\x06\x05\x00\x00\x00\x01",
        "odd_rle4_absolute": b"\x00\x03\x12\x30\x03\x45\x00\x00" + b"\x06\x67\x00\x00" * 3
                             + b"\x00\x01",
        "short_row": b"\x02\x09\x00\x00" + b"\x06\x08\x00\x00" * 3 + b"\x00\x01",
        "early_end": b"\x06\x01\x00\x00\x00\x01",
    }[case]
    data = bmp(w, h, 4 if rle4 else 8, rows, 2 if rle4 else 1, palette=pal)
    if case == "early_end":
        (tmp_path / "x").write_bytes(data)
        with pytest.raises(Exception):
            jax_load_image(str(tmp_path / "x"))
        with pytest.raises(ValueError, match="RLE data ends"):
            load_image(str(tmp_path / "x"))
    else:
        _same(tmp_path, data)


# -- JPEG --------------------------------------------------------------------------------

JPEG_SIZES = ((1, 1), (7, 13), (17, 33), (31, 2), (3, 40), (95, 131))


@pytest.mark.parametrize("quality", [50, 90])
@pytest.mark.parametrize("kind", ["420", "422", "444", "gray"])
def test_progressive_jpeg_equals_pillow(tmp_path, kind, quality):
    """Progressive files Pillow writes (libjpeg's scan script: DC first and
    refinement, AC bands with successive approximation), colour at each
    chroma sampling and gray, at odd sizes."""
    rng = np.random.default_rng([len(kind), quality])
    for h, w in JPEG_SIZES:
        im = Image.fromarray(_smooth(rng, h, w))
        if kind == "gray":
            im = im.convert("L")
        sub = {"420": 2, "422": 1, "444": 0, "gray": -1}[kind]
        data = _saved(im, "JPEG", quality=quality, subsampling=sub, progressive=True)
        assert data[2:].find(b"\xff\xc2") >= 0
        _same(tmp_path, data)


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
def test_progressive_jpeg_restart_markers(tmp_path, gray, interval):
    """Progressive files with restart markers every ``interval`` MCUs
    (OpenCV writes them): the end-of-band run restarts with them."""
    rng = np.random.default_rng(interval + 10 * gray)
    for h, w in ((45, 67), (16, 16), (9, 70)):
        img = _smooth(rng, h, w)
        if gray:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                                             cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                                             cv2.IMWRITE_JPEG_QUALITY, 80])
        data = enc.tobytes()
        assert ok and b"\xff\xc2" in data and b"\xff\xd0" in data
        _same(tmp_path, data)


@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
@pytest.mark.parametrize("sampling", ["411", "440"])
def test_jpeg_411_and_440(tmp_path, sampling, progressive):
    """4:1:1 (libjpeg replicates its chroma 4 times across) and 4:4:0 (the
    vertical triangle filter), written by OpenCV, Pillow's 4:1:1 option
    being 4:2:0."""
    rng = np.random.default_rng([int(sampling), progressive])
    factor = {"411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
              "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}[sampling]
    want = {"411": b"\x01\x41", "440": b"\x01\x12"}[sampling]
    for h, w in JPEG_SIZES:
        ok, enc = cv2.imencode(".jpg", _smooth(rng, h, w), [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor, cv2.IMWRITE_JPEG_PROGRESSIVE,
            int(progressive), cv2.IMWRITE_JPEG_QUALITY, 85])
        data = enc.tobytes()
        assert ok and want in data
        _same(tmp_path, data)


@pytest.mark.parametrize("adobe", [True, False], ids=["adobe", "no_marker"])
@pytest.mark.parametrize("progressive", [False, True], ids=["baseline", "progressive"])
def test_cmyk_jpeg(tmp_path, progressive, adobe):
    """CMYK files Pillow writes (Adobe transform 0, inverted samples as
    Photoshop stores them), and the same without the Adobe marker, through
    Pillow's ``CMYK`` -> ``RGB``."""
    rng = np.random.default_rng([progressive, adobe])
    for h, w in JPEG_SIZES:
        cmyk = rng.integers(0, 256, (h, w, 4)).astype(np.uint8)
        data = _saved(Image.frombytes("CMYK", (w, h), cmyk.tobytes()), "JPEG", quality=85,
                      progressive=progressive)
        if not adobe:
            at = data.index(b"\xff\xee")
            data = data[:at] + data[at + 2 + struct.unpack(">H", data[at + 2:at + 4])[0]:]
        _same(tmp_path, data)


# -- what stays refused ------------------------------------------------------------------

def _jpeg_segments(data: bytes):
    """The marker segments of a JPEG up to its first scan, then each scan
    with its entropy-coded data: ``[(marker, bytes)]``."""
    out, pos = [], 2
    while pos < len(data):
        code = data[pos + 1]
        if code == 0xD9:
            break
        (n,) = struct.unpack(">H", data[pos + 2:pos + 4])
        end = pos + 2 + n
        if code == 0xDA:
            j = end
            while not (data[j] == 0xFF and data[j + 1] not in (0,) + tuple(range(0xD0, 0xD8))):
                j += 1
            end = j
        out.append((code, data[pos:end]))
        pos = end
    return out


def test_unrefined_progressive_jpeg_is_refused(tmp_path):
    """A progressive file whose scans leave low coefficient bits unrefined
    (Pillow's file less its refinement scans): libjpeg smooths its blocks,
    which the port does not; it raises naming the case."""
    im = Image.fromarray(_smooth(np.random.default_rng(0), 40, 56))
    data = _saved(im, "JPEG", quality=90, progressive=True)
    kept = [seg for code, seg in _jpeg_segments(data) if code != 0xDA or seg[4 + 2 * seg[4]
                                                                            + 3] >> 4 == 0]
    cut = b"\xff\xd8" + b"".join(kept) + b"\xff\xd9"
    (tmp_path / "u.jpg").write_bytes(cut)
    jax_load_image(str(tmp_path / "u.jpg"))     # Pillow reads it
    with pytest.raises(UnsupportedJPEG, match="u.jpg: progressive JPEG whose scans leave low"):
        load_image(str(tmp_path / "u.jpg"))


def _refusals(tmp_path):
    rng = np.random.default_rng(0)
    rgb = _smooth(rng, 12, 16)
    jpg = _saved(Image.fromarray(rgb), "JPEG")
    cmyk = _saved(Image.fromarray(rgb).convert("CMYK"), "JPEG")
    at = cmyk.index(b"Adobe") + 11
    bmp24 = bmp(4, 2, 24, bytes(24))
    return {
        "jpeg_arithmetic": (jpg.replace(b"\xff\xc0", b"\xff\xc9", 1), UnsupportedJPEG,
                            "arithmetic-coded sequential JPEG"),
        "jpeg_lossless": (jpg.replace(b"\xff\xc0", b"\xff\xc3", 1), UnsupportedJPEG,
                          "lossless JPEG"),
        "jpeg_12_bit": (jpg.replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc1\x00\x11\x0c", 1),
                        UnsupportedJPEG, "12-bit JPEG"),
        "jpeg_ycck": (cmyk[:at] + b"\x02" + cmyk[at + 1:], UnsupportedJPEG, "YCCK JPEG"),
        "tiff_jpeg": (_saved(Image.fromarray(rgb), "TIFF", compression="jpeg"), UnsupportedTIFF,
                      "JPEG-in-TIFF"),
        "tiff_cmyk": (_saved(Image.fromarray(rgb).convert("CMYK"), "TIFF"), UnsupportedTIFF,
                      "CMYK TIFF"),
        "tiff_ycbcr": (tiff(rgb.astype(np.int64), 6, 8), UnsupportedTIFF, "YCbCr TIFF"),
        "tiff_float": (_saved(Image.fromarray(rgb[..., 0].astype(np.float32)), "TIFF"),
                       UnsupportedTIFF, "floating-point samples"),
        "tiff_premultiplied": (tiff(_rgb_samples(rng, 5, 6, 8, 4), 2, 8, extra=(1,)),
                               UnsupportedTIFF, "associated"),
        "tiff_ccitt": (_saved(Image.fromarray(rgb).convert("1"), "TIFF",
                              compression="group4"), UnsupportedTIFF, "CCITT Group 4"),
        "bigtiff": (b"II+\x00\x08\x00\x00\x00" + bytes(16), ValueError, "BigTIFF"),
        "bmp_jpeg": (bmp24[:30] + b"\x04" + bmp24[31:], ValueError, "BMP with JPEG compression"),
        "bmp_masks": (bmp(4, 2, 32, bytes(32), 3, (0xF00, 0xF0, 0xF)), ValueError,
                      "BMP bitfields"),
        "gif": (_saved(Image.fromarray(rgb), "GIF"), ValueError, "GIF image format"),
        "webp": (b"RIFF\x00\x00\x00\x00WEBPVP8 " + bytes(16), ValueError, "WebP image format"),
        "jpeg2000": (b"\x00\x00\x00\x0cjP  \r\n\x87\n" + bytes(16), ValueError,
                     "JPEG 2000 image format"),
    }


REFUSALS = ["jpeg_arithmetic", "jpeg_lossless", "jpeg_12_bit", "jpeg_ycck", "tiff_jpeg",
            "tiff_cmyk", "tiff_ycbcr", "tiff_float", "tiff_premultiplied", "tiff_ccitt",
            "bigtiff", "bmp_jpeg", "bmp_masks", "gif", "webp", "jpeg2000"]


@pytest.mark.parametrize("case", REFUSALS)
def test_what_stays_refused_is_named(tmp_path, case):
    """Each variant that stays refused raises ``ValueError`` (its format's
    own subclass where it has one) naming the file and the variant."""
    data, err, what = _refusals(tmp_path)[case]
    path = tmp_path / f"{case}.img"
    path.write_bytes(data)
    with pytest.raises(err, match=f"{case}.img: .*{what}"):
        load_image(str(path))


# -- the committed fixtures of chip_smoke.py's phase 16 ------------------------------------

def test_formats_fixtures_match_their_digests(tmp_path):
    """Every file phase 16 decodes: the committed JPEGs (progressive, CMYK,
    4:1:1) and the LZW TIFF frames ``chip_smoke.write_formats_data`` writes,
    decoded by Pillow and by the port, against ``digests.json``; the
    fixtures stay small and the annotations name the split's files."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        digests = json.load(f)
    files = chip_smoke.write_formats_data(str(tmp_path))
    files.update({k: os.path.join(FIXTURES, k) for k in chip_smoke.FORMATS_TIMED})
    assert sorted(files) == sorted(digests)
    for key, path in files.items():
        with Image.open(path) as im:
            assert chip_smoke.image_digest(np.asarray(im.convert("RGB"))) == digests[key], key
        assert chip_smoke.image_digest(load_image(path)) == digests[key], key
    with Image.open(os.path.join(FIXTURES, "k0.jpg")) as im:
        assert im.info.get("progressive") and im.size == (720, 576)
    with open(os.path.join(FIXTURES, "annotations.json")) as f:
        ann = json.load(f)
    assert [i["file_name"] for i in ann["images"]] == list(chip_smoke.FORMATS_JPEG[1])
    size = sum(os.path.getsize(os.path.join(FIXTURES, f)) for f in os.listdir(FIXTURES))
    assert size < 600 * 1024
