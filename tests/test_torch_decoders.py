"""The port's host decoders against Pillow and OpenCV, bit for bit: the
bilinear resize (``data/resample.py``), the polygon fill
(``utils/polyfill.py``), every PNG variant (``data/png.py``) and the
JPEG decoder (``data/jpeg.py``), on files Pillow (or OpenCV, for restart
markers) writes here, and on the committed JPEG fixtures; the other formats
and variants are in ``tests/test_torch_formats.py``.  Only the tests import
Pillow and OpenCV; the port imports neither."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import io
import os
import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from ttdg_mgm_torch.data.jpeg import UnsupportedJPEG, decode_jpeg
from ttdg_mgm_torch.data.loader import load_image
from ttdg_mgm_torch.data.png import decode_png
from ttdg_mgm_torch.data.resample import resize_bilinear
from ttdg_mgm_torch.utils.polyfill import fill_poly
from ttdg_mgm_torch.utils.rle import polygons_to_mask

HERE = os.path.dirname(os.path.abspath(__file__))
JPEG_FIXTURES = os.path.join(HERE, "fixtures", "torch_jpeg")


def _smooth(rng, h, w, ch=3):
    """Photograph-like content (smooth gradients and noise): JPEG blocks with
    many nonzero coefficients, still compressible."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / (7 + 3 * c) + y / (11 + c)) for c in range(ch)], -1)
    return np.clip(base + rng.normal(0, 25, base.shape), 0, 255).astype(np.uint8)


# -- the bilinear resize ---------------------------------------------------------

RESIZE_CASES = [((37, 53), (20, 31)), ((20, 31), (37, 53)), ((64, 48), (64, 17)),
                ((64, 48), (9, 48)), ((5, 7), (1, 1)), ((1, 1), (3, 4)), ((33, 65), (32, 90)),
                ((97, 13), (41, 13))]


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("src,dst", RESIZE_CASES)
def test_resize_equals_pillow(src, dst, mode):
    """Down- and upscales, one-axis changes and degenerate sizes, on random
    uint8 RGB and ``L`` images."""
    rng = np.random.default_rng(hash((src, dst, mode)) % 2 ** 32)
    img = rng.integers(0, 256, src + ((3,) if mode == "RGB" else ()), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((dst[1], dst[0]), Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, dst), want)


def test_resize_drishti_size_equals_pillow():
    """2896 x 1944 (a Drishti-GS image) to 800 x 1192, the test geometry."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (1944, 2896, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize((1192, 800), Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, (800, 1192)), want)


# -- the polygon fill ------------------------------------------------------------

def _rings(kind, rng, h, w):
    n = int(rng.integers(3, 9))
    if kind == "convex":
        t = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(2, min(h, w))
        c = rng.uniform(0, [w, h])
        return [np.round(np.stack([c[0] + r * np.cos(t), c[1] + r * np.sin(t)], 1))]
    if kind == "concave":
        return [np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)]
    if kind == "self_touching":
        p = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
        return [np.concatenate([p, p[:2], p[::-1]])]
    if kind == "overlapping":
        return [np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1) for _ in range(3)]
    if kind == "horizontal_edges":
        xs, ys = rng.integers(-3, w + 3, n), rng.integers(-3, h + 3, n)
        return [np.stack([xs, np.repeat(ys[::2], 2)[:n]], 1)]
    # off the canvas
    return [np.stack([rng.integers(-w, 2 * w, n), rng.integers(-h, 2 * h, n)], 1)
            for _ in range(2)]


@pytest.mark.parametrize("kind", ["convex", "concave", "self_touching", "overlapping",
                                  "horizontal_edges", "off_canvas"])
def test_fill_poly_equals_opencv(kind):
    """200 random ring sets of each kind, on small canvases, against
    ``cv2.fillPoly`` with the default 8-connected line type."""
    rng = np.random.default_rng(["convex", "concave", "self_touching", "overlapping",
                                 "horizontal_edges", "off_canvas"].index(kind))
    for _ in range(200):
        h, w = (int(v) for v in rng.integers(5, 60, 2))
        rings = [r.astype(np.int32) for r in _rings(kind, rng, h, w)]
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, rings, 1)
        got = fill_poly(np.zeros((h, w), np.uint8), rings, 1)
        np.testing.assert_array_equal(got, want, err_msg=str([r.tolist() for r in rings]))


def test_polygons_to_mask_equals_the_jax_rasterizer():
    """``utils/rle.py:polygons_to_mask`` on float COCO rings at a Drishti-GS
    image's size (disc and cup as two overlapping rings, the cup a hole, as
    OpenCV fills them) equals the JAX package's cv2 version."""
    from ttdg_mgm_tpu.utils.rle import polygons_to_mask as j_polygons_to_mask

    t = np.linspace(0, 2 * np.pi, 97, endpoint=False)
    disc = np.stack([1448.3 + 300.7 * np.cos(t), 972.1 + 280.2 * np.sin(t)], 1).reshape(-1)
    cup = np.stack([1460.6 + 150.3 * np.cos(t), 980.4 + 140.9 * np.sin(t)], 1).reshape(-1)
    rings = [disc.tolist(), cup.tolist(), [5.0, 5.0, 9.0]]  # the last too short: dropped
    np.testing.assert_array_equal(polygons_to_mask(rings, 1944, 2896),
                                  j_polygons_to_mask(rings, 1944, 2896))


# -- PNG ---------------------------------------------------------------------------

ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_rows(samples, depth, rng):
    """Scanlines of ``samples (h, w, ch)`` at ``depth`` bits, each with a
    random one of the five filters."""
    h, w, ch = samples.shape
    flat = samples.reshape(h, -1).astype(np.uint16)
    if depth == 16:
        b = np.empty((h, w * ch * 2), np.uint8)
        b[:, 0::2], b[:, 1::2] = flat >> 8, flat & 255
    elif depth == 8:
        b = flat.astype(np.uint8)
    else:
        bits = ((flat[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
        bits = np.concatenate([bits, np.zeros((h, (-bits.shape[1]) % 8), np.uint16)], 1)
        b = np.packbits(bits.astype(np.uint8), axis=1)
    bpp = max(1, ch * depth // 8)
    out, prev = [], np.zeros(b.shape[1], np.int32)
    for y in range(h):
        row = b[y].astype(np.int32)
        f = int(rng.integers(0, 5))
        left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if f == 1:
            row_f = row - left
        elif f == 2:
            row_f = row - prev
        elif f == 3:
            row_f = row - ((left + prev) >> 1)
        elif f == 4:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            row_f = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, ul))
        else:
            row_f = row
        out.append(bytes([f]) + (row_f & 255).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def _png(samples, depth, ctype, rng, interlace=0, palette=None):
    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    h, w = samples.shape[:2]
    if interlace:
        data = b"".join(_png_rows(samples[y0::dy, x0::dx], depth, rng)
                        for x0, y0, dx, dy in ADAM7
                        if samples[y0::dy, x0::dx].size)
    else:
        data = _png_rows(samples, depth, rng)
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0,
                                                            0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b"")


PNG_VARIANTS = [(0, d) for d in (1, 2, 4, 8, 16)] + [(2, 8), (2, 16)] + \
    [(3, d) for d in (1, 2, 4, 8)] + [(4, 8), (4, 16), (6, 8), (6, 16)]


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("ctype,depth", PNG_VARIANTS)
def test_png_variant_equals_pillow(ctype, depth, interlace):
    """Every colour type and bit depth, plain and Adam7-interlaced, every
    filter, odd sizes (a palette shorter than its indices included):
    ``decode_png`` equals Pillow's ``convert("RGB")``."""
    rng = np.random.default_rng(16 * ctype + depth + 100 * interlace)
    for h, w in ((1, 1), (7, 13), (19, 10)):
        samples = rng.integers(0, 1 << depth, (h, w, CHANNELS[ctype]))
        palette = None
        if ctype == 3:
            palette = rng.integers(0, 256, (max(1, (1 << depth) - 1), 3))
        data = _png(samples, depth, ctype, rng, interlace, palette)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("mode", ["1", "L", "LA", "I;16", "P;1", "P;2", "P;4", "P;8", "RGB",
                                  "RGBA"])
def test_png_written_by_pillow(mode):
    """Files Pillow itself writes, in each mode it writes PNG in."""
    rng = np.random.default_rng(0)
    arr = _smooth(rng, 23, 37)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 65536, (23, 37)).astype(np.uint16))
    elif mode.startswith("P"):
        im = Image.fromarray(arr).quantize(colors=1 << int(mode[2:]))
    else:
        im = Image.fromarray(arr).convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG", **({"bits": int(mode[2:])} if mode.startswith("P") else {}))
    data = buf.getvalue()
    np.testing.assert_array_equal(decode_png(data),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


# -- JPEG --------------------------------------------------------------------------

@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_equals_pillow(quality, subsampling, gray):
    """Files Pillow writes at each quality and chroma subsampling, gray and
    colour, at odd sizes (partial MCUs, chroma rows of 1 and 2 samples)."""
    rng = np.random.default_rng(quality + 10 * subsampling + 100 * gray)
    for h, w in ((1, 1), (7, 13), (17, 33), (31, 2), (3, 40), (95, 131)):
        im = Image.fromarray(_smooth(rng, h, w))
        if gray:
            im = im.convert("L")
        buf = io.BytesIO()
        im.save(buf, format="JPEG", quality=quality, subsampling=subsampling)
        data = buf.getvalue()
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_jpeg(data), want, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("interval", [1, 3])
@pytest.mark.parametrize("gray", [False, True], ids=["colour", "gray"])
def test_jpeg_restart_markers_equal_pillow(interval, gray):
    """Restart markers every ``interval`` MCUs (OpenCV writes them; Pillow
    cannot), decoded by Pillow as the reference."""
    rng = np.random.default_rng(interval + 10 * gray)
    img = _smooth(rng, 45, 67)
    if gray:
        img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
    ok, enc = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_RST_INTERVAL, interval,
                                         cv2.IMWRITE_JPEG_QUALITY, 80])
    data = enc.tobytes()
    assert ok and b"\xff\xdd" in data and b"\xff\xd0" in data
    np.testing.assert_array_equal(decode_jpeg(data),
                                  np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def test_progressive_jpeg_equals_pillow(tmp_path):
    """A progressive file (the one that raised before the progressive
    decoder) read by ``load_image`` equals Pillow's decode; the variants are
    held in ``tests/test_torch_formats.py``."""
    path = tmp_path / "prog.jpg"
    Image.fromarray(_smooth(np.random.default_rng(0), 20, 20)).save(
        path, format="JPEG", progressive=True)
    np.testing.assert_array_equal(load_image(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("name", ["p0.jpg", "p1.jpg", "p2.jpg"])
def test_committed_jpeg_fixtures_equal_pillow(name):
    """The committed baseline 4:2:0 JPEGs of 1280 x 959 (BKAI's size) that
    the card's command-line run reads."""
    path = os.path.join(JPEG_FIXTURES, name)
    im = Image.open(path)
    assert im.size == (1280, 959) and not im.info.get("progressive")
    np.testing.assert_array_equal(load_image(path), np.asarray(im.convert("RGB")))


@pytest.mark.parametrize("fmt", ["TIFF", "BMP"])
def test_load_image_reads_tiff_and_bmp(tmp_path, fmt):
    """The files that raised before the TIFF and BMP decoders equal
    Pillow's decode."""
    path = tmp_path / f"x.{fmt.lower()}"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(path, format=fmt)
    np.testing.assert_array_equal(load_image(str(path)),
                                  np.asarray(Image.open(path).convert("RGB")))


@pytest.mark.parametrize("kind", ["sof9", "jpeg_in_tiff", "gif"])
def test_load_image_names_what_stays_refused(tmp_path, kind):
    """An arithmetic-coded JPEG header, a JPEG-in-TIFF file and a GIF raise
    ``ValueError`` naming the file and the variant."""
    img = Image.fromarray(_smooth(np.random.default_rng(1), 8, 8))
    path = tmp_path / f"x.{kind}"
    if kind == "sof9":
        buf = io.BytesIO()
        img.save(buf, format="JPEG")
        path.write_bytes(buf.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1))
        err, what = UnsupportedJPEG, "arithmetic-coded sequential JPEG"
    elif kind == "jpeg_in_tiff":
        img.save(path, format="TIFF", compression="jpeg")
        err, what = ValueError, "JPEG-in-TIFF"
    else:
        img.save(path, format="GIF")
        err, what = ValueError, "GIF image format"
    with pytest.raises(err, match=f"x.{kind}: .*{what}"):
        load_image(str(path))
