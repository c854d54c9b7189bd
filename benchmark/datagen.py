"""The one traffic generator: writes a cell's dataset files from its traffic
file and the run's seed, in each dataset's own layout and file format.

A traffic file (``benchmark/traffic/<name>.json``) lists ``splits``, each
with a ``kind`` (the writer: ``fundus``, ``polyp`` or ``cityscapes_foggy``),
the frame size ``hw`` and the count ``n``, the file ``format`` and, for the
medical splits, the ``json`` and ``images`` paths that the dataset registry
reads.  Every draw comes from the seed, and every seed gives the same sizes,
formats and counts (so the work is the same): only the content moves.

The writers are frozen copies of ``chip_smoke.py``'s (``write_png``,
``write_fundus_split``, ``write_polyp_split``, ``tiff_bytes``,
``lzw_encode``, ``packbits_encode``, ``write_cityscapes_foggy``), changed
where the benchmark needs it: the Cityscapes writer draws each frame's
instance count, and the polyp writer also writes baseline JPEGs
(``jpeg_encode.py``).
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np

from jpeg_encode import encode_jpeg


def write_png(path: str, img: np.ndarray) -> None:
    """``img (H, W, 3)`` uint8 as an RGB PNG (no row filters), with zlib."""
    h, w = img.shape[:2]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    raw = b"".join(b"\0" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


# -- TIFF ---------------------------------------------------------------------

def _lzw_width(k: int) -> int:
    """The code width of the k-th code after a Clear code in TIFF LZW (9 bits
    up to the table's entry 510, then 10, 11 and 12; libtiff's early change)."""
    return 9 if k < 254 else 10 if k < 766 else 11 if k < 1790 else 12


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW of ``data`` (libtiff's ``LZWEncode``): greedy matches, a Clear
    code first and whenever the table fills at 4094 entries, MSB-first codes
    at libtiff's widths, EOI last."""
    codes, ks = [256], [0]
    table, nxt, k = {}, 258, 0
    if data:
        get = table.get
        w = data[0]
        for c in data[1:]:
            key = (w << 8) | c
            v = get(key)
            if v is not None:
                w = v
                continue
            codes.append(w)
            ks.append(k)
            k += 1
            table[key] = nxt
            nxt += 1
            w = c
            if nxt == 4094:
                codes.append(256)
                ks.append(k)
                table.clear()
                nxt, k = 258, 0
        codes.append(w)
        ks.append(k)
        k += 1
    codes.append(257)
    ks.append(k)
    widths = np.array([_lzw_width(x) for x in range(max(ks) + 1)], np.int64)[np.array(ks)]
    start = np.concatenate([[0], np.cumsum(widths)[:-1]])
    j = np.arange(int(widths.sum())) - np.repeat(start, widths)
    bits = (np.repeat(np.array(codes, np.int64), widths) >> (np.repeat(widths, widths) - 1 - j)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def packbits_encode(data: bytes) -> bytes:
    """PackBits (TIFF compression 32773): runs of 3 to 128 equal bytes as a
    repeat, the rest in literal runs of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit) - 1]) + lit
                lit = bytearray()
            out += bytes([257 - (j - i), data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
            if len(lit) == 128:
                out += bytes([127]) + lit
                lit = bytearray()
    if lit:
        out += bytes([len(lit) - 1]) + lit
    return bytes(out)


#: the coders of the TIFF compressions :func:`tiff_bytes` writes, by code
TIFF_CODERS = {1: bytes, 5: lzw_encode, 32773: packbits_encode}


def tiff_bytes(img: np.ndarray, comp: int = 1, pred: int = 1, rps: int = 16) -> bytes:
    """A little-endian classic TIFF of the RGB frame ``img (H, W, 3)`` uint8:
    chunky strips of ``rps`` rows, each coded by compression ``comp``
    (:data:`TIFF_CODERS`) after the horizontal predictor when ``pred`` is 2.
    A field's values stand in its entry when they fit in 4 bytes and out of
    line otherwise."""
    H, W, spp = img.shape
    data = []
    for y in range(0, H, rps):
        c = img[y:y + rps].astype(np.int64)
        if pred == 2:
            c = c.copy()
            c[:, 1:] = (c[:, 1:] - c[:, :-1]) % 256
        data.append(TIFF_CODERS[comp](c.astype(np.uint8).tobytes()))
    body = bytearray(b"II*\x00") + bytearray(4)
    offsets = []
    for d in data:
        offsets.append(len(body))
        body += d
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [8] * spp), (259, 3, [comp]),
               (262, 3, [2]), (273, 4, offsets), (277, 3, [spp]), (278, 3, [rps]),
               (279, 4, [len(d) for d in data]), (284, 3, [1])]
    if pred != 1:
        entries.append((317, 3, [pred]))
    entries.sort()
    fields = []
    for tag, typ, values in entries:
        raw = struct.pack(f"<{len(values)}{ {3: 'H', 4: 'I'}[typ] }", *values)
        if len(raw) > 4:
            body += bytes(len(body) % 2)
            fields.append((tag, typ, len(values), struct.pack("<I", len(body))))
            body += raw
        else:
            fields.append((tag, typ, len(values), raw + bytes(4 - len(raw))))
    body += bytes(len(body) % 2)
    struct.pack_into("<I", body, 4, len(body))
    body += struct.pack("<H", len(fields))
    for tag, typ, n, value in fields:
        body += struct.pack("<HHI", tag, typ, n) + value
    return bytes(body + bytes(4))


def encode_frame(img: np.ndarray, fmt: str) -> tuple[bytes, str]:
    """The bytes of ``img`` in ``fmt`` (``png``, ``jpeg``, ``tiff``,
    ``tiff_lzw``, ``tiff_packbits``) and the file's extension."""
    if fmt == "png":
        return b"", ".png"
    if fmt == "jpeg":
        return encode_jpeg(img), ".jpg"
    if fmt == "tiff":
        return tiff_bytes(img), ".tif"
    if fmt == "tiff_lzw":
        return tiff_bytes(img, comp=5, pred=2), ".tif"
    if fmt == "tiff_packbits":
        return tiff_bytes(img, comp=32773), ".tif"
    raise ValueError(f"unknown frame format {fmt!r}")


def _save(path_stem: str, img: np.ndarray, fmt: str) -> str:
    data, ext = encode_frame(img, fmt)
    path = path_stem + ext
    if fmt == "png":
        write_png(path, img)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return os.path.basename(path)


# -- the medical splits -------------------------------------------------------

def _ring(cx, cy, rx, ry, n: int) -> list:
    t = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    ring = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1).reshape(-1)
    return [[round(float(v), 2) for v in ring]]


def _ann(i: int, image_id: int, cat: int, mask: np.ndarray, seg) -> dict:
    ys, xs = np.nonzero(mask)
    return {"id": i, "image_id": image_id, "category_id": cat, "iscrowd": 0,
            "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                     float(ys.max() - ys.min() + 1)],
            "area": float(mask.sum()), "segmentation": seg}


def fundus_frame(rng, hw, fov, yy, xx):
    """A fundus-like frame: a dark red field of view with an optic disc and
    its cup (two ellipses); returns the frame and the two ellipses'
    ``(cy, cx, ry, rx)``."""
    h, w = hw
    img = np.zeros((h, w, 3), np.float32)
    img[fov] = [140, 55, 25]
    img += rng.normal(0, 6, (h, w, 3)).astype(np.float32) * fov[..., None]
    cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.08, 0.12) * h, rng.uniform(0.07, 0.11) * h
    disc = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    cup = ((yy - cy) / (0.5 * ry)) ** 2 + ((xx - cx) / (0.55 * rx)) ** 2 <= 1
    img[disc] = [225, 165, 85]
    img[cup] = [250, 225, 160]
    return np.clip(img, 0, 255).astype(np.uint8), ((disc, cy, cx, ry, rx),
                                                    (cup, cy, cx, 0.5 * ry, 0.55 * rx))


def polyp_frame(rng, hw, light, yy, xx):
    """A colonoscopy-like frame: a lit pink mucosa with darker folds and one
    polyp, a raised red ellipse with a highlight; returns the frame and the
    polyp's mask and ``(cy, cx, ry, rx)``."""
    h, w = hw
    folds = 0.85 + 0.15 * np.sin(xx / (0.05 * w) + rng.uniform(0, 6)) * np.cos(yy / (0.07 * h))
    img = np.stack([225 * light * folds, 120 * light * folds, 110 * light * folds], -1)
    img += rng.normal(0, 5, (h, w, 3)).astype(np.float32)
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.1, 0.2) * h, rng.uniform(0.1, 0.2) * w
    polyp = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    img[polyp] = img[polyp] * [0.9, 0.55, 0.5] + [20, 0, 0]
    spot = ((yy - cy + 0.4 * ry) / (0.15 * ry)) ** 2 + ((xx - cx) / (0.2 * rx)) ** 2 <= 1
    img[spot] = 245
    return np.clip(img, 0, 255).astype(np.uint8), (polyp, cy, cx, ry, rx)


def write_medical_split(root: str, spec: dict, rng) -> None:
    """One fundus (disc class 1, cup class 2, 96-vertex rings) or polyp
    (class 1, 64-vertex ring) split of ``spec`` under ``root``, in the
    reference's COCO layout: ``spec["json"]`` and the frames under
    ``spec["images"]``."""
    h, w = spec["hw"]
    img_dir = os.path.join(root, spec["images"])
    os.makedirs(img_dir, exist_ok=True)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    fundus = spec["kind"] == "fundus"
    if fundus:
        fov = ((yy - h / 2) / (0.49 * h)) ** 2 + ((xx - w / 2) / (0.49 * h)) ** 2 <= 1
        cats = [{"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]
    else:
        light = 1.0 - 0.55 * (((yy - h / 2) / h) ** 2 + ((xx - w / 2) / w) ** 2)
        cats = [{"id": 1, "name": "polyp"}]
    images, anns = [], []
    for i in range(spec["n"]):
        if fundus:
            img, shapes = fundus_frame(rng, (h, w), fov, yy, xx)
            objs = [(1, shapes[0], 96), (2, shapes[1], 96)]
        else:
            img, shape = polyp_frame(rng, (h, w), light, yy, xx)
            objs = [(1, shape, 64)]
        fname = _save(os.path.join(img_dir, f"f{i:04d}"), img, spec["format"])
        images.append({"id": i, "file_name": fname, "height": h, "width": w})
        for cat, (mask, cy, cx, ry, rx), nv in objs:
            anns.append(_ann(len(anns) + 1, i, cat, mask, _ring(cx, cy, rx, ry, nv)))
    os.makedirs(os.path.dirname(os.path.join(root, spec["json"])), exist_ok=True)
    with open(os.path.join(root, spec["json"]), "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)


# -- foggy Cityscapes -----------------------------------------------------------

#: Cityscapes' 8 thing classes, in the dataset's order
CITYSCAPES_THING_CLASSES = ("person", "rider", "car", "truck", "bus", "train", "motorcycle",
                            "bicycle")


def write_cityscapes_foggy(root: str, spec: dict, rng) -> None:
    """A foggy-Cityscapes split in the dataset's layout under
    ``root/cityscapes_foggy``: ``leftImg8bit/{split}/aachen/*_leftImg8bit_
    foggy_beta_0.02.png`` frames of ``hw`` (a hazy street: road, sky and one
    block per object) and ``gtFine/{split}/aachen/*_gtFine_polygons.json``.
    Each frame holds a number of objects drawn around ``spec["mean_objects"]``
    (Poisson, at least one, at most ``spec["max_objects"]``) of the 8 thing
    classes, with a ``cargroup`` crowd region, a ``deleted`` car and a
    ``sky`` region."""
    h, w = spec["hw"]
    split = spec["split"].rsplit("_", 1)[-1]          # cityscapes_foggy_train -> train
    img_dir = os.path.join(root, "cityscapes_foggy", "leftImg8bit", split, "aachen")
    gt_dir = os.path.join(root, "cityscapes_foggy", "gtFine", split, "aachen")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    yy = np.mgrid[:h, :1][0].astype(np.float32)
    base = np.where(yy < 0.45 * h, 200.0, 90.0 + 40 * yy / h)
    street = np.repeat(np.repeat(base[:, :, None], w, 1), 3, 2)
    for i in range(spec["n"]):
        img = street.copy()
        objs = []
        k = int(np.clip(rng.poisson(spec["mean_objects"]), 1, spec["max_objects"]))
        for _ in range(k):
            name = CITYSCAPES_THING_CLASSES[rng.randint(len(CITYSCAPES_THING_CLASSES))]
            bw, bh = rng.uniform(0.02, 0.1) * w, rng.uniform(0.05, 0.3) * h
            x0, y0 = rng.uniform(0, w - bw), rng.uniform(0.3 * h, 0.95 * h - bh)
            x1, y1 = x0 + bw, y0 + bh
            img[int(y0):int(y1), int(x0):int(x1)] = rng.uniform(20, 160, 3)
            objs.append({"label": name, "polygon": [[x0, y0], [x1, y0], [x1, y1],
                                                    [(x0 + x1) / 2, min(y1 + 8, h - 1)],
                                                    [x0, y1]]})
        objs += [{"label": "cargroup", "polygon": [[0.55 * w, 0.75 * h], [0.95 * w, 0.75 * h],
                                                   [0.95 * w, 0.95 * h], [0.55 * w, 0.95 * h]]},
                 {"label": "car", "deleted": 1, "polygon": [[10, 600], [90, 600], [90, 660]]},
                 {"label": "sky", "polygon": [[0, 0], [w, 0], [w, 0.3 * h], [0, 0.3 * h]]}]
        fog = 0.6 * img + 0.4 * 210 + rng.normal(0, 3, img.shape)
        stem = f"aachen_{i:06d}_000019_"
        write_png(os.path.join(img_dir, stem + "leftImg8bit_foggy_beta_0.02.png"),
                  np.clip(fog, 0, 255).astype(np.uint8))
        with open(os.path.join(gt_dir, stem + "gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)


WRITERS = {"fundus": write_medical_split, "polyp": write_medical_split,
           "cityscapes_foggy": write_cityscapes_foggy}


def write_traffic(root: str, traffic: dict, seed: int) -> None:
    """Every split of ``traffic`` under ``root``, each from its own stream of
    ``seed``."""
    streams = np.random.SeedSequence(seed).spawn(len(traffic["splits"]))
    for spec, ss in zip(traffic["splits"], streams):
        rng = np.random.RandomState(ss.generate_state(1)[0])
        WRITERS[spec["kind"]](root, spec, rng)
