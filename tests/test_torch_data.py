"""The port's data layer against the JAX package's: the PNG decoder against
Pillow, the RLE codec, the dataset registry and COCO parsing, the resize,
and ``prepare_sample`` / ``pack_batch`` / ``build_test_loader`` on the
shifted-target images of ``scripts/demo_tta_gain.py`` and on a rectangular
dataset under ``canvas="auto"``."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import io
import json
import os
import struct
import sys
import zlib

import numpy as np
import pytest
from PIL import Image

from ttdg_mgm_tpu.data import builtin as jbuiltin
from ttdg_mgm_tpu.data import coco as jcoco
from ttdg_mgm_tpu.data import loader as jloader
from ttdg_mgm_tpu.data import transforms as jtransforms
from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_tpu.data.catalog import MetadataCatalog as JMeta
from ttdg_mgm_tpu.utils import rle as jrle
from ttdg_mgm_torch.data import builtin as tbuiltin
from ttdg_mgm_torch.data import coco as tcoco
from ttdg_mgm_torch.data import loader as tloader
from ttdg_mgm_torch.data import transforms as ttransforms
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.data.catalog import MetadataCatalog as TMeta
from ttdg_mgm_torch.data.png import decode_png
from ttdg_mgm_torch.utils import rle as trle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
from demo_tta_gain import make_shifted_target  # noqa: E402

from demo_config import DEMO  # noqa: E402


def _image(h, w, ch, seed):
    rng = np.random.RandomState(seed)
    ramp = np.add.outer(np.arange(h), 2 * np.arange(w))[..., None] * 3
    arr = (ramp + rng.randint(0, 40, (h, w, ch))).astype(np.uint8)
    return arr[..., 0] if ch == 1 else arr


def _png_bytes(arr, filters, rng):
    """A PNG of ``arr`` written here with a filter type drawn per row from
    ``filters`` (Pillow picks its own)."""
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    px = arr.reshape(h, w * ch).astype(np.int32)
    rows = []
    for y in range(h):
        k = int(rng.choice(filters))
        cur = px[y]
        up = px[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][k]
        rows.append(bytes([k]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
    ctype = {1: 0, 3: 2, 4: 6}[ch]

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _pillow_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


@pytest.mark.parametrize("size", [(1, 1), (5, 3), (17, 31), (64, 47)])
@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_decoder_matches_pillow(mode, size):
    """Images written by Pillow (its own choice of filters): bit for bit."""
    arr = _image(*size, {"L": 1, "RGB": 3, "RGBA": 4}[mode], seed=size[0])
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    data = buf.getvalue()
    got = decode_png(data)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, _pillow_rgb(data))


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4), (0, 1, 2)],
                         ids=lambda f: "filters" + "".join(map(str, f)))
@pytest.mark.parametrize("ch", [1, 3, 4])
def test_png_decoder_each_filter_type(ch, filters):
    """Every scanline filter, alone and mixed row by row: bit for bit."""
    rng = np.random.RandomState(ch * 10 + len(filters))
    data = _png_bytes(_image(23, 19, ch, seed=ch), filters, rng)
    np.testing.assert_array_equal(decode_png(data), _pillow_rgb(data))


def test_load_image_matches_jax(tmp_path):
    """PNG (palette included) and baseline JPEG through the port's own
    decoders, no Pillow: as the JAX package loads them with Pillow."""
    arr = _image(20, 30, 3, seed=3)
    paths = []
    for name, img in (("a.png", Image.fromarray(arr)), ("b.jpg", Image.fromarray(arr)),
                      ("c.png", Image.fromarray(arr).convert("P"))):
        img.save(tmp_path / name)
        paths.append(str(tmp_path / name))
    with open(paths[2], "rb") as f:
        np.testing.assert_array_equal(decode_png(f.read()),
                                      np.asarray(Image.open(paths[2]).convert("RGB")))
    for p in paths:
        np.testing.assert_array_equal(tloader.load_image(p), jloader.load_image(p))


@pytest.mark.parametrize("seed", range(4))
def test_rle_codec_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = rng.randint(1, 60, 2)
    mask = (rng.rand(h, w) < [0.0, 0.3, 0.7, 1.0][seed]).astype(np.uint8)
    enc = trle.rle_encode(mask)
    assert enc == jrle.rle_encode(mask)
    np.testing.assert_array_equal(trle.rle_decode(enc), jrle.rle_decode(enc))
    np.testing.assert_array_equal(trle.rle_decode(enc), mask)
    counts = trle._decode_counts_string(enc["counts"])
    assert counts == jrle._decode_counts_string(enc["counts"])
    for segm in (enc, {"size": [int(h), int(w)], "counts": counts}):
        np.testing.assert_array_equal(trle.segmentation_to_mask(segm, h, w),
                                      jrle.segmentation_to_mask(segm, h, w))


def test_polygons_to_mask_matches_jax():
    polys = [[2.2, 3.1, 30.7, 5.0, 20.5, 25.9], [40, 40, 50, 41, 45, 55, 39, 50]]
    np.testing.assert_array_equal(trle.segmentation_to_mask(polys, 60, 70),
                                  jrle.segmentation_to_mask(polys, 60, 70))


@pytest.mark.parametrize("hw", [(2896, 1944), (1944, 2896), (576, 720), (800, 1192), (64, 64),
                                (333, 1000), (1000, 333)])
def test_resize_matches_jax(hw):
    h, w = hw
    for short, cap in ((800, 1333), (64, 64), (128, 128)):
        assert (ttransforms.resize_shortest_edge_size(h, w, short, cap)
                == jtransforms.resize_shortest_edge_size(h, w, short, cap))
    if h * w <= 800 * 1192:
        img = _image(h, w, 3, seed=1)
        got, gs = ttransforms.resize_shortest_edge(img, 800, 1333)
        want, ws = jtransforms.resize_shortest_edge(img, 800, 1333)
        np.testing.assert_array_equal(got, want)
        assert gs == ws


def test_registry_and_coco_json_match_jax(tmp_path, monkeypatch):
    assert tbuiltin.SPLITS == jbuiltin.SPLITS
    assert tbuiltin.FAMILIES == jbuiltin.FAMILIES
    jp, img_dir = make_shifted_target(str(tmp_path), 3, size=64, seed=5)
    assert tcoco.load_coco_json(jp, img_dir) == jcoco.load_coco_json(jp, img_dir)
    root = str(tmp_path / "root")
    for mod, cat in ((tbuiltin, TCatalog), (jbuiltin, JCatalog)):
        monkeypatch.setattr(mod, "_registered", False)
        for name in mod.SPLITS:
            cat.remove(name)
        mod.register_all_medical(root)
    try:
        for name in tbuiltin.SPLITS:
            assert TMeta.get(name) == JMeta.get(name)
            assert name in TCatalog.list()
    finally:
        for name in tbuiltin.SPLITS:
            TCatalog.remove(name)
            JCatalog.remove(name)


def _register(name, jp, img_dir):
    for cat, reg in ((TCatalog, tcoco.register_coco_instances),
                     (JCatalog, jcoco.register_coco_instances)):
        cat.remove(name)
        reg(name, jp, img_dir)


def _rect_dataset(root):
    """Three rectangular images of other sizes (one needs a resize under
    (800, 1333), one not), polygon GT."""
    img_dir = os.path.join(root, "img")
    os.makedirs(img_dir)
    images, anns = [], []
    for i, (h, w) in enumerate(((200, 300), (800, 1192), (160, 238))):
        Image.fromarray(_image(h, w, 3, seed=i)).save(os.path.join(img_dir, f"r{i}.png"))
        images.append({"id": i, "file_name": f"r{i}.png", "height": h, "width": w})
        anns.append({"id": i + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
                     "bbox": [10.0, 12.0, 50.0, 40.0],
                     "segmentation": [[10, 12, 60, 12, 60, 52, 10, 52]]})
    jp = os.path.join(root, "rect.json")
    with open(jp, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "disc"}]}, f)
    return jp, img_dir


def _assert_same_sample(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("case", ["shifted_square", "shifted_auto", "rect_auto"])
def test_loader_matches_jax(tmp_path, case):
    """``prepare_sample``, ``pack_batch`` (with and without GT) and
    ``build_test_loader`` (batch 4 over 3 or 16 records: the last batch
    repeats its final sample): identical arrays and metas."""
    if case == "rect_auto":
        jp, img_dir = _rect_dataset(str(tmp_path))
        canvas, min_size, max_size = "auto", 800, 1333
    else:
        jp, img_dir = make_shifted_target(str(tmp_path), DEMO["test_images"] - 2,
                                          size=DEMO["size"], seed=DEMO["seed"],
                                          blur=DEMO["blur"], brightness=DEMO["brightness"])
        size = DEMO["size"]
        canvas = size if case == "shifted_square" else "auto"
        min_size = max_size = size
    name = f"_loader_{case}"
    _register(name, jp, img_dir)
    try:
        recs = TCatalog.get(name)
        kw = dict(canvas=None if canvas == "auto" else canvas, min_size=min_size,
                  max_size=max_size)
        ts = [tloader.prepare_sample(r, **kw) for r in recs]
        js = [jloader.prepare_sample(r, **kw) for r in recs]
        for a, b in zip(ts, js):
            _assert_same_sample(a, b)
        # the flip of the training loaders, on one record
        _assert_same_sample(tloader.prepare_sample(recs[0], flip=True, **kw),
                            jloader.prepare_sample(recs[0], flip=True, **kw))
        cv = (tloader.canvas_bucket(max(s["image"].shape[0] for s in ts)),
              tloader.canvas_bucket(max(s["image"].shape[1] for s in ts)))
        assert cv == (jloader.canvas_bucket(cv[0]), jloader.canvas_bucket(cv[1]))
        _assert_same_sample(tloader.pack_batch(ts, canvas=cv, gt_cap=4, mask_res=64),
                            jloader.pack_batch(js, canvas=cv, gt_cap=4, mask_res=64))
        tl = list(tloader.build_test_loader(name, batch_size=4, canvas=canvas,
                                            min_size=min_size, max_size=max_size))
        jl = list(jloader.build_test_loader(name, batch_size=4, canvas=canvas,
                                            min_size=min_size, max_size=max_size))
        assert len(tl) == len(jl) == -(-len(recs) // 4)
        for (tb, tm), (jb, jm) in zip(tl, jl):
            _assert_same_sample(tb, jb)
            assert len(tm) == len(jm) == 4
            for a, b in zip(tm, jm):
                _assert_same_sample(a, b)
        if case == "rect_auto":
            assert tl[0][0]["image"].shape == (4, 832, 1216, 3)
            assert tl[0][1][0]["n_real"] == 3
    finally:
        TCatalog.remove(name)
        JCatalog.remove(name)


def test_rle_ground_truth_passes_the_test_path(tmp_path):
    """RLE segmentations stay in original-image coordinates through
    ``prepare_sample`` (the JAX package's ``scale_annotations`` raises on
    them) and the batch is the one polygon GT gives."""
    jp, img_dir = _rect_dataset(str(tmp_path))
    with open(jp) as f:
        coco = json.load(f)
    for a, im in zip(coco["annotations"], coco["images"]):
        m = trle.segmentation_to_mask(a["segmentation"], im["height"], im["width"])
        a["segmentation"] = trle.rle_encode(m)
    jp_rle = os.path.join(str(tmp_path), "rect_rle.json")
    with open(jp_rle, "w") as f:
        json.dump(coco, f)
    poly = tcoco.load_coco_json(jp, img_dir)
    rle = tcoco.load_coco_json(jp_rle, img_dir)
    for p, r in zip(poly, rle):
        a = tloader.prepare_sample(p, canvas=None)
        b = tloader.prepare_sample(r, canvas=None)
        assert b["polygons"] == [x["segmentation"] for x in r["annotations"]]
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["boxes"], b["boxes"])
    with pytest.raises(ValueError):
        jloader.prepare_sample(rle[0], canvas=None)
