"""The test path on image files as the datasets ship them, against the JAX
package's own loader and evaluator: a split of baseline JPEGs (4:2:0 and
4:4:4, odd sizes) and of PNG images that need a resize, a split of TIFF
frames (LZW with the horizontal predictor, uncompressed, Deflate, PackBits)
and a split of progressive JPEGs (4:2:0, 4:4:4, gray, CMYK), with polygon
ground truth.  ``build_test_loader`` gives the same batches and metas, and
``evaluate_dataset`` the same Dice, E and S (to 1e-9) as the JAX
``build_test_loader`` and ``evaluate_dataset`` fed the same detections (a
fixed detector, the same arithmetic in both packages)."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ttdg_mgm_tpu.data import coco as jcoco
from ttdg_mgm_tpu.data import loader as jloader
from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_tpu.engine import trainer as jtrainer
from ttdg_mgm_torch.data import coco as tcoco
from ttdg_mgm_torch.data import loader as tloader
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.engine import trainer as ttrainer

MIN_SIZE, MAX_SIZE = 96, 160
#: (file, height, width, how it is written)
FILES = [("a.jpg", 111, 150, dict(quality=85, subsampling=2)),
         ("b.jpg", 97, 131, dict(quality=60, subsampling=0)),
         ("c.png", 290, 193, {}), ("d.png", 64, 200, {})]
#: the splits of the formats the datasets ship besides PNG and baseline JPEG
FORMAT_FILES = {
    "tiff": [("e.tif", 288, 384, dict(compression="tiff_lzw", tiffinfo={317: 2})),
             ("f.tif", 97, 131, dict(compression="raw")),
             ("g.tif", 230, 171, dict(compression="tiff_adobe_deflate", tiffinfo={317: 2})),
             ("h.tif", 64, 200, dict(compression="packbits"))],
    "progressive": [("i.jpg", 111, 150, dict(quality=85, subsampling=2, progressive=True)),
                    ("j.jpg", 290, 193, dict(quality=75, subsampling=0, progressive=True)),
                    ("k.jpg", 97, 131, dict(quality=90, progressive=True, mode="L")),
                    ("l.jpg", 64, 200, dict(quality=90, progressive=True, mode="CMYK"))],
}


def _write_split(root, files=FILES, name="split.json"):
    rng = np.random.RandomState(0)
    images, anns = [], []
    for i, (name_i, h, w, kw) in enumerate(files):
        kw = dict(kw)
        mode = kw.pop("mode", "RGB")
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([120 + 60 * np.sin(xx / 9.0 + c) + 40 * np.cos(yy / 13.0)
                        for c in range(3)], -1) + rng.normal(0, 8, (h, w, 3))
        cy, cx, ry, rx = 0.47 * h, 0.53 * w, 0.23 * h, 0.31 * w
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] *= 0.6
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).convert(mode).save(
            os.path.join(root, name_i), **kw)
        t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
        disc = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1).reshape(-1)
        cup = np.stack([cx + 0.4 * rx * np.cos(t), cy + 0.5 * ry * np.sin(t)], 1).reshape(-1)
        images.append({"id": i, "file_name": name_i, "height": h, "width": w})
        for cat, ring in ((1, disc), (2, cup)):
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat, "iscrowd": 0,
                         "bbox": [float(ring[0::2].min()), float(ring[1::2].min()),
                                  float(np.ptp(ring[0::2])), float(np.ptp(ring[1::2]))],
                         "segmentation": [[round(float(v), 3) for v in ring]]})
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]}, f)
    return path


@pytest.fixture()
def split(tmp_path):
    name = "_real_images_split"
    path = _write_split(str(tmp_path))
    for cat, reg in ((TCatalog, tcoco.register_coco_instances),
                     (JCatalog, jcoco.register_coco_instances)):
        cat.remove(name)
        reg(name, path, str(tmp_path), evaluator_type="dice")
    yield name
    TCatalog.remove(name)
    JCatalog.remove(name)


@pytest.fixture()
def format_splits(tmp_path):
    """The TIFF and progressive-JPEG splits of ``FORMAT_FILES``, registered
    in both packages."""
    names = []
    for kind, files in FORMAT_FILES.items():
        name = f"_real_images_{kind}"
        path = _write_split(str(tmp_path), files, f"{kind}.json")
        for cat, reg in ((TCatalog, tcoco.register_coco_instances),
                         (JCatalog, jcoco.register_coco_instances)):
            cat.remove(name)
            reg(name, path, str(tmp_path), evaluator_type="dice")
        names.append(name)
    yield names
    for name in names:
        TCatalog.remove(name)
        JCatalog.remove(name)


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert a[k] == b[k], k


def test_loader_on_jpeg_and_resized_png_matches_jax(split, format_splits):
    """Decode (JPEG without Pillow, PNG, TIFF, progressive JPEG), resize and
    pad: the same batches and metas as the JAX loader, which runs Pillow,
    on each split."""
    kw = dict(batch_size=2, canvas="auto", min_size=MIN_SIZE, max_size=MAX_SIZE)
    for name in (split, *format_splits):
        tl = list(tloader.build_test_loader(name, **kw))
        jl = list(jloader.build_test_loader(name, **kw))
        assert len(tl) == len(jl) == 2, name
        for (tb, tm), (jb, jm) in zip(tl, jl):
            _same(tb, jb)
            for a, b in zip(tm, jm):
                _same(a, b)
        assert any(m["scale"] != (1.0, 1.0) for _, ms in tl for m in ms), name


# a fixed detector: three detections per image from its valid size, the
# same float32 arithmetic in both packages
FRACS = np.array([[0.13, 0.21, 0.71, 0.83], [0.301, 0.287, 0.6377, 0.6611],
                  [0.05, 0.05, 0.5, 0.5]], np.float32)
SCORES = np.array([0.95, 0.91, 0.97], np.float32)
CLASSES = np.array([0, 1, 0], np.int32)
VALID = np.array([True, True, False])


def _mask_probs():
    yy, xx = np.mgrid[:28, :28]
    disc = (((yy - 13.3) / 9.1) ** 2 + ((xx - 14.2) / 11.7) ** 2 <= 1).astype(np.float32)
    return np.stack([0.05 + 0.9 * disc, 0.05 + 0.9 * disc.T, np.full((28, 28), 0.9)]).astype(
        np.float32)


class _PortDetector(torch.nn.Module):
    mask_on = True

    def __init__(self):
        super().__init__()
        self.dummy = torch.nn.Parameter(torch.zeros(()))

    def forward_inference(self, images, sizes):
        B = images.shape[0]
        hw = sizes.to(torch.float32)
        scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
        boxes = torch.from_numpy(FRACS)[None] * scale[:, None, :]
        rep = lambda a: torch.from_numpy(a)[None].expand(B, *a.shape).clone()  # noqa: E731
        return {"boxes": boxes, "scores": rep(SCORES), "classes": rep(CLASSES),
                "valid": rep(VALID), "mask_probs": rep(_mask_probs())}


class _JaxDetector:
    mask_on = True

    def forward_inference(self):
        pass

    def apply(self, variables, images, sizes, method=None):
        B = images.shape[0]
        hw = sizes.astype(jnp.float32)
        scale = jnp.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
        boxes = jnp.asarray(FRACS)[None] * scale[:, None, :]
        rep = lambda a: jnp.broadcast_to(jnp.asarray(a)[None], (B, *a.shape))  # noqa: E731
        return {"boxes": boxes, "scores": rep(SCORES), "classes": rep(CLASSES),
                "valid": rep(VALID), "mask_probs": rep(_mask_probs())}


def test_evaluate_dataset_on_real_files_matches_jax(split, format_splits):
    """Dice, E and S over each split, every detection scored: the port's
    ``evaluate_dataset`` (NumPy decoders, its paste, its polygon fill)
    against the JAX package's (Pillow, its paste, OpenCV) on the same
    detections, to 1e-9."""
    kw = dict(batch_size=2, canvas="auto", min_size=MIN_SIZE, max_size=MAX_SIZE,
              dice_threshold=0.0)
    for name in (split, *format_splits):
        got = ttrainer.evaluate_dataset(_PortDetector(), name, **kw)
        with jax.default_device(jax.devices("cpu")[0]):
            want = jtrainer.evaluate_dataset(_JaxDetector(), {}, name, **kw)
        assert got.keys() == want.keys() and len(got) == 3, name
        for k in want:
            assert np.isfinite(want[k])
            assert got[k] == pytest.approx(want[k], abs=1e-9), (name, k)


def test_pack_batch_rle_mask_resize_equals_pillow(split):
    """RLE ground truth (the JAX loader raises on it) rasterized onto the
    batch's mask grid by ``pack_batch``: the full-size mask resized as the
    port did with Pillow, ``Image.resize(..., BILINEAR) > 127``, now by
    ``data/resample.py``, bit for bit."""
    from ttdg_mgm_torch.utils.rle import rle_encode, segmentation_to_mask

    recs = TCatalog.get(split)
    for r in recs:
        for a in r["annotations"]:
            a["segmentation"] = rle_encode(segmentation_to_mask(a["segmentation"], r["height"],
                                                                r["width"]))
    samples = [tloader.prepare_sample(r, canvas=None, min_size=MIN_SIZE, max_size=MAX_SIZE)
               for r in recs]
    mask_res = 64
    canvas = (tloader.canvas_bucket(max(s["image"].shape[0] for s in samples)),
              tloader.canvas_bucket(max(s["image"].shape[1] for s in samples)))
    got = tloader.pack_batch(samples, canvas=canvas, gt_cap=4, mask_res=mask_res)["gt_masks"]
    for b, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        for k, seg in enumerate(s["polygons"]):
            full = segmentation_to_mask(seg, s["orig_height"], s["orig_width"])
            m = np.asarray(Image.fromarray(full * 255).resize(
                (int(round(w * mask_res / canvas[1])), int(round(h * mask_res / canvas[0]))),
                Image.BILINEAR)) > 127
            want = np.zeros((mask_res, mask_res), np.uint8)
            want[:m.shape[0], :m.shape[1]] = m
            np.testing.assert_array_equal(got[b, k], want, err_msg=f"{b} {k}")
        assert got[b].sum() > 0
