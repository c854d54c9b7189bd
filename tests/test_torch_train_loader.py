"""The train loader against the JAX package's (CPU): ``build_train_loader``
on baseline JPEG and PNG files with polygon ground truth gives the same
batches, bit for bit, as ``ttdg_mgm_tpu/data/loader.py:build_train_loader``
for the same seed, on the square and ``"auto"`` canvases, with
``min_size_choices`` and ``flip_prob`` 0.5; with a missing file among the
records both substitute the same fallback samples.  The port alone: a
truncated PNG and a truncated JPEG are substituted, fewer records than the
batch raise, and an RLE mask of a flipped sample is the unflipped sample's
mask mirrored within its valid width."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
import logging
import os

import numpy as np
import pytest
from PIL import Image

from ttdg_mgm_tpu.data import coco as jcoco
from ttdg_mgm_tpu.data import loader as jloader
from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_torch.data import coco as tcoco
from ttdg_mgm_torch.data import loader as tloader
from ttdg_mgm_torch.data import transforms as ttransforms
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.utils.rle import rle_encode

#: (file, height, width, how it is written): JPEGs 4:2:0 and 4:4:4, PNG
FILES = [("a.jpg", 111, 150, dict(quality=85, subsampling=2)),
         ("b.jpg", 97, 131, dict(quality=60, subsampling=0)),
         ("c.png", 150, 100, {}), ("d.png", 64, 120, {}), ("e.png", 90, 90, {})]
N_BATCHES = 6


def _image(h, w, seed):
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.stack([120 + 60 * np.sin(xx / 9.0 + c) + 40 * np.cos(yy / 13.0)
                    for c in range(3)], -1) + rng.normal(0, 8, (h, w, 3))
    return img, yy, xx


def _write_split(root, files=FILES, rle: bool = False, name: str = "split.json"):
    images, anns = [], []
    for i, (fname, h, w, kw) in enumerate(files):
        img, yy, xx = _image(h, w, i)
        cy, cx, ry, rx = 0.47 * h, 0.53 * w, 0.23 * h, 0.31 * w
        disc = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        img[disc] *= 0.6
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, fname),
                                                                    **kw)
        images.append({"id": i, "file_name": fname, "height": h, "width": w})
        t = np.linspace(0, 2 * np.pi, 40, endpoint=False)
        for cat, (sy, sx) in ((1, (ry, rx)), (2, (0.5 * ry, 0.4 * rx))):
            ring = np.stack([cx + sx * np.cos(t), cy + sy * np.sin(t)], 1).reshape(-1)
            seg = ([[round(float(v), 3) for v in ring]] if not rle else
                   rle_encode((((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2 <= 1)
                              .astype(np.uint8)))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat, "iscrowd": 0,
                         "bbox": [float(ring[0::2].min()), float(ring[1::2].min()),
                                  float(np.ptp(ring[0::2])), float(np.ptp(ring[1::2]))],
                         "segmentation": seg})
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]}, f)
    return path


def _register(name, path, root, jax_too: bool = True):
    TCatalog.remove(name)
    tcoco.register_coco_instances(name, path, root)
    if jax_too:
        JCatalog.remove(name)
        jcoco.register_coco_instances(name, path, root)


@pytest.fixture()
def split(tmp_path):
    name = "_train_loader_split"
    _register(name, _write_split(str(tmp_path)), str(tmp_path))
    yield name
    TCatalog.remove(name)
    JCatalog.remove(name)


def _batches(loader, n=N_BATCHES):
    out = [next(loader) for _ in range(n)]
    if hasattr(loader, "close"):
        loader.close()
    return out


def _same_batches(got, want):
    for b, (t, j) in enumerate(zip(got, want)):
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, (b, k)
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"batch {b}: {k}")


@pytest.mark.parametrize("canvas", [128, "auto"])
def test_batches_match_jax(split, canvas):
    """Shuffle, scale choice, flip, decode, resize, fit, pad and rasterize:
    the same arrays as the JAX loader, which runs Pillow and OpenCV."""
    kw = dict(batch_size=2, canvas=canvas, min_size=96, max_size=160, gt_cap=4, mask_res=32,
              seed=3, flip_prob=0.5, min_size_choices=(72, 96, 128))
    got = _batches(tloader.build_train_loader([split], **kw))
    want = _batches(jloader.build_train_loader([split], **kw))
    _same_batches(got, want)
    # the run exercises what it claims: both flips, several scales, GT masks
    assert len({b["image_sizes"][i, 0] for b in got for i in range(2)}) > 2
    assert all(b["gt_valid"].sum() > 0 and b["gt_masks"].sum() > 0 for b in got)
    if canvas == "auto":
        assert len({b["image"].shape for b in got}) > 1


def test_missing_file_substituted_as_jax(split, tmp_path, caplog):
    """A record whose image is missing is replaced, in both packages, by the
    same random known-good record."""
    os.remove(os.path.join(str(tmp_path), "c.png"))
    kw = dict(batch_size=2, canvas=128, min_size=96, max_size=160, gt_cap=4, mask_res=32,
              seed=1, flip_prob=0.5, prefetch=0)
    with caplog.at_level(logging.WARNING, logger="ttdg_mgm_torch"):
        got = _batches(tloader.build_train_loader([split], **kw))
    want = _batches(jloader.build_train_loader([split], **kw))
    _same_batches(got, want)
    assert any("c.png" in r.getMessage() for r in caplog.records)


def test_truncated_files_substituted(tmp_path, caplog):
    """The port's decoders raise ``ValueError`` on a truncated PNG and a
    truncated JPEG; the loader substitutes a good record for each."""
    root = str(tmp_path)
    files = [("g1.png", 80, 96, {}), ("g2.png", 72, 90, {}), ("t.png", 80, 96, {}),
             ("t.jpg", 80, 96, dict(quality=90))]
    path = _write_split(root, files)
    for fname in ("t.png", "t.jpg"):
        p = os.path.join(root, fname)
        with open(p, "rb") as f:
            data = f.read()
        with open(p, "wb") as f:
            f.write(data[:len(data) // 2])
        with pytest.raises(ValueError):
            tloader.load_image(p)
    name = "_train_loader_truncated"
    _register(name, path, root, jax_too=False)
    kw = dict(batch_size=2, canvas=96, min_size=96, max_size=96, gt_cap=4, mask_res=32,
              flip_prob=0.0, prefetch=0)
    goods = [tloader.pack_batch([tloader.prepare_sample(r, canvas=96, min_size=96,
                                                        max_size=96)], canvas=96, gt_cap=4,
                                mask_res=32)["image"][0]
             for r in TCatalog.get(name)[:2]]
    with caplog.at_level(logging.WARNING, logger="ttdg_mgm_torch"):
        batches = _batches(tloader.build_train_loader([name], seed=0, **kw), 8)
    TCatalog.remove(name)
    for b in batches:
        for img in b["image"]:
            assert any(np.array_equal(img, g) for g in goods)
    warned = " ".join(r.getMessage() for r in caplog.records)
    assert "t.png" in warned and "t.jpg" in warned


def test_fewer_records_than_the_batch_raise(split):
    """Five records and a batch of 8: the JAX loader's epoch loop yields
    nothing and never returns; the port raises, naming both counts."""
    with pytest.raises(ValueError, match=r"5 training records .* batch of 8"):
        tloader.build_train_loader([split], batch_size=8, canvas=128)


def test_rle_masks_flip_with_the_image(tmp_path):
    """RLE ground truth: with every sample flipped, each GT mask is the
    unflipped batch's mask mirrored within its valid width (the image's
    mirror on the mask grid), and the images are mirrored too."""
    root = str(tmp_path)
    name = "_train_loader_rle"
    _register(name, _write_split(root, FILES[2:], rle=True), root, jax_too=False)
    kw = dict(batch_size=3, canvas=128, min_size=96, max_size=160, gt_cap=4, mask_res=64,
              seed=2, prefetch=0)
    plain = _batches(tloader.build_train_loader([name], flip_prob=0.0, **kw), 2)
    flipped = _batches(tloader.build_train_loader([name], flip_prob=1.0, **kw), 2)
    TCatalog.remove(name)
    for p, f in zip(plain, flipped):
        np.testing.assert_array_equal(p["image_sizes"], f["image_sizes"])
        for b, (h, w) in enumerate(p["image_sizes"].astype(int)):
            np.testing.assert_array_equal(f["image"][b, :h, :w], p["image"][b, :h, :w][:, ::-1])
            vw = int(round(w * 64 / 128))
            np.testing.assert_array_equal(f["gt_masks"][b, :, :, :vw],
                                          p["gt_masks"][b, :, :, :vw][:, :, ::-1])
            assert p["gt_masks"][b, :, :, vw:].sum() == f["gt_masks"][b, :, :, vw:].sum() == 0
            assert p["gt_masks"][b].sum() > 0


def test_hflip_keeps_rle_and_flips_polygons():
    img = np.arange(2 * 5 * 3, dtype=np.uint8).reshape(2, 5, 3)
    rle = {"size": [2, 5], "counts": "abc"}
    out, boxes, polys = ttransforms.hflip(img, np.array([[1, 0, 3, 2]], np.float32),
                                          [rle, [[1.0, 0.0, 3.0, 2.0]]])
    np.testing.assert_array_equal(out, img[:, ::-1])
    np.testing.assert_array_equal(boxes, [[2, 0, 4, 2]])
    assert polys[0] is rle and polys[1] == [[4.0, 0.0, 2.0, 2.0]]


def test_close_ends_the_prefetch_thread(split):
    """``close`` on the endless train loader drops its prefetched batches
    and its thread ends after the batch it is making."""
    loader = tloader.build_train_loader([split], batch_size=2, canvas=128, min_size=96,
                                        max_size=160, gt_cap=4, mask_res=32, prefetch=2)
    next(loader)
    loader.close()
    loader._thread.join(timeout=30)
    assert not loader._thread.is_alive() and loader._q.empty()
