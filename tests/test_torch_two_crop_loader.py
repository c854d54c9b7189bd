"""The mean-teacher loader against the JAX package's (CPU):
``divide_label_unlabel`` picks the same records, and
``build_two_crop_loader`` gives the same batches, bit for bit, as
``ttdg_mgm_tpu/data/loader.py``'s for the same seeds: the permutations,
the flips, the weak views (decode, resize, fit, flip, pad), the strong
views (the NumPy strong augmentation against Pillow's) and the ground
truth rasterized from polygons, on the square and ``"auto"`` canvases, and
with a ``SUP_PERCENT`` split of the labelled records.

RLE ground truth: the JAX package's ``scale_annotations`` and ``hflip``
raise on an RLE dict (``ROADMAP.md`` Queue 3), so for that case its loader
runs with the port's pass-through versions of the two, and the port's GT
mask of a flipped sample is the JAX loader's mirrored within the sample's
valid width (the JAX ``pack_batch`` does not mirror it; the port's
decision, ``ROADMAP.md`` Queue 3).
Everything else of those batches is compared bit for bit as above.  The
port alone: fewer labelled or unlabelled records than the batch raise
``ValueError``.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
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

N_BATCHES = 4
KW = dict(batch_size=2, min_size=96, max_size=160, gt_cap=4, mask_res=32)


def _write_split(root, name, sizes, seed, rle=False, jpeg=False):
    """Disc images (PNG, or the first one a JPEG) with a disc and a cup as
    polygon or RLE ground truth, registered in both catalogs."""
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i, (h, w) in enumerate(sizes):
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([110 + 50 * np.sin(xx / (7.0 + c) + seed) + 30 * np.cos(yy / 11.0)
                        for c in range(3)], -1) + rng.normal(0, 6, (h, w, 3))
        cy, cx, ry, rx = rng.uniform(0.4, 0.6) * h, rng.uniform(0.4, 0.6) * w, 0.25 * h, 0.3 * w
        img[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1] *= 0.5
        fname = f"{name}_{i}.jpg" if jpeg and i == 0 else f"{name}_{i}.png"
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(os.path.join(root, fname))
        images.append({"id": i, "file_name": fname, "height": h, "width": w})
        t = np.linspace(0, 2 * np.pi, 32, endpoint=False)
        for cat, (sy, sx) in ((1, (ry, rx)), (2, (0.45 * ry, 0.4 * rx))):
            ring = np.stack([cx + sx * np.cos(t), cy + sy * np.sin(t)], 1).reshape(-1)
            inside = (((yy - cy) / sy) ** 2 + ((xx - cx) / sx) ** 2 <= 1).astype(np.uint8)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat, "iscrowd": 0,
                         "bbox": [float(ring[0::2].min()), float(ring[1::2].min()),
                                  float(np.ptp(ring[0::2])), float(np.ptp(ring[1::2]))],
                         "segmentation": (rle_encode(inside) if rle
                                          else [[round(float(v), 3) for v in ring]])})
    path = os.path.join(root, name + ".json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]}, f)
    for cat, reg in ((TCatalog, tcoco.register_coco_instances),
                     (JCatalog, jcoco.register_coco_instances)):
        cat.remove(name)
        reg(name, path, root)
    return name


LABEL_SIZES = [(111, 150), (97, 131), (150, 100), (64, 120), (90, 90)]
UNLABEL_SIZES = [(120, 96), (80, 140), (100, 100), (128, 77)]


@pytest.fixture()
def splits(tmp_path):
    names = (_write_split(str(tmp_path), "_mt_label", LABEL_SIZES, 1, jpeg=True),
             _write_split(str(tmp_path), "_mt_unlabel", UNLABEL_SIZES, 2))
    yield names
    for n in names:
        TCatalog.remove(n)
        JCatalog.remove(n)


def _batches(loader, n=N_BATCHES):
    out = [next(loader) for _ in range(n)]
    if hasattr(loader, "close"):
        loader.close()
    return out


def _same(got, want):
    for b, (t, j) in enumerate(zip(got, want)):
        assert t.keys() == j.keys()
        for k in j:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, (b, k)
            np.testing.assert_array_equal(t[k], j[k], err_msg=f"batch {b}: {k}")


def test_divide_label_unlabel_matches_jax():
    records = [{"image_id": i} for i in range(23)]
    for pct in (1.0, 10.0, 37.5, 50.0, 100.0):
        for seed in (0, 3):
            got = tloader.divide_label_unlabel(records, pct, seed)
            want = jloader.divide_label_unlabel(records, pct, seed)
            assert got == want
            assert len(got[0]) == int(pct / 100 * 23) and len(got[0]) + len(got[1]) == 23
    table = {"10.0": {"0": [4, 17]}}
    assert (tloader.divide_label_unlabel(records, 10.0, 0, table)
            == jloader.divide_label_unlabel(records, 10.0, 0, table))
    with pytest.raises(ValueError, match="labelled indices"):
        tloader.divide_label_unlabel(records, 10.0, 0, {"10.0": {"0": [1, 2, 3]}})


@pytest.mark.parametrize("canvas", [128, "auto"])
def test_batches_match_jax(splits, canvas):
    """Both views of both record lists, the GT of the labelled strong view,
    the sizes: the same arrays as the JAX loader, which runs Pillow and
    OpenCV."""
    kw = dict(KW, canvas=canvas, seed=4)
    got = _batches(tloader.build_two_crop_loader([splits[0]], [splits[1]], **kw))
    want = _batches(jloader.build_two_crop_loader([splits[0]], [splits[1]], **kw))
    _same(got, want)
    # what the run claims: flips both ways, strong views that differ from the
    # weak ones with the same geometry, GT masks
    for b in got:
        for side in ("label", "unlabel"):
            assert not np.array_equal(b[f"{side}_strong"], b[f"{side}_weak"])
            h, w = b[f"{side}_sizes"].astype(int).max(0)
            assert not b[f"{side}_weak"][:, h:].any() and not b[f"{side}_weak"][:, :, w:].any()
        assert b["gt_valid"].sum() > 0 and b["gt_masks"].sum() > 0
    if canvas == "auto":
        for b in got:
            assert b["label_strong"].shape == b["unlabel_weak"].shape
        assert len({b["label_weak"].shape for b in got}) > 1


def test_sup_percent_split_matches_jax(splits):
    """No unlabelled datasets: ``SUP_PERCENT`` 60 of the labelled records
    are labelled, the rest unlabelled (split seed 2)."""
    kw = dict(KW, canvas=128, seed=1, sup_percent=60.0, split_seed=2)
    _same(_batches(tloader.build_two_crop_loader([splits[0]], [], **kw)),
          _batches(jloader.build_two_crop_loader([splits[0]], [], **kw)))


def test_rle_ground_truth(tmp_path, monkeypatch):
    root = str(tmp_path)
    label = _write_split(root, "_mt_label_rle", LABEL_SIZES[:4], 3, rle=True)
    unlabel = _write_split(root, "_mt_unlabel_rle", UNLABEL_SIZES, 4)
    monkeypatch.setattr(jloader, "scale_annotations", ttransforms.scale_annotations)
    monkeypatch.setattr(jloader, "hflip", ttransforms.hflip)
    flips = []
    real = jloader.prepare_sample

    def recording(record, **k):
        flips.append(k["flip"])
        return real(record, **k)

    monkeypatch.setattr(jloader, "prepare_sample", recording)
    kw = dict(KW, canvas=128, seed=6, prefetch=0)
    got = _batches(tloader.build_two_crop_loader([label], [unlabel], **kw))
    want = _batches(jloader.build_two_crop_loader([label], [unlabel], **kw))
    for n in (label, unlabel):
        TCatalog.remove(n)
        JCatalog.remove(n)
    B = KW["batch_size"]
    # per batch the JAX loader prepares the B labelled samples, then B unlabelled
    label_flips = [flips[2 * B * i:2 * B * i + B] for i in range(N_BATCHES)]
    assert any(f for fl in label_flips for f in fl) and not all(f for fl in label_flips for f in fl)
    for i, (t, j) in enumerate(zip(got, want)):
        for k in j:
            if k != "gt_masks":
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"batch {i}: {k}")
        for s, flipped in enumerate(label_flips[i]):
            h, w = t["label_sizes"][s].astype(int)
            mw = int(round(w * KW["mask_res"] / 128))
            mj = j["gt_masks"][s]
            mj = np.concatenate([mj[:, :, :mw][:, :, ::-1], mj[:, :, mw:]], -1) if flipped else mj
            np.testing.assert_array_equal(t["gt_masks"][s], mj, err_msg=f"batch {i} {s}")
            assert t["gt_masks"][s].sum() > 0


def test_fewer_records_than_the_batch_raise(splits):
    """4 unlabelled records, a batch of 5 (the JAX loader's
    ``permutation(n)[:batch_size]`` would give a short batch); 5 labelled
    records, a batch of 6."""
    with pytest.raises(ValueError, match=r"4 unlabelled records .* batch of 5"):
        tloader.build_two_crop_loader([splits[0]], [splits[1]], batch_size=5, canvas=128)
    with pytest.raises(ValueError, match=r"5 labelled records .* batch of 6"):
        tloader.build_two_crop_loader([splits[0]], [splits[0]], batch_size=6, canvas=128)
