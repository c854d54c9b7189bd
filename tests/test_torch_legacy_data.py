"""The legacy domain-adaptation datasets in the port against the JAX
package (CPU), on synthetic trees written in each dataset's own layout:

* foggy Cityscapes (``data/datasets/cityscapes_foggy.py``): records
  **equal** to JAX's (dict equality, floats exact) with every thing class,
  a ``cargroup`` crowd region, a ``deleted`` object, a 2-point polygon and
  a stuff class; the beta filter, the cache (a hit returns the cached
  records), a read-only tree (no cache written), a missing tree;
  ``register_all_cityscapes_foggy``;
* Pascal VOC layout (``pascal_voc.py``): an unknown class dropped,
  ``difficult``, the 1-indexed corner shifted; ``register_pascal_voc``;
* the fetal-ultrasound tree (``fetus.py``): split sizes and determinism,
  ``__getitem__``'s arrays equal the JAX class's (Pillow) on PNG and
  baseline JPEG images, ``load_fetus_dicts``;
* ``_load_images_only_json`` and ``register_all_legacy``'s names and
  metadata;
* the loaders on 2048 x 1024 foggy-Cityscapes frames: the train loader's
  batches on the square 800 canvas and the test loader's at the test
  geometry equal JAX's bit for bit for the same seed (crowd polygons
  dropped from the training GT);
* ``evaluate_dataset`` on a fixed detector: the COCO box and mask AP over
  the 8 classes with crowd GT, and the VOC mAP of a box-only model over
  Clipart1k's 20 classes and Watercolor's subset, equal to JAX's to 1e-9.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import builtins
import json
import math
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ttdg_mgm_tpu.data import builtin as jbuiltin
from ttdg_mgm_tpu.data import loader as jloader
from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_tpu.data.catalog import MetadataCatalog as JMeta
from ttdg_mgm_tpu.data.datasets import cityscapes_foggy as jcity
from ttdg_mgm_tpu.data.datasets import fetus as jfetus
from ttdg_mgm_tpu.data.datasets import pascal_voc as jvoc
from ttdg_mgm_tpu.engine import trainer as jtrainer
from ttdg_mgm_torch.data import builtin as tbuiltin
from ttdg_mgm_torch.data import loader as tloader
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.data.catalog import MetadataCatalog as TMeta
from ttdg_mgm_torch.data.datasets import cityscapes_foggy as tcity
from ttdg_mgm_torch.data.datasets import fetus as tfetus
from ttdg_mgm_torch.data.datasets import pascal_voc as tvoc
from ttdg_mgm_torch.engine import trainer as ttrainer

HERE = os.path.dirname(os.path.abspath(__file__))
JPEGS = os.path.join(HERE, "fixtures", "torch_jpeg")
LEGACY = ("coco_2017_unlabel", "coco_2017_for_voc20", "cityscapes_foggy_train",
          "cityscapes_foggy_val", "cityscapes_foggy_test", "Clipart1k_train", "Clipart1k_test",
          "Watercolor_train", "Watercolor_test")
CITY_SPLITS = ("cityscapes_foggy_train", "cityscapes_foggy_val", "cityscapes_foggy_test")


def _forget(names):
    for cat in (TCatalog, JCatalog):
        for n in names:
            cat.remove(n)


def _frame(h, w, seed):
    """A smooth street-like frame (PNG compresses it fast)."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    rng = np.random.RandomState(seed)
    img = np.stack([90 + 60 * np.sin(xx / (0.11 * w) + c + rng.uniform(0, 3))
                    + 40 * (yy / h) for c in range(3)], -1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _objects(h, w, i):
    """One polygon per thing class (the contiguous ids' order), a crowd
    region, a deleted object, a stuff class and a 2-point polygon."""
    objs = []
    for c, name in enumerate(tcity.CITYSCAPES_THING_CLASSES):
        x0, y0 = (0.05 + 0.11 * c) * w, (0.2 + 0.05 * ((c + i) % 3)) * h
        x1, y1 = x0 + 0.09 * w, y0 + (0.15 + 0.02 * c) * h
        objs.append({"label": name, "polygon": [[x0, y0], [x1, y0], [x1, y1],
                                                [(x0 + x1) / 2, y1 + 0.03 * h], [x0, y1]]})
    objs += [
        {"label": "cargroup", "polygon": [[0.6 * w, 0.7 * h], [0.9 * w, 0.7 * h],
                                          [0.9 * w, 0.9 * h], [0.6 * w, 0.9 * h]]},
        {"label": "car", "deleted": 1, "polygon": [[10, 10], [60, 10], [60, 40]]},
        {"label": "sky", "polygon": [[0, 0], [w, 0], [w, 0.1 * h]]},
        {"label": "person", "polygon": [[5, 5], [6, 5]]},
    ]
    return objs


def write_cityscapes(root, split, n, hw=(1024, 2048), image_dir="leftImg8bit",
                     betas=("0.02",), images=True):
    """``n`` frames of city ``aachen`` under ``root/cityscapes_foggy``:
    ``{image_dir}/{split}/aachen/*_leftImg8bit_foggy_beta_{beta}.png`` (each
    beta) and ``gtFine/{split}/aachen/*_gtFine_polygons.json``; without
    ``images`` the image files are empty."""
    h, w = hw
    img_dir = os.path.join(root, "cityscapes_foggy", image_dir, split, "aachen")
    gt_dir = os.path.join(root, "cityscapes_foggy", "gtFine", split, "aachen")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    for i in range(n):
        stem = f"aachen_{i:06d}_000019_"
        for beta in betas:
            path = os.path.join(img_dir, f"{stem}leftImg8bit_foggy_beta_{beta}.png")
            if images:
                Image.fromarray(_frame(h, w, i)).save(path)
            else:
                open(path, "wb").close()
        with open(os.path.join(gt_dir, stem + "gtFine_polygons.json"), "w") as f:
            json.dump({"imgHeight": h, "imgWidth": w, "objects": _objects(h, w, i)}, f)
    return (os.path.dirname(img_dir), os.path.dirname(gt_dir))


# -- foggy Cityscapes ---------------------------------------------------------------------

@pytest.mark.parametrize("beta", [None, "0.02"], ids=["all", "beta0.02"])
def test_cityscapes_records_equal_jax(tmp_path, beta):
    img, gt = write_cityscapes(str(tmp_path), "train", 3, betas=("0.02", "0.01"), images=False)
    got = tcity.load_cityscapes_foggy_instances(img, gt, beta, cache=False)
    want = jcity.load_cityscapes_foggy_instances(img, gt, beta, cache=False)
    assert got == want and len(got) == (6 if beta is None else 3)
    anns = got[0]["annotations"]
    # 8 classes and the crowd region; deleted, stuff and 2-point objects dropped
    assert [a["category_id"] for a in anns] == list(range(8)) + [2]
    assert [a["iscrowd"] for a in anns] == [0] * 8 + [1]
    assert anns[2]["raw_category_id"] == 26 and anns[0]["bbox_mode"] == "xyxy"
    assert (got[0]["height"], got[0]["width"]) == (1024, 2048)


def test_cityscapes_cache_hit_and_read_only_tree(tmp_path, monkeypatch):
    """The first call writes ``ttdg_cache_{tag}.json`` next to the
    annotations, a second returns it (a later edit of the annotations does
    not show); on a tree where writing fails no cache is written and the
    records are still JAX's."""
    img, gt = write_cityscapes(str(tmp_path), "val", 2, images=False)
    first = tcity.load_cityscapes_foggy_instances(img, gt, "0.02")
    assert os.path.exists(os.path.join(gt, "ttdg_cache_0.02.json"))
    assert first == jcity.load_cityscapes_foggy_instances(img, gt, "0.02", cache=False)
    poly = os.path.join(gt, "aachen", "aachen_000000_000019_gtFine_polygons.json")
    with open(poly, "w") as f:
        json.dump({"imgHeight": 1, "imgWidth": 1, "objects": []}, f)
    assert tcity.load_cityscapes_foggy_instances(img, gt, "0.02") == first
    assert jcity.load_cityscapes_foggy_instances(img, gt, "0.02") == first

    def read_only(path, mode="r", *a, **k):
        if "w" in mode:
            raise PermissionError(13, "read-only file system", path)
        return builtins.open(path, mode, *a, **k)

    for mod in (tcity, jcity):
        monkeypatch.setattr(mod, "open", read_only, raising=False)
    got = tcity.load_cityscapes_foggy_instances(img, gt)
    assert got == jcity.load_cityscapes_foggy_instances(img, gt) and len(got) == 2
    assert not os.path.exists(os.path.join(gt, "ttdg_cache_allsplits.json"))


def test_cityscapes_missing_tree_raises(tmp_path):
    empty = tmp_path / "none"
    empty.mkdir()
    for mod in (tcity, jcity):
        with pytest.raises(FileNotFoundError, match="no foggy cityscapes"):
            mod.load_cityscapes_foggy_instances(str(empty), str(empty), cache=False)
        with pytest.raises(FileNotFoundError):
            mod.load_cityscapes_foggy_instances(str(tmp_path / "absent"), str(empty))


def test_register_all_cityscapes_foggy_equals_jax(tmp_path):
    write_cityscapes(str(tmp_path), "train", 1, image_dir="leftImg8bit_foggy", images=False)
    _forget(CITY_SPLITS)
    try:
        tcity.register_all_cityscapes_foggy(str(tmp_path / "cityscapes_foggy"))
        jcity.register_all_cityscapes_foggy(str(tmp_path / "cityscapes_foggy"))
        for n in CITY_SPLITS:
            assert TMeta.get(n) == JMeta.get(n)
        assert TMeta.get("cityscapes_foggy_val")["thing_classes"][2] == "car"
        recs = TCatalog.get("cityscapes_foggy_train")
        assert recs == JCatalog.get("cityscapes_foggy_train") and len(recs) == 1
        with pytest.raises(FileNotFoundError):
            TCatalog.get("cityscapes_foggy_test")
    finally:
        _forget(CITY_SPLITS)


# -- Pascal VOC layout ------------------------------------------------------------------------

#: (id, [(class, difficult tag, xmin, ymin, xmax, ymax)]); None: no tag
VOC_OBJECTS = [
    ("p0", [("dog", "0", 101, 211, 640, 700), ("person", "1", 700, 100, 1100, 900),
            ("unknownthing", None, 1, 1, 5, 5)]),
    ("p1", [("car", None, 51, 61, 500, 400), ("bicycle", "0", 600, 500, 900, 800)]),
    ("p2", [("cat", "0", 300, 200, 1000, 800), ("bird", "", 20, 20, 200, 150)]),
]


def write_voc(d, split="test", size=(959, 1280)):
    """The 3 committed 1280 x 959 JPEGs as a VOC tree: ``JPEGImages``,
    ``Annotations`` (VOC classes, one difficult, one unknown class, an
    empty and an absent ``difficult`` tag) and ``ImageSets/Main/{split}.txt``."""
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for fid, objs in VOC_OBJECTS:
        shutil.copy(os.path.join(JPEGS, fid + ".jpg"), os.path.join(d, "JPEGImages"))
        xml = [f"<annotation><size><width>{size[1]}</width><height>{size[0]}</height>"
               "<depth>3</depth></size>"]
        for cls, diff, *box in objs:
            tag = "" if diff is None else f"<difficult>{diff}</difficult>"
            xml.append(f"<object><name>{cls}</name>{tag}<bndbox><xmin>{box[0]}</xmin>"
                       f"<ymin>{box[1]}</ymin><xmax>{box[2]}</xmax><ymax>{box[3]}</ymax>"
                       "</bndbox></object>")
        with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
            f.write("".join(xml) + "</annotation>")
    with open(os.path.join(d, "ImageSets", "Main", split + ".txt"), "w") as f:
        f.write("\n".join(fid for fid, _ in VOC_OBJECTS) + "\n")
    return d


def test_voc_records_equal_jax(tmp_path):
    d = write_voc(str(tmp_path / "clipart"))
    got = tvoc.load_voc_instances(d, "test")
    assert got == jvoc.load_voc_instances(d, "test")
    a = got[0]["annotations"]
    assert len(a) == 2  # the unknown class dropped
    assert a[0]["bbox"] == [100.0, 210.0, 640.0, 700.0] and a[0]["category_id"] == 11
    assert [x["difficult"] for r in got for x in r["annotations"]] == [0, 1, 0, 0, 0, 0]
    assert all(x["segmentation"] is None for r in got for x in r["annotations"])
    sub = tvoc.load_voc_instances(d, "test", tvoc.WATERCOLOR_CLASS_NAMES)
    assert sub == jvoc.load_voc_instances(d, "test", jvoc.WATERCOLOR_CLASS_NAMES)
    names = ("_voc_t", "_voc_07")
    _forget(names)
    try:
        tvoc.register_pascal_voc("_voc_t", d, "test")
        jvoc.register_pascal_voc("_voc_t", d, "test")
        assert TMeta.get("_voc_t") == JMeta.get("_voc_t")
        assert TCatalog.get("_voc_t") == got
        # year 2007 selects VOC2007's 11-point metric in the evaluator
        tvoc.register_pascal_voc("_voc_07", d, "test", year=2007)
        assert TMeta.get("_voc_07")["year"] == 2007 and "year" not in TMeta.get("_voc_t")
    finally:
        _forget(names)


# -- the fetal-ultrasound tree -------------------------------------------------------------------

def write_fetus(root):
    """hospital_A's three-vessel-tracheal slice: 6 PNG and 5 baseline JPEG
    images with two known organs and an unknown one, and an image of
    another body part (filtered out)."""
    hosp = os.path.join(root, "hospital_A")
    os.makedirs(os.path.join(hosp, "annotations"))
    os.makedirs(os.path.join(hosp, "three_vessel_tracheal"))
    rng = np.random.RandomState(0)
    per_image = {}
    for i in range(12):
        name = f"img_{i}.png" if i % 2 == 0 else f"img_{i}.jpg"
        arr = rng.randint(0, 256, (24, 32, 3)).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(hosp, "three_vessel_tracheal", name),
                                  **({} if name.endswith(".png") else dict(quality=90)))
        per_image[name] = {"bodyPart": "三血管气管切面" if i < 11 else "四腔心切面",
                           "annotations": [
                               {"name": "脊柱", "vertex": [[14, 15], [4, 5 + i % 3]]},
                               {"name": "气管", "vertex": [[20, 2], [28, 9]]},
                               {"name": "unknown-organ", "vertex": [[0, 0], [1, 1]]}]}
    with open(os.path.join(hosp, "annotations", "three_vessel_tracheal_annotations.json"),
              "w") as f:
        json.dump({"annotations": per_image}, f)
    return root


def test_fetus_dataset_equals_jax(tmp_path):
    root = write_fetus(str(tmp_path / "fetus"))
    kw = dict(hospitals=["hospital_A"], slices=["three_vessel_tracheal"])
    sizes = {}
    for op in ("train", "valid", "test"):
        t = tfetus.FetusDataset(root, operation=op, **kw)
        j = jfetus.FetusDataset(root, operation=op, **kw)
        assert t.used == j.used and t.splits == j.splits
        assert t.used == tfetus.FetusDataset(root, operation=op, **kw).used
        assert t.images.keys() == j.images.keys() and len(t.images) == 11
        for k in t.images:
            for f, v in t.images[k].items():
                np.testing.assert_array_equal(v, j.images[k][f], err_msg=f"{k} {f}")
        for i in range(len(t)):
            a, b = t[i], j[i]
            assert a.keys() == b.keys()
            for f in a:
                np.testing.assert_array_equal(a[f], b[f], err_msg=f)
            assert a["image"].dtype == np.uint8 and a["image"].shape == (24, 32, 3)
        sizes[op] = len(t)
        got = tfetus.load_fetus_dicts(root, kw["hospitals"], kw["slices"], operation=op)
        assert got == jfetus.load_fetus_dicts(root, kw["hospitals"], kw["slices"], operation=op)
    assert sizes == {"train": 7, "valid": 1, "test": 3}
    rec = tfetus.FetusDataset(root, operation="test", **kw)[0]
    assert rec["labels"].tolist() == [2, 4]  # 脊柱 and 气管 in the 3VT vocabulary
    ann = got[0]["annotations"][0]
    assert ann["bbox_mode"] == "xyxy" and ann["category_id"] == 1
    with pytest.raises(ValueError, match="operation"):
        tfetus.FetusDataset(root, operation="dev", **kw)


# -- the registry -------------------------------------------------------------------------------

def test_images_only_json_and_register_all_legacy_equal_jax(tmp_path):
    j = tmp_path / "info.json"
    j.write_text(json.dumps({"images": [
        {"id": 2, "file_name": "b.jpg", "height": 10, "width": 20},
        {"id": 1, "file_name": "a.jpg", "height": 30, "width": 40}]}))
    recs = tbuiltin._load_images_only_json(str(j), str(tmp_path))
    assert recs == jbuiltin._load_images_only_json(str(j), str(tmp_path))
    assert [r["image_id"] for r in recs] == [1, 2] and recs[0]["annotations"] == []
    _forget(LEGACY)
    try:
        tbuiltin.register_all_legacy(str(tmp_path))
        jbuiltin.register_all_legacy(str(tmp_path))
        assert set(LEGACY) <= set(TCatalog.list())
        for n in LEGACY:
            assert TMeta.get(n) == JMeta.get(n), n
        assert TMeta.get("Watercolor_test")["evaluator_type"] == "pascal_voc_water"
        assert TMeta.get("Clipart1k_test")["dirname"] == str(tmp_path / "clipart")
        with pytest.raises(KeyError, match="already registered"):
            tbuiltin.register_all_legacy(str(tmp_path))
    finally:
        _forget(LEGACY)


# -- the loaders and evaluators on legacy records ---------------------------------------------------

@pytest.fixture(scope="module")
def legacy_root(tmp_path_factory):
    """``register_all_legacy`` in both packages over a root holding foggy
    Cityscapes train (4 frames) and val (2 frames) of 2048 x 1024, and
    Clipart1k and Watercolor test splits of the committed JPEGs."""
    root = str(tmp_path_factory.mktemp("legacy"))
    write_cityscapes(root, "train", 4)
    write_cityscapes(root, "val", 2)
    write_voc(os.path.join(root, "clipart"))
    write_voc(os.path.join(root, "watercolor"))
    _forget(LEGACY)
    tbuiltin.register_all_legacy(root)
    jbuiltin.register_all_legacy(root)
    yield root
    _forget(LEGACY)


def _same(a, b, what=""):
    assert a.keys() == b.keys(), what
    for k in a:
        if isinstance(a[k], np.ndarray):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")
        else:
            assert a[k] == b[k], f"{what} {k}"


def test_train_loader_on_foggy_cityscapes_equals_jax(legacy_root):
    """The square 800 canvas of ``configs/seg_res50fpn_source.yaml`` (the
    "choice" shortest edges 640-800 under 1333, 32 GT slots, masks on 256),
    2 batches of 2: bit for bit; the crowd region is not training GT."""
    kw = dict(batch_size=2, canvas=800, min_size=800, max_size=1333, gt_cap=32, mask_res=256,
              seed=3, prefetch=0, min_size_choices=(640, 672, 704, 736, 768, 800))
    tl = tloader.build_train_loader(["cityscapes_foggy_train"], **kw)
    jl = jloader.build_train_loader(["cityscapes_foggy_train"], **kw)
    for i in range(2):
        t, j = next(tl), next(jl)
        _same(t, j, f"batch {i}")
        assert t["image"].shape == (2, 800, 800, 3)
        # 2048 x 1024 shrunk onto the canvas: the long side 799-800
        assert (t["image_sizes"][:, 1] >= 799).all() and (t["image_sizes"] <= 800).all()
        assert (np.abs(t["image_sizes"][:, 0] * 2 - t["image_sizes"][:, 1]) <= 2).all()
        assert t["gt_valid"].sum(1).tolist() == [8, 8]
        assert t["gt_masks"][:, :8].reshape(2, 8, -1).any(-1).all()


def test_test_loader_on_foggy_cityscapes_equals_jax(legacy_root):
    """The test geometry (shortest edge 800 under 1333, per-batch buckets),
    batches of 2: the same batches and metas."""
    kw = dict(batch_size=2, canvas="auto", min_size=800, max_size=1333, prefetch=0)
    tl = list(tloader.build_test_loader("cityscapes_foggy_val", **kw))
    jl = list(jloader.build_test_loader("cityscapes_foggy_val", **kw))
    assert len(tl) == len(jl) == 1
    (tb, tm), (jb, jm) = tl[0], jl[0]
    _same(tb, jb)
    for a, b in zip(tm, jm):
        _same(a, b)
    assert tb["image"].shape == (2, 832, 1344, 3)
    assert all(abs(s - 0.651) < 1e-3 for m in tm for s in m["scale"])


# a fixed detector: detections as fractions of each image's valid size, near
# the synthetic ground truth, the same float32 arithmetic in both packages
DET = dict(
    city=(np.array([[0.05, 0.2, 0.14, 0.36], [0.16, 0.25, 0.25, 0.45], [0.27, 0.31, 0.36, 0.5],
                    [0.6, 0.7, 0.9, 0.9], [0.61, 0.26, 0.7, 0.53], [0.2, 0.2, 0.6, 0.6]],
                   np.float32),
          np.array([0.9, 0.8, 0.85, 0.7, 0.6, 0.3], np.float32),
          np.array([0, 1, 2, 2, 5, 7], np.int32)),
    # every class detected somewhere: the JAX evaluator raises on a class
    # with ground truth and no detection
    city_all=(np.array([[0.05 + 0.11 * c, 0.2, 0.14 + 0.11 * c, 0.4] for c in range(8)]
                       + [[0.6, 0.7, 0.9, 0.9]], np.float32),
              np.array([0.9, 0.5, 0.8, 0.4, 0.7, 0.3, 0.6, 0.2, 0.75], np.float32),
              np.array([0, 1, 2, 3, 4, 5, 6, 7, 2], np.int32)),
    voc=(np.array([[0.08, 0.22, 0.5, 0.73], [0.55, 0.1, 0.86, 0.94], [0.04, 0.06, 0.39, 0.42],
                   [0.47, 0.52, 0.7, 0.83], [0.23, 0.21, 0.78, 0.83]], np.float32),
         np.array([0.9, 0.8, 0.7, 0.6, 0.5], np.float32),
         np.array([11, 14, 6, 1, 7], np.int32)))


def _mask_probs(n):
    yy, xx = np.mgrid[:28, :28]
    disc = (((yy - 13.3) / 9.1) ** 2 + ((xx - 14.2) / 11.7) ** 2 <= 1).astype(np.float32)
    return np.stack([0.05 + 0.9 * (disc if i % 2 else disc.T) for i in range(n)])


class _PortDetector(torch.nn.Module):
    def __init__(self, kind, mask_on):
        super().__init__()
        self.det, self.mask_on = DET[kind], mask_on
        self.dummy = torch.nn.Parameter(torch.zeros(()))

    def forward_inference(self, images, sizes):
        fr, sc, cl = (torch.from_numpy(a) for a in self.det)
        B, hw = images.shape[0], sizes.to(torch.float32)
        scale = torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
        rep = lambda a: a[None].expand(B, *a.shape).clone()  # noqa: E731
        return {"boxes": fr[None] * scale[:, None, :], "scores": rep(sc), "classes": rep(cl),
                "valid": torch.ones((B, len(sc)), dtype=torch.bool),
                "mask_probs": rep(torch.from_numpy(_mask_probs(len(sc))))}


class _JaxDetector:
    def __init__(self, kind, mask_on):
        self.det, self.mask_on = DET[kind], mask_on

    def forward_inference(self):
        pass

    def apply(self, variables, images, sizes, method=None):
        fr, sc, cl = (jnp.asarray(a) for a in self.det)
        B, hw = images.shape[0], sizes.astype(jnp.float32)
        scale = jnp.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], -1)
        rep = lambda a: jnp.broadcast_to(a[None], (B, *a.shape))  # noqa: E731
        return {"boxes": fr[None] * scale[:, None, :], "scores": rep(sc), "classes": rep(cl),
                "valid": jnp.ones((B, len(sc)), bool),
                "mask_probs": rep(jnp.asarray(_mask_probs(len(sc))))}


def _assert_same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        if math.isnan(want[k]):
            assert math.isnan(got[k]), k
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-9), k


@pytest.mark.parametrize("dataset,kind,mask_on", [
    ("cityscapes_foggy_val", "city_all", True), ("cityscapes_foggy_val", "city_all", False),
    ("Clipart1k_test", "voc", False), ("Watercolor_test", "voc", False)],
    ids=["city_coco_mask", "city_coco_box", "clipart_voc", "watercolor_voc"])
def test_evaluate_dataset_equals_jax(legacy_root, dataset, kind, mask_on):
    """Each dataset's own evaluator (its ``evaluator_type``): the same flat
    AP dict as the JAX package's on the same detections, to 1e-9."""
    kw = dict(batch_size=2, canvas="auto", min_size=400, max_size=667)
    got = ttrainer.evaluate_dataset(_PortDetector(kind, mask_on), dataset, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jtrainer.evaluate_dataset(_JaxDetector(kind, mask_on), {}, dataset, **kw)
    _assert_same(got, want)
    assert 0 < want["bbox_AP50"] <= 100
    assert any(k.startswith("segm") for k in got) == mask_on
    if kind == "voc":
        # the classes with GT that is not all difficult (person's is)
        assert {k for k in got if k.startswith("bbox_per_class")} == {
            f"bbox_per_class_{c}" for c in ("bicycle", "bird", "car", "cat", "dog")}


def test_coco_class_without_detection_scores_zero(legacy_root):
    """Classes 3, 4 and 6 have ground truth and no detection: the JAX
    evaluator raises ``IndexError`` (an empty precision array); the port
    scores them AP 0, as pycocotools does, which is what the JAX evaluator
    gives when each of them has one detection far from any ground truth."""
    kw = dict(batch_size=2, canvas="auto", min_size=400, max_size=667)
    got = ttrainer.evaluate_dataset(_PortDetector("city", False), "cityscapes_foggy_val", **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        with pytest.raises(IndexError):
            jtrainer.evaluate_dataset(_JaxDetector("city", False), {}, "cityscapes_foggy_val",
                                      **kw)
        far = _JaxDetector("city", False)
        fr, sc, cl = far.det
        far.det = (np.concatenate([fr, np.tile([[0.0, 0.96, 0.01, 0.97]], (3, 1))]).astype(
                       np.float32), np.concatenate([sc, [0.01] * 3]).astype(np.float32),
                   np.concatenate([cl, [3, 4, 6]]).astype(np.int32))
        want = jtrainer.evaluate_dataset(far, {}, "cityscapes_foggy_val", **kw)
    _assert_same(got, want)
    assert 0 < got["bbox_AP50"] < 100
