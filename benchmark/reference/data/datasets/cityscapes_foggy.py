"""Foggy-Cityscapes instance loader.

This package's own copy of ``ttdg_mgm_tpu/data/datasets/cityscapes_foggy.py``
(reference ``adapteacher/data/datasets/cityscapes_foggy.py``): each foggy
rendering under the image tree (all of them, or those of one fog
attenuation ``beta``) is paired with its ``gtFine_polygons.json``, and its
polygons become instance annotations of the 8 "thing" classes, boxes
``xyxy``.  A ``...group`` polygon is a crowd region of its class; a
``deleted`` object, another label and a polygon of fewer than 3 points are
dropped.  The records are cached as JSON next to the annotations (skipped on
a read-only tree), and the files are parsed on a thread pool.
"""

from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor

#: Cityscapes "thing" classes (hasInstances, not ignoreInEval) in canonical
#: order, contiguous ids 0-7, and their raw label ids
CITYSCAPES_THING_CLASSES = [
    "person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle",
]
_RAW_ID = {
    "person": 24, "rider": 25, "car": 26, "truck": 27,
    "bus": 28, "train": 31, "motorcycle": 32, "bicycle": 33,
}
_LABEL_TO_CONTIGUOUS = {name: i for i, name in enumerate(CITYSCAPES_THING_CLASSES)}
# group labels collapse onto their instance class (the Cityscapes convention)
_GROUP_ALIASES = {name + "group": name for name in CITYSCAPES_THING_CLASSES}

_SPLITS = {
    "cityscapes_foggy_train": ("leftImg8bit_foggy/train", "gtFine/train"),
    "cityscapes_foggy_val": ("leftImg8bit_foggy/val", "gtFine/val"),
    "cityscapes_foggy_test": ("leftImg8bit_foggy/test", "gtFine/test"),
}


def _pair_files(image_dir: str, gt_dir: str, beta: str | None):
    """``(image, polygons json)`` for every foggy rendering on disk, by city
    and file name; raises ``FileNotFoundError`` when there is none."""
    pairs = []
    for city in sorted(os.listdir(image_dir)):
        city_img = os.path.join(image_dir, city)
        if not os.path.isdir(city_img):
            continue
        for fname in sorted(os.listdir(city_img)):
            if "leftImg8bit_foggy" not in fname:
                continue
            if beta is not None and f"beta_{beta}" not in fname:
                continue
            stem = fname.split("leftImg8bit_foggy")[0]
            poly = os.path.join(gt_dir, city, stem + "gtFine_polygons.json")
            pairs.append((os.path.join(city_img, fname), poly))
    if not pairs:
        raise FileNotFoundError(f"no foggy cityscapes images under {image_dir}")
    return pairs


def _file_to_dict(pair):
    image_file, poly_file = pair
    with open(poly_file) as f:
        ann = json.load(f)
    record = {
        "file_name": image_file,
        "image_id": os.path.basename(image_file),
        "height": ann["imgHeight"],
        "width": ann["imgWidth"],
        "annotations": [],
    }
    for obj in ann["objects"]:
        if obj.get("deleted"):
            continue
        label = _GROUP_ALIASES.get(obj["label"], obj["label"])
        if label not in _LABEL_TO_CONTIGUOUS:
            continue
        poly = [float(v) for xy in obj["polygon"] for v in xy]
        if len(poly) < 6:
            continue
        xs, ys = poly[0::2], poly[1::2]
        record["annotations"].append({
            "bbox": [min(xs), min(ys), max(xs), max(ys)],
            "bbox_mode": "xyxy",
            "category_id": _LABEL_TO_CONTIGUOUS[label],
            "raw_category_id": _RAW_ID[label],
            "segmentation": [poly],
            # a "...group" polygon is a crowd region (reference
            # cityscapes_foggy.py:228): ignored by the train loader and
            # the COCO evaluation, its class that of its instances
            "iscrowd": 1 if obj["label"].endswith("group") else 0,
        })
    return record


def load_cityscapes_foggy_instances(image_dir: str, gt_dir: str, beta: str | None = None,
                                    cache: bool = True, workers: int = 8):
    """Foggy-Cityscapes records of ``image_dir`` with the annotations of
    ``gt_dir``.  ``beta``: the fog attenuation to keep (``"0.02"``,
    ``"0.01"``, ``"0.005"``); None keeps every rendering (the reference's
    ``_USE_ALLSPLITS=True``).  With ``cache``, the records are read from
    ``gt_dir/ttdg_cache_{beta or "allsplits"}.json`` when it exists, else
    written there (nothing is written when the tree is read-only)."""
    tag = beta or "allsplits"
    cache_path = os.path.join(gt_dir, f"ttdg_cache_{tag}.json")
    if cache and os.path.exists(cache_path):
        with open(cache_path) as f:
            return json.load(f)
    pairs = _pair_files(image_dir, gt_dir, beta)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        dicts = list(pool.map(_file_to_dict, pairs))
    if cache:
        try:
            with open(cache_path, "w") as f:
                json.dump(dicts, f)
        except OSError:
            pass  # a read-only dataset tree: no cache
    return dicts


def register_all_cityscapes_foggy(root: str | None = None, beta: str | None = None):
    """Register the train, val and test splits under ``root`` (default
    ``$TTDG_DATASETS/cityscapes_foggy``), each scored by the COCO
    evaluator over the 8 thing classes."""
    from reference.data.catalog import DatasetCatalog, MetadataCatalog

    root = root or os.path.join(os.environ.get("TTDG_DATASETS", "datasets"), "cityscapes_foggy")
    for name, (img_rel, gt_rel) in _SPLITS.items():
        img_dir = os.path.join(root, img_rel)
        gt_dir = os.path.join(root, gt_rel)
        DatasetCatalog.register(
            name, lambda i=img_dir, g=gt_dir: load_cityscapes_foggy_instances(i, g, beta))
        meta = MetadataCatalog.get(name)
        meta["thing_classes"] = list(CITYSCAPES_THING_CLASSES)
        meta["evaluator_type"] = "coco"
