"""COCO-instances JSON parsing with no pycocotools (d2 ``load_coco_json`` and
``register_coco_instances``).  This package's own copy of
``ttdg_mgm_tpu/data/coco.py``.

Records follow the d2 schema the loaders and evaluators read:
``{file_name, image_id, height, width, annotations: [{bbox (XYXY, absolute),
category_id (contiguous), segmentation, iscrowd}]}``.
"""

from __future__ import annotations

import json
import os

from reference.data.catalog import DatasetCatalog, MetadataCatalog


def load_coco_json(json_file: str, image_root: str):
    with open(json_file) as f:
        coco = json.load(f)

    cat_ids = sorted(c["id"] for c in coco.get("categories", []))
    id_map = {cid: i for i, cid in enumerate(cat_ids)}

    anns_by_img: dict = {}
    for ann in coco.get("annotations", []):
        anns_by_img.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in coco["images"]:
        anns = []
        for ann in anns_by_img.get(img["id"], []):
            x, y, w, h = ann["bbox"]
            # crowd annotations stay in the record: evaluation treats them as
            # ignore regions, the training path drops them
            anns.append({
                "bbox": [x, y, x + w, y + h],
                "category_id": id_map.get(ann["category_id"], ann["category_id"]),
                "segmentation": ann.get("segmentation"),
                "iscrowd": ann.get("iscrowd", 0),
            })
        records.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
            "annotations": anns,
        })
    return records


def register_coco_instances(name: str, json_file: str, image_root: str,
                            evaluator_type: str | None = None):
    """``evaluator_type`` goes into the dataset's metadata (``"dice"``,
    ``"coco"``, ...); unset, evaluation falls back to Dice
    (``evaluation/build.py``)."""
    DatasetCatalog.register(name, lambda: load_coco_json(json_file, image_root))
    meta = MetadataCatalog.get(name)
    meta.update({"json_file": json_file, "image_root": image_root})
    if evaluator_type is not None:
        meta["evaluator_type"] = evaluator_type
