"""Pascal-VOC-layout dataset loader (the Clipart1k and Watercolor
domain-adaptation sets).

This package's own copy of ``ttdg_mgm_tpu/data/datasets/pascal_voc.py``
(d2's ``register_pascal_voc``, as the reference's legacy registrations use
it): the ids of ``ImageSets/Main/{split}.txt``, each
``Annotations/{id}.xml`` parsed with ``xml.etree`` into a record of ``xyxy``
boxes with contiguous class ids; VOC's 1-indexed corners are shifted by
one at the origin, ``difficult`` is kept, a class outside ``class_names``
is dropped, and no record has a mask (``segmentation`` None).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

VOC_CLASS_NAMES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)
#: the Watercolor subset (the reference's ``pascal_voc_water`` evaluator)
WATERCOLOR_CLASS_NAMES = ("bicycle", "bird", "car", "cat", "dog", "person")


def load_voc_instances(dirname: str, split: str, class_names=VOC_CLASS_NAMES) -> list[dict]:
    """Records of ``split`` under ``dirname``, which holds ``Annotations/``,
    ``ImageSets/`` and ``JPEGImages/``."""
    with open(os.path.join(dirname, "ImageSets", "Main", split + ".txt")) as f:
        fileids = [line.strip() for line in f if line.strip()]
    name_to_id = {n: i for i, n in enumerate(class_names)}

    dicts = []
    for fileid in fileids:
        anno_file = os.path.join(dirname, "Annotations", fileid + ".xml")
        jpeg_file = os.path.join(dirname, "JPEGImages", fileid + ".jpg")
        record = {"file_name": jpeg_file, "image_id": fileid, "annotations": []}
        tree = ET.parse(anno_file)
        size = tree.find("size")
        record["height"] = int(float(size.find("height").text))
        record["width"] = int(float(size.find("width").text))
        for obj in tree.findall("object"):
            cls = obj.find("name").text
            if cls not in name_to_id:
                continue
            bb = obj.find("bndbox")
            # VOC boxes are 1-indexed and inclusive; d2 moves the origin
            # corner by one
            bbox = [float(bb.find("xmin").text) - 1.0, float(bb.find("ymin").text) - 1.0,
                    float(bb.find("xmax").text), float(bb.find("ymax").text)]
            record["annotations"].append({
                "category_id": name_to_id[cls],
                "bbox": bbox,
                "bbox_mode": "xyxy",
                "difficult": int((obj.find("difficult").text or "0"))
                if obj.find("difficult") is not None else 0,
                "iscrowd": 0,
                "segmentation": None,
            })
        dicts.append(record)
    return dicts


def register_pascal_voc(name: str, dirname: str, split: str, class_names=VOC_CLASS_NAMES,
                        year: int | None = None):
    """Register ``name`` (the records of ``split`` under ``dirname``),
    scored by the VOC evaluator; ``year`` 2007 selects VOC2007's 11-point
    metric (``evaluation/build.py`` reads it; unset, the area metric)."""
    from ttdg_mgm_torch.data.catalog import DatasetCatalog, MetadataCatalog

    DatasetCatalog.register(name, lambda: load_voc_instances(dirname, split, class_names))
    meta = MetadataCatalog.get(name)
    meta["thing_classes"] = list(class_names)
    meta["dirname"] = dirname
    meta["split"] = split
    meta["evaluator_type"] = "pascal_voc"
    if year is not None:
        meta["year"] = year
