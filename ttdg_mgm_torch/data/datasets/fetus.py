"""Fetal-ultrasound detection dataset (the legacy standalone loader).

This package's own copy of ``ttdg_mgm_tpu/data/datasets/fetus.py``
(reference ``adapteacher/data/datasets/fetus_dataset.py:157-493``), over a
tree laid out by hospital::

    <root>/<hospital>/annotations/<slice>_annotations.json
    <root>/<hospital>/<slice>/<image file>

where each annotation file maps an image's file name to ``{"bodyPart",
"annotations": [{"name", "vertex": [[x1, y1], [x2, y2]]}, ...]}``.  An
image is kept when its file exists, its ``bodyPart`` is its slice's and it
has at least one organ of the slice's vocabulary; the kept images are split
0.7 / 0.1 / 0.2 into train, valid and test by a seeded
``numpy.random.Generator``, and organ names become labels through per-slice
vocabularies (``label_maps``).  Images are decoded by the port's own
``data/loader.py:load_image`` (PNG, JPEG, TIFF and BMP), not Pillow.

No ``fetus_*`` split is registered, in this package or in the JAX one, so a
config that names one (``configs/test_detection.yaml``) raises ``KeyError``
in both.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ttdg_mgm_torch.data.loader import load_image

#: per-slice organ name -> label (the dataset's schema; reference
#: ``fetus_dataset.py:57-75``): heart and brain slices, organs from 1 (0 is
#: the background)
DEFAULT_LABEL_MAPS = {
    "four_chamber_heart": {
        "右心房": 1, "右心室": 2, "左心室": 3, "室间隔": 4, "脊柱": 5,
        "左心房": 6, "房室间隔十字交叉": 7, "降主动脉": 8, "肋骨": 9,
    },
    "left_ventricular_outflow_tract": {
        "右心室": 1, "左室流出道及主动脉": 2, "左心室": 3, "脊柱": 4, "室间隔": 5,
    },
    "right_ventricular_outflow_tract": {
        "右心室": 1, "主肺动脉及动脉导管": 2, "脊柱": 3, "左心室": 4,
        "升主动脉": 5, "主动脉弓": 6,
    },
    "three_vessel_tracheal": {
        "降主动脉": 1, "脊柱": 2, "主肺动脉及动脉导管": 3, "气管": 4,
        "上腔静脉": 5, "主动脉弓": 6,
    },
    "cenao": {
        "侧脑室后角": 1, "丘脑": 2, "脉络丛": 3, "透明隔腔": 4, "脑中线": 5,
        "大脑外侧裂": 6, "颅骨强回声环": 7,
    },
    "qiunao": {
        "丘脑": 1, "大脑外侧裂": 2, "脉络丛": 3, "透明隔腔": 4, "脑中线": 5,
        "颅骨强回声环": 6, "小脑": 7,
    },
    "xiaonao": {
        "小脑": 1, "丘脑": 2, "大脑外侧裂": 3, "透明隔腔": 4, "脑中线": 5,
        "颅后窝池": 6, "颅骨强回声环": 7,
    },
}

SLICE_BODYPART = {
    "four_chamber_heart": "四腔心切面",
    "left_ventricular_outflow_tract": "左室流出道切面",
    "right_ventricular_outflow_tract": "右室流出道切面",
    "three_vessel_tracheal": "三血管气管切面",
    "cenao": "侧脑室水平横切面",
    "qiunao": "丘脑水平横切面",
    "xiaonao": "小脑水平横切面",
}


def _vertex_to_xyxy(vertex) -> np.ndarray:
    (x1, y1), (x2, y2) = vertex[0], vertex[1]
    return np.asarray(
        [min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)], np.float32
    )


def _scan(root: str, hospitals, slices, label_maps, bodypart_ok):
    """``{"<hospital>/<slice>/<file>": record}`` over every hospital's and
    slice's annotation file."""
    images = {}
    for hospital in hospitals:
        ann_dir = os.path.join(root, hospital, "annotations")
        if not os.path.isdir(ann_dir):
            continue
        for slice_name in slices:
            path = os.path.join(ann_dir, f"{slice_name}_annotations.json")
            if not os.path.exists(path):
                continue
            with open(path) as f:
                per_image = json.load(f)["annotations"]
            vocab = label_maps[slice_name]
            want_part = bodypart_ok.get(slice_name)
            for key, info in per_image.items():
                img_path = os.path.join(root, hospital, slice_name, key)
                if not os.path.exists(img_path):
                    continue
                if want_part and info.get("bodyPart") not in want_part:
                    continue
                boxes, labels = [], []
                for organ in info.get("annotations", []):
                    if organ.get("name") in vocab:
                        boxes.append(_vertex_to_xyxy(organ["vertex"]))
                        labels.append(vocab[organ["name"]])
                if not boxes:
                    continue
                images[f"{hospital}/{slice_name}/{key}"] = {
                    "file_name": img_path,
                    "image_id": key,
                    "slice": slice_name,
                    "hospital": hospital,
                    "boxes": np.stack(boxes),
                    "labels": np.asarray(labels, np.int64),
                }
    return images


def _split_keys(keys, ratios, seed):
    keys = sorted(keys)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(len(keys))
    n_train = int(len(keys) * ratios[0])
    n_valid = int(len(keys) * ratios[1])
    train = [keys[i] for i in perm[:n_train]]
    valid = [keys[i] for i in perm[n_train : n_train + n_valid]]
    test = sorted(keys[i] for i in perm[n_train + n_valid :])
    return {"train": train, "valid": valid, "test": test}


class FetusDataset:
    """The records of one split (``operation``: train, valid or test);
    indexing decodes the image: ``rec["image"]`` ``(H, W, 3)`` uint8 RGB."""

    def __init__(
        self,
        root: str,
        hospitals,
        slices,
        operation: str = "train",
        ratios=(0.7, 0.1, 0.2),
        seed: int = 6666,
        label_maps: dict | None = None,
        bodypart_filter: dict | None = None,
    ):
        if operation not in ("train", "valid", "test"):
            raise ValueError(f"operation must be train/valid/test, got {operation}")
        label_maps = label_maps or DEFAULT_LABEL_MAPS
        bodypart = bodypart_filter
        if bodypart is None:
            bodypart = {s: {SLICE_BODYPART[s]} for s in slices if s in SLICE_BODYPART}
        self.images = _scan(root, hospitals, slices, label_maps, bodypart)
        self.splits = _split_keys(self.images.keys(), ratios, seed)
        self.operation = operation
        self.used = self.splits[operation]

    def __len__(self):
        return len(self.used)

    def __getitem__(self, index: int) -> dict:
        rec = dict(self.images[self.used[index]])
        rec["image"] = load_image(rec["file_name"])
        rec["height"], rec["width"] = rec["image"].shape[:2]
        return rec


def load_fetus_dicts(root: str, hospitals, slices, operation="test", **kw):
    """Catalog records of one split (no image decoded): ``xyxy`` boxes,
    0-based class ids."""
    ds = FetusDataset(root, hospitals, slices, operation=operation, **kw)
    out = []
    for key in ds.used:
        rec = ds.images[key]
        out.append({
            "file_name": rec["file_name"],
            "image_id": rec["image_id"],
            "annotations": [
                {
                    "bbox": box.tolist(),
                    "bbox_mode": "xyxy",
                    # the catalog's classes are 0-based
                    "category_id": int(label) - 1,
                    "iscrowd": 0,
                }
                for box, label in zip(rec["boxes"], rec["labels"])
            ],
        })
    return out
