"""The built-in dataset registries.

This package's own copy of ``SPLITS``, ``FAMILIES``,
``register_all_medical``, ``_load_images_only_json`` and
``register_all_legacy`` of ``ttdg_mgm_tpu/data/builtin.py``: 9 fundus
splits (Drishti-GS, ORIGA, REFUGE, RIM-ONE-r3 train and test, REFUGE-Valid),
8 polyp splits (BKAI, CVC-ClinicDB, ETIS-LaribPolypDB, Kvasir-SEG) and
COVID lung, under a root given as an argument or by ``TTDG_DATASETS``; and
the legacy domain-adaptation registrations (COCO-2017 unlabeled, foggy
Cityscapes, Clipart1k, Watercolor), a library entry point that no command
line calls, as in the JAX package.
"""

from __future__ import annotations

import os

from ttdg_mgm_torch.data.catalog import DatasetCatalog
from ttdg_mgm_torch.data.coco import register_coco_instances

SPLITS = {
    # Fundus (optic disc / cup, 2 classes)
    "Drishti_GS_train": ("Fundus/Drishti_GS_train.json", "Fundus/Drishti_GS/train/image"),
    "Drishti_GS_test": ("Fundus/Drishti_GS_test.json", "Fundus/Drishti_GS/test/image"),
    "ORIGA_train": ("Fundus/ORIGA_train.json", "Fundus/ORIGA/train/image"),
    "ORIGA_test": ("Fundus/ORIGA_test.json", "Fundus/ORIGA/test/image"),
    "REFUGE_train": ("Fundus/REFUGE_train.json", "Fundus/REFUGE/train/image"),
    "REFUGE_test": ("Fundus/REFUGE_test.json", "Fundus/REFUGE/test/image"),
    "RIM_ONE_r3_train": ("Fundus/RIM_ONE_r3_train.json", "Fundus/RIM_ONE_r3/train/image"),
    "RIM_ONE_r3_test": ("Fundus/RIM_ONE_r3_test.json", "Fundus/RIM_ONE_r3/test/image"),
    "REFUGE_Valid": ("Fundus/REFUGE_Valid.json", "Fundus/REFUGE_Valid/image"),
    # Polyp (1 class)
    "BKAI_train": ("Polyp/BKAI_train.json", "Polyp/BKAI/train/image"),
    "BKAI_test": ("Polyp/BKAI_test.json", "Polyp/BKAI/test/image"),
    "CVC_ClinicDB_train": ("Polyp/CVC-ClinicDB_train.json", "Polyp/CVC-ClinicDB/train/image"),
    "CVC_ClinicDB_test": ("Polyp/CVC-ClinicDB_test.json", "Polyp/CVC-ClinicDB/test/image"),
    "ETIS_LaribPolypDB_train": ("Polyp/ETIS-LaribPolypDB_train.json", "Polyp/ETIS-LaribPolypDB/train/image"),
    "ETIS_LaribPolypDB_test": ("Polyp/ETIS-LaribPolypDB_test.json", "Polyp/ETIS-LaribPolypDB/test/image"),
    "Kvasir_SEG_train": ("Polyp/Kvasir-SEG_train.json", "Polyp/Kvasir-SEG/train/image"),
    "Kvasir_SEG_test": ("Polyp/Kvasir-SEG_test.json", "Polyp/Kvasir-SEG/test/image"),
    # Lung
    "COVID_train": ("covid19/0_train.json", "covid19/0/train/images"),
    "COVID_test": ("covid19/0_test.json", "covid19/0/test/images"),
}

# dataset families for per-family metric averaging (reference
# ``engine/trainer.py:509-527`` groups results by source dataset family)
FAMILIES = {
    "Fundus": [k for k in SPLITS if "Fundus" in SPLITS[k][0]],
    "Polyp": [k for k in SPLITS if "Polyp" in SPLITS[k][0]],
    "Lung": ["COVID_train", "COVID_test"],
}

_registered = False


def register_all_medical(root: str | None = None, force: bool = False):
    """Register every split of ``SPLITS`` under ``root`` (or
    ``TTDG_DATASETS``, or ``datasets``), each evaluated with Dice; a second
    call does nothing unless ``force`` re-registers them."""
    global _registered
    if _registered and not force:
        return
    root = root or os.environ.get("TTDG_DATASETS", "datasets")
    for name, (json_rel, img_rel) in SPLITS.items():
        if force:
            DatasetCatalog.remove(name)
        register_coco_instances(name, os.path.join(root, json_rel),
                                os.path.join(root, img_rel), evaluator_type="dice")
    _registered = True


def _load_images_only_json(json_file: str, image_root: str) -> list[dict]:
    """Image records without annotations, sorted by image id (reference
    ``load_coco_unlabel_json``, ``builtin.py:75-108``)."""
    import json

    with open(json_file) as f:
        coco = json.load(f)
    return [{"file_name": os.path.join(image_root, img["file_name"]),
             "height": img["height"], "width": img["width"], "image_id": img["id"],
             "annotations": []}
            for img in sorted(coco["images"], key=lambda im: im["id"])]


def register_all_legacy(root: str | None = None):
    """The legacy domain-adaptation registrations (reference
    ``builtin.py:32-183``) under ``root`` (or ``DETECTRON2_DATASETS``, or
    ``TTDG_DATASETS``, or ``datasets``), each loaded when first read:
    ``coco_2017_unlabel`` and ``coco_2017_for_voc20`` (image-only records),
    ``cityscapes_foggy_{train,val,test}`` (``cityscapes_foggy/leftImg8bit``
    and ``gtFine``, every fog rendering, 8 classes, COCO evaluator) and
    ``Clipart1k_{train,test}`` and ``Watercolor_{train,test}`` (VOC layout
    under ``clipart`` and ``watercolor``, 20 classes, VOC evaluator;
    Watercolor's scores its 6-class subset).  A name already registered
    raises ``KeyError``."""
    from ttdg_mgm_torch.data.catalog import MetadataCatalog
    from ttdg_mgm_torch.data.datasets.cityscapes_foggy import (CITYSCAPES_THING_CLASSES,
                                                               load_cityscapes_foggy_instances)
    from ttdg_mgm_torch.data.datasets.pascal_voc import register_pascal_voc

    root = root or os.environ.get("DETECTRON2_DATASETS",
                                  os.environ.get("TTDG_DATASETS", "datasets"))
    for name, (image_root, json_file) in {
        "coco_2017_unlabel": ("coco/unlabeled2017",
                              "coco/annotations/image_info_unlabeled2017.json"),
        "coco_2017_for_voc20": (
            "coco", "coco/annotations/google/instances_unlabeledtrainval20class.json"),
    }.items():
        DatasetCatalog.register(
            name, lambda j=os.path.join(root, json_file), i=os.path.join(root, image_root):
            _load_images_only_json(j, i))
        MetadataCatalog.get(name)["evaluator_type"] = "coco"

    for split in ("train", "val", "test"):
        name = f"cityscapes_foggy_{split}"
        img_dir = os.path.join(root, f"cityscapes_foggy/leftImg8bit/{split}")
        gt_dir = os.path.join(root, f"cityscapes_foggy/gtFine/{split}")
        DatasetCatalog.register(
            name, lambda i=img_dir, g=gt_dir: load_cityscapes_foggy_instances(i, g))
        meta = MetadataCatalog.get(name)
        meta["thing_classes"] = list(CITYSCAPES_THING_CLASSES)
        meta["evaluator_type"] = "coco"

    for name, dirname, split in (("Clipart1k_train", "clipart", "train"),
                                 ("Clipart1k_test", "clipart", "test"),
                                 ("Watercolor_train", "watercolor", "train"),
                                 ("Watercolor_test", "watercolor", "test")):
        register_pascal_voc(name, os.path.join(root, dirname), split)
        if name.startswith("Watercolor"):
            MetadataCatalog.get(name)["evaluator_type"] = "pascal_voc_water"
