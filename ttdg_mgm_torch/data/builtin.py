"""The built-in medical dataset registry.

This package's own copy of ``SPLITS``, ``FAMILIES`` and
``register_all_medical`` of ``ttdg_mgm_tpu/data/builtin.py``: 9 fundus
splits (Drishti-GS, ORIGA, REFUGE, RIM-ONE-r3 train and test, REFUGE-Valid),
8 polyp splits (BKAI, CVC-ClinicDB, ETIS-LaribPolypDB, Kvasir-SEG) and
COVID lung, under a root given as an argument or by ``TTDG_DATASETS``.
The legacy registrations (COCO unlabeled, foggy Cityscapes, Clipart1k,
Watercolor) are not ported: they need those datasets' own loaders.
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
