"""Evaluator dispatch by dataset type.

This package's own copy of ``ttdg_mgm_tpu/evaluation/build.py``: a
dataset's registered ``evaluator_type`` picks the evaluator (reference
``build_evaluator``) -- Dice, E and S for ``"dice"``, COCO AP for
``"coco"`` (box, and mask when the model has a mask head), VOC mAP for
``"pascal_voc"`` (the 2007 metric when the dataset's ``year`` is 2007) and
over the Watercolor class subset for ``"pascal_voc_water"``.  A dataset
with none falls back to Dice, as the reference's flagship eval path
evaluates every test dataset with ``DiceEvaluator``.
"""

from __future__ import annotations

from ttdg_mgm_torch.data.catalog import MetadataCatalog
from ttdg_mgm_torch.evaluation.coco_eval import COCOEvaluator
from ttdg_mgm_torch.evaluation.dice import DiceEvaluator
from ttdg_mgm_torch.evaluation.pascal_voc import (VOC_CLASS_NAMES, WATERCOLOR_CLASS_NAMES,
                                                  PascalVOCDetectionEvaluator)


def evaluator_type_of(dataset_name: str, override: str | None = None) -> str:
    """The dataset's evaluator type: ``override``, else its metadata, else
    ``"dice"``."""
    if override:
        return override
    return MetadataCatalog.get(dataset_name).get("evaluator_type") or "dice"


def build_evaluator(dataset_name: str, *, dice_threshold: float = 0.9,
                    evaluator_type: str | None = None, mask_on: bool = True):
    """Returns ``(evaluator, evaluator_type)``."""
    etype = evaluator_type_of(dataset_name, evaluator_type)
    meta = MetadataCatalog.get(dataset_name)
    if etype == "dice":
        return DiceEvaluator(dataset_name, dice_threshold), etype
    if etype == "coco":
        return COCOEvaluator(iou_types=("bbox", "segm") if mask_on else ("bbox",)), etype
    if etype == "pascal_voc":
        return PascalVOCDetectionEvaluator(
            meta.get("thing_classes", list(VOC_CLASS_NAMES)),
            use_07_metric=bool(meta.get("year", 2012) == 2007)), etype
    if etype == "pascal_voc_water":
        return PascalVOCDetectionEvaluator(
            meta.get("thing_classes", list(VOC_CLASS_NAMES)),
            eval_class_subset=list(WATERCOLOR_CLASS_NAMES)), "pascal_voc"
    raise NotImplementedError(
        f"no Evaluator for the dataset {dataset_name} with the type {etype}")


def flatten_results(results: dict) -> dict:
    """``{"bbox": {"AP": x}} -> {"bbox_AP": x}``: one flat dict of scalars
    per dataset, so per-family averaging and the ``result_ap.txt`` lines stay
    uniform across evaluators."""
    flat = {}

    def walk(prefix, d):
        for k, v in d.items():
            key = f"{prefix}_{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            elif isinstance(v, (int, float)):
                flat[key] = float(v)

    walk("", results)
    return flat
