"""Evaluator dispatch by dataset type.

This package's own copy of ``ttdg_mgm_tpu/evaluation/build.py`` for the
Dice evaluator: a dataset's registered ``evaluator_type`` picks the
evaluator, and a dataset with none falls back to Dice, as the reference's
flagship eval path evaluates every test dataset with ``DiceEvaluator``.  The
COCO and Pascal VOC evaluators are not ported yet (``ROADMAP.md``, Queue 1,
"COCO and VOC evaluators"); asking for one raises.
"""

from __future__ import annotations

from ttdg_mgm_torch.data.catalog import MetadataCatalog
from ttdg_mgm_torch.evaluation.dice import DiceEvaluator

_NOT_PORTED = ("coco", "pascal_voc", "pascal_voc_water")


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
    if etype == "dice":
        return DiceEvaluator(dataset_name, dice_threshold), etype
    if etype in _NOT_PORTED:
        raise NotImplementedError(
            f"the {etype!r} evaluator of dataset {dataset_name} is not ported to "
            "ttdg_mgm_torch yet (ROADMAP.md, Queue 1: the COCO and VOC evaluators); "
            "the port evaluates with Dice only")
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
