"""A cell shrunk to a size the CPU runs in seconds: depth 14, narrow FPN and
heads, small RPN and graph budgets, 64-pixel images, few frames."""

from __future__ import annotations

import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

import harness  # noqa: E402

SMALL_CFG = {
    "MODEL": {"RESNETS": {"DEPTH": 14}, "FPN": {"OUT_CHANNELS": 32},
              "ROI_BOX_HEAD": {"FC_DIM": 64}, "ROI_MASK_HEAD": {"CONV_DIM": 32},
              "RPN": {"PRE_NMS_TOPK_TEST": 200, "POST_NMS_TOPK_TEST": 100,
                      "PRE_NMS_TOPK_TRAIN": 200},
              "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 64},
              "GRAPH": {"MAX_NODES": 20, "UNIV_SIZE": 8, "NODE_DIM": 32,
                        "GAGM_ITERS": 20, "HIPPI_ITERS": 5}},
    "INPUT": {"MIN_SIZE_TEST": 64, "MAX_SIZE_TEST": 96, "MIN_SIZE_TRAIN": [56, 64]},
    "TPU": {"PRECISION": "float32", "MAX_GT_PER_IMAGE": 8},
    "TEST": {"DETECTIONS_PER_IMAGE": 20},
    "SOLVER": {"AMP": {"ENABLED": False}},
}


def small_spec(cell: str, batch: int = 2) -> harness.Spec:
    """The cell's spec with :data:`SMALL_CFG` over its configuration, frames
    of at most 96 pixels and a batch of ``batch``."""
    spec = harness.Spec(cell)
    spec.cfg = harness.merge(spec.cfg, SMALL_CFG)
    spec.cfg["TEST"]["BATCH"] = batch
    spec.cfg["SOLVER"]["IMS_PER_BATCH"] = batch
    spec.traffic = copy.deepcopy(spec.traffic)
    for s in spec.traffic["splits"]:
        h, w = s["hw"]
        k = 96 / max(h, w)
        s["hw"] = [max(int(h * k), 32), max(int(w * k), 32)]
        s["n"] = min(s["n"], 4 * batch)
        if "mean_objects" in s:
            s["mean_objects"], s["max_objects"] = 3, 6
    return spec
