"""The ViTDet-B cell (``vitdet_b_tta_fundus``) and the mean-teacher cell
(``r50_mt_fundus``) on the CPU at small.py's size: each run is correct
against the cell's own limits, each planted fault of the cell makes it
false (the relative-position bias left out of the program's attention; the
teacher never updated, its moving average skipped, or at another keep
rate), and a traced run reads the cell's per-layer metrics that a CPU run
has (the trace's kernel metrics need the card).  The ViTDet cell runs a
ViT of width 64, 4 heads and 3 blocks (window, window, global) on a 96
square, the mean-teacher cell 2 labelled and 2 unlabelled images a batch.

The ViTDet reference computes two parts in other forms than the program:
the position embedding's resize (``F.interpolate`` against two matrix
products) and the channel LayerNorm (detectron2's formula against
``F.layer_norm``), a few float32 ulps apart.  At this size most leaves get no
gradient at all, so the median leaf's is 0 and ``compare.moving_leaves``
keeps every leaf; among them the matching affinity's last bias, whose
gradient is ~1e-4 of the median of the leaves the loss reaches and whose
change after three steps (~4e-13) those ulps move by 0.3-0.9 of its norm.
So the test reads ``change_gap`` by ``moving_leaves``'s own rule over the
leaves the loss reaches (:func:`_change_gap`), and names the leaf it leaves
out with its reading.  The card's sound runs read the harness's own
``change_gap`` (``PERF.md`` section 2)."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

import compare
import control_faults  # noqa: F401  (adds the cells' faults to control.PROGRAM_FAULTS)
import harness
from control import program_numbers
from small import small_spec

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23

#: the small ViT over small.py's configuration
SMALL_VIT = {"MODEL": {"VIT": {"EMBED_DIM": 64, "DEPTH": 3, "NUM_HEADS": 4, "WINDOW_SIZE": 4,
                               "WINDOW_BLOCK_INDEXES": [0, 1], "SQUARE_PAD": 96},
                       "ROI_BOX_HEAD": {"CONV_DIM": 32}},
             "INPUT": {"MIN_SIZE_TEST": 96, "MAX_SIZE_TEST": 96}}


def _spec(cell: str) -> harness.Spec:
    spec = small_spec(cell)
    if cell == "vitdet_b_tta_fundus":
        spec.cfg = harness.merge(spec.cfg, SMALL_VIT)
    else:
        spec.cfg["SOLVER"]["IMG_PER_BATCH_LABEL"] = 2
        spec.cfg["SOLVER"]["IMG_PER_BATCH_UNLABEL"] = 2
    return spec


def _change_gap(got: dict, ref: dict, run) -> tuple[float, list]:
    """``change_gap`` over the leaves that ``compare.moving_leaves`` keeps
    among those the loss reaches (a raw reference gradient other than 0):
    at this size most leaves get none, their median is 0 and the rule keeps
    every leaf.  Also ``[(leaf, its change's gap, its raw gradient over the
    median)]`` of the leaves reached but left out."""
    wd = run.cfg["SOLVER"]["WEIGHT_DECAY"]
    p0 = {k: run.weights[k] for k in ref["grad"]}
    raw = {k: float(torch.linalg.vector_norm((g - wd * p0[k]).double()))
           for k, g in ref["grad"].items()}
    reached = {k for k, v in raw.items() if v > 0}
    keep = compare.moving_leaves({k: ref["grad"][k] for k in reached}, wd, p0)
    cp, cr = compare.change(got["params"], p0), compare.change(ref["params"], p0)
    med = float(np.median([raw[k] for k in reached]))
    gaps = dict(compare.leaf_gaps(cp, cr, reached))
    out = [(k, gaps[k], raw[k] / med) for k in sorted(reached - keep)]
    return compare.worst_leaf(cp, cr, keep), out


@pytest.mark.parametrize("cell,metrics", [
    ("vitdet_b_tta_fundus", {"tta_mfu.vitdet", "tta_step_ms", "loader_wait_share.tta",
                             "decode_ms_per_image.tta", "eval_ms_per_image.tta"}),
    ("r50_mt_fundus", {"mt_step_ms.mt", "loader_wait_share.mt", "train_images_per_s.loop",
                       "decode_ms_per_image.train"}),
])
def test_new_cell_is_correct_and_reads_its_metrics(cell, metrics, monkeypatch):
    spec = _spec(cell)
    job = __import__("jobs." + spec.job, fromlist=["numbers"])
    seen = {}
    real = job.numbers

    def numbers(got, ref, run, log=None):
        seen.update(got=got, ref=ref, run=run)
        return real(got, ref, run, log=log)

    monkeypatch.setattr(job, "numbers", numbers)
    result = harness.execute(spec, SEED, 0.5, True, CPU, time.perf_counter(), log=lambda m: None)
    checks = result["checks"]
    if cell == "vitdet_b_tta_fundus":
        assert all(v["value"] <= v["limit"] for k, v in checks.items() if k != "change_gap"), \
            checks
        change, left_out = _change_gap(seen["got"], seen["ref"], seen["run"])
        # one leaf is left out at this size: the matching affinity's last
        # bias, whose gradient is ~1e-4 of the median and whose change the
        # ulps above move by 0.3-0.9 of its norm
        assert [k for k, _, _ in left_out] == ["multi_matching_unsup.node_affinity.fc_M.2.bias"], \
            left_out
        assert change <= checks["change_gap"]["limit"], (change, left_out, checks)
    else:
        assert result["correct"] is True, checks
    assert result["attempted"] > 0 and result["failed"] == 0
    assert metrics <= set(result["metrics"]), result["metrics"]


@pytest.mark.parametrize("cell,fault", [("vitdet_b_tta_fundus", "_no_rel_pos"),
                                        ("r50_mt_fundus", "_teacher_not_updated"),
                                        ("r50_mt_fundus", "_ema_skipped"),
                                        ("r50_mt_fundus", "_wrong_keep_rate")])
def test_planted_fault_makes_the_cell_incorrect(cell, fault):
    out = program_numbers(_spec(cell), SEED, CPU, 0.2, log=lambda m: None, plant=fault)
    assert out["correct"] is False, out["checks"]


def test_vitdet_attention_work():
    """The captures' shapes and arithmetic at ViTDet-B's published size and
    the cell's batch of 4: 8 windowed blocks of 4 x 25 windows x 12 heads of
    196 tokens, 4 global of 4 x 12 slices of 4,096; the global blocks'
    attention products 0.21 TFLOP an image in one forward."""
    from captures.vitdet import attention_work, block_shapes, forward_flops, least_seconds

    cfg = harness.Spec("vitdet_b_tta_fundus").cfg
    shapes = block_shapes(cfg, 4)
    assert shapes.count((1200, 196, 14, 14)) == 8 and shapes.count((48, 4096, 64, 64)) == 4
    assert [i for i, s in enumerate(shapes) if s[1] == 4096] == [2, 5, 8, 11]
    glob = 4 * attention_work(48, 4096, 64, 64, False)[1]
    assert glob == pytest.approx(4 * 4 * 48 * 4096 ** 2 * 64) and 0.8e12 < glob < 0.85e12
    assert forward_flops(cfg, 4) == pytest.approx(glob + 8 * 4 * 1200 * 196 ** 2 * 64)
    # the windows are memory-bound, the global slices compute-bound
    nbytes, flops = attention_work(1200, 196, 14, 14, False)
    assert least_seconds(1200, 196, 14, 14, False) == pytest.approx(nbytes / 3.35e12)
    assert least_seconds(48, 4096, 64, 64, True) == pytest.approx(
        attention_work(48, 4096, 64, 64, True)[1] / 989e12)
