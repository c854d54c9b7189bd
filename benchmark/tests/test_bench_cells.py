"""The harness end to end on the CPU at a small size: every cell's run gives
the result line's keys, the reference agrees with the port exactly (on the
CPU the port runs its plain versions, which the reference copies), a cell,
a traffic mix and a metric added as new files alone are found, and each
fault a cell can have makes ``correct`` false under the cell's limits."""

from __future__ import annotations

import json
import os
import shutil
import time

import pytest
import torch

import harness
from control import PROGRAM_FAULTS
from small import small_spec

CPU = torch.device("cpu")
CELLS = ("r50_tta_fundus", "vgg_source_cityscapes")


def _run(spec, seed=2 ** 31 + 11, trace=False):
    return harness.execute(spec, seed, 0.5, trace, CPU, time.perf_counter(), log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_small_run_matches_reference(cell):
    result = _run(small_spec(cell))
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    assert all(v["value"] == 0.0 for v in result["checks"].values()), result["checks"]
    assert set(result["checks"]) == set(small_spec(cell).limits["limits"])
    names = {m["name"] for m in small_spec(cell).end_to_end}
    assert set(result["metrics"]) == names
    assert result["device"]["platform"] == "cpu"


def test_traced_run_reads_per_layer_metrics():
    spec = small_spec("r50_tta_fundus")
    result = _run(spec, trace=True)
    # no profiler trace on the CPU: the device metrics are left out, the rest read
    assert {"loader_wait_share.tta", "decode_ms_per_image.tta", "tta_step_ms", "tta_mfu",
            "eval_ms_per_image.tta"} <= set(result["metrics"])
    assert "device_idle_share.tta" not in result["metrics"]
    assert all(v["value"] > 0 for v in result["metrics"].values())


def test_new_cell_traffic_and_metric_are_found_from_new_files(tmp_path):
    """A new cell needs an entry in BENCHMARK.json and new data files only:
    here a TTA mix of 8 PNG frames and a new per-layer metric."""
    src = harness.HERE
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(src, sub), bench / sub)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    traffic = json.loads((bench / "traffic" / "refuge_test_16.json").read_text())
    traffic["splits"][0]["n"] = 8
    (bench / "traffic" / "refuge_test_8.json").write_text(json.dumps(traffic))
    (bench / "limits" / "r50_tta_fundus8.json").write_text(
        (bench / "limits" / "r50_tta_fundus.json").read_text())
    (bench / "metrics" / "passes.tta.py").write_text(
        "UNIT = 'passes'\nMOVES = 'tta_images_per_s'\n\n\n"
        "def read(record):\n    return record['counts'].get('passes')\n")
    b["workloads"].append({"name": "r50_tta_fundus8", "config": "r50_fpn_mask_rcnn",
                           "traffic": "refuge_test_8", "chips": 1, "why": "test"})
    b["per_layer"].append({"name": "passes.tta", "unit": "passes", "better": "higher",
                           "source": "program_counter", "layer": "trainer loop",
                           "moves": "tta_images_per_s", "workloads": ["r50_tta_fundus8"]})
    for m in b["end_to_end"] + b["per_layer"]:
        if "r50_tta_fundus" in m.get("workloads", ()):
            m["workloads"].append("r50_tta_fundus8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.Spec("r50_tta_fundus8", root=str(tmp_path))
    small = small_spec("r50_tta_fundus")
    spec.cfg = small.cfg
    spec.traffic["splits"][0]["hw"] = small.traffic["splits"][0]["hw"]
    result = _run(spec, trace=True)
    assert result["correct"] is True
    assert result["metrics"]["passes.tta"]["value"] >= 1
    assert result["attempted"] % 8 == 0


# -- faults: each one the cell can have makes ``correct`` false ---------------

FAULTS = [(cell, f) for cell in CELLS for f in ("_no_update", "_half_batch")]
FAULTS += [("r50_tta_fundus", "_altered_answer"), ("r50_tta_fundus", "_altered_matching"),
           ("vgg_source_cityscapes", "_altered_projection")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_makes_correct_false(monkeypatch, cell, fault):
    PROGRAM_FAULTS[fault](monkeypatch.setattr)
    result = _run(small_spec(cell))
    assert result["correct"] is False, result["checks"]


def test_finale_gap_reads_an_assignment_and_its_objective():
    """GA-GM's finale by itself: a sound solve reads 0, an answer that is
    no assignment reads 1, an assignment moved one node on reads above the
    cell's limit."""
    from decisions import shift_assignments
    from jobs.tta import finale_gap
    from reference.ops.gagm import ga_gm_fused

    g = torch.Generator().manual_seed(5)
    G, M, nu = 3, 10, 6
    A = torch.zeros(G * M, G * M)
    for b in range(G):
        blk = torch.rand(M, M, generator=g)
        A[b * M:(b + 1) * M, b * M:(b + 1) * M] = (blk + blk.T) / 2
    W = torch.rand(G * M, G * M, generator=g)
    W = (W + W.T) / 2
    U0 = torch.full((G * M, nu), 1.0 / nu)
    ms = torch.tensor([10, 8, 4])
    kw = {"quad_weight": 1.0, "mgm_iter": 20, "sk_iter": 20, "sk_tau0": 0.1, "sk_gamma": 0.5,
          "min_tau": 1e-2, "tol": 1e-3, "lap_iter_cap": 20, "return_steps": True}
    out = ga_gm_fused(A, W, U0, ms, nu, **kw)
    choice = {"args": ((A, W, U0, ms, nu), kw), "out": out}
    assert finale_gap(ga_gm_fused, choice, CPU) == 0.0
    doubled = out[0].clone()
    doubled[0] = 1.0
    assert finale_gap(ga_gm_fused, {**choice, "out": (doubled, out[1])}, CPU) == 1.0

    def shifted(*a, **k):
        return shift_assignments(ga_gm_fused(*a, **k), *a)

    limit = harness.Spec("r50_tta_fundus").limits["limits"]["finale_gap"]
    assert finale_gap(shifted, choice, CPU) > limit


def test_reading_modes_run_at_a_small_size():
    """The readings the limits are set from: the program's matching numbers
    alone (sound: 0 on the CPU, where the program runs its plain versions;
    with the matching altered: above the limit), and the reference against
    itself with its weights moved one ulp."""
    from control import nudge_numbers, program_numbers

    spec = small_spec("r50_tta_fundus")
    quiet = lambda m: None  # noqa: E731
    sound = program_numbers(spec, 2 ** 31 + 17, CPU, 0.5, quiet, choosers=True)
    assert sound == {"match_gap": 0.0, "finale_gap": 0.0}
    bad = program_numbers(spec, 2 ** 31 + 17, CPU, 0.5, quiet, plant="_altered_matching",
                          choosers=True)
    assert bad["finale_gap"] > spec.limits["limits"]["finale_gap"]
    nudge = nudge_numbers(small_spec("vgg_source_cityscapes"), 2 ** 31 + 17, CPU, quiet)
    assert nudge["worst_change_gap"] >= nudge["median_change_gap"] >= 0.0
    assert len(nudge["widest"]) == 4


def test_score_distance_moves_by_a_share_for_one_flipped_detection():
    """The detections' score distance: 0 for equal lists, the shift for
    shifted ones, and a hundredth of the gap when one of 100 detections
    differs (a last bit through top-k or NMS), where the widest gap takes
    it whole."""
    import numpy as np

    from compare import score_distance, score_gap

    r = {0: {"scores": np.linspace(0.30, 0.40, 100)}}
    assert score_distance(r, r) == 0.0
    shifted = {0: {"scores": r[0]["scores"] + 0.05}}
    assert abs(score_distance(shifted, r) - 0.05) < 1e-12
    flipped = {0: {"scores": np.concatenate([r[0]["scores"][:-1], [0.2]])}}
    assert abs(score_distance(flipped, r) - (0.40 - 0.2) / 100) < 1e-9
    assert score_gap(flipped, r) > 0.09
    assert score_distance({}, r) == 1.0
