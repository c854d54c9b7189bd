"""On the card only (marked ``cuda``; they skip elsewhere): one short run of
each cell gives a correct result line, and the control comes out not
correct at the cell's own size."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import harness

CELLS = ("r50_tta_fundus", "vgg_source_cityscapes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_card(card, cell):
    cmd = [sys.executable, os.path.join(harness.HERE, "run.py"), "--workload", cell, "--seed",
           str(2 ** 31 + 101), "--seconds", "2", "--trace", "0"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=harness.ROOT, timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    result = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"] is True, result["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_on_card(card, cell):
    from control import control_numbers

    spec = harness.Spec(cell)
    nums = control_numbers(spec, 2 ** 31 + 103, card, log=lambda m: None)
    limits = spec.limits["limits"]
    assert any(v > limits[k] for k, v in nums.items()), nums
