"""A configuration that brings its own plain reference model, init rules and
kernel-work captures as new files (``configs/<config>.json``'s
``reference_model`` and ``captures``), on the CPU at a small size: such a
cell runs from new files alone, a reference model that is not the
program's model makes the run fail, a leaf without a rule still raises, and
a module that only wraps the default builder changes nothing."""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import pytest
import torch

import harness
from small import small_spec
from weights import make_weights

CPU = torch.device("cpu")
SEED = 2 ** 31 + 11
CELLS = ("r50_tta_fundus", "vgg_source_cityscapes")

#: SHA-256 of each cell's weights at small.py's size from :data:`SEED` on the
#: CPU, taken on the parent commit of the change that let a configuration
#: bring its own reference model, before that change was made
DIGESTS = {
    "r50_tta_fundus": "e89ae58279d9b7a90b34e81bebd9193f8b179d3b567de8d0629d9246efd2d689",
    "vgg_source_cityscapes": "c9f4c8caddfbce3d7b6aa1ff945eb5a67a082dadb9a8477d29b5f250a8b8b5ef",
}

DEFAULT_MODEL = '''
"""The default reference model, built through the configuration's own hook."""
from reference.cell import model_kwargs
from reference.models.rcnn import MaskRCNN


def build_model(cfg):
    return MaskRCNN(**model_kwargs(cfg))
'''

PROBE_MODEL = '''
"""The default model under a class of its own, with the box regressor drawn
at twice the default standard deviation by a rule of its own."""
from reference.cell import model_kwargs
from reference.models.rcnn import MaskRCNN

LEAF = "roi_heads.box_predictor.bbox_pred.weight"


class ProbeRCNN(MaskRCNN):
    pass


def build_model(cfg):
    return ProbeRCNN(**model_kwargs(cfg))


def init_rules(model):
    return {LEAF: ("normal", 0.002, 0.0, None)}
'''

PROBE_CAPTURES = '''
"""Counts the program's inference passes in the window."""


def instrument(run):
    model = run.state["trainer"].model
    calls = run.work.setdefault("probe_calls", [0])
    real = model.forward_inference

    def counted(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)

    run.recorder.replace(model, "forward_inference", counted)


def work(run):
    run.work["probe"] = {"inference_passes": run.work.pop("probe_calls")[0]}
'''

PROBE_READER = '''
"""Images inferred a chip: the captured passes, each of ``TEST.BATCH``."""
UNIT = "images"
MOVES = "tta_images_per_s"


def read(record):
    probe = record["work"].get("probe")
    if probe is None:
        return None
    return probe["inference_passes"] * record["config"]["TEST"]["BATCH"] / record["config"]["chips"]
'''

#: reference models that are not the program's model
OTHER_MODELS = {
    "normalisation": '''
from reference.cell import model_kwargs
from reference.models.rcnn import MaskRCNN


def build_model(cfg):
    return MaskRCNN(**{**model_kwargs(cfg), "pixel_std": (2.0, 2.0, 2.0)})
''',
    "trunk": '''
from reference.cell import model_kwargs
from reference.models.rcnn import MaskRCNN


def build_model(cfg):
    return MaskRCNN(**{**model_kwargs(cfg), "backbone_name": "vgg16"})
''',
}


def _new_cell(tmp_path, base: str, config_keys: dict, files: dict,
              per_layer: tuple = ()) -> harness.Spec:
    """A new cell ``<base>_own`` on a new configuration ``<config>_own`` in a
    copy of the benchmark's data files under ``tmp_path``: the base cell's
    configuration file with ``config_keys`` added, its traffic, a copy of
    its limits, ``files`` (``{path under benchmark/: text}``) and the
    ``per_layer`` entries, all new files and entries.  The spec is at
    small.py's size."""
    bench = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(harness.HERE, sub), bench / sub)
    for rel, text in files.items():
        (bench / rel).parent.mkdir(parents=True, exist_ok=True)
        (bench / rel).write_text(text)
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        b = json.load(f)
    cell = next(w for w in b["workloads"] if w["name"] == base)
    conf = next(c for c in b["configs"] if c["name"] == cell["config"])
    name, conf_name = base + "_own", conf["name"] + "_own"
    own_file = f"benchmark/configs/{conf_name}.json"
    tree = json.loads((tmp_path / conf["file"]).read_text())
    (tmp_path / own_file).write_text(json.dumps({**tree, "name": conf_name, **config_keys}))
    (bench / "limits" / f"{name}.json").write_text(
        (bench / "limits" / f"{base}.json").read_text())
    b["configs"].append({**conf, "name": conf_name, "file": own_file})
    b["workloads"].append({**cell, "name": name, "config": conf_name, "why": "test"})
    for m in b["end_to_end"] + b["per_layer"]:
        if base in m.get("workloads", ()):
            m["workloads"].append(name)
    b["per_layer"] += list(per_layer)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    spec = harness.Spec(name, root=str(tmp_path))
    small = small_spec(base)
    spec.cfg, spec.traffic = small.cfg, small.traffic
    return spec


def _run(spec, trace=False):
    return harness.execute(spec, SEED, 0.5, trace, CPU, time.perf_counter(), log=lambda m: None)


def _weights(spec) -> dict:
    run = harness.Run(spec, SEED, CPU, False, "/nonexistent")
    run.make_weights()
    return run.weights


def _digest(weights: dict) -> str:
    h = hashlib.sha256()
    for k, v in weights.items():
        v = v.contiguous()
        h.update(f"{k}|{v.dtype}|{tuple(v.shape)}|".encode())
        h.update(v.numpy().tobytes())
    return h.hexdigest()


def test_own_reference_model_rules_and_captures_run_a_new_cell(tmp_path):
    """(a) A configuration whose reference model, init rules and captures
    are new files, and a new metric reader that reads the record's
    configuration and what the captures' ``work`` put in ``run.work``: the
    rules shape the weights, the traced run is correct, the metric is read."""
    metric = {"name": "probe_images.tta", "unit": "images", "better": "higher",
              "source": "program_counter", "layer": "evaluation",
              "moves": "tta_images_per_s", "workloads": ["r50_tta_fundus_own"]}
    spec = _new_cell(tmp_path, "r50_tta_fundus",
                     {"reference_model": "reference/models/probe_model.py",
                      "captures": "captures/probe.py"},
                     {"reference/models/probe_model.py": PROBE_MODEL,
                      "captures/probe.py": PROBE_CAPTURES,
                      "metrics/probe_images.tta.py": PROBE_READER}, per_layer=(metric,))
    assert spec.reference_model == str(tmp_path / "benchmark/reference/models/probe_model.py")
    leaf = "roi_heads.box_predictor.bbox_pred.weight"
    own, default = _weights(spec), _weights(small_spec("r50_tta_fundus"))
    assert list(own) == list(default)
    assert torch.equal(own[leaf], 2 * default[leaf])
    assert all(torch.equal(own[k], default[k]) for k in own if k != leaf)

    result = _run(spec, trace=True)
    assert result["correct"] is True, result["checks"]
    assert result["metrics"]["probe_images.tta"]["value"] == result["attempted"] > 0


@pytest.mark.parametrize("other", sorted(OTHER_MODELS))
def test_reference_model_that_is_not_the_programs_fails(tmp_path, other):
    """(b) A reference model other than the program's: another input
    normalisation makes ``correct`` false; another trunk has leaves the
    program's model cannot load."""
    spec = _new_cell(tmp_path, "r50_tta_fundus", {"reference_model": "reference/other.py"},
                     {"reference/other.py": OTHER_MODELS[other]})
    if other == "trunk":
        with pytest.raises(RuntimeError, match="state_dict"):
            _run(spec)
    else:
        result = _run(spec)
        assert result["correct"] is False, result["checks"]


def test_leaf_without_rule_still_raises():
    """(c) A bare parameter that no rule covers raises; a rule of the model's
    own covers it; a rule for a leaf the model lacks raises."""
    from reference.cell import build

    model, _ = build(small_spec("r50_tta_fundus").cfg, CPU)
    model.rel_pos_h = torch.nn.Parameter(torch.zeros(7, 4))
    with pytest.raises(ValueError, match="no init rule for \\['rel_pos_h'\\]"):
        make_weights(model, SEED)
    sd = make_weights(model, SEED, {"rel_pos_h": ("normal", 0.02, 0.0, 2.0)})
    assert sd["rel_pos_h"].abs().max() > 0
    with pytest.raises(ValueError, match="does not have"):
        make_weights(model, SEED, {"rel_pos_h": ("fill", 0.0), "pos_embed": ("fill", 0.0)})


@pytest.mark.parametrize("cell", CELLS)
def test_weights_are_the_parents_and_a_wrapping_module_changes_nothing(tmp_path, cell):
    """(d) The cell's weights at small.py's size equal the parent commit's
    bit for bit; a configuration naming a module that only wraps the
    default builder makes the same weights and the same checks."""
    default = small_spec(cell)
    assert _digest(_weights(default)) == DIGESTS[cell]
    wrapped = _new_cell(tmp_path, cell, {"reference_model": "reference/default_model.py"},
                        {"reference/default_model.py": DEFAULT_MODEL})
    assert _digest(_weights(wrapped)) == DIGESTS[cell]
    assert _run(wrapped)["checks"] == _run(default)["checks"]


@pytest.mark.parametrize("rel", ["../outside.py", "/abs/model.py", "reference/../../x.py"])
def test_own_file_outside_the_benchmark_is_refused(tmp_path, rel):
    with pytest.raises(harness.RunError, match="not under benchmark/"):
        _new_cell(tmp_path, "r50_tta_fundus", {"reference_model": rel}, {})
