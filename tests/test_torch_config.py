"""The port's configuration against the JAX package's: its YAML reader
against ``yaml.safe_load``, ``setup_cfg`` on every file in ``configs/``
with the overrides of ``tests/test_cli.py``, the config -> model fields of
``build.py`` and the learning-rate schedules."""

import glob
import math
import os

import numpy as np
import pytest
import yaml

from ttdg_mgm_tpu import build as jbuild
from ttdg_mgm_tpu import config as jconfig
from ttdg_mgm_torch import build as tbuild
from ttdg_mgm_torch import config as tconfig
from ttdg_mgm_torch.build import OUT_OF_SLICE
from ttdg_mgm_torch.models.rcnn import MaskRCNN
from ttdg_mgm_torch.utils import yaml_lite

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml")))

#: tests/test_cli.py's overrides, one list per CLI test
_COMMON = ["MODEL.WEIGHTS", "", "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "64",
           "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
           "TEST.DETECTIONS_PER_IMAGE", "8", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
           "MODEL.GRAPH.UNIV_SIZE", "8", "MODEL.GRAPH.GAGM_ITERS", "8",
           "MODEL.GRAPH.HIPPI_ITERS", "5", "MODEL.GRAPH.SK_ITERS", "5",
           "MODEL.RESNETS.DEPTH", "14"]
CLI_OPTS = {
    "none": [],
    "eval_only_tta": ["DATASETS.TEST", '["Drishti_GS_test"]', "OUTPUT_DIR", "/tmp/out",
                      *_COMMON, "MODEL.GRAPH.MAX_NODES", "20", "TEST.BATCH", "2",
                      "TEST.MIN_BATCH_NUM", "1", "TEST.DICE_THRES", "0.0"],
    "eval_only_detection_ap": ["DATASETS.TEST", '["Drishti_GS_test"]', "OUTPUT_DIR",
                               "/tmp/det_out", *_COMMON, "MODEL.ROI_HEADS.NUM_CLASSES", "2",
                               "TEST.TTT", "False", "TEST.DRAW", "False"],
    "source_training": ["DATASETS.TRAIN", '["Drishti_GS_test"]', "DATASETS.TEST", "[]",
                        "OUTPUT_DIR", "/tmp/train_out", "SOLVER.MAX_ITER", "1",
                        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
                        "SOLVER.AMP.ENABLED", "False", "TEST.EVAL_PERIOD", "0",
                        "INPUT.MIN_SIZE_TRAIN", "(64,)", "INPUT.MAX_SIZE_TRAIN", "64",
                        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", *_COMMON, "MODEL.MASK_ON",
                        "False"],
}
#: the port computes in float32 only
FLOAT32 = ["TPU.PRECISION", "float32", "SOLVER.AMP.ENABLED", "False"]

SCALARS = ["", " ", "1e-4", "1.0e-4", "1.0e+4", "0.005", ".5", "-1", "+3", "017", "0", "0x1F",
           "0b101", "1_000", "1:30", "1:30.5", ".inf", "-.Inf", "True", "false", "yes", "Off",
           "~", "null", "NULL", "none", "2024-01-31", "2024-01-31 10:20:30.25 +02:00",
           "output/test", "a b", "a: b", "[]", "[-1]", "[[32], [64], [128]]", "[0.5, 1.0, 2.0]",
           '["Drishti_GS_test"]', "{ENABLED: False, CLIP_VALUE: 1.0}", "'it''s'", '"a\\tb"',
           "hello # comment", "foo:bar", "http://x.y/z", "(64,)", "(60000, 80000)",
           "[a, b]c", "*alias", "- a\n- b", "A:\n  B: 1\n  C: [2, 3]\nD: x"]


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return type(a) is type(b) and (a == b if not isinstance(a, (list, tuple, dict)) else
                                   _same_tree(a, b))


def _same_tree(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_reader_matches_safe_load(path):
    with open(path) as f:
        text = f.read()
    assert _same(yaml_lite.safe_load(text), yaml.safe_load(text))


@pytest.mark.parametrize("text", SCALARS)
def test_yaml_scalars_and_overrides_match(text):
    """Scalar resolution as ``yaml.safe_load`` does it, and the decoding of
    an override string as ``ttdg_mgm_tpu.config._decode_value`` does it."""
    try:
        want = yaml.safe_load(text)
    except yaml.YAMLError:
        with pytest.raises(yaml_lite.YAMLError):
            yaml_lite.safe_load(text)
    else:
        assert _same(yaml_lite.safe_load(text), want), (text, want)
    assert _same(tconfig._decode_value(text), jconfig._decode_value(text))


@pytest.mark.parametrize("opts", sorted(CLI_OPTS))
@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_setup_cfg_matches_jax(path, opts):
    want = jconfig._to_plain(jconfig.setup_cfg(path, CLI_OPTS[opts]))
    got = tconfig.to_plain(tconfig.setup_cfg(path, CLI_OPTS[opts]))
    assert _same(got, want)


def test_get_cfg_defaults_match_jax():
    assert _same(tconfig.to_plain(tconfig.get_cfg()), jconfig._to_plain(jconfig.get_cfg()))
    assert tconfig.get_cfg().TPU.PRECISION == "bfloat16"


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_model_fields_match_jax_build_model(path):
    """Every field of the JAX model that ``ttdg_mgm_tpu/build.py`` builds
    for the config (less ``OUT_OF_SLICE``) equals the port's: from
    ``model_kwargs`` or the port model's default."""
    opts = CLI_OPTS["eval_only_tta"] + FLOAT32
    jm = jbuild.build_model(jconfig.setup_cfg(path, opts))
    kw = tbuild.model_kwargs(tconfig.setup_cfg(path, opts))
    import inspect

    defaults = {k: p.default for k, p in inspect.signature(MaskRCNN.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    fields = [f for f in jm.__dataclass_fields__ if f not in ("parent", "name")]
    assert set(kw) <= set(fields)
    for f in fields:
        if f in OUT_OF_SLICE:
            continue
        want = getattr(jm, f)
        got = kw.get(f, defaults[f])
        assert _same(tuple(got) if isinstance(got, list) else got,
                     tuple(want) if isinstance(want, list) else want), f


def test_unported_options_are_refused():
    seg = os.path.join(REPO, "configs", "test_segment.yaml")
    with pytest.raises(NotImplementedError, match="TPU.PRECISION float32"):
        tbuild.model_kwargs(tconfig.setup_cfg(seg))
    with pytest.raises(NotImplementedError, match="SOLVER.AMP.ENABLED False"):
        tbuild.model_kwargs(tconfig.setup_cfg(seg, ["TPU.PRECISION", "float32",
                                                    "SOLVER.AMP.ENABLED", "True"]))
    with pytest.raises(NotImplementedError, match="VGG backbone"):
        tbuild.model_kwargs(tconfig.setup_cfg(seg, FLOAT32 + ["MODEL.BACKBONE.NAME",
                                                              "build_vgg_backbone"]))
    mt = os.path.join(REPO, "configs", "test_segment_MT.yaml")
    with pytest.raises(NotImplementedError, match="mean-teacher trainer"):
        tbuild.build_trainer(tconfig.setup_cfg(mt, FLOAT32), device="cpu")


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_schedule_matches_jax(path):
    """The learning rate at every step the schedules change at, from each
    config's solver."""
    jc, tc = jconfig.setup_cfg(path), tconfig.setup_cfg(path)
    js, ts = jbuild.build_schedule(jc), tbuild.build_schedule(tc)
    steps = [0, 1, 2, 500, 999, 1000, 1001, 30000, 59999, 60000, 80000, 90000, 360000]
    np.testing.assert_allclose([ts(s) for s in steps], [float(js(s)) for s in steps],
                               rtol=1e-6, atol=0)
