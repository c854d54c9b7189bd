"""``train_net_torch.py`` without ``--eval-only`` on the CPU, at a small size
(tests/test_cli.py's overrides on its miniature Drishti-GS split, with
narrow FPN and heads): source training with the shipped
``configs/seg_res50fpn_source.yaml`` writes its periodic and final
checkpoints and ``metrics.json`` and logs a finite validation loss; a second
call with a larger ``SOLVER.MAX_ITER`` resumes from the latest checkpoint
and trains on; an ``--eval-only`` call with ``configs/test_segment.yaml``
reads the final file as ``MODEL.WEIGHTS`` (every tensor loaded) and
evaluates it with the COCO evaluator (``TEST.EVALUATOR coco``).  Each with
the R50 trunk and with ``MODEL.BACKBONE.NAME build_vgg_backbone``.
``configs/test_detection.yaml`` names a split neither package registers
(``fetus_head_c1_test``): both raise ``KeyError``."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
import logging
import os

import torch

import pytest

import train_net_torch
from torch_port_fixture import cli_args, write_mini_split

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
          "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]


def _train_args(root, out, max_iter):
    # tests/test_cli.py's overrides, less the eval-only ones, and the train path's
    args = cli_args(root, out)
    args = args[args.index("--device"):]
    i = args.index("--config") + 1
    args[i] = os.path.join(REPO, "configs", "seg_res50fpn_source.yaml")
    return args + NARROW + [
        "DATASETS.TRAIN", '["Drishti_GS_test"]', "MODEL.ROI_HEADS.NUM_CLASSES", "2",
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", str(max_iter),
        "SOLVER.CHECKPOINT_PERIOD", "1", "TEST.EVAL_PERIOD", "2",
        "INPUT.MIN_SIZE_TRAIN", "(56, 64)", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64"]


BACKBONES = {"resnet": [], "vgg": ["MODEL.BACKBONE.NAME", "build_vgg_backbone"]}


@pytest.mark.parametrize("backbone", list(BACKBONES))
def test_train_resume_and_eval_only(tmp_path, caplog, backbone):
    root = write_mini_split(tmp_path / "data")
    out = tmp_path / "out"
    trunk = BACKBONES[backbone]
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        first = train_net_torch.main(_train_args(root, out, 2) + trunk)
    ckdir = out / "checkpoints"
    assert sorted(os.listdir(ckdir)) == ["last_checkpoint", "model_0000001.pth",
                                         "model_0000002.pth"]
    assert first["iteration"] == 2 and first["checkpoint"] == str(ckdir / "model_0000002.pth")
    assert [it for it, _ in first["validation_loss"]] == [2]
    assert all(torch.isfinite(torch.tensor(v)) for _, v in first["validation_loss"])
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [1]
    assert {"loss_rpn_cls", "loss_mask", "loss_matching", "total_loss"} <= set(lines[0])
    assert "resumed" not in caplog.text
    saved = torch.load(ckdir / "model_0000002.pth", weights_only=False)
    assert saved["iteration"] == 2 and saved["optimizer"]["state"]
    assert ("backbone.bottom_up.features.0.weight" in saved["model"]) == (backbone == "vgg")

    caplog.clear()
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        second = train_net_torch.main(_train_args(root, out, 3) + trunk)
    assert "resumed from checkpoint at iteration 2" in caplog.text
    assert second["iteration"] == 3 and (ckdir / "model_0000003.pth").exists()
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [1, 2]

    caplog.clear()
    ev = cli_args(root, tmp_path / "eval") + NARROW + trunk + [
        "MODEL.WEIGHTS", second["checkpoint"], "TEST.EVALUATOR", "coco"]
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        results = train_net_torch.main(ev)
    assert "0 of another shape and 0 absent" in caplog.text
    r = results["Drishti_GS_test"]
    assert {"bbox_AP", "bbox_AP50", "segm_AP"} <= set(r)
    rec = json.loads((tmp_path / "eval" / "result_ap.txt").read_text().splitlines()[-1])
    assert rec["weights"] == second["checkpoint"]


def test_detection_config_raises_as_jax(tmp_path):
    """``configs/test_detection.yaml`` (box-only, 7 classes) evaluates
    ``fetus_head_c1_test``, which neither package registers (the
    fetal-ultrasound loader is a library function in both): the port's
    command line raises ``KeyError`` naming it, as the JAX package's test
    loader does, with the file's ``TEST.DRAW True`` as shipped (the
    visualizer is ported) and without it."""
    from ttdg_mgm_tpu.data import loader as jloader
    from ttdg_mgm_tpu.data.builtin import register_all_medical

    args = ["--eval-only", "--device", "cpu", "--config",
            os.path.join(REPO, "configs", "test_detection.yaml"),
            "--datasets-root", str(tmp_path), "OUTPUT_DIR", str(tmp_path / "out"),
            "MODEL.RESNETS.DEPTH", "14", *NARROW]
    with pytest.raises(KeyError, match="fetus_head_c1_test"):
        train_net_torch.main(args)
    with pytest.raises(KeyError, match="fetus_head_c1_test"):
        train_net_torch.main(args + ["TEST.DRAW", "False"])
    register_all_medical(str(tmp_path))
    with pytest.raises(KeyError, match="fetus_head_c1_test"):
        jloader.build_test_loader("fetus_head_c1_test")
