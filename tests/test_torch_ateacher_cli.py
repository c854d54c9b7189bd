"""The mean-teacher trainer's entry points (CPU).

* ``build_trainer`` dispatches ``SEMISUPNET.Trainer`` as the JAX package's
  (``tests/test_ateacher_eval.py:test_build_trainer_dispatch``), with the
  JAX package's settings (``EMA_KEEP_RATE`` 0 read as 0.9996, the
  ``SUP_PERCENT`` split), and refuses the cross-domain head.
* ``test`` adapts and evaluates the teacher, with a fresh optimizer, and
  leaves the student as it was; ``eval_student=True`` adapts the student
  (``test_eval_teacher_vs_student``).
* ``train_net_torch.py`` trains with ``configs/seg_res50fpn_MT.yaml`` at a
  tiny size and ``--eval-only`` with ``configs/test_segment_MT.yaml`` reads
  its final file: the teacher by default, the student with
  ``TEST.EVAL_STU True`` (the shipped file's setting).

The loop's parity with the JAX package and its resume are in
tests/test_torch_ateacher.py.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
import logging
import os

import numpy as np
import pytest
import torch

import train_net_torch
from torch_port_fixture import cli_args, write_mini_split
from ttdg_mgm_torch import config as tconfig
from ttdg_mgm_torch.build import build_trainer
from ttdg_mgm_torch.data import coco as tcoco
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.engine.mean_teacher import ATeacherTrainer
from ttdg_mgm_torch.engine.trainer import BaselineTrainer
from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights
from ttdg_mgm_torch.solver import build as t_solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _host(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _tiny_cfg(trainer):
    cfg = tconfig.get_cfg()
    cfg.MODEL.RESNETS.DEPTH = 14
    cfg.MODEL.GRAPH.UNIV_SIZE = 8
    cfg.MODEL.GRAPH.GAGM_ITERS = 10
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 32
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 4
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.TPU.PRECISION = "float32"
    cfg.SEMISUPNET.Trainer = trainer
    cfg.SEMISUPNET.DIS_TYPE = "p2"
    return cfg


def test_build_trainer_dispatch():
    """``SEMISUPNET.Trainer`` selects the class, and the JAX package's
    settings reach it, ``CROSS_DOMAIN_MATCHING`` among them (the head and
    its zero class centers)."""
    cfg = _tiny_cfg("ateacher")
    cfg.DATALOADER.SUP_PERCENT = 40.0
    cfg.DATALOADER.RANDOM_DATA_SEED = 3
    cfg.SEMISUPNET.BURN_UP_STEP = 7
    t = build_trainer(cfg, device="cpu")
    assert isinstance(t, ATeacherTrainer)
    assert t.model.backbone.bottom_up.res2.__len__() == 1 and t.model.dis_type == "p2"
    assert t.ema_keep_rate == 0.9996  # EMA_KEEP_RATE 0.0 reads as 0.9996, as in JAX
    assert (t.burn_up_step, t.sup_percent, t.split_seed) == (7, 40.0, 3)
    assert all(torch.equal(v, t.teacher.state_dict()[k]) for k, v in t.model.state_dict().items())
    cfg.SEMISUPNET.Trainer = "baseline"
    t2 = build_trainer(cfg, device="cpu")
    assert isinstance(t2, BaselineTrainer) and not isinstance(t2, ATeacherTrainer)
    assert not t.cross_domain and t.centers is None
    cfg.SEMISUPNET.Trainer = "ateacher"
    cfg.SEMISUPNET.CROSS_DOMAIN_MATCHING = True
    t3 = build_trainer(cfg, device="cpu")
    assert isinstance(t3, ATeacherTrainer) and t3.cross_domain
    assert t3.centers.shape == (3, 256) and not t3.centers.any()


def test_eval_teacher_vs_student(tmp_path):
    """Default evaluation adapts and evaluates the teacher (the student
    untouched, the momentum of the student's optimizer untouched);
    ``eval_student=True`` adapts the student."""
    write_mini_split(tmp_path)
    name = "_mt_eval_ds"
    TCatalog.remove(name)
    tcoco.register_coco_instances(name, str(tmp_path / "Fundus" / "Drishti_GS_test.json"),
                                  str(tmp_path / "Fundus" / "Drishti_GS" / "test" / "image"))
    model = MaskRCNN(num_classes=2, univ_size=8, node_cap_per_level=4, pre_nms_topk_train=32,
                     pre_nms_topk_test=32, post_nms_topk=16, detections_per_image=4,
                     batch_size_per_image=16, mask_fg_cap=4,
                     pixel_mean=(103.5, 116.3, 123.7), pixel_std=(57.4, 57.1, 58.4),
                     resnet_depth=14, gagm_iters=20, hippi_iters=10)
    init_weights(model, torch.Generator().manual_seed(0))
    trainer = ATeacherTrainer(model, t_solver.build_optimizer(model, lambda _: 1.0),
                              canvas=64, min_size=64, max_size=64, gt_cap=4, mask_res=32)
    student = _host(trainer.model)
    res = trainer.test([name], ttt=True, tta_batch=2, min_batch_num=1, dice_threshold=0.0)
    assert name in res and all(np.isfinite(v) or np.isnan(v) for v in res[name].values())
    assert all(torch.equal(v, student[k]) for k, v in trainer.model.state_dict().items())
    assert trainer.optimizer.count == 0 and not trainer.optimizer.sgd.state
    assert trainer.model is not trainer.teacher
    teacher_moved = any(not torch.equal(v, student[k])
                        for k, v in trainer.teacher.state_dict().items())
    res2 = trainer.test([name], ttt=True, tta_batch=2, min_batch_num=1, eval_student=True,
                        dice_threshold=0.0)
    assert name in res2
    student_moved = any(not torch.equal(v, student[k])
                        for k, v in trainer.model.state_dict().items())
    assert trainer.optimizer.count == 1
    if trainer.last_tta_loss != 0.0:
        assert teacher_moved and student_moved
    TCatalog.remove(name)


def test_train_net_mt_config_then_eval_only(tmp_path, caplog):
    """``train_net_torch.py --config configs/seg_res50fpn_MT.yaml`` (tiny
    overrides on the miniature split as labelled and unlabelled data: one
    burn-in step, the copy, then MT steps with pseudo-labels from a zero
    threshold), its final checkpoint in the ensemble layout; then
    ``--eval-only --config configs/test_segment_MT.yaml`` on it."""
    root = write_mini_split(tmp_path / "data")
    out = tmp_path / "out"
    args = cli_args(root, out)
    args = args[args.index("--device"):]
    args[args.index("--config") + 1] = os.path.join(REPO, "configs", "seg_res50fpn_MT.yaml")
    narrow = ["MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
              "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]
    args += narrow + [
        "DATASETS.TRAIN_LABEL", '["Drishti_GS_test"]', "DATASETS.TRAIN_UNLABEL",
        '["Drishti_GS_test"]', "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.MAX_ITER", "3",
        "SEMISUPNET.BURN_UP_STEP", "1", "SEMISUPNET.BBOX_THRESHOLD", "0.0",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "SOLVER.CHECKPOINT_PERIOD", "2"]
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        res = train_net_torch.main(args)
    assert res["iteration"] == 3
    assert sorted(os.listdir(out / "checkpoints")) == ["last_checkpoint", "model_0000002.pth",
                                                      "model_0000003.pth"]
    saved = torch.load(res["checkpoint"], weights_only=False)
    student = {k[len("modelStudent."):]: v for k, v in saved["model"].items()
               if k.startswith("modelStudent.")}
    teacher = {k[len("modelTeacher."):]: v for k, v in saved["model"].items()
               if k.startswith("modelTeacher.")}
    assert student.keys() == teacher.keys() and len(student) * 2 == len(saved["model"])
    assert any(not torch.equal(student[k], teacher[k]) for k in student)
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert lines[-1]["iteration"] == 2 and "loss_D_img_t" in lines[-1]
    assert np.isfinite(lines[-1]["loss_cls_pseudo"])

    ev = cli_args(root, tmp_path / "eval") + narrow + ["MODEL.WEIGHTS", res["checkpoint"]]
    ev[ev.index("--config") + 1] = os.path.join(REPO, "configs", "test_segment_MT.yaml")
    for eval_stu, member in (("False", teacher), ("True", student)):
        opts = ev[ev.index("--config") + 2 + 2:] + ["TEST.EVAL_STU", eval_stu]
        cfg = tconfig.setup_cfg(ev[ev.index("--config") + 1], opts)
        built = build_trainer(cfg, device="cpu")
        assert isinstance(built, ATeacherTrainer)
        assert all(torch.equal(v, member[k]) for k, v in built.teacher.state_dict().items())
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
            results = train_net_torch.main(ev + ["TEST.EVAL_STU", eval_stu])
        assert f"loaded {len(student)} tensors" in caplog.text
        assert "0 of another shape and 0 absent" in caplog.text
        r = results["Drishti_GS_test"]
        assert len(r) == 3 and all(np.isfinite(v) for v in r.values())
