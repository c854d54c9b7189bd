"""Configuration -> model, schedule, weights and trainer.

Counterpart of ``ttdg_mgm_tpu/build.py``: :func:`model_kwargs` maps a
config onto the model's fields as ``ttdg_mgm_tpu/build.py:build_model``
does, :func:`build_schedule` picks the learning-rate schedule,
:func:`init_params` draws the seeded initial weights and merges
``MODEL.WEIGHTS`` (a d2 ``.pth`` or ``.pkl``) by name, and
:func:`build_trainer` puts them together for the eval-only TTA path.  The
port refuses, with a message naming the way out, what it has not ported:
the VGG backbone, the mean-teacher trainer and the bf16 compute policy
(``TPU.PRECISION`` defaults to ``"bfloat16"``; pass ``TPU.PRECISION
float32``).

``FLAGSHIP_KWARGS`` is the R50-FPN Mask R-CNN that the JAX package builds
for ``configs/test_segment.yaml``: full widths, 1000 proposals, 100
detections, a 32-slot universe and 12 nodes per FPN level
(``MODEL.GRAPH.MAX_NODES`` 64 // 5), so 60 nodes per graph, and the
source-training fields at their ``ttdg_mgm_tpu/config.py`` defaults (2000
pre-NMS proposals, 512 sampled ROIs per image at 25 % foreground, 128 mask
ROIs, cross-entropy, 50 HiPPI iterations).  Source training
(``configs/seg_res50fpn_source.yaml``) trains this model, with 2 classes;
``SOURCE_SOLVER`` holds that file's solver settings (``IMS_PER_BATCH`` 8,
``BASE_LR`` 0.0025, over ``config.py``'s defaults, which
``solver/build.py`` keeps as its own: momentum 0.9, weight decay 1e-4).
Fields of the JAX model which only the discriminator, the VGG backbone or
the bf16 compute policy read are not ported yet; ``OUT_OF_SLICE`` names
them.
"""

from __future__ import annotations

import logging
import os

import torch

from ttdg_mgm_torch import resolve_device
from ttdg_mgm_torch.config import CfgNode
from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights
from ttdg_mgm_torch.solver.build import (build_optimizer, warmup_cosine_schedule,
                                         warmup_multistep_schedule, warmup_two_stage_schedule)

logger = logging.getLogger("ttdg_mgm_torch")

FLAGSHIP_KWARGS = dict(
    num_classes=2, univ_size=32, sample_dist=10, node_cap_per_level=12,
    pixel_mean=(103.53, 116.28, 123.675), pixel_std=(1.0, 1.0, 1.0),
    pre_nms_topk_test=1000, post_nms_topk=1000, detections_per_image=100,
    sk_iters=20, sk_tau=0.05, gagm_iters=200, lap_polish_iters=200,
    resnet_depth=50, resnet_width=256, freeze_at=2, mask_on=True,
    score_thresh_test=0.05, nms_thresh_test=0.5, rpn_nms_thresh=0.7,
    pooler_sampling_ratio=0, fpn_channels=256, box_fc_dim=1024, box_num_fc=2,
    mask_conv_dim=256, mask_num_conv=4,
    anchor_sizes=((32,), (64,), (128,), (256,), (512,)),
    cls_loss_type="CrossEntropy", pre_nms_topk_train=2000, batch_size_per_image=512,
    roi_positive_fraction=0.25, mask_fg_cap=128, hippi_iters=50,
)

#: ``configs/seg_res50fpn_source.yaml`` SOLVER, and the GT-mask canvas of
#: the JAX trainer (``engine/trainer.py:196``)
SOURCE_SOLVER = dict(ims_per_batch=8, base_lr=0.0025, mask_res=256)

#: JAX ``MaskRCNN`` fields outside this package's slice: the discriminator's
#: feature level, the VGG backbone switch and the bf16 compute policy
OUT_OF_SLICE = ("dis_type", "backbone_name", "compute_dtype")

#: what :func:`model_kwargs` says when a config asks for bf16 compute
BF16_REFUSED = ("ttdg_mgm_torch computes in float32 only until the bf16 compute policy is "
                "ported (ROADMAP.md, Queue 1); TPU.PRECISION defaults to 'bfloat16' as in the "
                "JAX package, so pass TPU.PRECISION float32 (and SOLVER.AMP.ENABLED False)")


def model_kwargs(cfg: CfgNode) -> dict:
    """The model's fields from ``cfg``, as ``ttdg_mgm_tpu/build.py:build_model``
    maps them, less ``OUT_OF_SLICE``.  Raises for the VGG backbone and for
    bf16 compute, which the port has not ported."""
    if "vgg" in cfg.MODEL.BACKBONE.NAME:
        raise NotImplementedError(
            f"MODEL.BACKBONE.NAME {cfg.MODEL.BACKBONE.NAME!r}: the VGG backbone is not ported "
            "to ttdg_mgm_torch yet (ROADMAP.md, Queue 1: the long tail)")
    if cfg.SOLVER.AMP.ENABLED or cfg.TPU.PRECISION == "bfloat16":
        raise NotImplementedError(
            f"compute_dtype bfloat16 (TPU.PRECISION {cfg.TPU.PRECISION!r}, SOLVER.AMP.ENABLED "
            f"{cfg.SOLVER.AMP.ENABLED}): {BF16_REFUSED}")
    g = cfg.MODEL.GRAPH
    return dict(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        univ_size=g.UNIV_SIZE,
        sample_dist=g.SAMPLE_DIST,
        node_cap_per_level=max(g.MAX_NODES // 5, 4),
        cls_loss_type=cfg.MODEL.ROI_HEADS.LOSS,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        pre_nms_topk_train=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
        pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        resnet_depth=cfg.MODEL.RESNETS.DEPTH,
        freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        mask_on=cfg.MODEL.MASK_ON,
        score_thresh_test=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        roi_positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH,
        fpn_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        box_fc_dim=cfg.MODEL.ROI_BOX_HEAD.FC_DIM,
        box_num_fc=cfg.MODEL.ROI_BOX_HEAD.NUM_FC,
        mask_conv_dim=cfg.MODEL.ROI_MASK_HEAD.CONV_DIM,
        mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
        pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        anchor_sizes=tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES),
        sk_iters=g.SK_ITERS,
        sk_tau=g.SK_TAU,
        hippi_iters=g.HIPPI_ITERS,
        gagm_iters=g.GAGM_ITERS,
        lap_polish_iters=g.LAP_POLISH_ITERS,
    )


def build_model(*, device=None, seed: int = 0, **overrides) -> MaskRCNN:
    """The flagship model (``overrides`` replace fields) with random weights
    drawn from the JAX package's init distributions, on ``device`` (CUDA
    unless the caller names another)."""
    dev = resolve_device(device)
    model = MaskRCNN(**{**FLAGSHIP_KWARGS, **overrides})
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev)


def build_schedule(cfg: CfgNode):
    """``step -> lr`` of ``SOLVER.LR_SCHEDULER_NAME`` (warm-up multistep by
    default), counted in optimizer steps (TTA steps on the eval-only path)."""
    s = cfg.SOLVER
    name = s.get("LR_SCHEDULER_NAME", "WarmupMultiStepLR")
    warm = dict(warmup_iters=s.WARMUP_ITERS, warmup_factor=s.WARMUP_FACTOR)
    if name == "WarmupCosineLR":
        return warmup_cosine_schedule(s.BASE_LR, s.MAX_ITER, **warm)
    if name == "WarmupTwoStageMultiStepLR":
        return warmup_two_stage_schedule(s.BASE_LR, s.STEPS, s.FACTOR_LIST, **warm)
    return warmup_multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA, **warm)


def init_params(cfg: CfgNode, model: MaskRCNN, seed: int = 0) -> MaskRCNN:
    """Draw ``model``'s seeded initial weights, then merge ``MODEL.WEIGHTS``
    into them by name when the file exists: a shape mismatch skips the
    entry, a missing file keeps the initial weights (as
    ``ttdg_mgm_tpu/build.py:init_params``).  A teacher-student checkpoint
    gives its ``modelStudent`` with ``TEST.EVAL_STU``, else its
    ``modelTeacher``."""
    from ttdg_mgm_torch.checkpoint.bridge import load_reference_checkpoint, merge_state_dict

    init_weights(model, torch.Generator().manual_seed(seed))
    weights = cfg.MODEL.WEIGHTS
    if weights and os.path.exists(weights):
        prefer = "modelStudent" if cfg.TEST.EVAL_STU else "modelTeacher"
        report = merge_state_dict(model, load_reference_checkpoint(weights, prefer=prefer))
        logger.info("loaded %d tensors from %s; %d of another shape and %d absent kept their "
                    "initial values", len(report["loaded"]), weights,
                    len(report["shape_mismatch"]), len(report["missing"]))
    elif weights:
        logger.warning("MODEL.WEIGHTS %s does not exist: the model keeps its initial weights",
                       weights)
    return model


def _clip(cfg: CfgNode) -> dict | None:
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.get("ENABLED"):
        return None
    ctype = c.get("CLIP_TYPE", "value")
    if ctype == "norm" and float(c.get("NORM_TYPE", 2.0)) != 2.0:
        raise ValueError("only the L2 global norm is supported (SOLVER.CLIP_GRADIENTS.NORM_TYPE)")
    return {"type": "norm" if ctype == "norm" else "value",
            "value": float(c.get("CLIP_VALUE", 1.0))}


def build_trainer(cfg: CfgNode, *, device=None, seed: int = 0):
    """The eval-only trainer of ``cfg`` on ``device`` (CUDA unless the
    caller names another): the model with its weights, SGD under
    :func:`build_schedule` and the test geometry of ``INPUT.*_TEST``."""
    from ttdg_mgm_torch.engine.trainer import BaselineTrainer

    dev = resolve_device(device)
    if cfg.SEMISUPNET.Trainer == "ateacher":
        raise NotImplementedError(
            f"SEMISUPNET.Trainer {cfg.SEMISUPNET.Trainer!r}: the mean-teacher trainer is not "
            "ported to ttdg_mgm_torch yet (ROADMAP.md, Queue 1); pass SEMISUPNET.Trainer "
            "baseline")
    model = init_params(cfg, MaskRCNN(**model_kwargs(cfg)), seed).to(dev)
    opt = build_optimizer(model, build_schedule(cfg), momentum=cfg.SOLVER.MOMENTUM,
                          weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                          freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT, clip=_clip(cfg))
    return BaselineTrainer(model, opt, min_size=cfg.INPUT.MIN_SIZE_TEST,
                           max_size=cfg.INPUT.MAX_SIZE_TEST)
