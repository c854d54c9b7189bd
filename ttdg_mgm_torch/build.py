"""Configuration -> model, schedule, weights and trainer.

Counterpart of ``ttdg_mgm_tpu/build.py``: :func:`model_kwargs` maps a
config onto the model's fields as ``ttdg_mgm_tpu/build.py:build_model``
does, :func:`build_schedule` picks the learning-rate schedule,
:func:`init_params` draws the seeded initial weights and merges
``MODEL.WEIGHTS`` (a d2 ``.pth`` or ``.pkl``, or a checkpoint this package
wrote) by name, and :func:`build_trainer` puts them together with the train
and test geometry: ``SEMISUPNET.Trainer`` ``"baseline"`` builds
``engine/trainer.py:BaselineTrainer``, ``"ateacher"`` (the default)
``engine/mean_teacher.py:ATeacherTrainer`` (with its cross-domain head
under ``SEMISUPNET.CROSS_DOMAIN_MATCHING``).  A ``MODEL.BACKBONE.NAME``
containing ``"vgg"`` builds the VGG-16-BN trunk (``backbone_name="vgg16"``),
one containing ``"vit"`` (``build_vit_backbone``) ViTDet's plain ViT under
its simple feature pyramid (``backbone_name="vit"``, from the port's keys
``MODEL.VIT.*``, ``config.py:PORT_DEFAULTS``), whose test images lie on
its ``SQUARE_PAD`` square canvas, as its training images do.
``SOLVER.AMP.ENABLED`` or
``TPU.PRECISION bfloat16`` (the default) selects the bf16 compute policy,
``compute_dtype="bfloat16"``, as ``ttdg_mgm_tpu/build.py`` does.
:func:`build_mesh` reads ``TPU.MESH_SHAPE`` for the data-parallel world
(``parallel/``) and gives each rank its device.

``FLAGSHIP_KWARGS`` is the R50-FPN Mask R-CNN that the JAX package builds
for ``configs/test_segment.yaml``: full widths, 1000 proposals, 100
detections, a 32-slot universe and 12 nodes per FPN level
(``MODEL.GRAPH.MAX_NODES`` 64 // 5), so 60 nodes per graph, the
discriminator on ``p2`` (``SEMISUPNET.DIS_TYPE``), bf16 compute (the
config's default ``TPU.PRECISION``), and the
source-training fields at their ``ttdg_mgm_tpu/config.py`` defaults (2000
pre-NMS proposals, 512 sampled ROIs per image at 25 % foreground, 128 mask
ROIs, cross-entropy, 50 HiPPI iterations).  Source training
(``configs/seg_res50fpn_source.yaml``) trains this model, with 2 classes;
``SOURCE_SOLVER`` holds that file's solver settings (``IMS_PER_BATCH`` 8,
``BASE_LR`` 0.0025, over ``config.py``'s defaults, which
``solver/build.py`` keeps as its own: momentum 0.9, weight decay 1e-4).
"""

from __future__ import annotations

import logging
import os

import torch

from ttdg_mgm_torch import resolve_device
from ttdg_mgm_torch.config import CfgNode, port_value
from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights
from ttdg_mgm_torch.solver.build import (build_optimizer, warmup_cosine_schedule,
                                         warmup_multistep_schedule, warmup_two_stage_schedule)
from ttdg_mgm_torch.utils.profiling import span

logger = logging.getLogger("ttdg_mgm_torch")

FLAGSHIP_KWARGS = dict(
    num_classes=2, univ_size=32, sample_dist=10, node_cap_per_level=12, dis_type="p2",
    pixel_mean=(103.53, 116.28, 123.675), pixel_std=(1.0, 1.0, 1.0),
    pre_nms_topk_test=1000, post_nms_topk=1000, detections_per_image=100,
    sk_iters=20, sk_tau=0.05, gagm_iters=200, lap_polish_iters=200,
    backbone_name="resnet50", resnet_depth=50, resnet_width=256, freeze_at=2, mask_on=True,
    score_thresh_test=0.05, nms_thresh_test=0.5, rpn_nms_thresh=0.7,
    pooler_sampling_ratio=0, fpn_channels=256, box_fc_dim=1024, box_num_fc=2,
    mask_conv_dim=256, mask_num_conv=4,
    anchor_sizes=((32,), (64,), (128,), (256,), (512,)),
    cls_loss_type="CrossEntropy", pre_nms_topk_train=2000, batch_size_per_image=512,
    roi_positive_fraction=0.25, mask_fg_cap=128, hippi_iters=50, compute_dtype="bfloat16",
)

#: ``configs/seg_res50fpn_source.yaml`` SOLVER, and the GT-mask canvas of
#: the JAX trainer (``engine/trainer.py:196``)
SOURCE_SOLVER = dict(ims_per_batch=8, base_lr=0.0025, mask_res=256)

def backbone_name(cfg: CfgNode) -> str:
    """``"vit"``, ``"vgg16"`` or ``"resnet50"`` from ``MODEL.BACKBONE.NAME``."""
    name = cfg.MODEL.BACKBONE.NAME
    return "vit" if "vit" in name else "vgg16" if "vgg" in name else "resnet50"


#: the model's fields that the port's keys (``config.py:PORT_DEFAULTS``) and
#: ``ROI_BOX_HEAD``'s conv keys set; the JAX package's model has none of them
PORT_FIELDS = ("vit", "fpn_norm", "rpn_num_convs", "box_num_conv", "box_conv_dim", "box_norm",
               "mask_norm")


def rpn_num_convs(cfg: CfgNode) -> int:
    """The RPN head's conv count from ``MODEL.RPN.CONV_DIMS``, whose entries
    are each -1 (a conv as wide as its input, detectron2's only use)."""
    dims = port_value(cfg, "MODEL.RPN.CONV_DIMS")
    if not dims or any(d != -1 for d in dims):
        raise ValueError(f"MODEL.RPN.CONV_DIMS {list(dims)}: each entry must be -1 "
                         "(a conv as wide as its input)")
    return len(dims)


def vit_kwargs(cfg: CfgNode) -> dict:
    """The ViT trunk's fields and its square canvas from ``MODEL.VIT``."""
    def v(key):
        return port_value(cfg, "MODEL.VIT." + key)

    return dict(embed_dim=v("EMBED_DIM"), depth=v("DEPTH"), num_heads=v("NUM_HEADS"),
                mlp_ratio=float(v("MLP_RATIO")), patch_size=v("PATCH_SIZE"),
                window_size=v("WINDOW_SIZE"),
                window_block_indexes=tuple(v("WINDOW_BLOCK_INDEXES")),
                pretrain_img_size=v("PRETRAIN_IMG_SIZE"),
                drop_path_rate=float(v("DROP_PATH_RATE")), square_pad=v("SQUARE_PAD"))


def model_kwargs(cfg: CfgNode) -> dict:
    """The model's fields from ``cfg``, as ``ttdg_mgm_tpu/build.py:build_model``
    maps them: the trunk of :func:`backbone_name`, the ResNet of
    ``MODEL.RESNETS.DEPTH`` unless named otherwise; bf16 compute when
    ``SOLVER.AMP.ENABLED`` or ``TPU.PRECISION == "bfloat16"``.  The port's
    fields follow: ``vit`` (:func:`vit_kwargs`) for a ViT, and the pyramid's
    and heads' norms and conv counts (:data:`PORT_FIELDS`)."""
    g = cfg.MODEL.GRAPH
    kw = dict(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES,
        univ_size=g.UNIV_SIZE,
        sample_dist=g.SAMPLE_DIST,
        node_cap_per_level=max(g.MAX_NODES // 5, 4),
        dis_type=cfg.SEMISUPNET.DIS_TYPE,
        cls_loss_type=cfg.MODEL.ROI_HEADS.LOSS,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN),
        pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        pre_nms_topk_train=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
        pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        backbone_name=backbone_name(cfg),
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
        compute_dtype=("bfloat16" if cfg.SOLVER.AMP.ENABLED or cfg.TPU.PRECISION == "bfloat16"
                       else "float32"),
    )
    if kw["backbone_name"] == "vit":
        kw["vit"] = vit_kwargs(cfg)
    box = cfg.MODEL.ROI_BOX_HEAD
    kw.update(fpn_norm=port_value(cfg, "MODEL.FPN.NORM"), rpn_num_convs=rpn_num_convs(cfg),
              box_num_conv=box.NUM_CONV, box_conv_dim=box.CONV_DIM,
              box_norm=port_value(cfg, "MODEL.ROI_BOX_HEAD.NORM"),
              mask_norm=port_value(cfg, "MODEL.ROI_MASK_HEAD.NORM"))
    return kw


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


def local_data_ranks(cfg: CfgNode, device=None) -> int:
    """The data-parallel processes of this machine from ``TPU.MESH_SHAPE``,
    as ``ttdg_mgm_tpu/build.py:build_mesh`` reads it: ``[-1]`` is every
    visible GPU (one process each), ``[n]`` is ``n`` of them; a device that
    names its GPU (``cuda:N``) is one process on it, and ``[n]`` above 1
    then raises.  On the CPU ``[-1]`` is one process and ``[n]`` is ``n``
    gloo ranks.  A model axis above 1 raises ``ValueError``; CUDA without a
    GPU raises as :func:`~ttdg_mgm_torch.resolve_device` does."""
    from ttdg_mgm_torch.parallel.mesh import data_axis_size

    dev = resolve_device(device)
    shape = list(cfg.TPU.MESH_SHAPE)
    if dev.type != "cuda":
        return data_axis_size(shape, max(shape[0] if shape else 1, 1))
    return data_axis_size(shape, 1 if dev.index is not None else torch.cuda.device_count())


def build_mesh(cfg: CfgNode, device=None) -> torch.device:
    """This rank's device, the counterpart of
    ``ttdg_mgm_tpu/build.py:build_mesh``: on CUDA in a process group,
    ``cuda:<local rank>``, made the current device (one process per GPU);
    else ``device`` as :func:`~ttdg_mgm_torch.resolve_device` gives it.
    ``TPU.MESH_SHAPE`` is checked as :func:`local_data_ranks` reads it."""
    from ttdg_mgm_torch.parallel import mesh

    dev = resolve_device(device)
    local_data_ranks(cfg, dev)
    if dev.type == "cuda" and dev.index is None and mesh.active():
        dev = torch.device("cuda", mesh.local_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _clip(cfg: CfgNode) -> dict | None:
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.get("ENABLED"):
        return None
    ctype = c.get("CLIP_TYPE", "value")
    if ctype == "norm" and float(c.get("NORM_TYPE", 2.0)) != 2.0:
        raise ValueError("only the L2 global norm is supported (SOLVER.CLIP_GRADIENTS.NORM_TYPE)")
    return {"type": "norm" if ctype == "norm" else "value",
            "value": float(c.get("CLIP_VALUE", 1.0))}


def _canvas_size(cfg: CfgNode) -> int | str:
    """The train canvas of ``TPU.TRAIN_CANVAS``: ``"auto"`` (d2's per-batch
    buckets), or the square side ``MIN_SIZE_TEST`` rounded up to
    ``TPU.IMAGE_DIVISIBILITY``."""
    if cfg.TPU.TRAIN_CANVAS == "auto":
        return "auto"
    d = cfg.TPU.IMAGE_DIVISIBILITY
    return ((cfg.INPUT.MIN_SIZE_TEST + d - 1) // d) * d


def build_trainer(cfg: CfgNode, *, device=None, seed: int = 0):
    """The trainer of ``cfg`` (``SEMISUPNET.Trainer``) on ``device`` (CUDA
    unless the caller names another): the model with its weights, SGD under
    :func:`build_schedule`, and the geometry of
    ``ttdg_mgm_tpu/build.py:build_trainer``: the train canvas of
    :func:`_canvas_size`, ``TPU.MAX_GT_PER_IMAGE`` GT slots, the shortest
    edges of ``INPUT.MIN_SIZE_TRAIN`` under ``"choice"`` sampling, and
    ``INPUT.MIN_SIZE_TEST`` and ``MAX_SIZE_TEST`` for the train resize as
    for the test path (so ``INPUT.MAX_SIZE_TRAIN`` is not read, as in the
    JAX package).  The mean-teacher trainer takes the ``SEMISUPNET``
    settings as the JAX package does (``EMA_KEEP_RATE`` 0 reads as 0.9996,
    ``CROSS_DOMAIN_MATCHING`` adds the cross-domain head) and, with
    ``DATALOADER.SUP_PERCENT`` below 100, splits its labelled records with
    ``DATALOADER.RANDOM_DATA_SEED``.  In a process group the device is the
    rank's (:func:`build_mesh`).  Spans (``utils/profiling.py``):
    ``setup.build_trainer`` around it all, over ``setup.init_params`` (the
    model's construction and its weights, on the host)."""
    from ttdg_mgm_torch.engine.mean_teacher import ATeacherTrainer
    from ttdg_mgm_torch.engine.trainer import BaselineTrainer

    with span("setup.build_trainer"):
        dev = build_mesh(cfg, device)
        ss = cfg.SEMISUPNET
        with span("setup.init_params"):
            model = init_params(cfg, MaskRCNN(**model_kwargs(cfg)), seed)
        model = model.to(dev)
        opt = build_optimizer(model, build_schedule(cfg), momentum=cfg.SOLVER.MOMENTUM,
                              weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                              freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT, clip=_clip(cfg))
        train_sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
        common = dict(
            canvas=_canvas_size(cfg), min_size=cfg.INPUT.MIN_SIZE_TEST,
            max_size=cfg.INPUT.MAX_SIZE_TEST, gt_cap=cfg.TPU.MAX_GT_PER_IMAGE,
            train_min_sizes=(tuple(train_sizes) if cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING == "choice"
                             and train_sizes else None))
        if backbone_name(cfg) == "vit":
            common["test_canvas"] = port_value(cfg, "MODEL.VIT.SQUARE_PAD")
        if ss.Trainer == "ateacher":
            sup = cfg.DATALOADER.SUP_PERCENT
            return ATeacherTrainer(
                model, opt, ema_keep_rate=ss.EMA_KEEP_RATE or 0.9996,
                teacher_update_iter=ss.TEACHER_UPDATE_ITER, burn_up_step=ss.BURN_UP_STEP,
                unsup_weight=ss.UNSUP_LOSS_WEIGHT, dis_weight=ss.DIS_LOSS_WEIGHT,
                pseudo_threshold=ss.BBOX_THRESHOLD, cross_domain=ss.CROSS_DOMAIN_MATCHING,
                sup_percent=sup if sup < 100.0 else None,
                split_seed=cfg.DATALOADER.RANDOM_DATA_SEED, **common)
        return BaselineTrainer(model, opt, **common)
