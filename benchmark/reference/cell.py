"""The plain reference of a cell: the model, optimizer, loaders and steps of
the frozen copy under ``reference/`` (the port's plain code, kernels
replaced by their plain versions), built from the cell's configuration and
fed from the dataset files alone.  It imports nothing of the program and
takes nothing the program made: the configuration dict, the files and the
benchmark's weights are its inputs.

The model is ``MaskRCNN`` (``reference/models/rcnn.py``) from
:func:`model_kwargs`, unless the configuration names a reference model of
its own (``"reference_model"`` in ``configs/<config>.json``, loaded by
``harness.Run`` and passed here as ``model_module``): a file under
``benchmark/`` whose ``build_model(cfg)`` returns the model, built with the
device as the default.  Such a module may import ``reference.*`` (this
module's :func:`model_kwargs` among them) and nothing of the program.  Its
model offers what the steps call (``loss_ttt`` or ``loss_supervised``,
``forward_inference``, ``_box_inference``) and builds its convolution and
dense layers from ``reference/models/layers.py``, so that the control's
:func:`reference.models.layers.set_fp8` reaches them.

``fp8=True`` is the control: every convolution and dense layer of the bf16
policy takes inputs and weights rounded to float8 (e4m3, one scale per
tensor from its largest magnitude), the step below the configuration's
bf16.
"""

from __future__ import annotations

import torch

from reference.data import loader as ref_loader
from reference.data.catalog import DatasetCatalog
from reference.data.coco import register_coco_instances
from reference.engine.steps import make_source_step, make_tta_step
from reference.models import layers
from reference.models.rcnn import MaskRCNN
from reference.ops.mask_paste import paste_masks
from reference.solver.build import (build_optimizer, warmup_cosine_schedule,
                                    warmup_multistep_schedule, warmup_two_stage_schedule)


class Cfg(dict):
    """Attribute access over the nested configuration dict."""

    def __getattr__(self, name):
        v = self[name]
        return Cfg(v) if isinstance(v, dict) else v


def model_kwargs(cfg: Cfg) -> dict:
    """The model's fields from the configuration (the port's
    ``build.py:model_kwargs``)."""
    g = cfg.MODEL.GRAPH
    return dict(
        num_classes=cfg.MODEL.ROI_HEADS.NUM_CLASSES, univ_size=g.UNIV_SIZE,
        sample_dist=g.SAMPLE_DIST, node_cap_per_level=max(g.MAX_NODES // 5, 4),
        dis_type=cfg.SEMISUPNET.DIS_TYPE, cls_loss_type=cfg.MODEL.ROI_HEADS.LOSS,
        pixel_mean=tuple(cfg.MODEL.PIXEL_MEAN), pixel_std=tuple(cfg.MODEL.PIXEL_STD),
        pre_nms_topk_train=cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN,
        pre_nms_topk_test=cfg.MODEL.RPN.PRE_NMS_TOPK_TEST,
        post_nms_topk=cfg.MODEL.RPN.POST_NMS_TOPK_TEST,
        detections_per_image=cfg.TEST.DETECTIONS_PER_IMAGE,
        batch_size_per_image=cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE,
        backbone_name="vgg16" if "vgg" in cfg.MODEL.BACKBONE.NAME else "resnet50",
        resnet_depth=cfg.MODEL.RESNETS.DEPTH, freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT,
        mask_on=cfg.MODEL.MASK_ON, score_thresh_test=cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST,
        nms_thresh_test=cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST,
        roi_positive_fraction=cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION,
        rpn_nms_thresh=cfg.MODEL.RPN.NMS_THRESH, fpn_channels=cfg.MODEL.FPN.OUT_CHANNELS,
        box_fc_dim=cfg.MODEL.ROI_BOX_HEAD.FC_DIM, box_num_fc=cfg.MODEL.ROI_BOX_HEAD.NUM_FC,
        mask_conv_dim=cfg.MODEL.ROI_MASK_HEAD.CONV_DIM,
        mask_num_conv=cfg.MODEL.ROI_MASK_HEAD.NUM_CONV,
        pooler_sampling_ratio=cfg.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO,
        anchor_sizes=tuple(tuple(s) for s in cfg.MODEL.ANCHOR_GENERATOR.SIZES),
        sk_iters=g.SK_ITERS, sk_tau=g.SK_TAU, hippi_iters=g.HIPPI_ITERS,
        gagm_iters=g.GAGM_ITERS, lap_polish_iters=g.LAP_POLISH_ITERS,
        compute_dtype=("bfloat16" if cfg.SOLVER.AMP.ENABLED or cfg.TPU.PRECISION == "bfloat16"
                       else "float32"))


def schedule(cfg: Cfg):
    s = cfg.SOLVER
    name = s.get("LR_SCHEDULER_NAME", "WarmupMultiStepLR")
    warm = dict(warmup_iters=s.WARMUP_ITERS, warmup_factor=s.WARMUP_FACTOR)
    if name == "WarmupCosineLR":
        return warmup_cosine_schedule(s.BASE_LR, s.MAX_ITER, **warm)
    if name == "WarmupTwoStageMultiStepLR":
        return warmup_two_stage_schedule(s.BASE_LR, s.STEPS, s.FACTOR_LIST, **warm)
    return warmup_multistep_schedule(s.BASE_LR, s.STEPS, s.GAMMA, **warm)


def _clip(cfg: Cfg):
    c = cfg.SOLVER.CLIP_GRADIENTS
    if not c.get("ENABLED"):
        return None
    return {"type": "norm" if c.get("CLIP_TYPE", "value") == "norm" else "value",
            "value": float(c.get("CLIP_VALUE", 1.0))}


def geometry(cfg: Cfg) -> dict:
    """The loaders' geometry (the port's ``build.py:build_trainer``)."""
    d = cfg.TPU.IMAGE_DIVISIBILITY
    canvas = ("auto" if cfg.TPU.TRAIN_CANVAS == "auto"
              else ((cfg.INPUT.MIN_SIZE_TEST + d - 1) // d) * d)
    sizes = list(cfg.INPUT.MIN_SIZE_TRAIN)
    return dict(canvas=canvas, min_size=cfg.INPUT.MIN_SIZE_TEST, max_size=cfg.INPUT.MAX_SIZE_TEST,
                gt_cap=cfg.TPU.MAX_GT_PER_IMAGE,
                train_min_sizes=(tuple(sizes) if cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING == "choice"
                                 and sizes else None))


def build(cfg: dict, device, weights: dict | None = None, fp8: bool = False,
          model_module=None):
    """The reference model (with ``weights`` loaded when given) and its
    optimizer; the model is ``model_module.build_model(cfg)`` when a
    configuration's own module is given, else ``MaskRCNN``."""
    cfg = Cfg(cfg)
    # float32 means float32 (no TF32), and cuDNN's deterministic algorithms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    with torch.device(device):
        model = (MaskRCNN(**model_kwargs(cfg)) if model_module is None
                 else model_module.build_model(cfg))
    if weights is not None:
        model.load_state_dict({k: v.to(device) for k, v in weights.items()})
    if fp8:
        layers.set_fp8(model)
    opt = build_optimizer(model, schedule(cfg), momentum=cfg.SOLVER.MOMENTUM,
                          weight_decay=cfg.SOLVER.WEIGHT_DECAY,
                          freeze_at=cfg.MODEL.BACKBONE.FREEZE_AT, clip=_clip(cfg))
    return model, opt


def register(traffic: dict, root: str) -> None:
    """The traffic's datasets in the reference's own catalog, from the
    files under ``root``."""
    import os

    for spec in traffic["splits"]:
        name = spec["split"]
        DatasetCatalog.remove(name)
        if spec["kind"] == "cityscapes_foggy":
            from reference.data.datasets.cityscapes_foggy import load_cityscapes_foggy_instances

            img = os.path.join(root, "cityscapes_foggy", "leftImg8bit", name.split("_")[-1])
            gt = os.path.join(root, "cityscapes_foggy", "gtFine", name.split("_")[-1])
            DatasetCatalog.register(
                name, lambda i=img, g=gt: load_cityscapes_foggy_instances(i, g, cache=False))
        else:
            register_coco_instances(name, os.path.join(root, spec["json"]),
                                    os.path.join(root, spec["images"]))


def postprocess(det: dict, meta: dict, b: int) -> dict:
    """Image ``b``'s detections at its original size with their masks
    pasted (the port's ``engine/trainer.py:postprocess_detections``)."""
    sy, sx = meta["scale"]
    valid = det["valid"][b]
    boxes = det["boxes"][b][valid]
    scores = det["scores"][b][valid]
    classes = det["classes"][b][valid]
    probs = det["mask_probs"][b][valid]
    oh, ow = meta["orig_height"], meta["orig_width"]
    boxes = boxes / torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=boxes.device)
    boxes[:, 0::2] = boxes[:, 0::2].clamp(0, ow)
    boxes[:, 1::2] = boxes[:, 1::2].clamp(0, oh)
    masks = paste_masks(probs, boxes, oh, ow, threshold=0.5)
    return {"boxes": boxes.cpu().numpy(), "scores": scores.cpu().numpy(),
            "classes": classes.cpu().numpy(), "masks": masks.cpu().numpy()}


def _trainable(model, opt) -> dict:
    names = {id(p): n for n, p in model.named_parameters()}
    return {names[id(p)]: p for p in opt.params}


def run_tta(cfg: dict, split: str, device, weights: dict, steps: int, fp8: bool = False,
            follow: dict | None = None, counter=None, alter=None, model_module=None) -> dict:
    """The first ``steps`` TTA steps of the eval-only pass over ``split``,
    then inference and paste on its first batch, as the program's
    ``BaselineTrainer.test`` runs them.  Returns each step's loss and
    decisions (``decisions.py``), the optimizer's first gradient (its
    momentum after one step), the trainable parameters after the third step
    and the first batch's pasted detections.  With ``follow`` (another run's
    result) each step imposes that run's decisions.  ``counter`` (a dispatch mode
    factory) is entered around the first step and the inference pass;
    ``alter`` plants a fault in each GA-GM solution (``decisions.py``);
    ``model_module`` is the configuration's own reference model (:func:`build`)."""
    from decisions import Decisions
    from reference.graph import mgm as ref_mgm

    c = Cfg(cfg)
    model, opt = build(cfg, device, weights, fp8, model_module)
    step = make_tta_step(model, opt)
    geo = geometry(c)
    params = _trainable(model, opt)
    out = {"losses": []}

    def loader():
        return ref_loader.build_test_loader(split, batch_size=c.TEST.BATCH, canvas="auto",
                                            min_size=geo["min_size"], max_size=geo["max_size"],
                                            prefetch=0)

    dec = Decisions([(model, "_box_inference", "det"), (ref_mgm, "ga_gm_fused", "U")],
                    follow=follow["steps"] if follow else None, alter=alter, keep_args=("U",))
    try:
        for i, (batch, _) in enumerate(loader()):
            if i == steps:
                break
            x = {k: torch.from_numpy(batch[k]).to(device) for k in ("image", "image_sizes")}
            dec.begin()
            if counter is not None and i == 0:
                with counter("tta_step"):
                    loss = step(x)
            else:
                loss = step(x)
            dec.end()
            out["losses"].append(float(loss))
            if i == 0:
                out["grad"] = {n: opt.sgd.state[p]["momentum_buffer"].detach().to("cpu", copy=True)
                               for n, p in params.items()}
            if i == 2:
                out["params"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    finally:
        dec.close()
    out["steps"] = dec.steps
    first, metas = next(iter(loader()))
    images = torch.from_numpy(first["image"]).to(device)
    sizes = torch.from_numpy(first["image_sizes"]).to(device)
    if counter is not None:
        with counter("inference"):
            det = model.forward_inference(images, sizes)
    else:
        det = model.forward_inference(images, sizes)
    out["detections"] = {m["image_id"]: postprocess(det, m, b)
                         for b, m in enumerate(metas[:metas[0]["n_real"]])}
    return out


def run_source(cfg: dict, datasets, device, weights: dict, steps: int, seed: int,
               fp8: bool = False, follow: dict | None = None, counter=None,
               alter=None, model_module=None) -> dict:
    """The first ``steps`` source steps from the loader seeded with ``seed``
    and the sampling generator on ``device`` seeded with it (the port's
    ``BaselineTrainer.train`` in one process).  Returns each step's total
    loss and decisions (``decisions.py``: the RPN's proposals, HiPPI's
    target, and the first batched Sinkhorn of each step with its inputs),
    the first gradient
    (momentum after one step) and the trainable parameters after the third
    step.  With ``follow`` each step imposes that run's proposals and HiPPI
    targets;
    ``alter`` plants a fault at a choice point; ``model_module`` is the
    configuration's own reference model (:func:`build`)."""
    from decisions import Decisions
    from reference.graph import solvers as ref_solvers
    from reference.graph import universe as ref_universe
    from reference.models import rcnn as ref_rcnn

    c = Cfg(cfg)
    model, opt = build(cfg, device, weights, fp8, model_module)
    step = make_source_step(model, opt)
    geo = geometry(c)
    params = _trainable(model, opt)
    loader = ref_loader.build_train_loader(
        datasets, batch_size=c.SOLVER.IMS_PER_BATCH, canvas=geo["canvas"],
        min_size=geo["min_size"], max_size=geo["max_size"], gt_cap=geo["gt_cap"], mask_res=256,
        seed=seed, min_size_choices=geo["train_min_sizes"], prefetch=0)
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {"losses": []}
    dec = Decisions([(ref_rcnn, "generate_proposals", "proposals"),
                     (ref_universe, "hippi", "hippi"), (ref_solvers, "sinkhorn_batched", "sk")],
                    follow=follow["steps"] if follow else None, alter=alter, keep_args=("sk",))
    try:
        for i in range(steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in next(loader).items()}
            dec.begin()
            if counter is not None and i == 0:
                with counter("source_step"):
                    m = step(batch, gen)
            else:
                m = step(batch, gen)
            dec.end()
            out["losses"].append(float(m["total_loss"]))
            if i == 0:
                out["grad"] = {n: opt.sgd.state[p]["momentum_buffer"].detach().to("cpu", copy=True)
                               for n, p in params.items()}
            if i == 2:
                out["params"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
    finally:
        dec.close()
    out["steps"] = dec.steps
    return out

