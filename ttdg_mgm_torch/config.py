"""The configuration tree: defaults, YAML files with ``_BASE_`` inheritance
and dotted-path overrides.

This package's own copy of ``ttdg_mgm_tpu/config.py``: the same keys and
defaults (the ``TPU.*`` keys too, so that one YAML file means the same in
both packages), the same merge rules and the same decoding of override
strings.  It reads YAML with :mod:`ttdg_mgm_torch.utils.yaml_lite`, which
needs no PyYAML and returns what ``yaml.safe_load`` returns on the files in
``configs/``; only :meth:`CfgNode.dump` imports PyYAML.

The port runs float32 only: ``TPU.PRECISION`` defaults to ``"bfloat16"``
as in the JAX package, and ``ttdg_mgm_torch.build`` refuses it until the
bf16 policy is ported (pass ``TPU.PRECISION float32``).
"""

from __future__ import annotations

import ast
import copy
import os
from typing import Any

from ttdg_mgm_torch.utils.yaml_lite import YAMLError, safe_load


class CfgNode(dict):
    """Attribute-access dict with freeze support (yacs-compatible subset)."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"CfgNode has no attribute '{name}'")

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = CfgNode(value) if isinstance(value, dict) and not isinstance(
            value, CfgNode) else value

    def __setitem__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"CfgNode is frozen; cannot set '{name}'")
        super().__setitem__(name, value)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def __deepcopy__(self, memo):
        out = CfgNode()
        for k, v in self.items():
            out[k] = copy.deepcopy(v, memo)
        return out

    def freeze(self) -> "CfgNode":
        self.__dict__[CfgNode.IMMUTABLE] = True
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()
        return self

    def defrost(self) -> "CfgNode":
        self.__dict__[CfgNode.IMMUTABLE] = False
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()
        return self

    def is_frozen(self) -> bool:
        return self.__dict__.get(CfgNode.IMMUTABLE, False)

    def merge_from_other(self, other: "CfgNode | dict", allow_new: bool = True) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_other(v, allow_new=allow_new)
            else:
                if not allow_new and k not in self:
                    raise KeyError(f"Unknown config key: {k}")
                self[k] = CfgNode(v) if isinstance(v, dict) and not isinstance(v, CfgNode) else v

    def merge_from_file(self, path: str, allow_new: bool = True) -> None:
        self.merge_from_other(_load_yaml_with_base(path), allow_new=allow_new)

    def merge_from_list(self, opts: list) -> None:
        """``["SOLVER.BASE_LR", "0.01", ...]`` dotted-path overrides."""
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must be key/value pairs, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = _decode_value(value)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted.split("."):
            if not isinstance(node, dict) or p not in node:
                return default
            node = node[p]
        return node

    def dump(self) -> str:
        import yaml

        return yaml.safe_dump(to_plain(self), sort_keys=True)


def to_plain(node: Any) -> Any:
    """Nested plain dicts and lists (tuples become lists)."""
    if isinstance(node, dict):
        return {k: to_plain(v) for k, v in node.items()}
    if isinstance(node, tuple):
        return list(node)
    return node


def _decode_value(value: Any) -> Any:
    """Parse an override string into a Python value when possible: tuple and
    list literals through ``ast.literal_eval`` (the reference configs write
    ``STEPS: (60000, 80000)``), anything else as a YAML scalar or flow
    collection (``""`` becomes None, ``False`` a bool, ``1e-4`` stays a
    string), and the string itself when neither parses."""
    if not isinstance(value, str):
        return value
    s = value.strip()
    if s[:1] in "([":
        try:
            return ast.literal_eval(s)
        except (ValueError, SyntaxError):
            pass
    try:
        return safe_load(value)
    except YAMLError:
        return value


def _decode_strings(node: Any) -> Any:
    """Re-decode the string leaves of a loaded YAML tree, so tuple literals
    become sequences."""
    if isinstance(node, dict):
        return {k: _decode_strings(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_decode_strings(v) for v in node)
    return _decode_value(node)


def _load_yaml_with_base(path: str) -> dict:
    with open(path) as f:
        cfg = _decode_strings(safe_load(f.read()) or {})
    base = cfg.pop("_BASE_", None)
    if base is not None:
        base_path = base if os.path.isabs(base) else os.path.join(os.path.dirname(path), base)
        merged = _load_yaml_with_base(base_path)
        _dict_merge(merged, cfg)
        return merged
    return cfg


def _dict_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _dict_merge(dst[k], v)
        else:
            dst[k] = v


# ---------------------------------------------------------------------------
# Defaults: the keys and values of ttdg_mgm_tpu/config.py:get_cfg.
# ---------------------------------------------------------------------------

def get_cfg() -> CfgNode:
    c = CfgNode()
    c.VERSION = 2
    c.OUTPUT_DIR = "./output"
    c.SEED = 0
    c.VIS_PERIOD = 0

    # ---------------- MODEL ----------------
    c.MODEL = CfgNode()
    c.MODEL.META_ARCHITECTURE = "DAobjTwoStagePseudoLabGeneralizedRCNN"
    c.MODEL.MASK_ON = True
    c.MODEL.KEYPOINT_ON = False
    c.MODEL.WEIGHTS = ""
    c.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]  # BGR order, d2 default
    c.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
    c.MODEL.DEVICE = "tpu"

    c.MODEL.BACKBONE = CfgNode()
    c.MODEL.BACKBONE.NAME = "build_resnet_fpn_backbone"
    c.MODEL.BACKBONE.FREEZE_AT = 2

    c.MODEL.RESNETS = CfgNode()
    c.MODEL.RESNETS.DEPTH = 50
    c.MODEL.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    c.MODEL.RESNETS.NUM_GROUPS = 1
    c.MODEL.RESNETS.WIDTH_PER_GROUP = 64
    c.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
    c.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
    c.MODEL.RESNETS.STRIDE_IN_1X1 = True  # caffe2-style R50

    c.MODEL.FPN = CfgNode()
    c.MODEL.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    c.MODEL.FPN.OUT_CHANNELS = 256
    c.MODEL.FPN.FUSE_TYPE = "sum"

    c.MODEL.ANCHOR_GENERATOR = CfgNode()
    c.MODEL.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    c.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    c.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0

    c.MODEL.PROPOSAL_GENERATOR = CfgNode()
    c.MODEL.PROPOSAL_GENERATOR.NAME = "PseudoLabRPN"
    c.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

    c.MODEL.RPN = CfgNode()
    c.MODEL.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    c.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
    c.MODEL.RPN.IOU_LABELS = [0, -1, 1]
    c.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
    c.MODEL.RPN.POSITIVE_FRACTION = 0.5
    c.MODEL.RPN.BBOX_REG_WEIGHTS = [1.0, 1.0, 1.0, 1.0]
    c.MODEL.RPN.SMOOTH_L1_BETA = 0.0
    c.MODEL.RPN.LOSS_WEIGHT = 1.0
    c.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000
    c.MODEL.RPN.PRE_NMS_TOPK_TEST = 1000
    c.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
    c.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    c.MODEL.RPN.NMS_THRESH = 0.7
    c.MODEL.RPN.BOUNDARY_THRESH = -1
    c.MODEL.RPN.UNSUP_LOSS_WEIGHT = 1.0
    c.MODEL.RPN.LOSS = "CrossEntropy"

    c.MODEL.ROI_HEADS = CfgNode()
    c.MODEL.ROI_HEADS.NAME = "StandardROIHeadsPseudoLab"
    c.MODEL.ROI_HEADS.NUM_CLASSES = 2
    c.MODEL.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    c.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
    c.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
    c.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
    c.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
    c.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    c.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
    c.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
    c.MODEL.ROI_HEADS.LOSS = "CrossEntropy"  # or "FocalLoss"

    c.MODEL.ROI_BOX_HEAD = CfgNode()
    c.MODEL.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    c.MODEL.ROI_BOX_HEAD.NUM_FC = 2
    c.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
    c.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
    c.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
    c.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    c.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
    c.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = [10.0, 10.0, 5.0, 5.0]
    c.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    c.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False

    c.MODEL.ROI_MASK_HEAD = CfgNode()
    c.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    c.MODEL.ROI_MASK_HEAD.NUM_CONV = 4
    c.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
    c.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    c.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
    c.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False

    # Graph-matching subsystem (reference rcnn.py:115-120 and
    # multi_graph_matching.py constants; single tree replaces graph_config.py)
    c.MODEL.GRAPH = CfgNode()
    c.MODEL.GRAPH.UNIV_SIZE = 32
    c.MODEL.GRAPH.NODE_DIM = 256
    c.MODEL.GRAPH.SAMPLE_DIST = 10
    c.MODEL.GRAPH.FPN_STRIDES = [4, 8, 16, 32, 64]
    c.MODEL.GRAPH.SK_TAU = 0.05
    c.MODEL.GRAPH.SK_ITERS = 20
    c.MODEL.GRAPH.HIPPI_TAU = 1.0 / 200.0
    c.MODEL.GRAPH.HIPPI_ITERS = 50
    c.MODEL.GRAPH.GAGM_ITERS = 200
    c.MODEL.GRAPH.GAGM_SK_TAU0 = 0.1
    c.MODEL.GRAPH.GAGM_SK_GAMMA = 0.5
    c.MODEL.GRAPH.GAGM_MIN_TAU = 1.0e-2
    c.MODEL.GRAPH.GAGM_CONVERGE_TOL = 1.0e-3
    # iteration cap of the exact-LAP Hungarian finale inside the fused GA-GM
    # kernel; the default reproduces the reference's full 200-iteration
    # hungarian-projector round (multi_graph_matching.py:374-387)
    c.MODEL.GRAPH.LAP_POLISH_ITERS = 200
    c.MODEL.GRAPH.CLUSTER_ITERS = 10
    c.MODEL.GRAPH.QUAD_WEIGHT = 0.5
    c.MODEL.GRAPH.CLUSTER_QUAD_WEIGHT = 1.0
    c.MODEL.GRAPH.U_LOSS_W = 0.1
    c.MODEL.GRAPH.U_LOSS_LAM = 1.0e-4
    c.MODEL.GRAPH.PERM_LOSS = "perm"
    # static padding: max sampled nodes per image graph
    c.MODEL.GRAPH.MAX_NODES = 64

    # ---------------- INPUT ----------------
    c.INPUT = CfgNode()
    c.INPUT.FORMAT = "RGB"
    c.INPUT.MIN_SIZE_TRAIN = [640, 672, 704, 736, 768, 800]
    c.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    c.INPUT.MAX_SIZE_TRAIN = 1333
    c.INPUT.MIN_SIZE_TEST = 800
    c.INPUT.MAX_SIZE_TEST = 1333
    c.INPUT.RANDOM_FLIP = "horizontal"
    c.INPUT.MASK_FORMAT = "polygon"

    # ---------------- DATASETS ----------------
    c.DATASETS = CfgNode()
    c.DATASETS.TRAIN = []
    c.DATASETS.TEST = []
    c.DATASETS.TRAIN_LABEL = []
    c.DATASETS.TRAIN_UNLABEL = []
    c.DATASETS.CROSS_DATASET = True
    c.DATASETS.ROOT = "datasets"

    c.DATALOADER = CfgNode()
    c.DATALOADER.NUM_WORKERS = 4
    c.DATALOADER.SUP_PERCENT = 100.0
    c.DATALOADER.RANDOM_DATA_SEED = 0
    c.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

    # ---------------- SOLVER ----------------
    c.SOLVER = CfgNode()
    c.SOLVER.IMS_PER_BATCH = 16
    c.SOLVER.IMG_PER_BATCH_LABEL = 1
    c.SOLVER.IMG_PER_BATCH_UNLABEL = 1
    c.SOLVER.BASE_LR = 0.02
    c.SOLVER.MOMENTUM = 0.9
    c.SOLVER.WEIGHT_DECAY = 0.0001
    c.SOLVER.WEIGHT_DECAY_NORM = 0.0
    c.SOLVER.GAMMA = 0.1
    c.SOLVER.STEPS = [60000, 80000]
    c.SOLVER.FACTOR_LIST = [1]
    c.SOLVER.MAX_ITER = 90000
    c.SOLVER.WARMUP_FACTOR = 1.0 / 1000
    c.SOLVER.WARMUP_ITERS = 1000
    c.SOLVER.WARMUP_METHOD = "linear"
    c.SOLVER.CHECKPOINT_PERIOD = 5000
    # d2 gradient clipping (CLIP_TYPE "value" clips per-element, "norm" clips
    # the global norm); from-scratch FrozenBN training needs it at the
    # reference BASE_LR (ImageNet-init runs don't)
    c.SOLVER.CLIP_GRADIENTS = CfgNode({
        "ENABLED": False, "CLIP_TYPE": "value", "CLIP_VALUE": 1.0,
        "NORM_TYPE": 2.0,
    })
    c.SOLVER.AMP = CfgNode({"ENABLED": False})  # on TPU -> bf16 compute policy
    c.SOLVER.BIAS_LR_FACTOR = 1.0
    c.SOLVER.WEIGHT_DECAY_BIAS = 0.0001

    # ---------------- TEST ----------------
    c.TEST = CfgNode()
    c.TEST.EVAL_PERIOD = 0
    c.TEST.EVALUATOR = "COCOeval"
    c.TEST.VAL_LOSS = True
    c.TEST.EVAL_STU = False
    c.TEST.DRAW = False
    c.TEST.DICE = False
    c.TEST.DICE_THRES = 0.9
    c.TEST.TTT = True
    c.TEST.BATCH = 1
    c.TEST.MIN_BATCH_NUM = None
    c.TEST.DETECTIONS_PER_IMAGE = 100

    # ---------------- SEMISUPNET (reference config.py:36-58) -------------
    c.SEMISUPNET = CfgNode()
    c.SEMISUPNET.Trainer = "ateacher"
    c.SEMISUPNET.MLP_DIM = 128
    c.SEMISUPNET.BBOX_THRESHOLD = 0.7
    c.SEMISUPNET.PSEUDO_BBOX_SAMPLE = "thresholding"
    c.SEMISUPNET.TEACHER_UPDATE_ITER = 1
    c.SEMISUPNET.BURN_UP_STEP = 12000
    c.SEMISUPNET.EMA_KEEP_RATE = 0.0
    c.SEMISUPNET.UNSUP_LOSS_WEIGHT = 4.0
    c.SEMISUPNET.SUP_LOSS_WEIGHT = 0.5
    c.SEMISUPNET.LOSS_WEIGHT_TYPE = "standard"
    c.SEMISUPNET.DIS_TYPE = "res4"
    c.SEMISUPNET.DIS_LOSS_WEIGHT = 0.1
    c.SEMISUPNET.TTT = False
    # cross-domain graph matching in the mean-teacher step (the reference's
    # broken intent at trainer.py:929 / GModule graph_matching.py:597-721,
    # implemented correctly; SURVEY.md section 0)
    c.SEMISUPNET.CROSS_DOMAIN_MATCHING = False

    c.EMAMODEL = CfgNode()
    c.EMAMODEL.SUP_CONSIST = True

    # ---------------- TPU-native additions ----------------
    c.TPU = CfgNode()
    c.TPU.MESH_SHAPE = [-1]          # data-parallel by default; -1 = all devices
    c.TPU.MESH_AXES = ["data"]
    c.TPU.PRECISION = "bfloat16"      # compute dtype for conv/matmul
    c.TPU.SOLVER_DTYPE = "float32"    # Sinkhorn/HiPPI/GA-GM accumulation dtype
    # Static shape budget (ragged -> fixed + mask). Image padding buckets are
    # multiples of IMAGE_DIVISIBILITY; one bucket per dataset keeps recompiles rare.
    c.TPU.IMAGE_DIVISIBILITY = 32
    # Train geometry: "square" fits ResizeShortestEdge output onto ONE static
    # square canvas (min recompiles); "auto" is the reference-faithful
    # geometry (dataset_mapper.py:31-35 ResizeShortestEdge + batch-max
    # padding) on per-batch rectangular CANVAS_BUCKETS pairs.
    c.TPU.TRAIN_CANVAS = "square"
    c.TPU.MAX_GT_PER_IMAGE = 32
    c.TPU.MAX_DETECTIONS = 100
    c.TPU.DONATE_TTA_STATE = True

    return c


def setup_cfg(config_file: str | None = None, opts: list | None = None) -> CfgNode:
    """A frozen config from the defaults, a YAML file and overrides."""
    cfg = get_cfg()
    if config_file:
        cfg.merge_from_file(config_file)
    if opts:
        cfg.merge_from_list(list(opts))
    cfg.freeze()
    return cfg
