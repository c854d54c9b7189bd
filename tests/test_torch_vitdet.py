"""ViTDet-B Mask R-CNN in the port (``models/vit.py``, ``fpn.py:
SimpleFeaturePyramid``, the LN heads) against the plain reference
``benchmark/reference/models/vitdet_model.py`` (detectron2's dense
attention, gathered relative positions, ``F.interpolate`` for the position
embedding), on seeded random weights at a small size: width 64, 4 heads,
3 blocks (window, window, global), window 4 on a 10 x 10 token grid padded
to 12 x 12, input 160 square, in float32 on the CPU.

Tolerances, float32 on both sides: the attention, a block and the pyramid
differ only in summation order (the position embedding's resize as two
matrix products against ``F.interpolate``, the channel LayerNorm as
``F.layer_norm`` against detectron2's formula), so 1e-5 relative to each
output's largest magnitude and 1e-4 for the gradients; the whole model's
``loss_ttt``, with the reference following the port's detections and
GA-GM answer (``benchmark/decisions.py``; those choose, and a last bit
may flip them), 1e-4 relative, each leaf's gradient within 1e-3 of the
largest leaf norm's share (the gap of its norm over max(its reference
norm, the median leaf's), ``benchmark/compare.py``); ``forward_inference``'s
scores 1e-4.  The port with the relative-position bias left out, or with
the windows' padded tokens masked, misses these by orders of magnitude.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import copy
import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

import compare  # noqa: E402
from decisions import Decisions  # noqa: E402
from reference.cell import Cfg  # noqa: E402
from reference.models import vitdet_model as ref  # noqa: E402
from weights import make_weights  # noqa: E402

from ttdg_mgm_torch.build import FLAGSHIP_KWARGS, PORT_FIELDS, model_kwargs  # noqa: E402
from ttdg_mgm_torch.config import PORT_DEFAULTS, get_cfg, setup_cfg, to_plain  # noqa: E402
from ttdg_mgm_torch.graph import mgm as mgm_mod  # noqa: E402
from ttdg_mgm_torch.models import vit as vit_mod  # noqa: E402
from ttdg_mgm_torch.models.fpn import SimpleFeaturePyramid  # noqa: E402
from ttdg_mgm_torch.models.rcnn import MaskRCNN  # noqa: E402
from ttdg_mgm_torch.ops import vit_attention as attn_op  # noqa: E402

SEED = 2 ** 31 + 19
WIDTH, HEADS, WINDOW, SIDE = 64, 4, 4, 160
GRID = SIDE // 16

#: the small ViTDet configuration over the port's defaults
SMALL = {
    "MODEL": {
        "BACKBONE": {"NAME": "build_vit_backbone"},
        "PIXEL_MEAN": [123.675, 116.28, 103.53], "PIXEL_STD": [58.395, 57.12, 57.375],
        "VIT": {"EMBED_DIM": WIDTH, "DEPTH": 3, "NUM_HEADS": HEADS, "MLP_RATIO": 4.0,
                "PATCH_SIZE": 16, "WINDOW_SIZE": WINDOW, "WINDOW_BLOCK_INDEXES": [0, 1],
                "PRETRAIN_IMG_SIZE": 224, "DROP_PATH_RATE": 0.0,
                "SQUARE_PAD": SIDE},
        "FPN": {"OUT_CHANNELS": 32, "NORM": "LN"},
        "RPN": {"CONV_DIMS": [-1, -1], "PRE_NMS_TOPK_TEST": 200, "POST_NMS_TOPK_TEST": 100},
        "ROI_BOX_HEAD": {"NUM_CONV": 4, "CONV_DIM": 32, "NUM_FC": 1, "FC_DIM": 64, "NORM": "LN"},
        "ROI_MASK_HEAD": {"CONV_DIM": 32, "NORM": "LN"},
        "GRAPH": {"MAX_NODES": 20, "UNIV_SIZE": 8, "GAGM_ITERS": 20, "HIPPI_ITERS": 5},
        "ROI_HEADS": {"BATCH_SIZE_PER_IMAGE": 64},
    },
    "SEMISUPNET": {"DIS_TYPE": "p2"},
    "TEST": {"DETECTIONS_PER_IMAGE": 20},
    "TPU": {"PRECISION": "float32"},
    "INPUT": {"MIN_SIZE_TEST": SIDE, "MAX_SIZE_TEST": SIDE},
}


def small_cfg(overrides: dict | None = None):
    cfg = get_cfg()
    cfg.merge_from_other(copy.deepcopy(SMALL))
    if overrides:
        cfg.merge_from_other(overrides)
    return cfg


@pytest.fixture(scope="module")
def models():
    """The port's model and the reference, both with the reference's seeded
    weights (``benchmark/weights.py`` with its ``init_rules``)."""
    cfg = small_cfg()
    reference = ref.build_model(Cfg(to_plain(cfg)))
    weights = make_weights(reference, SEED, ref.init_rules(reference))
    reference.load_state_dict(weights)
    port = MaskRCNN(**model_kwargs(cfg))
    port.load_state_dict(weights)
    return port, reference


def _images(seed: int, n: int = 2):
    gen = torch.Generator().manual_seed(seed)
    imgs = torch.rand((n, SIDE, SIDE, 3), generator=gen) * 255
    sizes = torch.tensor([[SIDE, SIDE], [SIDE - 10, SIDE - 24]][:n])
    return imgs, sizes


def _rel(got, want) -> float:
    got, want = got.detach(), want.detach()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _grid(seed: int, windows: bool):
    """A normed token grid of the trunk's width: 2 images of the 10 x 10
    grid, as padded windows of 4 (2 x 9 windows of 16 tokens) or whole."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((2, GRID, GRID, WIDTH), generator=gen)
    return vit_mod.window_partition(x, WINDOW)[0] if windows else x


@pytest.mark.parametrize("kind", ["window", "global"])
def test_attention_matches_dense_reference(models, kind):
    """The port's attention (the plain dispatch of kernel F) against the
    reference's dense attention on padded windows or the whole grid:
    output, and gradients into the input (so q, k, v), ``qkv``,
    ``rel_pos_h`` and ``rel_pos_w``."""
    port, reference = models
    b = 0 if kind == "window" else 2
    pa, ra = port.backbone.net.blocks[b].attn, reference.backbone.net.blocks[b].attn
    x = _grid(1, kind == "window")
    xp, xr = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    op, orr = pa(xp), ra(xr)
    assert _rel(op, orr) < 1e-5
    g = torch.randn(op.shape, generator=torch.Generator().manual_seed(2))
    op.backward(g)
    orr.backward(g)
    assert _rel(xp.grad, xr.grad) < 1e-4
    for name in ("qkv.weight", "qkv.bias", "rel_pos_h", "rel_pos_w", "proj.weight"):
        gp = dict(pa.named_parameters())[name].grad
        gr = dict(ra.named_parameters())[name].grad
        assert gr.abs().max() > 0 and _rel(gp, gr) < 1e-4, name
    pa.zero_grad()
    ra.zero_grad()


@pytest.mark.parametrize("block", [0, 2], ids=["window", "global"])
def test_block_matches_reference(models, block):
    port, reference = models
    x = _grid(3, False)
    got = port.backbone.net.blocks[block](x)
    want = reference.backbone.net.blocks[block](x)
    assert _rel(got, want) < 1e-5


def test_simple_pyramid_matches_reference(models):
    """The trunk (patch embedding, resized position embedding, 3 blocks) and
    the pyramid's p2-p6 at strides 4-64."""
    port, reference = models
    assert isinstance(port.backbone, SimpleFeaturePyramid)
    imgs, _ = _images(4)
    x = port._normalize(imgs)
    got, want = port.backbone(x), reference.backbone(x)
    assert sorted(got) == ["p2", "p3", "p4", "p5", "p6"]
    for k, stride in zip(("p2", "p3", "p4", "p5", "p6"), (4, 8, 16, 32, 64)):
        assert got[k].shape == (2, 32, -(-SIDE // stride), -(-SIDE // stride))
        assert _rel(got[k], want[k]) < 1e-5, k


def _loss_ttt(model, imgs, sizes, follow=None):
    """``loss_ttt`` and every leaf's gradient, recording (or, with
    ``follow``, imposing) the detections and GA-GM answer."""
    graph = mgm_mod if follow is None else sys.modules["reference.graph.mgm"]
    dec = Decisions([(model, "_box_inference", "det"), (graph, "ga_gm_fused", "U")],
                    follow=follow)
    model.zero_grad()
    try:
        dec.begin()
        loss = model.loss_ttt(imgs, sizes)
        dec.end()
        loss.backward()
        loss = loss.detach()
    finally:
        dec.close()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss), grads, dec.steps


def _gaps(models, imgs, sizes):
    port, reference = models
    lp, gp, steps = _loss_ttt(port, imgs, sizes)
    lr, gr, _ = _loss_ttt(reference, imgs, sizes, follow=steps)
    assert set(gp) <= set(gr)
    gp = {k: gp.get(k, torch.zeros_like(v)) for k, v in gr.items()}
    keep = {k for k, v in gr.items() if v.abs().max() > 0}
    return abs(lp - lr) / abs(lr), compare.worst_leaf(gp, gr, keep), keep


def test_loss_ttt_gradients_and_inference_match_reference(models):
    """The whole model: ``loss_ttt`` and every leaf's gradient (the trunk's
    relative-position tables and position embedding among them), then
    ``forward_inference``'s detections and masks."""
    imgs, sizes = _images(5)
    loss_gap, grad_gap, keep = _gaps(models, imgs, sizes)
    assert {"backbone.net.pos_embed", "backbone.net.blocks.0.attn.rel_pos_h",
            "backbone.net.blocks.2.attn.rel_pos_w"} <= keep
    assert loss_gap < 1e-4 and grad_gap < 1e-3, (loss_gap, grad_gap)
    port, reference = models
    got = port.forward_inference(imgs, sizes)
    want = reference.forward_inference(imgs, sizes)
    assert got["valid"].equal(want["valid"]) and got["valid"].any()
    assert got["classes"].equal(want["classes"])
    assert _rel(got["scores"], want["scores"]) < 1e-4
    assert (got["mask_probs"] - want["mask_probs"]).abs().max() < 1e-4


def _without_bias(real):
    def attention(q, k, v, rel_h, rel_w, scale):
        return real(q, k, v, torch.zeros_like(rel_h), torch.zeros_like(rel_w), scale)
    return attention


def _padding_masked(real):
    """Window attention with keys on the grid's zero padding masked out:
    the windows (image, row, column of 3 x 3) of the 12 x 12 padded grid hold
    padding in their last rows (row of windows 2) or columns (column 2)."""
    n_win = -(-GRID // WINDOW)
    valid = GRID - (n_win - 1) * WINDOW

    def attention(q, k, v, rel_h, rel_w, scale):
        if q.shape[1] != WINDOW * WINDOW:
            return real(q, k, v, rel_h, rel_w, scale)
        rel_h, rel_w = rel_h.clone(), rel_w.clone()
        win = torch.arange(q.shape[0]) // HEADS
        last_row = (win // n_win) % n_win == n_win - 1
        last_col = win % n_win == n_win - 1
        rel_h[last_row, :, valid:] = -1e30
        rel_w[last_col, :, valid:] = -1e30
        return real(q, k, v, rel_h, rel_w, scale)
    return attention


@pytest.mark.parametrize("fault", [_without_bias, _padding_masked],
                         ids=["bias_left_out", "padding_masked"])
def test_port_variants_fail_the_tolerances(models, monkeypatch, fault):
    """The port with the relative-position bias left out of its attention,
    or with the padded tokens masked, misses the loss or the gradient
    tolerance of the whole-model test."""
    monkeypatch.setattr(attn_op, "vit_attention", fault(attn_op.vit_attention))
    loss_gap, grad_gap, _ = _gaps(models, *_images(5))
    assert loss_gap > 1e-2 or grad_gap > 1e-1, (loss_gap, grad_gap)


@pytest.mark.parametrize("config", ["test_segment.yaml", "vgg16_bn_fpn"])
def test_config_round_trip_leaves_resnet_and_vgg_models_unchanged(config):
    """The R50 and VGG models' fields, parameter names and counts are those
    without the ViTDet keys: ``model_kwargs`` passes the model's defaults of
    the port's fields for them, and the port's keys stay out of
    ``get_cfg``."""
    opts = ["MODEL.BACKBONE.NAME", "build_vgg_backbone"] if config.startswith("vgg") else []
    cfg = setup_cfg(os.path.join(REPO, "configs", "test_segment.yaml"), opts)
    kw = model_kwargs(cfg)
    assert "vit" not in kw
    assert {f: kw[f] for f in PORT_FIELDS if f != "vit"} == dict(
        fpn_norm="", rpn_num_convs=1, box_num_conv=0, box_conv_dim=256, box_norm="",
        mask_norm="")
    for dotted in PORT_DEFAULTS:
        assert cfg.get_path(dotted) is None
    kw.update(resnet_depth=14, resnet_width=16)
    names = [n for n, _ in MaskRCNN(**kw).named_parameters()]
    assert not any(n.startswith("backbone.net.") or ".conv.conv" in n or ".norm." in n
                   and ".roi_heads." in n for n in names)
    assert "proposal_generator.rpn_head.conv.weight" in names
    assert "roi_heads.box_head.fc2.weight" in names and "roi_heads.box_head.conv1.weight" \
        not in names
    assert any(n.startswith("roi_heads.mask_head.mask_fcn1.bias") for n in names)
    base = MaskRCNN(**{k: v for k, v in kw.items()
                       if k in FLAGSHIP_KWARGS or k in ("resnet_depth", "resnet_width")})
    assert [(n, tuple(p.shape)) for n, p in base.named_parameters()] == [
        (n, tuple(p.shape)) for n, p in MaskRCNN(**kw).named_parameters()]


def test_vitdet_config_file_builds_vitdet_b():
    """``configs/vitdet/test_segment_vitdet_b.yaml``: ViTDet-B's fields,
    about 86 M parameters in the trunk (built on the meta device)."""
    cfg = setup_cfg(os.path.join(REPO, "configs", "vitdet", "test_segment_vitdet_b.yaml"))
    kw = model_kwargs(cfg)
    assert kw["backbone_name"] == "vit" and kw["rpn_num_convs"] == 2
    assert kw["vit"]["window_block_indexes"] == (0, 1, 3, 4, 6, 7, 9, 10)
    with torch.device("meta"):
        model = MaskRCNN(**kw)
    trunk = sum(p.numel() for p in model.backbone.net.parameters())
    assert 85e6 < trunk < 87e6, trunk


def test_nonzero_drop_path_raises():
    cfg = small_cfg({"MODEL": {"VIT": {"DROP_PATH_RATE": 0.1}}})
    with pytest.raises(ValueError, match="stochastic depth"):
        MaskRCNN(**model_kwargs(cfg))


@pytest.mark.parametrize("dims", [[-1, 256], []])
def test_rpn_conv_dims_give_only_a_count(dims):
    """``MODEL.RPN.CONV_DIMS`` entries other than -1 (a width the head would
    not build), or none, raise."""
    with pytest.raises(ValueError, match="CONV_DIMS"):
        model_kwargs(small_cfg({"MODEL": {"RPN": {"CONV_DIMS": dims}}}))


def test_backbone_spans_nest_in_the_step_backbone(models):
    """The tracer's spans ``backbone.vit`` and ``backbone.pyramid`` lie
    inside ``step.backbone`` (``utils/profiling.py``)."""
    from ttdg_mgm_torch.utils import profiling

    port, _ = models
    profiling.drain()
    profiling.enable()
    try:
        with torch.no_grad():
            port.extract_features(_images(6)[0])
    finally:
        profiling.disable()
    spans = {s["name"]: s for s in profiling.drain()}
    for name in ("backbone.vit", "backbone.pyramid"):
        assert spans[name]["parent"] == "step.backbone"
        assert spans["step.backbone"]["t0"] <= spans[name]["t0"] <= spans[name]["t1"] \
            <= spans["step.backbone"]["t1"]


#: ``train_net_torch.py`` overrides of a small ViT on ``configs/vitdet``'s file
CLI_VIT = ["MODEL.VIT.EMBED_DIM", "64", "MODEL.VIT.DEPTH", "3", "MODEL.VIT.NUM_HEADS", "4",
           "MODEL.VIT.WINDOW_SIZE", "4", "MODEL.VIT.WINDOW_BLOCK_INDEXES", "[0, 1]",
           "MODEL.VIT.SQUARE_PAD", "96", "INPUT.MIN_SIZE_TEST", "96", "INPUT.MAX_SIZE_TEST", "96",
           "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.CONV_DIM", "32",
           "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]


def test_train_net_trains_and_adapts_vitdet(tmp_path, caplog):
    """``train_net_torch.py`` with ``configs/vitdet/test_segment_vitdet_b.yaml``
    at a small width on the miniature Drishti-GS split: two source steps
    (``loss_supervised`` through the ViT, its checkpoint with the trunk's
    detectron2 names), then ``--eval-only`` on that file (every tensor
    loaded), the TTA step and Dice on the 96 square canvas."""
    import json
    import logging

    import train_net_torch
    from torch_port_fixture import cli_args, write_mini_split

    root = write_mini_split(tmp_path / "data")
    config = os.path.join(REPO, "configs", "vitdet", "test_segment_vitdet_b.yaml")
    base = cli_args(root, tmp_path / "out")
    base[base.index("--config") + 1] = config
    train = base[base.index("--device"):] + CLI_VIT + [
        "DATASETS.TRAIN", '["Drishti_GS_test"]', "SEMISUPNET.Trainer", "baseline",
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2",
        "TEST.EVAL_PERIOD", "0", "INPUT.MIN_SIZE_TRAIN", "(64,)",
        "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64"]
    first = train_net_torch.main(train)
    saved = torch.load(first["checkpoint"], weights_only=False)["model"]
    assert "backbone.net.blocks.2.attn.rel_pos_h" in saved
    assert saved["backbone.net.blocks.2.attn.rel_pos_h"].shape == (11, 16)
    lines = [json.loads(x) for x in (tmp_path / "out" / "metrics.json").read_text().splitlines()]
    assert all(torch.isfinite(torch.tensor(x["total_loss"])) for x in lines)
    ev = base + CLI_VIT + ["MODEL.WEIGHTS", first["checkpoint"], "OUTPUT_DIR",
                           str(tmp_path / "eval")]
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        results = train_net_torch.main(ev)
    assert "0 of another shape and 0 absent" in caplog.text
    assert results["Drishti_GS_test"]
