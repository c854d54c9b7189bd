"""The COCO and Pascal VOC evaluators against the JAX package's (CPU): the
same AP dicts, to 1e-9, on seeded random detections and ground truth with
crowd regions, difficult boxes, masks, the 2007 and 2012 VOC metrics and a
class subset; and through ``evaluate_dataset`` on image files with a fixed
detector, with each evaluator forced as ``TEST.EVALUATOR`` forces it."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import json
import math

import jax
import numpy as np
import pytest

from test_torch_real_images import _JaxDetector, _PortDetector, _write_split
from ttdg_mgm_tpu.data import coco as jcoco
from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_tpu.data.datasets import pascal_voc as jvoc_data
from ttdg_mgm_tpu.engine import trainer as jtrainer
from ttdg_mgm_tpu.evaluation import coco_eval as jcoco_eval
from ttdg_mgm_tpu.evaluation import pascal_voc as jvoc
from ttdg_mgm_torch.data import coco as tcoco
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.engine import trainer as ttrainer
from ttdg_mgm_torch.evaluation import coco_eval as tcoco_eval
from ttdg_mgm_torch.evaluation import pascal_voc as tvoc

SIZE = 200


def _boxes(rng, n):
    wh = rng.uniform(4, 150, (n, 2))
    xy = rng.uniform(0, SIZE - wh)
    return np.concatenate([xy, xy + wh], 1)


def _masks(rng, boxes):
    yy, xx = np.mgrid[:SIZE, :SIZE]
    out = []
    for x0, y0, x1, y1 in boxes:
        cx, cy = (x0 + x1) / 2 + rng.uniform(-3, 3), (y0 + y1) / 2 + rng.uniform(-3, 3)
        out.append(((((xx - cx) / max((x1 - x0) / 2, 1)) ** 2
                     + ((yy - cy) / max((y1 - y0) / 2, 1)) ** 2) <= 1).astype(np.uint8))
    return out


def _images(seed, n_img=6, n_cls=3):
    """Per image: GT and detections near them (jittered, some far off),
    with crowd and difficult flags and masks."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_img):
        n_gt = rng.randint(1, 6)
        gt = _boxes(rng, n_gt)
        near = gt[rng.randint(0, n_gt, 4)] + rng.uniform(-12, 12, (4, 4))
        det = np.concatenate([near, _boxes(rng, 3)])
        out.append(dict(
            gt_boxes=gt, gt_classes=rng.randint(0, n_cls, n_gt),
            gt_crowd=rng.rand(n_gt) < 0.2, gt_difficult=rng.rand(n_gt) < 0.2,
            gt_masks=_masks(rng, gt), det_boxes=det, det_scores=rng.rand(len(det)),
            det_classes=rng.randint(0, n_cls, len(det)), det_masks=_masks(rng, det)))
    return out


def _assert_same(got, want, path=""):
    assert got.keys() == want.keys(), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k], f"{path}/{k}")
        elif math.isnan(want[k]):
            assert math.isnan(got[k]), f"{path}/{k}"
        else:
            assert got[k] == pytest.approx(want[k], abs=1e-9), f"{path}/{k}"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coco_evaluator_matches_jax(seed):
    imgs = _images(seed)
    te = tcoco_eval.COCOEvaluator(iou_types=("bbox", "segm"))
    je = jcoco_eval.COCOEvaluator(iou_types=("bbox", "segm"))
    for im in imgs:
        kw = {k: v for k, v in im.items() if k != "gt_difficult"}
        te.process(**kw)
        je.process(**kw)
    got, want = te.evaluate(), je.evaluate()
    _assert_same(got, want)
    assert set(want) == {"bbox", "segm"}
    assert {"AP", "AP50", "AP75", "APs", "APm", "APl"} == set(want["bbox"])
    assert 0 < want["bbox"]["AP50"] < 100 and any(im["gt_crowd"].any() for im in imgs)


@pytest.mark.parametrize("use_07,subset", [(False, None), (True, None),
                                           (False, ["bicycle", "car"])])
def test_voc_evaluator_matches_jax(use_07, subset):
    names = list(jvoc_data.VOC_CLASS_NAMES[:4])
    assert tvoc.VOC_CLASS_NAMES == jvoc_data.VOC_CLASS_NAMES
    assert tvoc.WATERCOLOR_CLASS_NAMES == jvoc_data.WATERCOLOR_CLASS_NAMES
    te = tvoc.PascalVOCDetectionEvaluator(names, use_07_metric=use_07, eval_class_subset=subset)
    je = jvoc.PascalVOCDetectionEvaluator(names, use_07_metric=use_07, eval_class_subset=subset)
    for im in _images(5, n_img=8, n_cls=4):
        args = (im["det_boxes"], im["det_scores"], im["det_classes"], im["gt_boxes"],
                im["gt_classes"])
        te.process(*args, gt_difficult=im["gt_difficult"])
        je.process(*args, gt_difficult=im["gt_difficult"])
    got, want = te.evaluate(), je.evaluate()
    _assert_same(got, want)
    assert 0 < want["bbox"]["AP50"] < 100
    assert set(want["bbox"]["per_class"]) <= set(subset or names)


@pytest.fixture()
def det_split(tmp_path):
    """tests/test_torch_real_images.py's split (JPEG and resized PNG,
    polygon ground truth) with a crowd box on its first image."""
    name = "_coco_voc_split"
    path = _write_split(str(tmp_path))
    with open(path) as f:
        coco = json.load(f)
    coco["annotations"].append({"id": 99, "image_id": 0, "category_id": 1, "iscrowd": 1,
                                "bbox": [10.0, 10.0, 40.0, 30.0], "segmentation":
                                [[10.0, 10.0, 50.0, 10.0, 50.0, 40.0, 10.0, 40.0]]})
    with open(path, "w") as f:
        json.dump(coco, f)
    for cat, reg in ((TCatalog, tcoco.register_coco_instances),
                     (JCatalog, jcoco.register_coco_instances)):
        cat.remove(name)
        reg(name, path, str(tmp_path))
    yield name
    TCatalog.remove(name)
    JCatalog.remove(name)


@pytest.mark.parametrize("etype,mask_on", [("coco", True), ("coco", False),
                                           ("pascal_voc", True)])
def test_evaluate_dataset_coco_and_voc_match_jax(det_split, etype, mask_on):
    """``evaluate_dataset`` with the evaluator forced (``TEST.EVALUATOR``):
    the same flat AP dict as the JAX package's on the same detections."""
    kw = dict(batch_size=2, canvas="auto", min_size=96, max_size=160, evaluator_type=etype)
    tdet, jdet = _PortDetector(), _JaxDetector()
    tdet.mask_on = jdet.mask_on = mask_on
    got = ttrainer.evaluate_dataset(tdet, det_split, **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jtrainer.evaluate_dataset(jdet, {}, det_split, **kw)
    _assert_same(got, want)
    assert "bbox_AP50" in want
    assert any(k.startswith("segm") for k in want) == (etype == "coco" and mask_on)


def test_mask_ap_without_segmentation_raises(det_split):
    """A box-only annotation (``segmentation`` None) under the COCO mask AP:
    the JAX package raises ``TypeError`` in the middle of the loop; the port
    raises ``ValueError`` before inference, naming the way out."""
    recs = TCatalog.get(det_split)
    recs[0]["annotations"][0]["segmentation"] = None
    TCatalog.remove(det_split)
    TCatalog.register(det_split, lambda: recs)
    with pytest.raises(ValueError, match="MODEL.MASK_ON False"):
        ttrainer.evaluate_dataset(_PortDetector(), det_split, evaluator_type="coco",
                                  canvas="auto", min_size=96, max_size=160)
    bbox = ttrainer.evaluate_dataset(type("BoxOnly", (_PortDetector,), {"mask_on": False})(),
                                     det_split, evaluator_type="coco", canvas="auto",
                                     min_size=96, max_size=160)
    assert "bbox_AP" in bbox and not any(k.startswith("segm") for k in bbox)


def test_voc_year_and_water_dispatch():
    from ttdg_mgm_tpu.data.catalog import MetadataCatalog as JMeta
    from ttdg_mgm_tpu.evaluation import build as jbuild
    from ttdg_mgm_torch.data.catalog import MetadataCatalog as TMeta
    from ttdg_mgm_torch.evaluation import build as tbuild

    for meta in (TMeta, JMeta):
        meta.get("_voc07").update(year=2007, thing_classes=["a", "b"])
    for etype, name in (("pascal_voc", "_voc07"), ("pascal_voc_water", "_voc_any")):
        te, tt = tbuild.build_evaluator(name, evaluator_type=etype)
        je, jt = jbuild.build_evaluator(name, evaluator_type=etype)
        assert tt == jt == "pascal_voc"
        assert (te.class_names, te.use_07, te.subset) == (je.class_names, je.use_07, je.subset)
