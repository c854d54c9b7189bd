"""The port's evaluation and weight loading against the JAX package's: the
mask paste, the Dice / E / S evaluator, the evaluator dispatch, result
flattening and family means, ``postprocess_detections``, and
``build.py:init_params`` on d2 checkpoints."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu import build as jbuild
from ttdg_mgm_tpu.checkpoint.converter import (convert_d2_state_dict, flax_to_d2_state_dict,
                                               load_reference_checkpoint)
from ttdg_mgm_tpu.engine import trainer as jtrainer
from ttdg_mgm_tpu.evaluation import build as jeval_build
from ttdg_mgm_tpu.evaluation import dice as jdice
from ttdg_mgm_tpu.ops.mask_paste import paste_masks_np
from ttdg_mgm_torch import build as tbuild
from ttdg_mgm_torch import config as tconfig
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2, load_d2_state_dict
from ttdg_mgm_torch.data.catalog import MetadataCatalog
from ttdg_mgm_torch.engine import trainer as ttrainer
from ttdg_mgm_torch.evaluation import build as teval_build
from ttdg_mgm_torch.evaluation import dice as tdice
from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights
from ttdg_mgm_torch.ops.mask_paste import paste_masks, paste_masks_plain

from torch_port_fixture import (jax_model_and_params, shifted_images,  # noqa: E402
                                to_numpy_tree)
from chip_smoke import paste_boxes as _boxes  # noqa: E402
from chip_smoke import paste_masks_np as paste_masks_twin  # noqa: E402


@pytest.mark.parametrize("seed,H,W,thr", [(0, 90, 130, 0.5), (1, 200, 77, 0.5),
                                          (2, 64, 64, 0.3), (3, 150, 240, 0.9)])
def test_paste_masks_matches_numpy(seed, H, W, thr):
    """Equal to ``paste_masks_np`` except at pixels whose value lies within
    1e-6 of the threshold."""
    rng = np.random.RandomState(seed)
    K = 40
    m = rng.rand(K, 28, 28).astype(np.float32)
    b = _boxes(rng, K, H, W)
    want = paste_masks_np(m, b, H, W, thr)
    got = paste_masks(torch.from_numpy(m), torch.from_numpy(b), H, W, thr)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (K, H, W)
    for k, y, x in zip(*np.nonzero(got.numpy() != want)):
        # the NumPy version's value there lies in [thr - 1e-6, thr + 1e-6)
        lo = paste_masks_np(m[k:k + 1], b[k:k + 1], H, W, thr - 1e-6)[0, y, x]
        hi = paste_masks_np(m[k:k + 1], b[k:k + 1], H, W, thr + 1e-6)[0, y, x]
        assert lo != hi, (k, y, x)
    assert want.sum() > 0


def _paste_case(case, rng):
    """Masks, boxes, height, width and threshold of a CPU case of
    :func:`test_paste_masks_cpu_cases`."""
    H, W = 60, 77
    if case == "empty":
        return np.zeros((0, 28, 28), np.float32), np.zeros((0, 4), np.float32), H, W, 0.5
    m = rng.rand(12, 28, 28).astype(np.float32)
    if case == "mixed":
        return m, _boxes(rng, 12, H, W), H, W, 0.3
    if case == "outside":
        # wholly left of, above, right of, below the image, and on its far corner
        b = np.array([[-40, 5, -1.5, 30], [3, -50, 40, -0.2], [W + 0.5, 2, W + 30, 40],
                      [4, H, 50, H + 20], [W, H, W + 10, H + 10], [-9, -9, -1, -1]] * 2,
                     np.float32)
        return m, b, H, W, 0.5
    # inside the image, thinner than a pixel along one axis or both, and
    # between two pixel centres there, so that every sample falls off the grid
    lo = rng.randint(2, [W - 25, H - 25], (12, 2)) + rng.uniform(0.55, 0.65, (12, 2))
    side = np.stack([rng.uniform(0.0, 0.3, 12), rng.uniform(3, 20, 12)], 1)
    side[4:8] = side[4:8, ::-1]
    side[8:] = rng.uniform(0.0, 0.3, (4, 2))
    return m, np.concatenate([lo, lo + side], 1).astype(np.float32), H, W, 0.5


@pytest.mark.parametrize("case", ["mixed", "empty", "outside", "subpixel"])
def test_paste_masks_cpu_cases(case):
    """On CPU tensors the wrapper runs the plain version (no kernel launch
    counted): K = 0 gives a ``(0, H, W)`` uint8 tensor, boxes wholly outside
    the image and boxes thinner than a pixel paste zeros, as
    ``paste_masks_np`` does."""
    m, b, H, W, thr = _paste_case(case, np.random.RandomState(7))
    before = paste_masks.launches
    got = paste_masks(torch.from_numpy(m), torch.from_numpy(b), H, W, thr)
    assert paste_masks.launches == before == 0
    assert got.dtype == torch.uint8 and tuple(got.shape) == (len(m), H, W)
    assert torch.equal(got, paste_masks_plain(torch.from_numpy(m), torch.from_numpy(b), H, W,
                                              thr))
    want = paste_masks_np(m, b, H, W, thr)
    if case == "mixed":
        assert want.sum() > 0
    else:
        assert want.sum() == 0 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,H,W,thr,dtype", [(0, 90, 130, 0.5, "float32"),
                                                (1, 200, 77, 0.3, "float32"),
                                                (2, 64, 1944, 0.9, "bfloat16"),
                                                (3, 800, 800, 0.5, "float32")])
def test_paste_numpy_twin_equals_jax_package(seed, H, W, thr, dtype):
    """``chip_smoke.paste_masks_np``, the NumPy paste the card's tests and
    smoke phase hold the kernel to (that machine has no JAX), equals the JAX
    package's ``paste_masks_np`` bit for bit, boxes over the border and
    thinner than a pixel included."""
    rng = np.random.RandomState(seed)
    K = 100 if H == 800 else 24
    m = rng.rand(K, 28, 28).astype(np.float32)
    if dtype == "bfloat16":
        m = torch.from_numpy(m).bfloat16().float().numpy()
    b = _boxes(rng, K, H, W)
    want = paste_masks_np(m, b, H, W, thr)
    np.testing.assert_array_equal(paste_masks_twin(m, b, H, W, thr), want)
    assert want.sum() > 0


def _masks(rng, n, h, w):
    yy, xx = np.mgrid[:h, :w]
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(2, h / 2), rng.uniform(2, w / 2)
        out.append((((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.uint8))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_dice_evaluator_matches_jax(seed):
    rng = np.random.RandomState(seed)
    h, w = 48, 70
    te, je = tdice.DiceEvaluator("x", 0.3), jdice.DiceEvaluator("x", 0.3)
    for _ in range(4):
        pm = _masks(rng, 6, h, w) + [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]
        pc = rng.randint(0, 2, len(pm))
        ps = rng.rand(len(pm))
        gm = _masks(rng, 2, h, w)
        gc = [0, 1]
        te.process(pm, pc, ps, gm, gc)
        je.process(pm, pc, ps, gm, gc)
        for p in pm[:3] + pm[-2:]:
            for g in gm + [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8)]:
                for f in ("dice_coefficient", "enhanced_align", "structure_measure"):
                    assert getattr(tdice, f)(p, g) == pytest.approx(getattr(jdice, f)(p, g),
                                                                    abs=1e-9)
    got, want = te.evaluate(), je.evaluate()
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9)
    empty = tdice.DiceEvaluator().evaluate()
    assert all(np.isnan(v) for v in empty.values())


def test_flatten_and_family_means_match_jax():
    nested = {"bbox": {"AP": 1.0, "AP50": 2, "per_class": {"car": 3.0, "n": "x"}},
              "Dice Coefficient": 43.5}
    assert teval_build.flatten_results(nested) == jeval_build.flatten_results(nested)
    rng = np.random.RandomState(0)
    res = {n: {"Dice Coefficient": rng.rand() * 100, "Enhanced Alignment Metric": rng.rand()}
           for n in ("REFUGE_train", "REFUGE_test", "ORIGA_test", "Drishti_GS_test",
                     "BKAI_test", "Drishti_mean")}
    got, want = ttrainer.aggregate_family_means(res), jtrainer.aggregate_family_means(res)
    assert got.keys() == want.keys()
    for k in want:
        for m in want[k]:
            assert got[k][m] == pytest.approx(want[k][m], abs=1e-9)


def test_evaluator_dispatch():
    """Each evaluator type gives the JAX dispatch's evaluator class, type
    and settings; an unknown type raises as there."""
    from ttdg_mgm_torch.evaluation.coco_eval import COCOEvaluator
    from ttdg_mgm_torch.evaluation.pascal_voc import PascalVOCDetectionEvaluator

    MetadataCatalog.get("_eval_untyped")
    ev, et = teval_build.build_evaluator("_eval_untyped", dice_threshold=0.4)
    assert et == "dice" and isinstance(ev, tdice.DiceEvaluator) and ev.score_threshold == 0.4
    for etype, cls in (("coco", COCOEvaluator), ("pascal_voc", PascalVOCDetectionEvaluator),
                       ("pascal_voc_water", PascalVOCDetectionEvaluator)):
        for mask_on in (True, False):
            ev, et = teval_build.build_evaluator("_eval_untyped", evaluator_type=etype,
                                                 mask_on=mask_on)
            jev, jet = jeval_build.build_evaluator("_eval_untyped", evaluator_type=etype,
                                                   mask_on=mask_on)
            assert isinstance(ev, cls) and type(ev).__name__ == type(jev).__name__
            assert et == jet
            assert {k: v for k, v in vars(ev).items() if k != "_images"} == {
                k: v for k, v in vars(jev).items() if k != "_images"}
    with pytest.raises(NotImplementedError, match="no Evaluator"):
        teval_build.build_evaluator("_eval_untyped", evaluator_type="cityscapes")


def test_postprocess_detections_matches_jax():
    """Rescale, clip, drop invalid detections and paste, from the same
    ``forward_inference`` output in both layouts."""
    rng = np.random.RandomState(3)
    B, D = 2, 12
    det = {"boxes": np.concatenate([rng.uniform(-10, 90, (B, D, 2)),
                                    rng.uniform(60, 160, (B, D, 2))], -1).astype(np.float32),
           "scores": rng.rand(B, D).astype(np.float32),
           "classes": rng.randint(0, 2, (B, D)).astype(np.int32),
           "valid": rng.rand(B, D) < 0.7,
           "mask_probs": rng.rand(B, D, 28, 28).astype(np.float32)}
    meta = {"scale": (128 / 100, 128 / 90), "orig_height": 100, "orig_width": 90}
    tdet = {k: torch.from_numpy(v) for k, v in det.items()}
    for b in range(B):
        got = ttrainer.postprocess_detections(tdet, meta, b)
        want = jtrainer.postprocess_detections(det, meta, b)
        for k in ("boxes", "scores", "classes"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["masks"].shape == want["masks"].shape
        assert (got["masks"] != want["masks"]).sum() <= 2


# -- MODEL.WEIGHTS ----------------------------------------------------------------

def _save(path, sd):
    torch.save({"model": {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}}, path)


def _cfg(path, eval_stu=False):
    return tconfig.setup_cfg(None, ["MODEL.WEIGHTS", path, "TEST.EVAL_STU", str(eval_stu)])


@pytest.fixture(scope="module")
def fixture_export(tmp_path_factory):
    """The golden fixture exported by the JAX package's exporter
    (``flax_to_d2_state_dict``) to a d2 ``.pth``, plain and as a
    teacher-student checkpoint whose student differs."""
    jmodel, params = jax_model_and_params()
    sd = flax_to_d2_state_dict(to_numpy_tree(params), box_head_channels=128)
    d = tmp_path_factory.mktemp("weights")
    plain, ens = str(d / "plain.pth"), str(d / "ens.pth")
    _save(plain, sd)
    student = {k: (v + 1.0 if k.endswith("cls_score.bias") else v) for k, v in sd.items()}
    _save(ens, {**{"modelTeacher." + k: v for k, v in sd.items()},
                **{"modelStudent." + k: v for k, v in student.items()}})
    return jmodel, params, sd, plain, ens


def _port_model():
    from demo_config import DEMO

    return MaskRCNN(**DEMO["model_kwargs"])


@pytest.mark.parametrize("which", ["plain", "teacher", "student"])
def test_init_params_loads_fixture_checkpoint(fixture_export, which):
    """``init_params`` on the exported fixture gives the weights the
    bridge gives (all of them, by name), the teacher unless
    ``TEST.EVAL_STU``."""
    _, params, sd, plain, ens = fixture_export
    model = tbuild.init_params(_cfg(plain if which == "plain" else ens, which == "student"),
                               _port_model(), seed=0)
    # the JAX exporter writes no cross-domain head (the reference has none):
    # those tensors keep the seeded initial values
    ref = init_weights(_port_model(), torch.Generator().manual_seed(0))
    head = {k: v.numpy() for k, v in ref.state_dict().items() if k.startswith("cross_domain.")}
    assert len(head) == 40 and not any(k.startswith("cross_domain.") for k in sd)
    load_d2_state_dict(ref, {**sd, **head})
    got, want = model.state_dict(), ref.state_dict()
    for k in want:
        if which == "student" and k.endswith("cls_score.bias"):
            torch.testing.assert_close(got[k], want[k] + 1.0, rtol=0, atol=0)
        else:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_init_params_forward_inference_matches_jax(fixture_export, tmp_path):
    """The port's ``forward_inference`` with the weights ``init_params``
    read from the exported fixture against the JAX package's on the
    fixture's own parameters: the detections of ``tests/test_torch_models.py``
    to its tolerances."""
    jmodel, params, _, plain, _ = fixture_export
    imgs, sizes = shifted_images(tmp_path, n=2)
    want = jax.jit(lambda p, i, s: jmodel.apply({"params": p}, i, s,
                                                method=jmodel.forward_inference))(
        params, jnp.asarray(imgs), jnp.asarray(sizes))
    model = tbuild.init_params(_cfg(plain), _port_model(), seed=0).eval()
    got = model.forward_inference(torch.from_numpy(imgs), torch.from_numpy(sizes))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["classes"].numpy()[v], np.asarray(want["classes"])[v])
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v],
                               atol=1e-3, rtol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy()[v], np.asarray(want["scores"])[v],
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(got["mask_probs"].numpy()[v], np.asarray(want["mask_probs"])[v],
                               atol=1e-5, rtol=1e-4)
    assert v.sum() > 0


R50_NARROW = dict(resnet_depth=50, resnet_width=16, fpn_channels=256, box_fc_dim=32,
                  mask_conv_dim=16, univ_size=8, num_classes=2)


def _random_flax_tree(seed):
    """A parameter tree of the narrow R50 in the JAX layout, random, built
    from the port model's own export (no JAX trace)."""
    model = tbuild.build_model(device="cpu", seed=seed, **R50_NARROW)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return convert_d2_state_dict(sd, num_classes=2)


def test_init_params_merge_matches_jax_loader(tmp_path):
    """On a checkpoint the JAX loader reads (R50 blocks, a 256-channel box
    head), as teacher-student and with one entry of another shape: the
    port's ``init_params`` against the two steps of the JAX package's
    ``init_params`` after its ``model.init`` (``load_reference_checkpoint``
    and ``_merge_params``) on the same file.  Every loaded tensor is equal;
    the entry of another shape keeps its initial value in both; a missing
    file keeps the initial weights."""
    src = _random_flax_tree(seed=1)
    sd = flax_to_d2_state_dict(src, box_head_channels=256)
    bad = "roi_heads.box_predictor.cls_score.weight"
    sd_bad = {**sd, bad: np.zeros((5, 32), np.float32)}
    path = str(tmp_path / "ens.pth")
    _save(path, {**{"modelTeacher." + k: v for k, v in sd_bad.items()},
                 **{"modelStudent." + k: v * 0.5 for k, v in sd.items()}})
    # the JAX side: its loader and merge onto a template of the model's tree
    template = jax.tree.map(lambda a: np.full(np.shape(a), 7.0, np.float32), src)
    loaded = load_reference_checkpoint(path, num_classes=2, prefer="modelTeacher")
    jtree = jbuild._merge_params(template, loaded)
    assert float(np.asarray(jtree["box_predictor"]["cls_score"]["kernel"]).max()) == 7.0
    want = flax_params_to_d2(jax.tree.map(np.asarray, jtree), box_head_channels=256)

    init = tbuild.build_model(device="cpu", seed=0, **R50_NARROW).state_dict()
    model = tbuild.init_params(_cfg(path), MaskRCNN(**R50_NARROW), seed=0)
    got = model.state_dict()
    torch.testing.assert_close(got[bad], init[bad], rtol=0, atol=0)
    n = 0
    for k, v in want.items():
        if k == bad or k not in got:
            continue
        if k.endswith(("running_mean", "running_var")):
            continue
        if ".norm." in k and k.endswith(".weight"):
            # FrozenBN: the JAX loader folds the statistics into the scale
            pre = k.rsplit(".", 1)[0]
            scale = got[pre + ".weight"] * (got[pre + ".running_var"] + 1e-5).rsqrt()
            wscale = torch.tensor(want[pre + ".weight"]) * torch.rsqrt(
                torch.tensor(want[pre + ".running_var"]) + 1e-5)
            torch.testing.assert_close(scale, wscale, rtol=1e-6, atol=0)
        else:
            torch.testing.assert_close(got[k], torch.tensor(v), rtol=0, atol=0, msg=k)
        n += 1
    assert n > 200

    missing = tbuild.init_params(_cfg(str(tmp_path / "absent.pth")), MaskRCNN(**R50_NARROW),
                                 seed=0).state_dict()
    for k in init:
        torch.testing.assert_close(missing[k], init[k], rtol=0, atol=0)
