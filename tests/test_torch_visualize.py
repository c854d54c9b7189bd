"""The visualizer (``TEST.DRAW``) against the JAX package's, which draws
with OpenCV 5.0.0: ``utils/draw.py:rectangle`` against ``cv2.rectangle``
pixel for pixel; ``draw_detections``, ``dump_visualization`` and the dumps
of ``evaluate_dataset`` equal to JAX's with ``cv2.putText`` made a no-op,
apart from the port's label ink, which is one colour, the box's, inside the
label's band (and JAX's own ink meets that band); ``mask_image`` and
``overlay_masks`` bit for bit; ``encode_png`` read back by ``decode_png``
and ``cv2.imread``; and under two gloo ranks only rank 0 draws."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import os

import cv2
import jax
import numpy as np
import pytest

from test_torch_real_images import _JaxDetector, _PortDetector
from torch_port_fixture import cli_args, write_mini_split
from ttdg_mgm_tpu.data.builtin import register_all_medical as j_register
from ttdg_mgm_tpu.engine import trainer as jtrainer
from ttdg_mgm_tpu.utils import visualize as jvis
from ttdg_mgm_torch.data.builtin import register_all_medical as t_register
from ttdg_mgm_torch.data.png import decode_png, encode_png
from ttdg_mgm_torch.engine import trainer as ttrainer
from ttdg_mgm_torch.parallel import multihost
from ttdg_mgm_torch.utils import draw
from ttdg_mgm_torch.utils import visualize as tvis

RANK_TIMEOUT_S = 240.0


def _random_boxes(rng, n, h, w, margin=12):
    """Corner pairs in either order, some off the image, some of zero
    width or height."""
    x = rng.randint(-margin, w + margin, (n, 2))
    y = rng.randint(-margin, h + margin, (n, 2))
    x[::7, 1] = x[::7, 0]
    y[::5, 1] = y[::5, 0]
    return x, y


@pytest.mark.parametrize("thickness", [1, 2])
def test_rectangle_matches_opencv(thickness):
    """Random, clipped, reversed and degenerate boxes on colour and gray
    images."""
    rng = np.random.RandomState(thickness)
    for k in range(400):
        h, w = rng.randint(1, 48, 2)
        x, y = _random_boxes(rng, 1, h, w)
        p1, p2 = (int(x[0, 0]), int(y[0, 0])), (int(x[0, 1]), int(y[0, 1]))
        shape = (h, w, 3) if k % 2 else (h, w)
        color = tuple(int(c) for c in rng.randint(1, 256, 3)) if k % 2 else 255
        base = rng.randint(0, 256, shape).astype(np.uint8)
        want = cv2.rectangle(base.copy(), p1, p2, color, thickness)
        got = draw.rectangle(base.copy(), p1, p2, color, thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{shape} {p1} {p2}")


def test_rectangle_band_has_cut_corners():
    """At thickness 2 each side is a 3-pixel band centred on it, and each
    outer corner pixel stays unset."""
    img = draw.rectangle(np.zeros((12, 14), np.uint8), (3, 2), (9, 8), 1, 2)
    assert img[1:4, 3:10].all() and img[2:9, 2:5].all()
    assert img[1, 2] == img[1, 10] == img[9, 2] == img[9, 10] == 0
    assert img[4:7, 5:8].sum() == 0


@pytest.mark.parametrize("text", ["0 0.97", "optic_disc 1.00", "A-z ~!{}|"])
def test_put_label_ink(text):
    """One colour, no anti-aliasing, every pixel inside the label's band,
    some in every glyph cell of a visible character; non-printable
    characters draw as ``?``."""
    img = np.zeros((40, 160, 3), np.uint8)
    org = (3, 30)
    draw.put_label(img, text, org, (9, 200, 77))
    ink = img.any(-1)
    assert set(map(tuple, img[ink])) == {(9, 200, 77)}
    x0, y0, x1, y1 = draw.label_box(text, org)
    ys, xs = np.nonzero(ink)
    assert ys.min() >= y0 and ys.max() <= y1 and xs.min() >= x0 and xs.max() <= x1
    assert y1 - y0 + 1 == draw.CAP_HEIGHT == 10
    for i, ch in enumerate(text):
        cell = ink[y0:y1 + 1, x0 + i * draw.ADVANCE:x0 + (i + 1) * draw.ADVANCE]
        assert cell.any() == (ch != " "), ch
    assert np.array_equal(draw._glyph("\x07"), draw._glyph("?"))


def _detections(seed, n, h, w):
    rng = np.random.RandomState(seed)
    x0, y0 = rng.uniform(-5, w - 8, n), rng.uniform(-5, h - 8, n)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, w / 2, n), y0 + rng.uniform(2, h / 2, n)], 1)
    boxes[0] = [10.5, 20.5, 60.5, 70.5]  # round-half-even corners
    return dict(boxes=boxes.astype(np.float32), scores=rng.rand(n).astype(np.float32),
                classes=rng.randint(0, 8, n))


def _check_ink(got, plain, boxes, scores, classes, score_floor=0.0, jax_full=None,
               class_names=None):
    """``got`` equals ``plain`` (JAX with no text) but for label ink: each
    pixel where they differ lies in the band of a drawn box whose colour it
    has; each drawn box's label has ink; JAX's own ink meets the band."""
    diff = (got != plain).any(-1)
    drawn = [i for i in range(len(boxes)) if float(scores[i]) >= score_floor]
    bands = []
    for i in drawn:
        c = int(classes[i])
        label = class_names[c] if class_names else str(c)
        text = tvis.label_text(label, float(scores[i]))
        bands.append((draw.label_box(text, tvis.label_origin(boxes[i])),
                      tuple(tvis._COLORS[c % len(tvis._COLORS)][::-1]), text,
                      tvis.label_origin(boxes[i])))
    for y, x in zip(*np.nonzero(diff)):
        ok = [col for (x0, y0, x1, y1), col, _, _ in bands
              if x0 <= x <= x1 and y0 <= y <= y1]
        assert tuple(got[y, x]) in ok, (y, x, got[y, x], ok)
    h, w = got.shape[:2]
    for (x0, y0, x1, y1), col, text, org in bands:
        alone = draw.put_label(np.zeros((h, w), np.uint8), text, org, 1)
        if alone.any():
            assert (got[alone > 0] == col).all(-1).any()
        if jax_full is not None and x0 >= 0 and y0 >= 0 and x1 < w and y1 < h:
            jink = (jax_full != plain).any(-1)
            assert jink[y0:y1 + 1, x0:x1 + 1].any(), text
    return diff


@pytest.mark.parametrize("seed,score_floor,names", [(0, 0.0, None), (1, 0.4, None),
                                                     (2, 0.0, [f"c{i}" for i in range(8)])])
def test_draw_detections_matches_jax(seed, score_floor, names, monkeypatch):
    h, w = 120, 170
    rng = np.random.RandomState(100 + seed)
    image = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    det = _detections(seed, 12, h, w)
    args = (image, det["boxes"], det["scores"], det["classes"], names, score_floor)
    full = jvis.draw_detections(*args)
    got = tvis.draw_detections(*args)
    monkeypatch.setattr(cv2, "putText", lambda img, *a, **k: img)
    plain = jvis.draw_detections(*args)
    assert got.shape == plain.shape and got.dtype == plain.dtype == np.uint8
    diff = _check_ink(got, plain, det["boxes"], det["scores"], det["classes"], score_floor,
                      jax_full=full, class_names=names)
    assert diff.any()


def test_masks_match_jax():
    rng = np.random.RandomState(3)
    image = rng.randint(0, 256, (50, 70, 3)).astype(np.uint8)
    masks = rng.rand(4, 50, 70) < 0.3
    for classes in (None, np.array([0, 5, 7, 2])):
        np.testing.assert_array_equal(tvis.overlay_masks(image, masks, classes),
                                      jvis.overlay_masks(image, masks, classes))
    np.testing.assert_array_equal(tvis.mask_image(image, masks), jvis.mask_image(image, masks))
    np.testing.assert_array_equal(tvis.mask_image(image, []), jvis.mask_image(image, []))


@pytest.mark.parametrize("shape", [(1, 1, 3), (37, 53, 3), (21, 8)])
def test_encode_png_round_trip(shape, tmp_path):
    a = np.random.RandomState(len(shape)).randint(0, 256, shape).astype(np.uint8)
    data = encode_png(a)
    rgb = a if a.ndim == 3 else np.repeat(a[..., None], 3, -1)
    np.testing.assert_array_equal(decode_png(data), rgb)
    (tmp_path / "a.png").write_bytes(data)
    back = cv2.imread(str(tmp_path / "a.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back, a[..., ::-1] if a.ndim == 3 else a)


def _read(path):
    return cv2.imread(str(path))[..., ::-1]


def test_dump_visualization_matches_jax(tmp_path, monkeypatch):
    """Both files as ``cv2.imread`` reads them; an image without
    detections still gets its (black) mask file."""
    rng = np.random.RandomState(4)
    image = rng.randint(0, 256, (90, 110, 3)).astype(np.uint8)
    det = _detections(4, 5, 90, 110)
    det["masks"] = (rng.rand(5, 90, 110) < 0.2).astype(np.uint8)
    tvis.dump_visualization(str(tmp_path / "t"), "img7", image, det)
    jvis.dump_visualization(str(tmp_path / "jfull"), "img7", image, det)
    monkeypatch.setattr(cv2, "putText", lambda img, *a, **k: img)
    jvis.dump_visualization(str(tmp_path / "j"), "img7", image, det)
    for kind in ("visual", "masks"):
        assert os.listdir(tmp_path / "t" / kind) == ["img7.png"]
    np.testing.assert_array_equal(_read(tmp_path / "t/masks/img7.png"),
                                  _read(tmp_path / "j/masks/img7.png"))
    _check_ink(_read(tmp_path / "t/visual/img7.png"), _read(tmp_path / "j/visual/img7.png"),
               det["boxes"], det["scores"], det["classes"],
               jax_full=_read(tmp_path / "jfull/visual/img7.png"))
    empty = dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros(0), classes=np.zeros(0))
    tvis.dump_visualization(str(tmp_path / "t"), 8, image, empty)
    assert not _read(tmp_path / "t/masks/8.png").any()
    np.testing.assert_array_equal(_read(tmp_path / "t/visual/8.png"), image)


def test_evaluate_dataset_draws_as_jax(tmp_path, monkeypatch):
    """``evaluate_dataset`` on the miniature Drishti-GS split
    (``torch_port_fixture.write_mini_split``) with a fixed detector: one
    pair of files per image, equal to the JAX package's but for the label
    ink, and the same metrics as without drawing."""
    root = write_mini_split(tmp_path / "data")
    t_register(str(root), force=True)
    j_register(str(root), force=True)
    monkeypatch.setattr(cv2, "putText", lambda img, *a, **k: img)
    kw = dict(batch_size=2, canvas="auto", min_size=64, max_size=64, dice_threshold=0.0)
    plain = ttrainer.evaluate_dataset(_PortDetector(), "Drishti_GS_test", **kw)
    got = ttrainer.evaluate_dataset(_PortDetector(), "Drishti_GS_test",
                                    draw_dir=str(tmp_path / "t"), **kw)
    with jax.default_device(jax.devices("cpu")[0]):
        want = jtrainer.evaluate_dataset(_JaxDetector(), {}, "Drishti_GS_test",
                                         draw_dir=str(tmp_path / "j"), **kw)
    assert got == plain
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    ids = sorted(os.listdir(tmp_path / "j" / "visual"))
    assert len(ids) == 3
    for kind in ("visual", "masks"):
        assert sorted(os.listdir(tmp_path / "t" / kind)) == ids
    from ttdg_mgm_torch.data.catalog import DatasetCatalog

    recs = {f"{r['image_id']}.png": r for r in DatasetCatalog.get("Drishti_GS_test")}
    for name in ids:
        np.testing.assert_array_equal(_read(tmp_path / "t/masks" / name),
                                      _read(tmp_path / "j/masks" / name))
        t_img, j_img = _read(tmp_path / "t/visual" / name), _read(tmp_path / "j/visual" / name)
        h, w = recs[name]["height"], recs[name]["width"]
        assert t_img.shape == (h, w, 3)
        # the fixed detector's two valid boxes at the image's size (classes 0, 1)
        from test_torch_real_images import CLASSES, FRACS, SCORES, VALID

        boxes = FRACS[VALID] * np.array([w, h, w, h], np.float32)
        _check_ink(t_img, j_img, boxes, SCORES[VALID], CLASSES[VALID])


def test_only_rank_zero_draws(tmp_path):
    """``train_net_torch.py --eval-only ... TEST.DRAW True`` under two gloo
    ranks: both evaluate, only the main process calls the visualizer, and
    each image's two dumps are there."""
    from torch_parallel_worker import draw_rank_main

    root = write_mini_split(tmp_path / "data")
    out = tmp_path / "out"
    marks = tmp_path / "marks"
    marks.mkdir()
    argv = cli_args(root, out) + [
        "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
        "MODEL.ROI_MASK_HEAD.CONV_DIM", "32", "TEST.DRAW", "True", "TPU.MESH_SHAPE", "[2]"]
    multihost.launch(draw_rank_main, 2, dist_url=f"file://{tmp_path / 'store'}", device="cpu",
                     args=(argv, str(marks)), timeout_s=RANK_TIMEOUT_S)
    assert sorted(os.listdir(marks)) == ["rank0_0", "rank0_1", "rank0_2"]
    for kind in ("visual", "masks"):
        files = sorted(os.listdir(out / kind))
        assert files == ["0.png", "1.png", "2.png"]
        for f in files:
            assert decode_png((out / kind / f).read_bytes()).shape == (64, 64, 3)
