"""The pseudo-label probes against the JAX package's (``engine/probe.py``):
the cases of tests/test_aux.py and tests/test_vgg_probe.py, and padded
random batches (boxes, classes, scores, validity from NumPy seeds), every
statistic equal to JAX's to 1e-12 (both compute in float64 on the host).
CPU tensors are read as NumPy arrays."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.engine import probe as jprobe
from ttdg_mgm_torch.engine import probe as tprobe


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=0, err_msg=k)


def _batch(seed, B=3, K=6, G=4):
    rs = np.random.RandomState(seed)
    gt = np.zeros((B, G, 4), np.float32)
    xy = rs.uniform(0, 200, (B, G, 2))
    wh = rs.uniform(8, 120, (B, G, 2))
    gt[..., :2], gt[..., 2:] = xy, xy + wh
    gt_valid = rs.rand(B, G) > 0.3
    gt_valid[0] = False  # an image without ground truth
    # pseudo-boxes: jittered GT boxes and random ones
    idx = rs.randint(0, G, (B, K))
    pseudo = gt[np.arange(B)[:, None], idx] + rs.randn(B, K, 4).astype(np.float32) * 6
    far = rs.rand(B, K) < 0.4
    pseudo[far] = np.array([300, 300, 340, 350], np.float32)
    return dict(pseudo=pseudo, pseudo_classes=rs.randint(0, 2, (B, K)),
                pseudo_valid=rs.rand(B, K) > 0.2, scores=rs.rand(B, K).astype(np.float32),
                gt=gt, gt_classes=rs.randint(0, 2, (B, G)), gt_valid=gt_valid)


def test_counts_case_of_the_jax_tests():
    gt = np.asarray([[[10, 10, 50, 50], [0, 0, 0, 0]]])
    pseudo = np.asarray([[[11, 11, 49, 49], [70, 70, 90, 90]]])
    args = (pseudo, np.asarray([[0, 1]]), np.asarray([[True, True]]), gt, np.asarray([[0, 0]]),
            np.asarray([[True, False]]))
    got = tprobe.probe_pseudo_labels(*args)
    _same(got, jprobe.probe_pseudo_labels(*args))
    assert got["num_pseudo"] == 2 and got["true_pos"] == 1
    assert got["false_pos"] == 1 and got["cls_accuracy"] == 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("iou", [0.3, 0.5])
def test_probe_pseudo_labels_matches_jax(seed, iou):
    b = _batch(seed)
    args = (b["pseudo"], b["pseudo_classes"], b["pseudo_valid"], b["gt"], b["gt_classes"],
            b["gt_valid"])
    got = tprobe.probe_pseudo_labels(*args, iou_thresh=iou)
    _same(got, jprobe.probe_pseudo_labels(*args, iou_thresh=iou))
    assert got["true_pos"] > 0 and got["false_pos"] > 0
    # CPU tensors (the trainer's pseudo-labels) read the same
    _same(tprobe.probe_pseudo_labels(*map(torch.from_numpy, args), iou_thresh=iou), got)


@pytest.mark.parametrize("seed", [0, 3])
def test_probe_size_distribution_matches_jax(seed):
    b = _batch(seed)
    got = tprobe.probe_size_distribution(b["pseudo"], b["pseudo_valid"])
    _same(got, jprobe.probe_size_distribution(b["pseudo"], b["pseudo_valid"]))
    boxes = np.asarray([[[0, 0, 10, 10], [0, 0, 200, 200], [0, 0, 50, 50]]])
    valid = np.asarray([[True, True, True]])
    s = tprobe.probe_size_distribution(boxes, valid)
    _same(s, jprobe.probe_size_distribution(boxes, valid))
    assert (s["num_boxes"], s["small"], s["medium"], s["large"]) == (3, 1, 1, 1)
    empty = tprobe.probe_size_distribution(boxes, np.zeros_like(valid))
    _same(empty, jprobe.probe_size_distribution(boxes, np.zeros_like(valid)))


@pytest.mark.parametrize("seed", [0, 4])
def test_probe_ood_accuracy_matches_jax(seed):
    b = _batch(seed)
    args = (b["scores"], b["pseudo_valid"], b["pseudo"], b["gt"], b["gt_valid"])
    got = tprobe.probe_ood_accuracy(*args)
    _same(got, jprobe.probe_ood_accuracy(*args))
    assert got["num_in"] > 0 and got["num_out"] > 0
    gt = np.asarray([[[10, 10, 50, 50]]])
    pseudo = np.asarray([[[11, 11, 49, 49], [100, 100, 140, 140]]])
    case = (np.asarray([[0.95, 0.2]]), np.asarray([[True, True]]), pseudo, gt,
            np.asarray([[True]]))
    s = tprobe.probe_ood_accuracy(*case)
    _same(s, jprobe.probe_ood_accuracy(*case))
    assert s["score_auc"] == 1.0 and s["num_in"] == 1 and s["num_out"] == 1
