"""Box inference's class-aware NMS solved per image and class on the valid
candidates only (``ops/nms.py:compact_batched_nms_mask``) against the dense
solve it replaced and against the JAX package (CPU).

The dense solve ran ``batched_nms_mask`` over every ``K x classes``
candidate of an image, valid or not (:func:`dense` below runs the port's
box inference with it in place of the compact solve, as the reference).  The
compact one must give the same keep-mask and the same outputs bit for bit:

* the keep-masks on tests/test_torch_ops.py's NMS inputs (score ties among
  them), batched with an image that has no valid candidate;
* ``roi_box_inference`` on random logits, deltas and clustered proposals
  (duplicated rows for exact score ties, invalid proposals, every class on
  every proposal, so boxes of different classes overlap), at 2 classes and
  at 20 (Clipart1k's), at the score threshold 0.05 and at 0 (every
  candidate of a valid proposal valid);
* ``forward_inference`` on the committed fixture.

Against JAX's ``roi_box_inference`` (one image at a time), the
forward-inference tolerance of tests/test_torch_models.py: identical valid
slots and classes, boxes within 2e-2, scores within 1e-3.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import numpy as np
import pytest
import torch

from torch_port_fixture import jax_model_and_params, port_model, source_batch
from ttdg_mgm_tpu.models.roi_heads import roi_box_inference as j_roi_box_inference
from ttdg_mgm_torch.models import roi_heads as troi
from ttdg_mgm_torch.models.roi_heads import roi_box_inference
from ttdg_mgm_torch.ops.nms import batched_nms_mask, compact_batched_nms_mask


def dense(fn, *args, **kw):
    """``fn(*args, **kw)`` with box inference's NMS solved dense:
    ``batched_nms_mask`` over all ``K x num_classes`` candidates."""
    with pytest.MonkeyPatch.context() as m:
        m.setattr(troi, "compact_batched_nms_mask", batched_nms_mask)
        return fn(*args, **kw)


def _rand_boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2)).astype(np.float32)
    wh = rng.uniform(1, scale / 2, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def test_keep_masks_equal_the_dense_solve():
    """tests/test_torch_ops.py's inputs (seeds 0-2: 60 boxes, ten tied
    scores, 10 % invalid, 3 classes) as one batch with an image that has
    no valid candidate."""
    b, s, v, c = [], [], [], []
    for seed in (0, 1, 2):
        rng = np.random.RandomState(seed)
        b.append(_rand_boxes(rng, 60, scale=60.0))
        sc = rng.rand(60).astype(np.float32)
        sc[10:20] = sc[0]
        s.append(sc)
        v.append(rng.rand(60) > 0.1)
        c.append(rng.randint(0, 3, 60))
    b.append(b[0])
    s.append(s[0])
    v.append(np.zeros(60, bool))
    c.append(c[0])
    args = [torch.from_numpy(np.stack(x)) for x in (b, s, c, v)]
    for thr in (0.3, 0.5, 0.7):
        want = batched_nms_mask(*args, iou_threshold=thr)
        got = compact_batched_nms_mask(*args, iou_threshold=thr)
        assert torch.equal(got, want), thr
        assert want[:3].any(dim=1).all() and not got[3].any()
    none = compact_batched_nms_mask(*(a[3:] for a in args), iou_threshold=0.5)
    assert none.shape == (1, 60) and not none.any()


def _inputs(seed, B, K, nc, size=(96.0, 128.0)):
    """Logits, deltas and proposals clustered on three objects per image,
    rows duplicated (exact score ties), some proposals invalid."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(20, 80, (B, 3, 2))
    pick = rng.randint(0, 3, (B, K))
    ctr = np.take_along_axis(centers, pick[..., None], 1) + rng.randn(B, K, 2) * 4
    wh = rng.uniform(10, 40, (B, K, 2))
    boxes = np.concatenate([ctr - wh / 2, ctr + wh / 2], -1).astype(np.float32)
    logits = (rng.randn(B, K, nc + 1) * 2.0).astype(np.float32)
    deltas = (rng.randn(B, K, 4 * nc) * 0.3).astype(np.float32)
    src = np.arange(0, K - 1, 7)
    for a in (boxes, logits, deltas):
        a[:, src + 1] = a[:, src]
    valid = rng.rand(B, K) > 0.15
    sizes = np.tile(np.asarray(size, np.float32), (B, 1))
    return logits, deltas, boxes, valid, sizes


@pytest.mark.parametrize("nc,K,B", [(2, 64, 3), (20, 100, 2)])
@pytest.mark.parametrize("score_thresh", [0.05, 0.0])
def test_roi_box_inference_equals_dense_and_jax(nc, K, B, score_thresh):
    arrays = _inputs(nc + K, B, K, nc)
    args = [torch.from_numpy(a) for a in arrays]
    kw = dict(num_classes=nc, score_thresh=score_thresh, nms_thresh=0.5, topk=16)
    got = roi_box_inference(*args, **kw)
    want = dense(roi_box_inference, *args, **kw)
    for name, g, w in zip(("boxes", "scores", "classes", "valid"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert got[3].sum(1).min() > 1  # detections in every image
    for b in range(B):
        jb, js, jc, jv = (np.asarray(x) for x in j_roi_box_inference(
            *(a[b] for a in arrays), **kw))
        v = got[3][b].numpy()
        np.testing.assert_array_equal(v, jv)
        np.testing.assert_array_equal(got[2][b].numpy()[v], jc[v])
        np.testing.assert_allclose(got[0][b].numpy(), jb, atol=2e-2)
        np.testing.assert_allclose(got[1][b].numpy(), js, atol=1e-3)


def test_forward_inference_equals_dense_on_fixture():
    _, jp = jax_model_and_params()
    pm = port_model(jp)
    b = source_batch(6)
    images, sizes = torch.from_numpy(b["image"]), torch.from_numpy(b["image_sizes"])
    got = pm.forward_inference(images, sizes)
    want = dense(pm.forward_inference, images, sizes)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert got["valid"].sum() > 0
