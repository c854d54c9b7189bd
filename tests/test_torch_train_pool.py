"""The plain versions of the training pool's backward (kernel C) and of the
batched Sinkhorn (kernel D) against the JAX package; the CUDA kernels
against these plain versions are in tests/test_torch_cuda.py.  Also the
plain ``roi_footprints``, the plan kernel C works from, against the plain
backward's support.

Tolerances:

* the pool's feature gradient against ``jax.vjp`` of
  ``multilevel_roi_align_windowed_train(..., interpret=True)`` on ROIs that
  fit the window, and against the exact gather pooler's: atol 3e-4,
  rtol 1e-3 (tests/test_pallas.py:253-255, the JAX package's own bound for
  the windowed backward);
* the batched Sinkhorn against ``sinkhorn_pallas(..., dummy_row=True,
  interpret=True)``: atol 1e-5 (tests/test_pallas.py:166);
* ``sinkhorn_masked`` against the JAX function: atol 1e-5, the same bound;
* ``mask_roi_align`` against the JAX function: atol 1e-5 on values in
  [0, 1] (two float32 products summed in another order).
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.ops.pallas.roi_pool_pallas import multilevel_roi_align_windowed_train
from ttdg_mgm_tpu.ops.pallas.sinkhorn_pallas import sinkhorn_pallas
from ttdg_mgm_tpu.ops.roi_align import mask_roi_align as j_mask_roi_align
from ttdg_mgm_tpu.ops.roi_align import multilevel_roi_align as j_pool
from ttdg_mgm_tpu.ops.sinkhorn import sinkhorn_masked as j_sinkhorn_masked
from ttdg_mgm_torch.ops.roi_align import (mask_roi_align, multilevel_roi_align_backward,
                                          roi_footprints, roi_geometry)
from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool_backward, multilevel_roi_pool_train
from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched, sinkhorn_masked

GRAD_TOL = dict(atol=3e-4, rtol=1e-3)
SIZES = [(64, 64), (32, 32), (16, 16), (8, 8)]


def _problem(seed, B=2, K=10, C=32, P=7):
    rng = np.random.RandomState(seed)
    feats = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SIZES]
    # compact boxes that fit the TPU kernel's 32 x 40 window
    wh = rng.uniform(8, 110, (B, K, 2)).astype(np.float32)
    xy = rng.uniform(0, 140, (B, K, 2)).astype(np.float32)
    rois = np.concatenate([xy, xy + wh], -1)
    cot = rng.randn(B, K, P, P, C).astype(np.float32)
    return feats, rois, cot


@pytest.mark.parametrize("P,seed", [(7, 3), (14, 5)])
def test_plain_backward_matches_jax_windowed_vjp(P, seed):
    feats, rois, cot = _problem(seed, P=P)
    jr = jnp.asarray(rois)
    _, vjp_win = jax.vjp(lambda fs: multilevel_roi_align_windowed_train(
        fs, jr, output_size=P, sampling_ratio=0, interpret=True), [jnp.asarray(f) for f in feats])
    _, vjp_gather = jax.vjp(lambda fs: jax.vmap(lambda f, b: j_pool(
        f, b, output_size=P, sampling_ratio=0, pack_corners=False))(fs, jr),
        [jnp.asarray(f) for f in feats])
    (g_win,) = vjp_win(jnp.asarray(cot))
    (g_gather,) = vjp_gather(jnp.asarray(cot))
    got = multilevel_roi_align_backward(torch.from_numpy(cot), SIZES, torch.from_numpy(rois))
    for lvl, (a, w, g) in enumerate(zip(got, g_win, g_gather)):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=f"level {lvl}", **GRAD_TOL)
        np.testing.assert_allclose(a.numpy(), np.asarray(g), err_msg=f"level {lvl}", **GRAD_TOL)


def test_train_pool_autograd_on_cpu():
    """The training pool's ``autograd.Function`` on CPU tensors: forward is
    the plain pool, backward the plain scatter; the ROIs get no gradient and
    no kernel launch is counted."""
    feats, rois, cot = _problem(7)
    tf = [torch.from_numpy(f).requires_grad_() for f in feats]
    tr = torch.from_numpy(rois).requires_grad_()
    before = multilevel_roi_pool_backward.launches
    out = multilevel_roi_pool_train(tf, tr, output_size=7)
    (out * torch.from_numpy(cot)).sum().backward()
    assert multilevel_roi_pool_backward.launches == before
    assert tr.grad is None
    want = multilevel_roi_align_backward(torch.from_numpy(cot), SIZES, torch.from_numpy(rois))
    for f, w in zip(tf, want):
        torch.testing.assert_close(f.grad, w, rtol=0, atol=0)


@pytest.mark.parametrize("shape,dummy_row,max_iter", [
    ((16, 60, 60), True, 20), ((16, 60, 60), False, 20), ((16, 60, 60), True, 7),
    ((16, 60, 32), True, 20)], ids=["hippi", "no_dummy_row", "odd_max_iter", "non_square"])
def test_batched_sinkhorn_matches_pallas(shape, dummy_row, max_iter):
    """HiPPI's shape (16 square 60 x 60 matrices, mixed valid counts, dummy
    rows where nrows < ncols, tau 1/200, 20 iterations) and the other cases
    the CUDA kernel takes: no dummy rows, an odd iteration count (ends on a
    row sweep), a non-square batch."""
    N, n1, n2 = shape
    rng = np.random.RandomState(1)
    s = rng.rand(N, n1, n2).astype(np.float32)
    nrows = rng.randint(0, n1 + 1, N).astype(np.int32)
    ncols = rng.randint(1, n2 + 1, N).astype(np.int32)
    nrows[:3] = [n1, 32, 0]
    ncols[:3] = [min(32, n2), n2, n2]
    want = np.asarray(sinkhorn_pallas(jnp.asarray(s), jnp.asarray(nrows), jnp.asarray(ncols),
                                      tau=1 / 200, max_iter=max_iter, dummy_row=dummy_row,
                                      interpret=True))
    before = sinkhorn_batched.launches
    got = sinkhorn_batched(torch.from_numpy(s), torch.from_numpy(nrows), torch.from_numpy(ncols),
                           tau=torch.tensor(1 / 200), max_iter=max_iter, dummy_row=dummy_row)
    assert sinkhorn_batched.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    plain = sinkhorn(torch.from_numpy(s), torch.from_numpy(nrows), torch.from_numpy(ncols),
                     tau=1 / 200, max_iter=max_iter, dummy_row=dummy_row)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


def _corner_span(pos, w, n):
    """Span of the clamped bilinear corners of the samples with weight, in
    numpy; None when there is none."""
    pos, w = pos.numpy(), w.numpy()
    ok = (w > 0) & (pos > -1) & (pos < n)
    if not ok.any():
        return None
    c0 = np.floor(np.clip(pos, 0, n - 1))
    c1 = np.minimum(c0 + 1, n - 1)
    return c0[ok].min(), c1[ok].max()


@pytest.mark.parametrize("P,ratio", [(7, 0), (7, 2), (14, 0), (14, 2)])
def test_roi_footprints_bound_the_plain_backward(P, ratio):
    """``roi_footprints``, the plan the gather backward kernel relies on: for
    each ROI alone, with a cotangent of ones on that ROI only, the plain
    backward's nonzero support lies on the ROI's level inside its footprint,
    at most one pixel inside its far edges (a corner of weight 0), and the
    footprint is no larger than the span of its samples' corners.  Compact,
    elongated, degenerate, inverted and edge ROIs."""
    rng = np.random.RandomState(8)
    wh = np.exp(rng.uniform(np.log(2.0), np.log(240.0), (24, 2)))
    xy = rng.uniform(-20, 250, (24, 2))
    odd = [[-20, 5, 30, 60], [230, 240, 290, 300], [2, 3, 250, 18], [3, 2, 18, 250],
           [8, 8, 8, 8], [-40, -30, -2, -1], [0, 0, 256, 256], [10, 10, 9, 200],
           [255.5, 100, 256, 140]]
    rois = torch.from_numpy(
        np.concatenate([np.concatenate([xy, xy + wh], -1), odd]).astype(np.float32))
    R = rois.shape[0]
    level, y0, y1, x0, x1 = roi_footprints(rois, SIZES, output_size=P, sampling_ratio=ratio)
    want_level, ys, wy, xs, wx, _ = roi_geometry(rois, SIZES, output_size=P,
                                                 sampling_ratio=ratio)
    assert torch.equal(level, want_level)
    assert all(t.dtype == torch.int32 and t.shape == (R,) for t in (level, y0, y1, x0, x1))
    # one image per ROI, so each ROI's gradient stands alone
    grads = multilevel_roi_align_backward(torch.ones((R, 1, P, P, 1)), SIZES, rois[:, None],
                                          sampling_ratio=ratio)
    nonempty = 0
    for r in range(R):
        lv = int(level[r])
        assert all(not bool(g[r].any()) for j, g in enumerate(grads) if j != lv)
        H, W = SIZES[lv]
        for lo, hi, span in ((y0[r], y1[r], _corner_span(ys[r], wy[r], H)),
                             (x0[r], x1[r], _corner_span(xs[r], wx[r], W))):
            if span is None:
                assert hi < lo
            else:
                assert span[0] <= lo <= hi <= span[1]
        yy, xx = torch.nonzero(grads[lv][r, ..., 0], as_tuple=True)
        if yy.numel() == 0:
            continue
        nonempty += 1
        for idx, lo, hi in ((yy, y0[r], y1[r]), (xx, x0[r], x1[r])):
            assert lo == idx.min() and idx.max() <= hi <= idx.max() + 1
    assert nonempty >= R - 2


def test_sinkhorn_masked_matches_jax():
    rng = np.random.RandomState(2)
    s = rng.randn(40, 8).astype(np.float32)
    row_mask = rng.rand(40) > 0.3
    want = np.asarray(j_sinkhorn_masked(jnp.asarray(s), jnp.asarray(row_mask), tau=0.05,
                                        max_iter=20))
    got = sinkhorn_masked(torch.from_numpy(s), torch.from_numpy(row_mask), tau=0.05, max_iter=20)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    assert np.all(got.numpy()[~row_mask] == 0)


@pytest.mark.parametrize("ratio", [0, 2])
def test_mask_roi_align_matches_jax(ratio):
    rng = np.random.RandomState(4)
    masks = (rng.rand(6, 48, 48) > 0.5).astype(np.float32)
    wh = rng.uniform(4, 40, (6, 2)).astype(np.float32)
    xy = rng.uniform(-2, 30, (6, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], -1)
    want = np.asarray(j_mask_roi_align(jnp.asarray(masks), jnp.asarray(boxes), output_size=28,
                                       sampling_ratio=ratio))
    got = mask_roi_align(torch.from_numpy(masks), torch.from_numpy(boxes), output_size=28,
                         sampling_ratio=ratio)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
