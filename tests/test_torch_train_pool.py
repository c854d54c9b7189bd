"""The plain versions of the training pool's backward (kernel C) and of the
batched Sinkhorn (kernel D) against the JAX package; the CUDA kernels
against these plain versions are in tests/test_torch_cuda.py.

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
from ttdg_mgm_torch.ops.roi_align import mask_roi_align, multilevel_roi_align_backward
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


def test_batched_sinkhorn_matches_pallas():
    """HiPPI's shape: 16 square 60 x 60 matrices, mixed valid counts (dummy
    rows where nrows < ncols), tau 1/200, 20 iterations."""
    rng = np.random.RandomState(1)
    s = rng.rand(16, 60, 60).astype(np.float32)
    nrows = rng.randint(0, 61, 16).astype(np.int32)
    ncols = rng.randint(1, 61, 16).astype(np.int32)
    nrows[:3] = [60, 32, 0]
    ncols[:3] = [32, 60, 60]
    want = np.asarray(sinkhorn_pallas(jnp.asarray(s), jnp.asarray(nrows), jnp.asarray(ncols),
                                      tau=1 / 200, max_iter=20, dummy_row=True, interpret=True))
    before = sinkhorn_batched.launches
    got = sinkhorn_batched(torch.from_numpy(s), torch.from_numpy(nrows), torch.from_numpy(ncols),
                           tau=torch.tensor(1 / 200), max_iter=20, dummy_row=True)
    assert sinkhorn_batched.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    plain = sinkhorn(torch.from_numpy(s), torch.from_numpy(nrows), torch.from_numpy(ncols),
                     tau=1 / 200, max_iter=20, dummy_row=True)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)


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
