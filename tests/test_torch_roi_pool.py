"""The ROI pool's plain version against the JAX package (the CUDA kernel
against the plain version is in tests/test_torch_cuda.py).

Tolerance atol 2e-5, rtol 1e-4 (tests/test_pallas.py:TestWindowedRoiPool):
the same bilinear arithmetic in float32, summed in another order.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.ops.pallas.roi_pool_pallas import multilevel_roi_align_windowed
from ttdg_mgm_tpu.ops.roi_align import multilevel_roi_align as j_pool
from ttdg_mgm_torch.ops.roi_align import multilevel_roi_align
from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool

TOL = dict(atol=2e-5, rtol=1e-4)
SIZES = [(64, 64), (32, 32), (16, 16), (8, 8)]


def _feats(rng, B, sizes, C=32):
    return [rng.randn(B, h, w, C).astype(np.float32) for h, w in sizes]


def _j_gather(feats, rois, P, ratio=0):
    return np.asarray(jax.vmap(lambda fs, b: j_pool(
        fs, b, output_size=P, sampling_ratio=ratio, pack_corners=False))(feats, rois))


def _t(feats, rois, P, ratio=0):
    return multilevel_roi_pool([torch.from_numpy(f) for f in feats], torch.from_numpy(rois),
                               output_size=P, sampling_ratio=ratio).numpy()


def _compact_rois(rng, B, K, lo=8, hi=120, origin=(-4, 250)):
    wh = rng.uniform(lo, hi, (B, K, 2)).astype(np.float32)
    xy = rng.uniform(*origin, (B, K, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


@pytest.mark.parametrize("P", [7, 14])
def test_plain_matches_jax_gather_and_windowed(P):
    """Compact ROIs (no window misfits) at P = 7 and 14, adaptive grid:
    plain == JAX gather pooler == JAX windowed kernel in interpret mode."""
    rng = np.random.RandomState(P)
    B, K = 2, 10
    feats = _feats(rng, B, SIZES)
    rois = _compact_rois(rng, B, K, hi=90 if P == 14 else 120)
    got = _t(feats, rois, P)
    np.testing.assert_allclose(got, _j_gather(feats, rois, P), **TOL)
    win = np.asarray(multilevel_roi_align_windowed(
        feats, rois, output_size=P, sampling_ratio=0, interpret=True))
    np.testing.assert_allclose(got, win, **TOL)


@pytest.mark.parametrize("ratio", [0, 2])
def test_plain_out_of_range_elongated_degenerate(ratio):
    """ROIs outside the image, elongated beyond the TPU window (exact here,
    no misfit budget), degenerate and clamped beyond the adaptive cap."""
    rng = np.random.RandomState(5)
    feats = _feats(rng, 1, [(48, 64), (24, 32), (12, 16), (6, 8)])
    rois = np.array([[[2, 3, 250, 18], [5, 10, 20, 200], [-40, -30, -2, -1],
                      [230, 170, 300, 260], [8, 8, 8, 8], [0, 0, 255, 191],
                      [100.5, 20.25, 140.75, 60.5], [1, 1, 230, 20],
                      [-10, 5, 30, 40]]], np.float32)
    for P in (7, 14):
        np.testing.assert_allclose(_t(feats, rois, P, ratio), _j_gather(feats, rois, P, ratio),
                                   **TOL)


def test_wrapper_runs_plain_on_cpu():
    """On CPU tensors the kernel wrapper is the plain pooler, and it counts no
    kernel launch."""
    rng = np.random.RandomState(8)
    feats = [torch.from_numpy(f) for f in _feats(rng, 1, SIZES)]
    rois = torch.from_numpy(_compact_rois(rng, 1, 6))
    before = multilevel_roi_pool.launches
    got = multilevel_roi_pool(feats, rois, output_size=7)
    assert multilevel_roi_pool.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  multilevel_roi_align(feats, rois, output_size=7).numpy())


@pytest.mark.parametrize("P,ratio", [(7, 0), (14, 0), (7, 2)])
def test_plain_geometry_matches_jax(P, ratio):
    """``roi_geometry``, the plain version of the CUDA kernels' device
    geometry, against the JAX package: the FPN level of ROIs on and around
    the level boundaries (side 112, 224, 448), and the per-axis sample
    positions and weights (1e-5: a division here is a reciprocal multiply
    there); the same sample counts."""
    import jax.numpy as jnp

    from ttdg_mgm_tpu.ops.roi_align import _axis_samples as j_axis
    from ttdg_mgm_tpu.ops.roi_align import assign_fpn_levels as j_levels
    from ttdg_mgm_torch.ops.roi_align import roi_geometry

    rng = np.random.RandomState(P + ratio)
    side = np.array([111.9, 112.0, 112.1, 223.9, 224.0, 224.1, 447.9, 448.0, 448.1, 3.0, 900.0],
                    np.float32)
    edge = np.stack([np.zeros_like(side), np.zeros_like(side), side, side], -1)
    rois = np.concatenate([edge, _compact_rois(rng, 1, 30, lo=2, hi=500)[0],
                           np.array([[5, 5, 5, 5], [10, 10, 9, 300]], np.float32)])
    shapes = [(200, 200), (100, 100), (50, 50), (25, 25)]
    lv, ys, wy, xs, wx, m = roi_geometry(torch.from_numpy(rois), shapes, output_size=P,
                                         sampling_ratio=ratio)
    jl = np.asarray(j_levels(jnp.asarray(rois), min_level=2, max_level=5)) - 2
    np.testing.assert_array_equal(lv.numpy(), jl)
    scale = 1.0 / np.array([4, 8, 16, 32], np.float32)[jl]
    b = rois * scale[:, None] - 0.5
    for lo, hi, pos, w in ((1, 3, ys, wy), (0, 2, xs, wx)):
        jp, jw, jm = j_axis(jnp.asarray(b[:, lo]), jnp.asarray((b[:, hi] - b[:, lo]) / P), P, ratio)
        assert jm == m
        np.testing.assert_allclose(pos.numpy(), np.asarray(jp), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
        np.testing.assert_array_equal((w.numpy() > 0).sum(1), (np.asarray(jw) > 0).sum(1))
