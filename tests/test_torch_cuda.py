"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
no JAX, so it runs on a machine with PyTorch for CUDA alone (the package
conftest imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of the CPU tests that hold the plain versions against
the JAX package: ROI pool atol 2e-5, rtol 1e-4 (same float32 bilinear
arithmetic, another summation order); its backward atol 3e-4, rtol 1e-3
(float32 atomics add in an order that changes from run to run); GA-GM atol
1e-5 with identical 0/1 assignments on planted problems; batched Sinkhorn
atol 1e-5.
"""

import numpy as np
import pytest
import torch

from ttdg_mgm_torch.graph.solvers import ga_gm
from ttdg_mgm_torch.ops.gagm import ga_gm_fused
from ttdg_mgm_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_backward
from ttdg_mgm_torch.ops.roi_pool import (multilevel_roi_pool, multilevel_roi_pool_backward,
                                         multilevel_roi_pool_train)
from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched
from ttdg_mgm_torch.synth import planted_matching_problem

pytestmark = pytest.mark.cuda

GAGM_KW = dict(quad_weight=0.5, mgm_iter=40, sk_iter=20, sk_tau0=0.1, sk_gamma=0.5,
               min_tau=1e-2, tol=1e-3)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def test_roi_pool_kernel_matches_plain(dev):
    rng = np.random.RandomState(11)
    sizes = [(64, 64), (32, 32), (16, 16), (8, 8)]
    feats = [torch.from_numpy(rng.randn(2, h, w, 64).astype(np.float32)).to(dev)
             for h, w in sizes]
    wh = rng.uniform(8, 120, (2, 30, 2)).astype(np.float32)
    xy = rng.uniform(-4, 250, (2, 30, 2)).astype(np.float32)
    odd = np.array([[2, 3, 250, 18], [-40, -30, -2, -1], [8, 8, 8, 8], [0, 0, 255, 255]],
                   np.float32)
    rois = np.concatenate([np.concatenate([xy, xy + wh], -1),
                           np.broadcast_to(odd, (2, 4, 4))], axis=1)
    tr = torch.from_numpy(np.ascontiguousarray(rois)).to(dev)
    for P in (7, 14):
        before = multilevel_roi_pool.launches
        got = multilevel_roi_pool(feats, tr, output_size=P)
        want = multilevel_roi_align(feats, tr, output_size=P)
        torch.cuda.synchronize()
        assert multilevel_roi_pool.launches == before + 1
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("G,n,univ,ms", [(4, 12, 16, [12, 9, 11, 5]), (2, 10, 12, [10, 7]),
                                         (3, 10, 8, [10, 9, 10]), (4, 60, 32, [60, 52, 30, 45])])
def test_gagm_kernel_matches_plain(dev, G, n, univ, ms):
    A, W, U0, ms, _ = planted_matching_problem(G, n, univ, ms, seed=7)
    args = [torch.from_numpy(x).to(dev) for x in (A, W, U0, ms)]
    before = ga_gm_fused.launches
    got = ga_gm_fused(*args, univ, lap_iter_cap=40, **GAGM_KW)
    want = ga_gm(*args, univ, hung_iter_cap=40, **GAGM_KW)
    torch.cuda.synchronize()
    assert ga_gm_fused.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)


def test_roi_pool_backward_kernel_matches_plain(dev):
    rng = np.random.RandomState(12)
    sizes = [(64, 64), (32, 32), (16, 16), (8, 8)]
    # ROIs clustered around two boxes per image, as sampled training ROIs are
    centres = rng.uniform(40, 200, (2, 2, 2)).astype(np.float32)
    c = centres[:, rng.randint(0, 2, 40)] + rng.uniform(-10, 10, (2, 40, 2)).astype(np.float32)
    half = rng.uniform(6, 50, (2, 40, 2)).astype(np.float32)
    rois = torch.from_numpy(np.concatenate([c - half, c + half], -1)).to(dev)
    for P in (7, 14):
        g = torch.from_numpy(rng.randn(2, 40, P, P, 64).astype(np.float32)).to(dev)
        before = multilevel_roi_pool_backward.launches
        got = multilevel_roi_pool_backward(g, sizes, rois)
        want = multilevel_roi_align_backward(g, sizes, rois)
        torch.cuda.synchronize()
        assert multilevel_roi_pool_backward.launches == before + 1
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=3e-4, rtol=1e-3)


def test_train_pool_autograd_launches_both_kernels(dev):
    rng = np.random.RandomState(13)
    sizes = [(32, 32), (16, 16), (8, 8), (4, 4)]
    feats = [torch.from_numpy(rng.randn(1, h, w, 32).astype(np.float32)).to(dev).requires_grad_()
             for h, w in sizes]
    rois = torch.tensor([[[4.0, 6.0, 60.0, 50.0], [10.0, 10.0, 100.0, 120.0]]], device=dev)
    fwd, bwd = multilevel_roi_pool.launches, multilevel_roi_pool_backward.launches
    out = multilevel_roi_pool_train(feats, rois, output_size=7)
    out.square().sum().backward()
    torch.cuda.synchronize()
    assert (multilevel_roi_pool.launches, multilevel_roi_pool_backward.launches) == (fwd + 1,
                                                                                     bwd + 1)
    want = multilevel_roi_align_backward(2 * out.detach(), sizes, rois)
    for f, w in zip(feats, want):
        np.testing.assert_allclose(f.grad.cpu().numpy(), w.cpu().numpy(), atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("dummy_row", [True, False])
def test_sinkhorn_kernel_matches_plain(dev, dummy_row):
    rng = np.random.RandomState(14)
    s = torch.from_numpy(rng.rand(16, 60, 60).astype(np.float32)).to(dev)
    nr = torch.from_numpy(rng.randint(0, 61, 16).astype(np.int32)).to(dev)
    nc = torch.from_numpy(rng.randint(1, 61, 16).astype(np.int32)).to(dev)
    tau = torch.tensor(1 / 200, device=dev)
    before = sinkhorn_batched.launches
    got = sinkhorn_batched(s, nr, nc, tau=tau, max_iter=20, dummy_row=dummy_row)
    want = sinkhorn(s, nr, nc, tau=tau, max_iter=20, dummy_row=dummy_row)
    torch.cuda.synchronize()
    assert sinkhorn_batched.launches == before + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)
