"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file imports
no JAX, so it runs on a machine with PyTorch for CUDA alone (the package
conftest imports JAX; skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances are those of the CPU tests that hold the plain versions against
the JAX package: ROI pool atol 2e-5, rtol 1e-4 (same float32 bilinear
arithmetic, another summation order); its backward atol 3e-4, rtol 1e-3
(the JAX package's bound for its windowed backward; the kernel merges each
pixel's sample weights and sums in ROI order, the plain version adds corner
by corner), and two of its launches equal bit for bit; GA-GM atol
1e-5 with identical 0/1 assignments on planted problems; batched Sinkhorn
atol 1e-5.  The device ROI geometry must pick the plain geometry's levels and
sample counts exactly and place the samples within 1 ulp.  On a random (not
planted) problem one LAP finale step is held in two well-posed parts: the
power step V within 1e-5 of its largest entry (float32 sums of some hundreds
of terms in another order), and the kernel's 0/1 output equal to the plain
exact LAP of the kernel's own V.  The mask paste equals the JAX package's
NumPy paste bit for bit (``chip_smoke.paste_masks_np``, its copy without JAX,
which ``tests/test_torch_eval.py`` holds equal to it).
"""

import numpy as np
import pytest
import torch

from chip_smoke import (VIT_ATTN_SHAPES, paste_boxes, paste_masks_np, vit_attention_errors,
                        vit_attention_inputs, vit_attention_run)
from ttdg_mgm_torch.graph.solvers import _project_blocks, ga_gm
from ttdg_mgm_torch.ops.lap import lap_slots_to_nodes
from ttdg_mgm_torch.ops import _cuda
from ttdg_mgm_torch.ops.gagm import ga_gm_fused, padded_sizes, resident_smem_bytes
from ttdg_mgm_torch.ops.mask_paste import paste_masks
from ttdg_mgm_torch.ops import roi_pool as roi_pool_mod
from ttdg_mgm_torch.ops.roi_align import (multilevel_roi_align, multilevel_roi_align_backward,
                                          roi_footprints, roi_geometry)
from ttdg_mgm_torch.ops.roi_pool import (multilevel_roi_pool, multilevel_roi_pool_backward,
                                         multilevel_roi_pool_train, roi_footprints_device,
                                         roi_geometry_device)
from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched
from ttdg_mgm_torch.ops.vit_attention import VitAttention, vit_attention, vit_attention_plain
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


@pytest.mark.parametrize("ratio", [0, 2])
def test_device_geometry_matches_plain(dev, ratio):
    """The kernels' own geometry (csrc/roi_geometry.cuh) against
    ops/roi_align.py:roi_geometry on the card: compact, elongated,
    degenerate and out-of-range ROIs."""
    rng = np.random.RandomState(15)
    wh = np.exp(rng.uniform(np.log(2.0), np.log(600.0), (400, 2))).astype(np.float32)
    xy = rng.uniform(-60, 800, (400, 2)).astype(np.float32)
    odd = np.array([[2, 3, 250, 18], [-40, -30, -2, -1], [8, 8, 8, 8], [0, 0, 799, 799],
                    [10, 10, 9, 300], [0, 0, 112, 112], [0, 0, 224, 224], [0, 0, 448, 448]],
                   np.float32)
    rois = torch.from_numpy(np.concatenate([np.concatenate([xy, xy + wh], -1), odd])).to(dev)
    shapes = [(200, 200), (100, 100), (50, 50), (25, 25)]
    for P in (7, 14):
        want = roi_geometry(rois, shapes, output_size=P, sampling_ratio=ratio)
        got = roi_geometry_device(rois, len(shapes), output_size=P, sampling_ratio=ratio)
        torch.cuda.synchronize()
        assert got[5] == want[5]
        assert torch.equal(got[0], want[0])
        for k in (2, 4):  # weights: the same sample counts, the same values
            assert torch.equal(got[k], want[k])
        for k in (1, 3):  # positions within 1 ulp
            ulp = torch.abs(want[k]) * 2.0 ** -23 + 1e-30
            assert bool((torch.abs(got[k] - want[k]) <= ulp).all())


def test_gagm_smem_helper_matches_kernel(dev):
    for G, M, univ in [(4, 60, 32), (2, 10, 12), (3, 10, 8), (8, 24, 16), (4, 12, 16)]:
        Mp, _ = padded_sizes(M, univ)
        assert _cuda.lib().ttdg_gagm_smem_bytes(G, Mp, univ) == resident_smem_bytes(G, Mp, univ)


@pytest.mark.parametrize("G,n,univ,ms", [(4, 60, 32, [23, 21, 20, 22]), (3, 20, 12, [20, 9, 15]),
                                         (4, 40, 32, [40, 33, 12, 0])])
def test_gagm_kernel_one_finale_step_on_random_problem(dev, G, n, univ, ms):
    """A random, not planted, problem from a random soft U: one LAP finale
    step (no annealed step)."""
    rng = np.random.RandomState(16)
    T = G * n
    valid = (np.arange(n)[None] < np.asarray(ms)[:, None]).reshape(T)
    A = np.zeros((T, T), np.float32)
    for g in range(G):
        A[g * n:(g + 1) * n, g * n:(g + 1) * n] = rng.rand(n, n) / n
    A *= valid[:, None] & valid[None]
    W = (rng.rand(T, T) / n).astype(np.float32) * (valid[:, None] & valid[None])
    U0 = (rng.rand(T, univ) / univ).astype(np.float32) * valid[:, None]
    args = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev) for x in (A, W, U0)]
    tms = torch.tensor(ms, dtype=torch.int32, device=dev)
    kw = {**GAGM_KW, "mgm_iter": 0}
    got, steps, V = ga_gm_fused(*args, tms, univ, lap_iter_cap=1, return_steps=True,
                                return_power_step=True, **kw)
    assert steps == [0] * (len(steps) - 1) + [1]
    Ad, Wd, Ud = args
    Vp = ((Ad @ ((Ud @ Ud.T) @ Ad)) @ Ud * (kw["quad_weight"] * 2.0) + Wd @ Ud) / G
    rows = torch.from_numpy(valid).to(dev)  # the kernel computes the valid rows only
    np.testing.assert_allclose(V[rows].cpu().numpy(), Vp[rows].cpu().numpy(),
                               atol=1e-5 * float(Vp.abs().max()))
    Vg = V.reshape(G, n, univ)
    assert torch.equal(got, lap_slots_to_nodes(Vg, tms).reshape(T, univ))
    # the plain projection solves each graph in its own orientation: the same
    # optimum up to what float32 duals near the dummy cost of 1000 resolve
    # (6e-5 per slot), and the same assignment wherever the slots are the
    # rows there too (ms > univ)
    plain = _project_blocks(Vg, tms.long(), univ, tau=1.0, sk_iter=0, exact_hungarian=True)
    score_k = (got.reshape(G, n, univ) * Vg).sum((1, 2))
    score_p = (plain * Vg).sum((1, 2))
    np.testing.assert_allclose(score_k.cpu().numpy(), score_p.cpu().numpy(), rtol=1e-6,
                               atol=univ * 1.2e-4)
    for g in range(G):
        if ms[g] > univ:
            assert torch.equal(got.reshape(G, n, univ)[g], plain[g])


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


def _backward_rois(rng, B, K, size):
    """Training-like ROIs on a ``size`` canvas: clustered around two boxes
    per image, then elongated, edge-crossing and zero-size ones."""
    centres = rng.uniform(0.2 * size, 0.8 * size, (B, 2, 2)).astype(np.float32)
    c = centres[:, rng.randint(0, 2, K)] + rng.uniform(-10, 10, (B, K, 2)).astype(np.float32)
    half = rng.uniform(3, 0.2 * size, (B, K, 2)).astype(np.float32)
    rois = np.concatenate([c - half, c + half], -1)
    odd = np.array([[2, 3, size - 6, 18], [4, 2, 20, size - 3], [-30, -12, 40, 50],
                    [size - 40, size - 30, size + 25, size + 9], [40, 40, 40, 40],
                    [30, 30, 30.5, 31]], np.float32)
    rois[:, :len(odd)] = odd
    return torch.from_numpy(rois)


@pytest.mark.parametrize("P,ratio", [(7, 0), (14, 0), (32, 2)])
def test_roi_pool_backward_kernel_matches_plain(dev, P, ratio):
    """Kernel C against its plain version (P=32 stages no cotangent bins:
    the tile reads them from device memory), two launches bit for bit."""
    rng = np.random.RandomState(12)
    sizes = [(64, 64), (32, 32), (16, 16), (8, 8)]
    rois = _backward_rois(rng, 2, 40, 256).to(dev)
    g = torch.from_numpy(rng.randn(2, 40, P, P, 64).astype(np.float32)).to(dev)
    before = multilevel_roi_pool_backward.launches
    got = multilevel_roi_pool_backward(g, sizes, rois, sampling_ratio=ratio)
    again = multilevel_roi_pool_backward(g, sizes, rois, sampling_ratio=ratio)
    want = multilevel_roi_align_backward(g, sizes, rois, sampling_ratio=ratio)
    torch.cuda.synchronize()
    assert multilevel_roi_pool_backward.launches == before + 2
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=3e-4, rtol=1e-3)


def test_roi_pool_backward_padding_rows(dev):
    """Zero boxes with an all-zero cotangent, as pad the mask pool's rows
    (the kernel skips them), among zero boxes and tiny ROIs whose cotangent
    is not zero (it must not): equal to the plain version, bit for bit over
    two launches."""
    rng = np.random.RandomState(19)
    sizes = [(50, 50), (25, 25), (13, 13), (7, 7)]
    rois = _backward_rois(rng, 2, 48, 200)
    rois[:, 24:] = 0.0                        # padding rows
    rois[:, 20:22] = torch.tensor([3.0, 5.0, 3.5, 5.25])  # tiny, live
    g = torch.from_numpy(rng.randn(2, 48, 14, 14, 32).astype(np.float32))
    g[:, 24:] = 0.0
    g[:, 22:24] = 0.0                         # live rows may have a zero cotangent too
    rois[:, 23] = 0.0
    rois, g = rois.to(dev), g.to(dev)
    got = multilevel_roi_pool_backward(g, sizes, rois)
    again = multilevel_roi_pool_backward(g, sizes, rois)
    want = multilevel_roi_align_backward(g, sizes, rois)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), atol=3e-4, rtol=1e-3)


def test_roi_pool_backward_writes_every_element(dev):
    """The bare C entry into level gradients pre-filled with NaN: every
    element is written (zeros where no ROI reaches), equal to the wrapper's
    result.  72 channels: a partial channel chunk."""
    rng = np.random.RandomState(17)
    sizes = [(50, 50), (25, 25), (13, 13), (7, 7)]
    rois = _backward_rois(rng, 3, 24, 200).to(dev)
    g = torch.from_numpy(rng.randn(3, 24, 7, 7, 72).astype(np.float32)).to(dev)
    want = multilevel_roi_pool_backward(g, sizes, rois)
    grads = [torch.full((3, h, w, 72), float("nan"), device=dev) for h, w in sizes]
    args = roi_pool_mod._kernel_args("backward", grads, sizes, rois, 72, 7, (4, 8, 16, 32), 0, 2)
    plan = torch.empty((3 * 24, roi_pool_mod.plan_words(7, 0)), dtype=torch.int32, device=dev)
    err = _cuda.lib().ttdg_roi_pool_backward(*args, plan.data_ptr(), g.data_ptr(),
                                             _cuda.stream_ptr(dev))
    _cuda.check(err, "roi_pool_backward")
    torch.cuda.synchronize()
    for a, b in zip(grads, want):
        assert bool(torch.isfinite(a).all())
        assert torch.equal(a, b)
    assert any(bool((a == 0).any()) for a in grads)  # tiles no ROI reaches


@pytest.mark.parametrize("P,ratio", [(7, 0), (14, 0), (7, 2)])
def test_device_footprints_match_plain(dev, P, ratio):
    """The backward's plan (csrc/roi_pool_backward.cu:roi_plan_kernel)
    against ops/roi_align.py:roi_footprints; its row size as the wrapper
    allocates it."""
    assert _cuda.lib().ttdg_roi_plan_words(P, ratio) == roi_pool_mod.plan_words(P, ratio)
    rng = np.random.RandomState(18)
    rois = _backward_rois(rng, 1, 300, 800)[0].to(dev)
    shapes = [(200, 200), (100, 100), (50, 50), (25, 25)]
    got = roi_footprints_device(rois, shapes, output_size=P, sampling_ratio=ratio)
    want = roi_footprints(rois, shapes, output_size=P, sampling_ratio=ratio)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


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


@pytest.mark.parametrize("shape,dummy_row,max_iter,generic", [
    ((16, 60, 60), True, 20, False), ((16, 60, 60), False, 20, False),
    ((16, 60, 60), True, 7, False), ((16, 60, 32), True, 20, False),
    ((16, 60, 60), True, 20, True), ((4, 100, 70), True, 20, False),
    ((3, 5, 300), False, 9, False)],
    ids=["hippi", "no_dummy_row", "odd_max_iter", "non_square", "hippi_generic_path",
         "larger_than_64", "wide"])
def test_sinkhorn_kernel_matches_plain(dev, shape, dummy_row, max_iter, generic):
    """Kernel D against the plain Sinkhorn: both of its paths (entries in
    registers up to 64 x 64, in shared memory beyond or when asked), with an
    all-masked matrix (nrows 0) and a matrix with no live column among them."""
    N, n1, n2 = shape
    rng = np.random.RandomState(14)
    s = torch.from_numpy(rng.rand(N, n1, n2).astype(np.float32)).to(dev)
    nr_np = rng.randint(0, n1 + 1, N).astype(np.int32)
    nc_np = rng.randint(1, n2 + 1, N).astype(np.int32)
    nr_np[0], nc_np[1] = 0, 0
    nr, nc = torch.from_numpy(nr_np).to(dev), torch.from_numpy(nc_np).to(dev)
    tau = torch.tensor(1 / 200, device=dev)
    before = sinkhorn_batched.launches
    got = sinkhorn_batched(s, nr, nc, tau=tau, max_iter=max_iter, dummy_row=dummy_row,
                           _generic=generic)
    want = sinkhorn(s, nr, nc, tau=tau, max_iter=max_iter, dummy_row=dummy_row)
    torch.cuda.synchronize()
    assert sinkhorn_batched.launches == before + 1
    assert bool(torch.isfinite(got).all())
    assert not bool(got[0].any()) and not bool(got[1].any())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("K,H,W,thr,dtype,inside", [
    (100, 800, 800, 0.5, "float32", True),      # the TTA cell's shape, boxes clamped
    (100, 800, 800, 0.5, "float32", False),
    (100, 800, 800, 0.5, "bfloat16", True),
    (40, 90, 77, 0.3, "float32", False),        # widths that are not multiples of 16
    (40, 64, 1944, 0.9, "float32", False),
    (40, 61, 1944, 0.3, "bfloat16", False),
])
def test_paste_masks_kernel_equals_numpy(dev, K, H, W, thr, dtype, inside):
    """The paste kernel equals ``paste_masks_np`` bit for bit, one launch a
    call, on boxes clamped to the image (as ``postprocess_detections`` clamps
    them) or over its border and thinner than a pixel (``paste_boxes``)."""
    rng = np.random.RandomState(K + H + W)
    m = torch.from_numpy(rng.rand(K, 28, 28).astype(np.float32)).to(dev).to(getattr(torch, dtype))
    b = paste_boxes(rng, K, H, W)
    if inside:
        b[:, 0::2] = b[:, 0::2].clip(0, W)
        b[:, 1::2] = b[:, 1::2].clip(0, H)
    before = paste_masks.launches
    got = paste_masks(m, torch.from_numpy(b).to(dev), H, W, thr)
    torch.cuda.synchronize()
    assert paste_masks.launches == before + 1
    want = paste_masks_np(m.float().cpu().numpy(), b, H, W, thr)
    assert want.sum() > 0
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_paste_masks_kernel_no_boxes(dev):
    """K = 0 launches nothing and gives a ``(0, H, W)`` uint8 tensor."""
    before = paste_masks.launches
    got = paste_masks(torch.zeros((0, 28, 28), device=dev), torch.zeros((0, 4), device=dev),
                      800, 800)
    assert paste_masks.launches == before
    assert got.dtype == torch.uint8 and tuple(got.shape) == (0, 800, 800) and got.is_cuda


@pytest.mark.parametrize("shape", sorted(VIT_ATTN_SHAPES))
def test_vit_attention_kernel_matches_plain(dev, shape):
    """Kernel F against its plain version on the same bf16 inputs, at the
    ViTDet-B cell's shapes: the windowed blocks' (4 x 25 x 12, 196, 64) with
    a 14 x 14 grid and the global blocks' (4 x 12, 4096, 64) with 64 x 64.
    Each output's largest gap over its largest magnitude: the output and
    dq, dk, dv within 2e-2 (the kernel rounds the probabilities and dS to
    bf16 for the tensor cores, 2^-9 each, and its outputs to bf16); the bias
    gradients, summed from the float32 dS, within 1e-2 (dS takes delta =
    dO . o from the bf16-rounded output, 2^-9 of each term).  Two runs give
    the same bits (no atomics), a forward is one launch and a backward two,
    and at the global shape a forward and backward hold under a quarter of
    one float32 score matrix above their inputs (0.38 GB measured: the
    inputs' copies, the outputs and the gradients; dense attention would
    hold 3.2 GB of scores and as much of probabilities)."""
    BH, N, Kh, Kw = VIT_ATTN_SHAPES[shape]
    scale = 64 ** -0.5
    q, k, v, rh, rw, grad = vit_attention_inputs(torch, dev, BH, N, Kh, Kw, seed=3)
    before = VitAttention.launches
    got = vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, scale)
    torch.cuda.synchronize()
    assert VitAttention.launches == before + 3
    again = vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, scale)
    assert all(torch.equal(got[key], again[key]) for key in got)
    assert all(t.dtype == (torch.float32 if key.startswith("drel") else torch.bfloat16)
               for key, t in got.items())
    want = vit_attention_run(torch, vit_attention_plain, q, k, v, rh, rw, grad, scale)
    err = vit_attention_errors(torch, got, want)
    print(f"vit attention {shape} errors: {err}")
    for key, e in err.items():
        assert e <= (1e-2 if key.startswith("drel") else 2e-2), (key, e)
    del want, again
    if N < 1024:
        return
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, scale)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(dev) - base < BH * N * N * 4 / 4


def test_vit_attention_kernel_refuses_what_it_does_not_take(dev):
    """A float32 ``q`` or a head size other than 64 raises before a launch."""
    q, k, v, rh, rw, _ = vit_attention_inputs(torch, dev, 2, 16, 4, 4)
    before = VitAttention.launches
    with pytest.raises(ValueError, match="bfloat16"):
        vit_attention(q.float(), k, v, rh, rw, 0.125)
    with pytest.raises(ValueError, match="head size"):
        vit_attention(q[..., :32], k[..., :32], v[..., :32], rh, rw, 0.125)
    assert VitAttention.launches == before


def test_vit_attention_counters(dev):
    """With the tracer on, a forward and backward through kernel F count its
    launches and the query tokens of each direction, windows (N < 1024) and
    global slices apart: the forward's on the spans open around it, the
    backward's on the span ``vit_attention.backward`` it opens (in
    autograd's device thread)."""
    from ttdg_mgm_torch.utils import profiling

    profiling.drain()
    profiling.enable()
    try:
        with profiling.span("probe"):
            for BH, N, K in ((6, 196, 14), (2, 1024, 32)):
                q, k, v, rh, rw, grad = vit_attention_inputs(torch, dev, BH, N, K, K)
                vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, 0.125)
            torch.cuda.synchronize()
    finally:
        profiling.disable()
    spans = profiling.drain()
    (probe,) = [s for s in spans if s["name"] == "probe"]
    back = [s for s in spans if s["name"] == "vit_attention.backward"]
    assert len(back) == 2
    c = probe["counts"]
    assert c["vit_attention.launches"] == 2
    assert c["vit_attention.tokens.window.forward"] == 6 * 196
    assert c["vit_attention.tokens.global.forward"] == 2 * 1024
    b = {}
    for s in back:
        for key, n in s["counts"].items():
            b[key] = b.get(key, 0) + n
    want = {"vit_attention.launches": 4, "vit_attention.tokens.window.backward": 6 * 196,
            "vit_attention.tokens.global.backward": 2 * 1024}
    assert {key: b.get(key) for key in want} == want
