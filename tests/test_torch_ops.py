"""Port ops against the JAX package on the CPU: boxes, NMS keep masks,
Sinkhorn (forward and gradient) and the JV LAP.

Inputs come from NumPy seeds and go through both frameworks as float32.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.ops import boxes as jboxes
from ttdg_mgm_tpu.ops import lap as jlap
from ttdg_mgm_tpu.ops import nms as jnms
from ttdg_mgm_tpu.ops.sinkhorn import sinkhorn_project as j_sinkhorn_project
from ttdg_mgm_torch.ops import boxes as tboxes
from ttdg_mgm_torch.ops import lap as tlap
from ttdg_mgm_torch.ops import nms as tnms
from ttdg_mgm_torch.ops import sinkhorn as tsk


def _rand_boxes(rng, n, scale=100.0):
    xy = rng.uniform(0, scale, (n, 2)).astype(np.float32)
    wh = rng.uniform(1, scale / 2, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def test_box_arithmetic():
    """Elementwise float32 formulas: equal to 1e-6 relative (same ops, the
    two frameworks' exp/log may differ in the last ulp)."""
    rng = np.random.RandomState(0)
    a, b = _rand_boxes(rng, 30), _rand_boxes(rng, 20)
    d = (rng.randn(30, 4) * 0.5).astype(np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(tboxes.box_area(t(a)).numpy(), np.asarray(jboxes.box_area(a)),
                               rtol=1e-6)
    np.testing.assert_allclose(tboxes.pairwise_iou(t(a), t(b)).numpy(),
                               np.asarray(jboxes.pairwise_iou(a, b)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tboxes.clip_boxes(t(a), 60.0, 80.0).numpy(),
                               np.asarray(jboxes.clip_boxes(a, 60.0, 80.0)))
    w = (10.0, 10.0, 5.0, 5.0)
    np.testing.assert_allclose(tboxes.encode_boxes(t(a), t(a[::-1].copy()), w).numpy(),
                               np.asarray(jboxes.encode_boxes(a, a[::-1], w)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tboxes.decode_boxes(t(d), t(a), w).numpy(),
                               np.asarray(jboxes.decode_boxes(d, a, w)), rtol=1e-6, atol=1e-4)
    cell_t = tboxes.cell_anchors((32,), (0.5, 1.0, 2.0))
    cell_j = jboxes.cell_anchors((32,), (0.5, 1.0, 2.0))
    np.testing.assert_allclose(cell_t.numpy(), np.asarray(cell_j), rtol=1e-6)
    np.testing.assert_allclose(tboxes.grid_anchors(5, 7, 8, cell_t).numpy(),
                               np.asarray(jboxes.grid_anchors(5, 7, 8, cell_j)), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_keep_masks_identical(seed):
    """Keep masks must be identical, ties included (duplicate scores)."""
    rng = np.random.RandomState(seed)
    n = 60
    b = _rand_boxes(rng, n, scale=60.0)
    s = rng.rand(n).astype(np.float32)
    s[10:20] = s[0]  # score ties break towards the lower index
    v = rng.rand(n) > 0.1
    cls = rng.randint(0, 3, n)
    for thr in (0.3, 0.5, 0.7):
        want = np.asarray(jnms.nms_mask(b, s, v, iou_threshold=thr))
        got = tnms.nms_mask(torch.from_numpy(b), torch.from_numpy(s),
                            torch.from_numpy(v), iou_threshold=thr).numpy()
        np.testing.assert_array_equal(got, want)
        want = np.asarray(jnms.batched_nms_mask(b, s, cls, v, iou_threshold=thr))
        got = tnms.batched_nms_mask(torch.from_numpy(b), torch.from_numpy(s),
                                    torch.from_numpy(cls), torch.from_numpy(v),
                                    iou_threshold=thr).numpy()
        np.testing.assert_array_equal(got, want)
    keep = rng.rand(n) > 0.5
    jb, js, ji, jv = jnms.topk_after_nms(b, s, keep, 16)
    tb, ts, ti, tv = tnms.topk_after_nms(torch.from_numpy(b), torch.from_numpy(s),
                                         torch.from_numpy(keep), 16)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))


def test_sinkhorn_project_forward_and_grad():
    """Forward and gradient of the differentiable projection, both
    orientations and ragged counts: atol 1e-5 (tests/test_pallas.py's
    Sinkhorn tolerance)."""
    rng = np.random.RandomState(3)
    s = (rng.randn(3, 2, 9, 7) * 0.3).astype(np.float32)
    nr = np.array([[9, 4], [6, 7], [2, 9]], np.int32)
    nc = np.array([[7, 7], [3, 5], [7, 1]], np.int32)
    cot = rng.randn(3, 2, 9, 7).astype(np.float32)

    def jf(x):
        return jnp.sum(j_sinkhorn_project(x, nr, nc, tau=0.05, max_iter=20) * cot)

    jv, jg = jax.value_and_grad(jf)(jnp.asarray(s))
    ts = torch.from_numpy(s).requires_grad_(True)
    out = tsk.sinkhorn_project(ts, torch.from_numpy(nr), torch.from_numpy(nc), tau=0.05,
                               max_iter=20)
    want = np.asarray(j_sinkhorn_project(jnp.asarray(s), nr, nc, tau=0.05, max_iter=20))
    np.testing.assert_allclose(out.detach().numpy(), want, atol=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), atol=1e-5)


@pytest.mark.parametrize("shape,n1,n2", [((6, 6), 6, 6), ((8, 10), 5, 9), ((12, 7), 12, 7)])
def test_lap_identical_assignments(shape, n1, n2):
    """Exact JV: identical 0/1 assignments, including orientation-auto
    (n1 > n2) and integer-valued scores full of ties."""
    rng = np.random.RandomState(sum(shape) + n1)
    for scores in (rng.randn(4, *shape).astype(np.float32),
                   rng.randint(0, 3, (4, *shape)).astype(np.float32)):
        want = np.asarray(jlap.hungarian_auto(scores, np.full(4, n1), np.full(4, n2)))
        got = tlap.hungarian_auto(torch.from_numpy(scores), torch.full((4,), n1),
                                  torch.full((4,), n2)).numpy()
        np.testing.assert_array_equal(got, want)
        if n1 <= n2:
            want = np.asarray(jlap.hungarian(scores, n1, n2))
            got = tlap.hungarian(torch.from_numpy(scores), n1, n2).numpy()
            np.testing.assert_array_equal(got, want)
