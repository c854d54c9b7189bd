"""The rest of the port's long tail against the JAX package: the matching
losses (value and autograd gradient within 1e-6 relative of ``jax.grad``),
``gumbel_sinkhorn`` on JAX's own uniforms (1e-5), ``sinkhorn_auto`` (1e-4,
tests/test_sinkhorn.py's tolerance), ``hungarian_scipy`` and ``ilp_solver``
(equal), the KNN hypergraph and ``HyperGraphBlock`` with the flax weights
carried across (1e-5), the mask samplers (``boundary_points`` point for
point and in order against OpenCV's contours, which the JAX package
stacks), ``torch.profiler`` traces, and ``CfgNode.dump`` read back by
PyYAML as the JAX package's dump."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import glob
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ttdg_mgm_tpu import config as jconfig
from ttdg_mgm_tpu.data import node_sampling as jns
from ttdg_mgm_tpu.graph import hypergraph as jhg
from ttdg_mgm_tpu.graph import ilp as jilp
from ttdg_mgm_tpu.graph import losses as jl
from ttdg_mgm_torch import config as tconfig
from ttdg_mgm_torch.checkpoint.bridge import hypergraph_to_torch
from ttdg_mgm_torch.data import node_sampling as tns
from ttdg_mgm_torch.graph import hypergraph as thg
from ttdg_mgm_torch.graph import ilp as tilp
from ttdg_mgm_torch.graph import losses as tl
from ttdg_mgm_torch.ops import lap as tlap
from ttdg_mgm_torch.ops import sinkhorn as tsk
from ttdg_mgm_torch.utils import profiling as tprof
from ttdg_mgm_torch.utils import yaml_lite

# the JAX ops package exports functions under its modules' names
jlap = importlib.import_module("ttdg_mgm_tpu.ops.lap")
jsk = importlib.import_module("ttdg_mgm_tpu.ops.sinkhorn")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-6
GUMBEL_ATOL = 1e-5
SINKHORN_ATOL = 1e-4
HG_ATOL = 1e-5


def _problem(seed, B=3, n1=5, n2=6):
    """Doubly-stochastic-like predictions, 0/1 targets and a validity mask
    with padded rows and columns."""
    rng = np.random.RandomState(seed)
    pred = rng.uniform(0.02, 0.98, (B, n1, n2)).astype(np.float32)
    gt = np.zeros((B, n1, n2), np.float32)
    for b in range(B):
        gt[b, np.arange(n1), rng.permutation(n2)[:n1]] = 1.0
    mask = np.ones((B, n1, n2), bool)
    mask[1, 3:] = False
    mask[2, :, 4:] = False
    return pred, gt, mask


def _hold(jfn, tfn, *args, argnums=(0,)):
    """Value and gradient of ``jfn`` (JAX) and ``tfn`` (autograd) on the
    NumPy ``args``, the gradient with respect to the arguments at
    ``argnums``."""
    want, jgrads = jax.value_and_grad(jfn, argnums=argnums)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    targs = [torch.tensor(a, requires_grad=i in argnums) if isinstance(a, np.ndarray) else a
             for i, a in enumerate(args)]
    got = tfn(*targs)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for i, g in zip(argnums, jgrads):
        g = np.asarray(g)
        np.testing.assert_allclose(targs[i].grad.numpy(), g, rtol=LOSS_RTOL,
                                   atol=LOSS_RTOL * np.abs(g).max())
    return got.item()


@pytest.mark.parametrize("masked", [False, True])
def test_permutation_losses_match_jax(masked):
    pred, gt, mask = _problem(0)
    m = mask if masked else None
    row = mask.any(-1) if masked else None
    _hold(lambda p, t: jl.permutation_loss(p, t, m), lambda p, t: tl.permutation_loss(
        p, t, None if m is None else torch.from_numpy(m)), pred, gt)
    _hold(lambda p, t: jl.cross_entropy_perm_loss(p, t, row),
          lambda p, t: tl.cross_entropy_perm_loss(p, t, None if row is None
                                                  else torch.from_numpy(row)), pred, gt)
    for fn in ("hamming_loss", "inner_product_loss"):
        _hold(lambda p, t: getattr(jl, fn)(p, t, m),
              lambda p, t: getattr(tl, fn)(p, t, None if m is None else torch.from_numpy(m)),
              pred, gt, argnums=(0, 1))
    for gamma in (0.0, 2.0):
        _hold(lambda p, t: jl.focal_perm_loss(p, t, m, gamma=gamma),
              lambda p, t: tl.focal_perm_loss(p, t, None if m is None else torch.from_numpy(m),
                                              gamma=gamma), pred, gt)


def test_displacement_and_offset_loss_match_jax():
    rng = np.random.RandomState(1)
    s = rng.rand(2, 5, 6).astype(np.float32)
    p_src = rng.rand(2, 5, 2).astype(np.float32) * 50
    p_tgt = rng.rand(2, 6, 2).astype(np.float32) * 50
    ns = np.array([5, 3])
    d_gt = rng.rand(2, 5, 2).astype(np.float32)
    norm = np.float32(7.0)

    def jfn(s, a, b):
        d, gm = jl.displacement(s, a, b, ns)
        return jl.offset_loss(d, d_gt, gm, norm=norm)

    def tfn(s, a, b):
        d, gm = tl.displacement(s, a, b, torch.from_numpy(ns))
        return tl.offset_loss(d, torch.from_numpy(d_gt), gm, norm=float(norm))

    _hold(jfn, tfn, s, p_src, p_tgt, argnums=(0, 1, 2))
    d, gm = tl.displacement(torch.from_numpy(s), torch.from_numpy(p_src),
                            torch.from_numpy(p_tgt))
    assert gm is None
    _hold(lambda a: jl.offset_loss(a, d_gt), lambda a: tl.offset_loss(a, torch.from_numpy(d_gt)),
          d.numpy())


@pytest.mark.parametrize("shape,ns", [((3, 5, 6), ([5, 4, 5], [6, 6, 3])),
                                      ((2, 6, 4), None), ((5, 5), None)])
def test_ilp_attention_loss_matches_jax(shape, ns):
    """The discretisation (the exact LAP of ``p + 1``, in either
    orientation) enters as data."""
    rng = np.random.RandomState(2)
    pred = rng.uniform(0.02, 0.98, shape).astype(np.float32)
    gt = (rng.rand(*shape) < 0.2).astype(np.float32)
    src, tgt = (None, None) if ns is None else (np.asarray(ns[0]), np.asarray(ns[1]))
    _hold(lambda p: jl.ilp_attention_loss(p, gt, src, tgt),
          lambda p: tl.ilp_attention_loss(p, torch.from_numpy(gt),
                                          None if src is None else torch.from_numpy(src),
                                          None if tgt is None else torch.from_numpy(tgt)),
          pred)


def test_concat_matrix_matches_jax():
    rng = np.random.RandomState(3)
    mats = rng.rand(3, 4, 4).astype(np.float32)
    idx = [(1, 0), (2, 0), (2, 1)]
    w = rng.rand(12, 12).astype(np.float32)
    _hold(lambda m: jnp.sum(jl.concat_matrix(m, idx, 3) * w),
          lambda m: (tl.concat_matrix(m, idx, 3) * torch.from_numpy(w)).sum(), mats)
    np.testing.assert_array_equal(tl.concat_matrix(torch.from_numpy(mats), idx, 3).numpy(),
                                  np.asarray(jl.concat_matrix(mats, idx, 3)))


@pytest.mark.parametrize("dummy_row,counts", [(False, None), (True, ([3, 5], [5, 5]))])
def test_gumbel_sinkhorn_on_jax_uniforms(dummy_row, counts):
    """The uniforms the JAX function draws (``jax.random.uniform`` over
    ``split(key, sample_num)``), computed here and given to the port."""
    rng = np.random.RandomState(4)
    s = rng.randn(2, 5, 5).astype(np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(tau=0.3, max_iter=12, sample_num=4, dummy_row=dummy_row)
    nr, nc = (None, None) if counts is None else (np.asarray(counts[0]), np.asarray(counts[1]))
    want = np.asarray(jsk.gumbel_sinkhorn(jnp.asarray(s), key, nr, nc, **kw))
    u = np.stack([np.asarray(jax.random.uniform(k, s.shape))
                  for k in jax.random.split(key, kw["sample_num"])])
    got = tsk.gumbel_sinkhorn(torch.from_numpy(s), torch.from_numpy(u),
                              None if nr is None else torch.from_numpy(nr),
                              None if nc is None else torch.from_numpy(nc), **kw)
    assert got.shape == (4, 2, 5, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=GUMBEL_ATOL)
    gen = torch.Generator().manual_seed(0)
    drawn = tsk.gumbel_sinkhorn(torch.from_numpy(s), generator=gen, **kw)
    assert drawn.shape == (4, 2, 5, 5) and torch.isfinite(drawn).all()
    with pytest.raises(ValueError, match="uniforms or a generator"):
        tsk.gumbel_sinkhorn(torch.from_numpy(s), **kw)


def test_sinkhorn_auto_matches_jax():
    """Mixed orientations in one batch: more valid rows than columns,
    fewer, and square."""
    rng = np.random.RandomState(5)
    s = rng.randn(4, 7, 7).astype(np.float32)
    nr, nc = np.array([7, 3, 6, 5]), np.array([4, 7, 6, 5])
    want = np.asarray(jsk.sinkhorn_auto(jnp.asarray(s), nr, nc, tau=0.2, max_iter=15))
    got = tsk.sinkhorn_auto(torch.from_numpy(s), torch.from_numpy(nr), torch.from_numpy(nc),
                            tau=0.2, max_iter=15)
    np.testing.assert_allclose(got.numpy(), want, atol=SINKHORN_ATOL)
    with pytest.raises(ValueError, match="square"):
        tsk.sinkhorn_auto(torch.zeros(2, 3, 4))


def test_hungarian_scipy_and_ilp_match_jax():
    rng = np.random.RandomState(6)
    s = rng.rand(3, 5, 7).astype(np.float32)
    n1, n2 = np.array([5, 3, 4]), np.array([7, 6, 2])
    np.testing.assert_array_equal(tlap.hungarian_scipy(s, n1, n2), jlap.hungarian_scipy(s, n1, n2))
    np.testing.assert_array_equal(tlap.hungarian_scipy(s[0]), jlap.hungarian_scipy(s[0]))
    for args in ((s[1],), (s[1], 4, 5), (s[2].T, 6, 3)):
        for maximize in (True, False):
            np.testing.assert_array_equal(tilp.ilp_solver(*args, maximize=maximize),
                                          jilp.ilp_solver(*args, maximize=maximize))


def test_hypergraph_matches_jax():
    """The Laplacian (with distance ties among the nodes) and the block at
    the cross-domain head's node count, with the flax weights carried
    across; the dropout path draws from its generator."""
    rng = np.random.RandomState(8)
    x = rng.randn(62, 32).astype(np.float32)
    x[5] = x[9]  # a distance tie
    for k, prob in ((10, True), (4, False), (80, True)):
        want = np.asarray(jhg.knn_hypergraph_laplacian(jnp.asarray(x), k, prob=prob))
        got = thg.knn_hypergraph_laplacian(torch.from_numpy(x), k, prob=prob).numpy()
        np.testing.assert_allclose(got, want, atol=HG_ATOL)
    jblock = jhg.HyperGraphBlock(hidden=48, k_neig=10, dropout=0.5)
    params = jblock.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))
    tblock = thg.HyperGraphBlock(32, hidden=48, k_neig=10, dropout=0.5)
    tblock.load_state_dict(hypergraph_to_torch(jax.tree.map(np.asarray, params)))
    got = tblock(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=HG_ATOL)
    gen = torch.Generator().manual_seed(0)
    out = tblock(torch.from_numpy(x), deterministic=False, generator=gen)
    assert torch.isfinite(out).all() and not np.allclose(out.detach().numpy(), got)
    with pytest.raises(ValueError, match="generator"):
        tblock(torch.from_numpy(x), deterministic=False)


def _masks():
    """Disks, a ring with a hole (and a blob inside the hole), several
    components, single pixels, lines, masks on the frame, random noise."""
    yy, xx = np.mgrid[:40, :50]
    d = (yy - 20) ** 2 + (xx - 25) ** 2
    out = {"disk": d < 120, "ring": (d < 200) & (d >= 60),
           "ring_blob": ((d < 200) & (d >= 60)) | (d < 9), "empty": np.zeros((40, 50), bool)}
    comps = np.zeros((40, 50), bool)
    comps[2:6, 3:9] = comps[30:37, 40:48] = comps[10, 20] = comps[25:27, 5] = True
    out["components"] = comps
    line = np.zeros((40, 50), bool)
    line[12, 3:45] = True
    line[np.arange(5, 35), np.arange(5, 35)] = True
    out["lines"] = line
    frame = np.zeros((40, 50), bool)
    frame[0, :] = frame[:, 0] = frame[-1, 10:20] = frame[15:25, -1] = True
    out["frame"] = frame
    out["full"] = np.ones((7, 9), bool)
    out["pixel"] = np.zeros((5, 5), bool)
    out["pixel"][4, 4] = True
    rng = np.random.RandomState(9)
    for i, p in enumerate((0.3, 0.55, 0.8)):
        out[f"noise{i}"] = rng.rand(30, 33) < p
    return out


@pytest.mark.parametrize("name", list(_masks()))
def test_boundary_points_match_jax(name):
    mask = _masks()[name]
    want = jns.boundary_points(mask)
    got = tns.boundary_points(mask)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    for kw in (dict(num_samples=10), dict(num_samples=7, inward_offset=2.5)):
        assert tns.sample_boundary(mask, **kw) == jns.sample_boundary(mask, **kw)
    rt, rj = np.random.default_rng(3), np.random.default_rng(3)
    assert (tns.sample_boundary(mask, 5, uniform=False, rng=rt)
            == jns.sample_boundary(mask, 5, uniform=False, rng=rj))
    assert tns.sample_grid(mask, 6) == jns.sample_grid(mask, 6)
    assert (tns.sample_centroid_ring(mask, 8, radius=6.0)
            == jns.sample_centroid_ring(mask, 8, radius=6.0))


def test_sample_polygon_instances_match_jax():
    polys = [[[5.0, 5.0, 30.0, 6.0, 28.0, 25.0, 7.0, 22.0]],
             [[35.0, 2.0, 48.0, 2.0, 48.0, 15.0], [40.0, 20.0, 46.0, 20.0, 43.0, 30.0]]]
    assert (tns.sample_polygon_instances(polys, 40, 50, num_boundary=6, num_centroid=4)
            == jns.sample_polygon_instances(polys, 40, 50, num_boundary=6, num_centroid=4))


def test_profiling_trace_writes_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)):
        with tprof.annotate("ttdg_region"):
            torch.ones(8).sum()
    (path,) = glob.glob(str(tmp_path / "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "ttdg_region" for e in events)


@pytest.mark.parametrize("path", [None] + sorted(glob.glob(os.path.join(REPO, "configs",
                                                                          "*.yaml"))),
                         ids=lambda p: "defaults" if p is None else os.path.basename(p))
def test_cfg_dump_reads_back_as_jax(path):
    tcfg = tconfig.setup_cfg(path) if path else tconfig.get_cfg()
    jcfg = jconfig.setup_cfg(path) if path else jconfig.get_cfg()
    text = tcfg.dump()
    assert yaml.safe_load(text) == yaml.safe_load(jcfg.dump())
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)


def test_yaml_dump_scalars_read_back():
    """Strings that would resolve to other types, escapes, floats in PyYAML's
    form, nested and empty collections."""
    data = {"a": "1e-4", "b": "yes", "c": "x: y", "d": [[1, 2], [3]], "e": 1e-5, "f": 1e17,
            "g": "é\n ", "h": [], "i": {}, "j": [{"k": "v"}], "l": None, "m": float("inf"),
            "n": "-x", "o": "2024-01-31", "p": "", "q": -0.0, "r": "ünï\U0001f600"}
    text = yaml_lite.safe_dump(data)
    assert yaml.safe_load(text) == data
    assert yaml_lite.safe_load(text) == data
    assert "e: 1.0e-05" in text and "f: 1.0e+17" in text
