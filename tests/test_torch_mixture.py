"""MGM-Mixture (the multi-cluster GA-GM) against the JAX package:
``ga_gm_mixture`` on the two-cluster problem of tests/test_mixture.py's
own mixture test (and, the port alone, on both seeds against the planted
answer), its graph affinity, ``MGM3Unsup(num_clusters=2)`` with the JAX module's
weights carried across, and spectral clustering on random symmetric
affinities.

Clusters are compared as partitions (``c[:, None] == c[None, :]``): the
sign of an eigenvector is arbitrary, so the 2-cluster labels may come out
swapped, and every consumer compares labels only with each other.  U is
held within atol 1e-5 with identical 0/1 assignments, as
tests/test_torch_gagm.py holds the single-cluster solver; the affinity
within 1e-5; the loss within rtol 1e-5.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_mixture import two_cluster_problem
from ttdg_mgm_tpu.graph import solvers as j_solvers
from ttdg_mgm_tpu.graph.mgm import MGM3Unsup as JMGM3Unsup
from ttdg_mgm_tpu.graph.solvers import _cluster_affinity as j_affinity
from ttdg_mgm_tpu.graph.solvers import _mutual_argmax as j_mutual_argmax
from ttdg_mgm_tpu.graph.solvers import ga_gm_mixture as j_mixture
from ttdg_mgm_tpu.graph.spectral import spectral_clustering as j_spectral
from ttdg_mgm_torch.checkpoint.bridge import _affinity_block, _mha_block
from ttdg_mgm_torch.graph.mgm import MGM3Unsup
from ttdg_mgm_torch.graph.solvers import _cluster_affinity, _mutual_argmax, ga_gm_mixture
from ttdg_mgm_torch.graph.spectral import spectral_clustering
from ttdg_mgm_torch.ops.gagm import ga_gm_fused

U_ATOL = 1e-5
ALPHA_ATOL = 1e-5
LOSS_RTOL = 1e-5


def _same_partition(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.array_equal(a[:, None] == a[None, :], b[:, None] == b[None, :])


def _t(x):
    return torch.from_numpy(np.array(x))


def test_mixture_matches_jax(seed=0):
    """On the two-cluster problem of JAX's own mixture test (seed 0)."""
    W, Ugt, ms = two_cluster_problem(seed=seed)
    G, M, univ = Ugt.shape
    T = G * M
    A = np.zeros((T, T), np.float32)
    U0 = (Ugt.reshape(T, univ) + 0.2).astype(np.float32)
    ju, jc = j_mixture(jnp.asarray(A), W, jnp.asarray(U0), ms, univ, 2, quad_weight=0.5)
    before = ga_gm_fused.launches
    tu, tc, trace = ga_gm_mixture(_t(A), _t(W), _t(U0), _t(ms), univ, 2, quad_weight=0.5)
    assert ga_gm_fused.launches == before  # the plain rounds on CPU tensors
    assert _same_partition(tc.numpy(), jc)
    c = tc.numpy()
    assert len(set(c[:3])) == 1 and len(set(c[3:])) == 1 and c[0] != c[3]
    assert tc.dtype == torch.int32 and set(np.unique(tu.numpy())) <= {0.0, 1.0}
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=U_ATOL)
    # each pass: annealed rounds, then a finale of 0 steps
    assert len(trace["steps"]) == 2 and all(s[-1] == 0 for s in trace["steps"])
    want_alpha = j_affinity(jnp.asarray(A), W, jnp.asarray(trace["projected"][0].numpy()), ms,
                            G, M)
    np.testing.assert_allclose(trace["alpha"].numpy(), np.asarray(want_alpha), atol=ALPHA_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_mixture_recovers_planted_matching(seed):
    """The port's mixture on the two-cluster problems: the planted
    partition, and within each cluster the planted pairwise matchings
    ``U_i U_j^T`` (the universe's labels are arbitrary)."""
    W, Ugt, ms = two_cluster_problem(seed=seed)
    G, M, univ = Ugt.shape
    T = G * M
    U0 = (Ugt.reshape(T, univ) + 0.2).astype(np.float32)
    tu, tc, _ = ga_gm_mixture(torch.zeros(T, T), _t(W), _t(U0), _t(ms), univ, 2,
                              quad_weight=0.5)
    assert _same_partition(tc.numpy(), [0, 0, 0, 1, 1, 1])
    Ug = tu.numpy().reshape(G, M, univ)
    for grp in (range(3), range(3, 6)):
        for i in grp:
            for j in grp:
                np.testing.assert_array_equal(Ug[i] @ Ug[j].T, Ugt[i] @ Ugt[j].T)


@pytest.mark.parametrize("seed", [0, 1])
def test_cluster_affinity_matches_jax(seed):
    """On the planted assignment, with a nonzero adjacency and both
    quadratic weights."""
    W, Ugt, ms = two_cluster_problem(seed=seed)
    G, M, univ = Ugt.shape
    T = G * M
    rng = np.random.RandomState(seed)
    A = np.kron(np.eye(G), np.ones((M, M))) * rng.rand(T, T)
    A = ((A + A.T) / 2).astype(np.float32)
    U = Ugt.reshape(T, univ).astype(np.float32)
    for qw, scale in ((1.0, 1.0), (0.5, 3.0)):
        want = np.asarray(j_affinity(jnp.asarray(A), W, jnp.asarray(U), ms, G, M,
                                     quad_weight=qw, scale=scale))
        got = _cluster_affinity(_t(A), _t(W), _t(U), _t(ms), G, M, quad_weight=qw,
                                scale=scale).numpy()
        assert got.shape == (G, G) and np.all(np.diag(got) == 0.0)
        np.testing.assert_allclose(got, want, atol=ALPHA_ATOL)
        assert got[0, 1] > got[0, 4]


def test_mutual_argmax_matches_jax():
    rng = np.random.RandomState(0)
    X = rng.rand(3, 6, 8).astype(np.float32)
    X[1, 2] = 0.0  # a row with no positive entry
    X[2, :, 3] = X[2, :, 4]  # ties break towards the lower index
    want = np.asarray(j_mutual_argmax(jnp.asarray(X), None, 8))
    np.testing.assert_array_equal(_mutual_argmax(_t(X)).numpy(), want)


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("normalized", [False, True])
def test_spectral_clustering_partition_matches_jax(k, normalized):
    """Random symmetric affinities, zero diagonal, with ``k`` planted blocks
    and without."""
    for seed in range(6):
        rng = np.random.RandomState(seed)
        n = rng.randint(4, 10)
        sim = rng.rand(n, n)
        if seed % 2:
            lab = rng.randint(0, k, n)
            sim = sim + 3.0 * (lab[:, None] == lab[None, :])
        sim = ((sim + sim.T) / 2 * (1 - np.eye(n))).astype(np.float32)
        want = np.asarray(j_spectral(jnp.asarray(sim), k, normalized=normalized))
        got = spectral_clustering(_t(sim), k, normalized=normalized)
        assert got.dtype == torch.int32 and got.shape == (n,)
        assert _same_partition(got.numpy(), want), (seed, got.numpy(), want)


def _groups_problem(G=4, M=6, D=16, seed=0):
    """Two groups of graphs whose nodes are noisy copies of their group's
    own prototypes, in shuffled order; the universe holds both groups'
    prototypes."""
    rng = np.random.RandomState(seed)
    protos = rng.randn(2, M, D).astype(np.float32)
    nodes = np.zeros((G, M, D), np.float32)
    for g in range(G):
        nodes[g] = protos[g % 2][rng.permutation(M)] + 0.05 * rng.randn(M, D)
    mask = np.ones((G, M), bool)
    labels = np.where(mask, (np.arange(M)[None] % 2) + 1, 0)
    return nodes, labels, mask, 3.0 * protos.reshape(2 * M, D)


def _l1_affinity(aff, D, scale):
    """The affinity's weights set to score ``-scale * |x - y|_1`` (identity
    projections; the first layer's units ``relu(x - y)`` and ``relu(y -
    x)``): a problem whose matching is well posed, where the random
    initial affinity leaves every Sinkhorn block flat and the discrete
    rounding chaotic."""
    hidden = aff["fc0_x"]["kernel"].shape[1]
    eye = np.eye(D, dtype=np.float32)
    aff["project_sr"]["kernel"] = eye.copy()
    aff["project_tg"]["kernel"] = eye.copy()
    kx = np.zeros((D, hidden), np.float32)
    kx[:, :D], kx[:, D:2 * D] = eye, -eye
    aff["fc0_x"]["kernel"], aff["fc0_y"]["kernel"] = kx, -kx
    aff["fc0_x"]["bias"] = np.zeros(hidden, np.float32)
    k1 = np.zeros((hidden, 1), np.float32)
    k1[:2 * D] = -scale
    aff["fc1"]["kernel"], aff["fc1"]["bias"] = k1, np.zeros(1, np.float32)


def _jax_params(jmod, seed, nodes, labels, mask, U):
    """Seeded NumPy weights on the JAX module's parameter tree (its shapes
    by ``jax.eval_shape``, so the init's forward never runs): layer-norm
    scales 1, every other leaf normal with std 0.2."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), nodes, labels, mask, U)["params"]
    return jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones(s.shape, np.float32) if path[-1].key == "scale"
                         else (0.2 * rng.randn(*s.shape)).astype(np.float32)), shapes)


@pytest.mark.parametrize("seed,scale", [(2, 0.01)])
def test_mgm3_with_clusters_matches_jax(seed, scale, monkeypatch):
    """``MGM3Unsup(num_clusters=2)`` on tests/test_mixture.py's smoke shape
    (4 graphs of 6 nodes, width 16), the JAX module's weights carried
    across (the attention seeded, the affinity :func:`_l1_affinity`): the
    partition, U and the affinity of the JAX solve on the port's problem,
    and the JAX module's loss."""
    nodes, labels, mask, U = _groups_problem(seed=seed)
    G, M, D = nodes.shape
    univ = U.shape[0]
    jmod = JMGM3Unsup(num_classes=2, univ_size=univ, dim=D, num_clusters=2)
    params = _jax_params(jmod, seed, nodes, labels, mask, U)
    _l1_affinity(params["node_affinity"], D, scale)
    sd = {}
    _mha_block(params["intra_domain_graph"], "intra_domain_graph", sd)
    _affinity_block(params["node_affinity"], "node_affinity", sd)
    tmod = MGM3Unsup(num_classes=2, univ_size=univ, dim=D, num_clusters=2)
    tmod.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()})
    tmod.eval()

    solves = []

    def record(*args, **kw):  # the JAX module's own solve, inputs and outputs
        out = j_mixture(*args, **kw)
        solves.append((args, kw, out))
        return out

    monkeypatch.setattr(j_solvers, "ga_gm_mixture", record)
    want = float(jmod.apply({"params": params}, nodes, labels, mask, U))
    got = tmod(_t(nodes), _t(labels), _t(mask), _t(U))
    assert got.requires_grad and want > 1e-3
    np.testing.assert_allclose(got.item(), want, rtol=LOSS_RTOL)
    assert len(tmod.last_clusters) == G and len(tmod.last_solver_steps) == 2
    ((jargs, jkw, (ju, jc)),) = solves
    assert _same_partition(tmod.last_clusters, jc)
    # the port's solve on the JAX module's problem
    A, Wds, U0, ms = (_t(x) for x in jargs[:4])
    assert jargs[4:] == (univ, 2) and jkw["quad_weight"] == 0.5
    tu, tc, trace = ga_gm_mixture(A, Wds, U0, ms, univ, 2, quad_weight=0.5)
    assert _same_partition(tc.numpy(), jc)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=U_ATOL)
    assert trace["annealed"][0].max() > 0.9  # a sharp annealed solution
    want_alpha = j_affinity(jnp.asarray(A.numpy()), jnp.asarray(Wds.numpy()),
                            jnp.asarray(trace["projected"][0].numpy()), jnp.asarray(ms.numpy()),
                            G, M)
    np.testing.assert_allclose(trace["alpha"].numpy(), np.asarray(want_alpha), atol=ALPHA_ATOL)


def test_single_cluster_path_unchanged():
    """``num_clusters=1`` (the default) solves with the single-cluster
    GA-GM: no clusters recorded, one list of steps."""
    nodes, labels, mask, U = _groups_problem(seed=2)
    torch.manual_seed(0)
    mod = MGM3Unsup(num_classes=2, univ_size=U.shape[0], dim=nodes.shape[-1])
    loss = mod(_t(nodes), _t(labels), _t(mask), _t(U))
    assert torch.isfinite(loss) and mod.last_clusters is None
    assert all(isinstance(s, int) for s in mod.last_solver_steps)
