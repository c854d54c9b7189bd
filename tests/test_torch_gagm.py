"""The GA-GM solver's plain version against the JAX package (the CUDA
kernel against the plain version is in tests/test_torch_cuda.py).

Structured, well-separated matching problems (a planted assignment plus
noise), as tests/test_pallas.py uses for the fused kernel: on near-tie data
the discrete rounding may legitimately break ties differently.  Tolerance
atol 1e-5 with identical 0/1 assignments (tests/test_pallas.py:21-156).
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.graph.solvers import ga_gm as j_ga_gm
from ttdg_mgm_tpu.ops.pallas.gagm_pallas import ga_gm_fused as j_ga_gm_fused
from ttdg_mgm_torch.graph.solvers import ga_gm
from ttdg_mgm_torch.ops.gagm import ga_gm_fused
from ttdg_mgm_torch.synth import planted_matching_problem as structured_problem

KW = dict(quad_weight=0.5, mgm_iter=40, sk_iter=20, sk_tau0=0.1, sk_gamma=0.5,
          min_tau=1e-2, tol=1e-3)


CASES = {
    "G4": (4, 12, 16, [12, 12, 12, 12]),
    "G4_padded": (4, 12, 16, [12, 9, 11, 5]),
    "G2_identity_pin": (2, 10, 12, [10, 7]),
    "ms_gt_univ": (3, 10, 8, [10, 9, 10]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_solver_and_fused(case):
    G, n, univ, ms = CASES[case]
    A, W, U0, ms, Ugt = structured_problem(G, n, univ, ms, seed=len(case))
    got = ga_gm(torch.from_numpy(A), torch.from_numpy(W), torch.from_numpy(U0),
                torch.from_numpy(ms), univ, hung_iter_cap=40, **KW).numpy()
    want = np.asarray(j_ga_gm(jnp.asarray(A), jnp.asarray(W), jnp.asarray(U0),
                              jnp.asarray(ms), univ, hung_iter_cap=40, **KW))
    fused = np.asarray(j_ga_gm_fused(
        jnp.asarray(A), jnp.asarray(W), jnp.asarray(U0), jnp.asarray(ms), univ,
        interpret=True, final_hungarian=False, exact_lap_finale=True, lap_iter_cap=40, **KW))
    assert set(np.unique(got)) <= {0.0, 1.0}
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got, fused, atol=1e-5)
    # a partial permutation per graph: at most one slot per node and per slot
    Ug = got.reshape(Ugt.shape)
    assert Ug.sum(-1).max() <= 1 and Ug.sum(-2).max() <= 1


def test_wrapper_runs_plain_on_cpu():
    """On CPU tensors the kernel wrapper is the plain solver, and it counts
    no kernel launch."""
    A, W, U0, ms, _ = structured_problem(4, 12, 16, [12, 10, 12, 8], seed=3)
    args = (torch.from_numpy(A), torch.from_numpy(W), torch.from_numpy(U0),
            torch.from_numpy(ms), 16)
    before = ga_gm_fused.launches
    got, steps = ga_gm_fused(*args, lap_iter_cap=40, return_steps=True, **KW)
    assert ga_gm_fused.launches == before
    assert len(steps) == 6 and all(1 <= s <= 40 for s in steps)
    np.testing.assert_array_equal(got.numpy(), ga_gm(*args, hung_iter_cap=40, **KW).numpy())


def test_final_hungarian_round_matches_jax():
    """The terminal exact-LAP round alone, from a noisy start: identical
    0/1 assignments."""
    from ttdg_mgm_tpu.graph.solvers import final_hungarian_round as j_final
    from ttdg_mgm_torch.graph.solvers import final_hungarian_round

    A, W, U0, ms, _ = structured_problem(4, 12, 16, [12, 10, 7, 12], seed=5)
    kw = dict(quad_weight=0.5, mgm_iter=30, sk_iter=20, tau=1e-2, tol=1e-3)
    got = final_hungarian_round(torch.from_numpy(A), torch.from_numpy(W),
                                torch.from_numpy(U0), torch.from_numpy(ms), 16, **kw).numpy()
    want = np.asarray(j_final(jnp.asarray(A), jnp.asarray(W), jnp.asarray(U0),
                              jnp.asarray(ms), 16, **kw))
    assert set(np.unique(got)) <= {0.0, 1.0} and got.sum() > 0
    np.testing.assert_array_equal(got, want)


def test_one_finale_step_mode_matches_jax():
    """The mode the chip check holds the CUDA kernel in: no annealed step
    (``mgm_iter=0``), one exact-LAP finale step (cap 1) from a noisy planted
    start.  Identical 0/1 output to the JAX package's ``ga_gm`` in the same
    mode and to its terminal round alone capped at one step."""
    from ttdg_mgm_tpu.graph.solvers import final_hungarian_round as j_final

    A, W, U0, ms, _ = structured_problem(4, 12, 16, [12, 10, 7, 12], seed=9)
    kw = {**KW, "mgm_iter": 0}
    targs = (torch.from_numpy(A), torch.from_numpy(W), torch.from_numpy(U0),
             torch.from_numpy(ms), 16)
    got, steps = ga_gm_fused(*targs, lap_iter_cap=1, return_steps=True, **kw)
    assert steps == [0, 0, 0, 0, 0, 1]
    got = got.numpy()
    jargs = (jnp.asarray(A), jnp.asarray(W), jnp.asarray(U0), jnp.asarray(ms), 16)
    want = np.asarray(j_ga_gm(*jargs, hung_iter_cap=1, **kw))
    final = np.asarray(j_final(*jargs, quad_weight=0.5, mgm_iter=1, sk_iter=20, tau=1e-2,
                               tol=1e-3))
    assert set(np.unique(got)) <= {0.0, 1.0} and got.sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, final)


def test_annealed_rounds_alone_match_jax():
    """The other mode of the chip check: the annealed rounds without the
    finale (cap 0), a soft assignment; atol 1e-5 as for the whole solve."""
    A, W, U0, ms, _ = structured_problem(4, 12, 16, [12, 9, 11, 5], seed=2)
    got, steps = ga_gm(torch.from_numpy(A), torch.from_numpy(W), torch.from_numpy(U0),
                       torch.from_numpy(ms), 16, hung_iter_cap=0, return_steps=True, **KW)
    want = np.asarray(j_ga_gm(jnp.asarray(A), jnp.asarray(W), jnp.asarray(U0),
                              jnp.asarray(ms), 16, hung_iter_cap=0, **KW))
    assert steps[-1] == 0
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_resident_kernel_shared_memory_budget():
    """The flagship shape fits the 232,448 bytes one H100 block may use; the
    limits of the resident kernel are reported with their reason."""
    from ttdg_mgm_torch.ops.gagm import (MAX_BLOCK_SMEM, padded_sizes, resident_limits,
                                         resident_smem_bytes)

    Mp, L = padded_sizes(60, 32)
    assert (Mp, L) == (64, 128)
    need = resident_smem_bytes(4, Mp, 32)
    # A blocks, W rows, U, U_last and U_new, two tiles, the small table
    assert need == 4 * (4 * 64 * 68 + 64 * 260 + 256 * 36 + 2 * 64 * 32 + 2 * 64 * 68 + 128)
    assert need <= MAX_BLOCK_SMEM == 232448
    assert resident_limits(4, 60, 32) == (True, "")
    for G, M, univ in [(2, 10, 12), (3, 10, 8), (4, 12, 16), (8, 24, 16)]:
        assert resident_limits(G, M, univ)[0]
    for G, M, univ, word in [(9, 12, 16, "graphs"), (4, 80, 32, "nodes"), (8, 60, 32, "bytes")]:
        fits, why = resident_limits(G, M, univ)
        assert not fits and word in why


@pytest.mark.parametrize("ms", [[12, 9, 11, 5], [16, 14, 0, 3]])
def test_kernel_lap_formulation_matches_plain_projection(ms):
    """``ops/lap.py:lap_slots_to_nodes`` (the LAP as the CUDA kernel poses it:
    universe slots to node columns, node-less columns at 2 max|V| + 1000)
    against the plain projection's ``hungarian_auto`` on well-separated
    scores (a planted permutation plus 5 % noise): identical assignments."""
    from ttdg_mgm_torch.ops.lap import hungarian_auto, lap_slots_to_nodes

    rng = np.random.RandomState(sum(ms))
    G, M, univ = 4, 16, 12
    V = np.zeros((G, M, univ), np.float32)
    for g in range(G):
        perm = rng.permutation(M)[:univ]
        V[g, perm, np.arange(univ)] = 1.0
    V += 0.05 * rng.rand(G, M, univ).astype(np.float32)
    tms = torch.tensor(ms)
    got = lap_slots_to_nodes(torch.from_numpy(V), tms).numpy()
    want = hungarian_auto(torch.from_numpy(V), tms, torch.full_like(tms, univ)).numpy()
    want = want * (np.arange(M)[None, :, None] < np.asarray(ms)[:, None, None])
    np.testing.assert_array_equal(got, want)
    assert got.sum(axis=(1, 2)).tolist() == [float(min(m, univ)) for m in ms]
