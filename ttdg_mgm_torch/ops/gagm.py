"""The fused GA-GM solver: CUDA kernel ``csrc/gagm.cu`` with its plain
PyTorch version ``graph/solvers.py:ga_gm``.

Replaces the JAX package's fused Pallas solver
(``ttdg_mgm_tpu/ops/pallas/gagm_pallas.py:ga_gm_fused``) as the production
TTA path calls it (``exact_lap_finale=True, final_hungarian=False``): the
annealed Sinkhorn rounds and the exact JV LAP finale in one launch.  On CPU
tensors the plain version runs; on CUDA tensors the kernel launches (or the
call raises).  No gradient: the solver's inputs are detached.

The kernel is one thread-block cluster of ``G`` blocks with every operand
resident in shared memory, so it needs a device with clusters (compute
capability 9.0) and a shape within :func:`resident_limits`; another shape
raises.  It reads only the diagonal ``M x M`` blocks of ``A`` (the adjacency
is block-diagonal by construction, ``graph/mgm.py``), and it leaves out the
plain version's overflow guard (``graph/solvers.py:_gagm_round``,
``c = max(max|V| / 1e30, 1)``), which is the identity while ``|V| < 1e30``.
"""

from __future__ import annotations

import ctypes

import torch

from ttdg_mgm_torch.graph.solvers import anneal_taus, ga_gm
from ttdg_mgm_torch.ops import _cuda

__all__ = ["ga_gm_fused", "ga_gm", "padded_sizes", "resident_smem_bytes", "resident_limits"]

#: shared memory one block may use on the H100, bytes
MAX_BLOCK_SMEM = 232448
#: the resident kernel's limits: graphs (the portable cluster size), padded
#: nodes per graph, universe slots
MAX_GRAPHS, MAX_MP, MAX_UNIV = 8, 64, 64
#: slots of the kernel's clock table (``csrc/gagm.cu:ttdg_gagm``)
CLOCK_SLOTS = 16


def padded_sizes(M: int, n_univ: int):
    """Per-graph row block ``Mp`` (holds the dummy node rows of the
    ``ms <= n_univ`` orientation, a multiple of 8) and the LAP column count
    of the JAX fused kernel, ``L`` (a multiple of 128).  The CUDA kernel's
    LAP scans the ``Mp`` node columns only, with identical assignments."""
    Mp = -(-max(M, n_univ) // 8) * 8
    L = -(-max(Mp, n_univ) // 128) * 128
    return Mp, L


def resident_smem_bytes(G: int, Mp: int, n_univ: int) -> int:
    """Dynamic shared memory one block of the resident kernel needs (the
    layout of ``csrc/gagm.cu:make_layout``): the ``G`` diagonal blocks of
    ``A``, the block's ``Mp`` rows of ``W``, all of ``U``, the block's own
    ``U_last`` and ``U_new``, two ``Mp x Mp`` scratch tiles (they also hold
    the projection's state and the power step), and a small table; row
    strides are padded by 4 floats."""
    nup = -(-n_univ // 4) * 4
    lda, ldw, ldu = Mp + 4, G * Mp + 4, nup + 4
    misc = 2 * MAX_GRAPHS + 8 + MAX_MP + MAX_GRAPHS + 2 * CLOCK_SLOTS
    floats = (G * Mp * lda + Mp * ldw + G * Mp * ldu + 2 * Mp * nup + 2 * Mp * lda + misc)
    return 4 * floats


def resident_limits(G: int, M: int, n_univ: int):
    """``(fits, reason)``: whether the resident kernel takes ``G`` graphs of
    ``M`` nodes and a universe of ``n_univ`` slots, and if not, why."""
    Mp, _ = padded_sizes(M, n_univ)
    if G > MAX_GRAPHS:
        return False, f"{G} graphs exceed the cluster of {MAX_GRAPHS} blocks"
    if Mp > MAX_MP or n_univ > MAX_UNIV:
        return False, (f"padded nodes per graph {Mp} or universe {n_univ} exceed "
                       f"{MAX_MP} and {MAX_UNIV}")
    need = resident_smem_bytes(G, Mp, n_univ)
    if need > MAX_BLOCK_SMEM:
        return False, (f"{need} bytes of shared memory per block exceed {MAX_BLOCK_SMEM}")
    return True, ""


@torch.no_grad()
def ga_gm_fused(A, W, U0, ms, n_univ: int, *, quad_weight: float = 1.0,
                mgm_iter: int = 200, sk_iter: int = 20, sk_tau0: float = 0.1,
                sk_gamma: float = 0.5, min_tau: float = 1e-2, tol: float = 1e-3,
                lap_iter_cap: int = 200, return_steps: bool = False,
                return_power_step: bool = False, return_clocks: bool = False):
    """GA-GM with the exact-LAP finale.  A ``(G*M, G*M)`` block-diagonal, W
    ``(G*M, G*M)``, U0 ``(G*M, U)`` float32, ms ``(G,)`` int.
    Returns ``(G*M, U)``; with ``return_steps`` also the steps taken per round
    (annealed rounds, then the finale); with ``return_power_step`` (CUDA
    only) also ``V (G*M, U)``, the last power step the kernel projected; with
    ``return_clocks`` (CUDA only) also the kernel's clock table as a list
    (``csrc/gagm.cu:ttdg_gagm`` names its slots).  Extras follow the result
    in that order.  The overflow guard of the plain version is left out
    (identity for ``|V| < 1e30``).  A, W and U0 must be float32 on either
    path (the bf16 compute policy builds them in float32, as the JAX package
    does): another dtype raises."""
    for name, t in (("A", A), ("W", W), ("U0", U0)):
        if t.dtype != torch.float32:
            raise ValueError(f"ga_gm_fused: {name} must be float32, got {t.dtype}")
    if A.device.type == "cpu":
        if return_power_step or return_clocks:
            raise ValueError("the power step and the clocks are the CUDA kernel's")
        return ga_gm(A, W, U0, ms, n_univ, quad_weight=quad_weight, mgm_iter=mgm_iter,
                     sk_iter=sk_iter, sk_tau0=sk_tau0, sk_gamma=sk_gamma,
                     min_tau=min_tau, tol=tol, hung_iter_cap=lap_iter_cap,
                     return_steps=return_steps)
    dev = A.device
    if dev.type != "cuda":
        raise ValueError(f"ga_gm_fused runs on CPU or CUDA tensors, got {dev}")
    G = ms.shape[0]
    T = A.shape[0]
    M = T // G
    if A.shape != (T, T) or W.shape != (T, T) or U0.shape != (T, n_univ) or T != G * M:
        raise ValueError(f"ga_gm_fused shapes: A {tuple(A.shape)}, W {tuple(W.shape)}, "
                         f"U0 {tuple(U0.shape)}, G {G}")
    # no-ops on the contiguous tensors the TTA path builds
    A, W, U0 = A.contiguous(), W.contiguous(), U0.contiguous()
    for name, t in (("A", A), ("W", W), ("U0", U0)):
        _cuda.require_cuda_f32(name, t, dev)
    if ms.device != dev:
        raise ValueError(f"ms must lie on {dev}")
    fits, why = resident_limits(G, M, n_univ)
    if not fits:
        raise ValueError(f"ga_gm_fused: the shape does not fit the resident kernel: {why}")
    Mp, _ = padded_sizes(M, n_univ)
    ms32 = ms.to(torch.int32).contiguous()
    out = torch.empty((T, n_univ), dtype=torch.float32, device=dev)
    taus = anneal_taus(sk_tau0, sk_gamma, min_tau)
    # steps per round, then the kernel's status word
    iters = torch.zeros(len(taus) + 2, dtype=torch.int32, device=dev)
    v = torch.empty((G * Mp, n_univ), dtype=torch.float32, device=dev) if return_power_step else None
    clk = torch.zeros(CLOCK_SLOTS, dtype=torch.int64, device=dev) if return_clocks else None
    c_taus = (ctypes.c_float * len(taus))(*taus)
    err = _cuda.lib().ttdg_gagm(
        A.data_ptr(), W.data_ptr(), U0.data_ptr(), ms32.data_ptr(), out.data_ptr(),
        iters.data_ptr(), v.data_ptr() if v is not None else None,
        clk.data_ptr() if clk is not None else None, G, M, Mp, n_univ,
        float(quad_weight), float(tol * tol), int(mgm_iter), int(sk_iter),
        int(lap_iter_cap), len(taus), c_taus, _cuda.stream_ptr(dev))
    _cuda.check(err, "gagm kernel")
    ga_gm_fused.launches += 1
    # the one host synchronisation: the steps and the kernel's check of ms
    *steps, status = iters.tolist()
    if status != 0:
        raise ValueError(f"ms must lie in [0, {M}], got {ms.tolist()}")
    res = [out]
    if return_steps:
        res.append(steps)
    if return_power_step:
        res.append(v.reshape(G, Mp, n_univ)[:, :M].reshape(T, n_univ))
    if return_clocks:
        res.append(clk.tolist())
    return res[0] if len(res) == 1 else tuple(res)


#: kernel launches since the count was last reset (plain CPU calls not counted)
ga_gm_fused.launches = 0
