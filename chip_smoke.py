#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ttdg_mgm_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--warm] [--dump-dir DIR]

Phases, each of which exits non-zero when it fails:

1. set-up: the card's name and power limit, the torch version, and the
   build of the port's CUDA kernels from ``ttdg_mgm_torch/csrc``;
2. the ROI pool kernel (``csrc/roi_pool.cu``) against its plain PyTorch
   version at the flagship shapes: FPN levels p2-p5 of 4 images at 800 px,
   256 channels; the 7x7 box pool of 4 x 1000 ROIs and the 14x14 mask pool
   of 4 x 100 ROIs, with elongated and out-of-range ROIs among them; before
   each pool, the kernels' device geometry (``csrc/roi_geometry.cuh``)
   against ``ops/roi_align.py:roi_geometry`` on the same ROIs (levels and
   sample counts equal, positions within 1 ulp); the wrapper's time apart
   from the bare kernel's;
3. the fused GA-GM kernel (``csrc/gagm.cu``) against its plain version on
   planted problems at the flagship size (4 graphs of 60 nodes, a 32-slot
   universe), one with 2 graphs, one with every graph at or below the
   universe size;
4. the eval-only TTA path end to end: the flagship R50-FPN Mask R-CNN at
   full width with seeded random weights, 3 TTA steps and one
   ``forward_inference`` on 4 synthetic 800x800 images, with both kernels'
   launch counters read around it, keeping a copy of every input the TTA
   steps give the GA-GM solver; then kernel B on those inputs: its time by
   CUDA events, its steps per round and its bound from them, the in-kernel
   clock split of an annealed and of a finale step, and the checks that are
   well-posed although the unconverged finale is chaotic (the annealed
   rounds against the plain version; one finale step: the power step
   against the plain one, and the 0/1 output against the host LAP of the
   kernel's own power step, bit for bit); then a narrow copy of the model on
   the GPU and on the CPU (plain versions) compared on a small input;
5. the training pools at the flagship training shapes: levels of 8 images
   at 800 px, 256 channels; the box pool's 8 x 512 ROIs at P=7 and the mask
   pool's 8 x 128 at P=14, clustered around two boxes per image as sampled
   training ROIs are; the ROI pool kernel (forward) and the backward kernel
   (``csrc/roi_pool_backward.cu``) each against its plain version;
6. source training end to end: the flagship at full width in float32,
   5 ``make_source_step`` steps on 8 synthetic 800x800 disc images with GT
   (masks on a 256 canvas), the source solver (lr 0.0025) with the
   global-norm clip 1.0 and warm-up of ``bench.py:warm_params``, the launch
   counters of kernels A, C and D read around every step; a copy of the
   inputs of every HiPPI call and of every projection it makes is kept
   (device copies of a few hundred kB per projection); the narrow
   GPU-vs-CPU comparison of phase 4 also holds ``loss_supervised`` and its
   parameter gradients;
7. the batched Sinkhorn kernel (``csrc/sinkhorn.cu``) against its plain
   version on every projection input HiPPI gave it in phase 6 (16 matrices
   of 60 x 60, tau 1/200 over the overflow guard's c, 20 iterations), timed
   on the first; the HiPPI call that took the most iterations rerun with
   the plain projection; and one synthetic batch with mixed valid counts.

TF32 is off for convolutions and matrix products throughout (parity
setting; the end-to-end times are taken with it off).  Bounds use the H100
SXM's published peaks: 3.35 TB/s of device memory, 67 TFLOP/s float32
outside the tensor cores.  The last lines are the card's name and power
limit (nvidia-smi), one JSON object with each kernel's numbers, and the
device line ``{"ok": true, "device": {...}}``.

``--profile`` adds, after each end-to-end phase, more timed steps and one
step under ``torch.profiler`` (device time by kernel, device busy share):
five TTA steps, and one source step.

``--dump-dir DIR`` saves the GA-GM inputs of the TTA steps to
``DIR/gagm_inputs.pt`` (for ``scripts/time_kernels.py --gagm-input``).

``--warm`` adds the answer to whether the GA-GM finale converges on a
trained detector: a fresh flagship model warmed by ``bench.py:warm_params``'s
recipe (120 source steps at 320 px, batch 4, the same schedule and clip),
then TTA steps at 800 px, batch 4, logging the GA-GM power steps per round,
and one TTA step under the profiler (kernel B's share of it).
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
ROI_TOL = dict(atol=2e-5, rtol=1e-4)
# the backward's float32 atomics add in a run-dependent order
# (tests/test_pallas.py:253-255 bound for the windowed backward)
ROI_BWD_TOL = dict(atol=3e-4, rtol=1e-3)
GAGM_ATOL = 1e-5
# the annealed rounds on the main path's inputs: U is a soft assignment in
# [0, 1]; the kernel and cuBLAS sum the products in other orders, and V / tau
# down to tau = 0.0125 amplifies that over the rounds' ~10 steps
GAGM_ANNEAL_ATOL = 2e-3
# one power step: float32 sums of up to 240 terms in another order
GAGM_V_RTOL = 1e-5
SINKHORN_ATOL = 1e-5  # tests/test_pallas.py:166
# the flagship model's solver settings (graph/mgm.py, build.py)
GAGM_KW = dict(quad_weight=0.5, mgm_iter=200, sk_iter=20, sk_tau0=0.1, sk_gamma=0.5,
               min_tau=1e-2, tol=1e-3)
TTA_LR = 0.005  # configs/test_segment.yaml SOLVER.BASE_LR
# bench.py:warm_params: the source solver's lr with a 40-step warm-up from
# 0.05 and the global-norm clip 1.0, without which training from random
# weights diverges (bench.py:107-119)
WARM_SCHEDULE = dict(steps=(100000,), warmup_iters=40, warmup_factor=0.05)
WARM_CLIP = {"type": "norm", "value": 1.0}


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def event_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, after one
    warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(torch, fn) -> float:
    """Wall time of one call that ends in a device synchronise (for the plain
    versions whose loops and stop tests run on the host)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bound(bytes_: float, flops: float):
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: ROI pool ---------------------------------------------------------

def make_rois(torch, gen, B: int, K: int, size: int):
    """Seeded ROIs on a ``size`` canvas: 80 % compact boxes of 8-400 px,
    10 % elongated (up to the whole canvas along one axis), 10 % partly or
    wholly outside the canvas."""
    u = lambda *s: torch.rand(s, generator=gen)  # noqa: E731
    side = torch.exp(math.log(8.0) + u(B, K, 2) * math.log(400.0 / 8.0))
    xy = u(B, K, 2) * (size - side)
    rois = torch.cat([xy, xy + side], -1)
    n_el = K // 10
    long_side = 0.5 * size + 0.5 * size * u(B, n_el)
    short = 8.0 + 24.0 * u(B, n_el)
    x0 = u(B, n_el) * (size - long_side)
    y0 = u(B, n_el) * (size - short)
    horiz = torch.stack([x0, y0, x0 + long_side, y0 + short], -1)
    vert = torch.stack([y0, x0, y0 + short, x0 + long_side], -1)
    rois[:, :n_el] = torch.where((torch.arange(n_el) % 2 == 0)[None, :, None], horiz, vert)
    out = rois[:, n_el:2 * n_el]
    rois[:, n_el:2 * n_el] = out + (u(B, n_el, 1) - 0.5) * 1.5 * size
    return rois.contiguous()


def roi_pool_work(torch, feats, rois, P: int):
    """Bytes and float operations this ROI pool needs on these inputs: each
    feature row (one pixel's C values) that some valid bilinear corner reads,
    read once; the output written once; 10 operations per valid sample and
    channel (4 corner FMAs, the weighted accumulate)."""
    from ttdg_mgm_torch.ops.roi_align import roi_geometry

    B, K = rois.shape[:2]
    C = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    levels, ys, wy, xs, wx, _ = roi_geometry(rois.reshape(B * K, 4), shapes, output_size=P)
    dev = rois.device
    lv = levels.long()
    Hs = torch.tensor([h for h, _ in shapes], device=dev)[lv][:, None].float()
    Ws = torch.tensor([w for _, w in shapes], device=dev)[lv][:, None].float()
    sizes = torch.tensor([B * h * w for h, w in shapes], device=dev)
    offs = torch.cumsum(sizes, 0) - sizes
    bidx = torch.arange(B * K, device=dev) // K
    base = offs[lv] + bidx * (Hs[:, 0] * Ws[:, 0]).long()

    def corners(pos, w, lim):
        ok = (w > 0) & (pos > -1.0) & (pos < lim)
        c = torch.minimum(pos.clamp(min=0.0), lim - 1)
        c0 = torch.floor(c)
        c1 = torch.minimum(c0 + 1, lim - 1)
        idx = torch.cat([c0, c1], 1).long()
        return torch.where(torch.cat([ok, ok], 1), idx, torch.full_like(idx, -1)), ok

    yi, vy = corners(ys, wy, Hs)
    xi, vx = corners(xs, wx, Ws)
    ids = base[:, None, None] + yi[:, :, None] * Ws[:, :, None].long() + xi[:, None, :]
    live = (yi[:, :, None] >= 0) & (xi[:, None, :] >= 0)
    touched = torch.unique(ids[live]).numel()
    pairs = (vy.sum(1) * vx.sum(1)).sum().item()
    out_bytes = B * K * P * P * C * 4
    return touched * C * 4 + out_bytes + rois.numel() * 4, 10.0 * pairs * C


def check_roi_geometry(torch, rois, shapes, P: int, what: str):
    """The kernels' device geometry (``csrc/roi_geometry.cuh``) against its
    plain version ``ops/roi_align.py:roi_geometry`` on the same ROIs: levels
    and weights (so sample counts) equal, positions within 1 ulp.  Returns
    the largest position difference in ulps."""
    from ttdg_mgm_torch.ops.roi_align import roi_geometry
    from ttdg_mgm_torch.ops.roi_pool import roi_geometry_device

    flat = rois.reshape(-1, 4)
    want = roi_geometry(flat, shapes, output_size=P)
    got = roi_geometry_device(flat, len(shapes), output_size=P)
    torch.cuda.synchronize()
    check(got[5] == want[5], f"{what}: sample slots per bin {got[5]} vs {want[5]}")
    check(bool(torch.equal(got[0], want[0])), f"{what}: device geometry assigns other levels")
    ulps = 0.0
    for k, name in ((2, "wy"), (4, "wx")):
        check(bool(torch.equal(got[k], want[k])),
              f"{what}: device geometry {name} differs (sample counts or weights)")
    for k in (1, 3):
        ulp = torch.abs(want[k]) * 2.0 ** -23 + 1e-30
        ulps = max(ulps, (torch.abs(got[k] - want[k]) / ulp).max().item())
    counts = (want[2] > 0).sum(1).float().mean().item() / P
    log(f"{what}: device geometry of {flat.shape[0]} ROIs equals roi_geometry: levels and "
        f"weights identical (mean {counts:.2f} samples per bin and axis), positions within "
        f"{ulps:.2f} ulp (bound 1)")
    check(ulps <= 1.0, f"{what}: device geometry positions differ by {ulps} ulp")
    return ulps


def pool_split_ms(torch, feats_or_grads, shapes, rois, P: int, C: int, other, backward: bool):
    """Kernel A's (or C's) time apart from its wrapper's: CUDA events around
    the argument set-up alone, and around the bare launch through the C entry
    point with the set-up done once.  ``other`` is the forward's output buffer
    or the backward's cotangent.  Returns ``(args_ms, kernel_only_ms)``."""
    from ttdg_mgm_torch.ops import _cuda
    from ttdg_mgm_torch.ops import roi_pool as rp

    name = "multilevel_roi_pool_backward" if backward else "multilevel_roi_pool"
    make = lambda: rp._kernel_args(name, feats_or_grads, shapes, rois, C, P,  # noqa: E731
                                   (4, 8, 16, 32), 0, 2)
    args_ms = event_ms(torch, make, 20)
    args = make()
    fn = _cuda.lib().ttdg_roi_pool_backward if backward else _cuda.lib().ttdg_roi_pool
    stream = _cuda.stream_ptr(rois.device)

    def launch():
        _cuda.check(fn(*args, other.data_ptr(), stream), name)

    return args_ms, event_ms(torch, launch, 20)


def phase_roi_pool(torch, dev, B: int = 4, S: int = 800, C: int = 256,
                   box_rois: int = 1000, mask_rois: int = 100, profile: bool = False):
    from ttdg_mgm_torch.ops.roi_align import multilevel_roi_align
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool

    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn((B, S // s, S // s, C), generator=gen).to(dev) for s in (4, 8, 16, 32)]
    res = {}
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    for name, K, P in (("box", box_rois, 7), ("mask", mask_rois, 14)):
        rois = make_rois(torch, gen, B, K, S).to(dev)
        ulps = check_roi_geometry(torch, rois, shapes, P, f"roi_pool {name}")
        got = multilevel_roi_pool(feats, rois, output_size=P)
        want = multilevel_roi_align(feats, rois, output_size=P)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"roi_pool {name}: non-finite output")
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **ROI_TOL)
        del want
        log(f"roi_pool {name} pool {tuple(got.shape)}: max_abs_err {err:.3e} "
            f"(atol {ROI_TOL['atol']}, rtol {ROI_TOL['rtol']}) -> {'ok' if ok else 'FAIL'}")
        check(ok, f"roi_pool {name}: kernel disagrees with the plain version ({err})")
        ms = event_ms(torch, lambda: multilevel_roi_pool(feats, rois, output_size=P), 20)
        args_ms, only_ms = pool_split_ms(torch, feats, shapes, rois, P, C, got, False)
        plain_ms = event_ms(torch, lambda: multilevel_roi_align(feats, rois, output_size=P), 2)
        torch.cuda.empty_cache()
        nbytes, flops = roi_pool_work(torch, feats, rois, P)
        b_ms, b_by = bound(nbytes, flops)
        log(f"roi_pool {name}: wrapper {ms:.4f} ms (its argument set-up {args_ms:.4f} ms, the "
            f"kernel alone {only_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        res[name] = dict(max_abs_err=err, ms=ms, kernel_only_ms=only_ms, args_ms=args_ms,
                         geometry_ulps=ulps, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"levels ({B}, {S // 4}..{S // 32}, {S // 4}..{S // 32}, {C}) f32, "
                               f"rois ({B}, {K}, 4), P={P}")
        if profile:
            # the wrapper's whole device work is its one kernel
            _, by_kernel = profile_call(
                torch, lambda: multilevel_roi_pool(feats, rois, output_size=P),
                f"multilevel_roi_pool call ({name} pool)")
            check(len(by_kernel) == 1 and "roi_pool_kernel" in next(iter(by_kernel)),
                  f"roi_pool {name}: the wrapper ran other device work: {sorted(by_kernel)}")
    return res


# -- phase 5: training pools, forward and backward -------------------------------

def make_train_rois(torch, gen, B: int, K: int, size: int):
    """Seeded training ROIs: proposals clustered around two disc-sized boxes
    per image (jittered corners, scale 0.5-1.5x), a quarter of them near a
    box, the rest anywhere, as label_and_sample_proposals draws them."""
    u = lambda *s: torch.rand(s, generator=gen)  # noqa: E731
    side = size * (0.2 + 0.2 * u(B, 2, 1))
    ctr = side / 2 + u(B, 2, 2) * (size - side)
    pick = (u(B, K) * 2).long().clamp(max=1)
    c = torch.gather(ctr, 1, pick[..., None].expand(B, K, 2))
    s = torch.gather(side, 1, pick[..., None]).expand(B, K, 2) * (0.5 + u(B, K, 2))
    near = torch.cat([c - s / 2, c + s / 2], -1) + (u(B, K, 4) - 0.5) * 0.1 * size
    side2 = torch.exp(math.log(16.0) + u(B, K, 2) * math.log(400.0 / 16.0))
    xy = u(B, K, 2) * (size - side2)
    far = torch.cat([xy, xy + side2], -1)
    rois = torch.where((torch.arange(K) < K // 4)[None, :, None], near, far)
    return rois.clamp(0.0, float(size)).contiguous()


def roi_backward_work(torch, feats, rois, P: int):
    """Bytes and float operations the pool's backward needs on these inputs:
    the cotangent and the ROIs read once, every level gradient written once;
    10 operations per valid sample and channel (the weighted value and four
    corner adds).  Also the bytes of the atomic design, which zeroes the
    level gradients and then reads and writes each touched row: the
    cotangent, the zeroing, and a read and a write of each touched row."""
    touched_and_out, flops = roi_pool_work(torch, feats, rois, P)
    B, K = rois.shape[:2]
    C = feats[0].shape[-1]
    g_bytes = B * K * P * P * C * 4
    touched_bytes = touched_and_out - g_bytes - rois.numel() * 4
    grad_bytes = sum(f.numel() for f in feats) * 4
    nbytes = g_bytes + grad_bytes + rois.numel() * 4
    return nbytes, flops, nbytes + 2 * touched_bytes


def phase_roi_backward(torch, dev, B: int = 8, S: int = 800, C: int = 256,
                       box_rois: int = 512, mask_rois: int = 128):
    """The training pools: the ROI pool kernel, then the backward kernel,
    each against its plain version on the same levels and ROIs.  Returns
    ``(backward results, forward results)``."""
    from ttdg_mgm_torch.ops.roi_align import multilevel_roi_align, multilevel_roi_align_backward
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_backward

    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn((B, S // s, S // s, C), generator=gen).to(dev) for s in (4, 8, 16, 32)]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    res, fwd = {}, {}
    for name, K, P in (("box", box_rois, 7), ("mask", mask_rois, 14)):
        rois = make_train_rois(torch, gen, B, K, S).to(dev)
        ulps = check_roi_geometry(torch, rois, shapes, P, f"roi_pool train {name}")
        got = multilevel_roi_pool(feats, rois, output_size=P)
        want = multilevel_roi_align(feats, rois, output_size=P)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got).all()), f"roi_pool train {name}: non-finite output")
        err = (got - want).abs().max().item()
        ok = torch.allclose(got, want, **ROI_TOL)
        del want
        log(f"roi_pool train {name} pool of {B} x {K} training ROIs, P={P}: max_abs_err "
            f"{err:.3e} (atol {ROI_TOL['atol']}, rtol {ROI_TOL['rtol']}) -> {'ok' if ok else 'FAIL'}")
        check(ok, f"roi_pool train {name}: kernel disagrees with the plain version ({err})")
        ms = event_ms(torch, lambda: multilevel_roi_pool(feats, rois, output_size=P), 20)
        args_ms, only_ms = pool_split_ms(torch, feats, shapes, rois, P, C, got, False)
        del got
        plain_ms = event_ms(torch, lambda: multilevel_roi_align(feats, rois, output_size=P), 2)
        torch.cuda.empty_cache()
        nbytes, flops = roi_pool_work(torch, feats, rois, P)
        b_ms, b_by = bound(nbytes, flops)
        log(f"roi_pool train {name}: wrapper {ms:.4f} ms (its argument set-up {args_ms:.4f} ms, "
            f"the kernel alone {only_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        fwd[name] = dict(max_abs_err=err, ms=ms, kernel_only_ms=only_ms, args_ms=args_ms,
                         geometry_ulps=ulps, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=f"levels ({B}, {S // 4}..{S // 32}, {S // 4}..{S // 32}, {C}) f32, "
                               f"rois ({B}, {K}, 4) clustered training ROIs, P={P}")
        g = torch.randn((B, K, P, P, C), generator=gen).to(dev)
        got = multilevel_roi_pool_backward(g, shapes, rois)
        want = multilevel_roi_align_backward(g, shapes, rois)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        for a, b in zip(got, want):
            check(bool(torch.isfinite(a).all()), f"roi_pool_backward {name}: non-finite output")
            err = max(err, (a - b).abs().max().item())
            ok = ok and torch.allclose(a, b, **ROI_BWD_TOL)
        del got, want
        log(f"roi_pool_backward {name} grads of {shapes}: max_abs_err {err:.3e} "
            f"(atol {ROI_BWD_TOL['atol']}, rtol {ROI_BWD_TOL['rtol']}) -> {'ok' if ok else 'FAIL'}")
        check(ok, f"roi_pool_backward {name}: kernel disagrees with the plain version ({err})")
        ms = event_ms(torch, lambda: multilevel_roi_pool_backward(g, shapes, rois), 20)
        # the bare launch keeps adding into one set of gradients: the same
        # atomics on the same rows, without the wrapper's zeroing
        grads = [torch.zeros_like(f) for f in feats]
        args_ms, only_ms = pool_split_ms(torch, grads, shapes, rois, P, C, g, True)
        del grads
        plain_ms = event_ms(torch, lambda: multilevel_roi_align_backward(g, shapes, rois), 2)
        torch.cuda.empty_cache()
        nbytes, flops, design_bytes = roi_backward_work(torch, feats, rois, P)
        b_ms, b_by = bound(nbytes, flops)
        design_ms = design_bytes / PEAK_BYTES_PER_S * 1e3
        log(f"roi_pool_backward {name}: wrapper {ms:.4f} ms (its argument set-up {args_ms:.4f} "
            f"ms, the kernel alone {only_ms:.4f} ms, the rest zeroes the level gradients), "
            f"plain {plain_ms:.4f} ms, bound "
            f"{b_ms:.4f} ms by {b_by} ({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); the "
            f"atomic design moves {design_bytes / 1e6:.1f} MB ({design_ms:.4f} ms)")
        res[name] = dict(max_abs_err=err, ms=ms, kernel_only_ms=only_ms, args_ms=args_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         design_bytes_ms=design_ms,
                         shape=f"g ({B}, {K}, {P}, {P}, {C}) f32 -> levels ({B}, {S // 4}..{S // 32}"
                               f", {S // 4}..{S // 32}, {C}), clustered training ROIs")
    return res, fwd


# -- phase 7: batched Sinkhorn -----------------------------------------------------

def phase_sinkhorn(torch, dev, record, iters: int = 20, tau: float = 1 / 200):
    """Kernel D against the plain Sinkhorn on every projection input HiPPI
    gave it in the source phase (``record``, from :func:`capture_hippi`),
    timed on the first; the HiPPI call with the most iterations rerun with
    the plain projection; one synthetic batch with mixed valid counts."""
    import ttdg_mgm_torch.graph.solvers as solvers
    from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched

    proj = record["projections"]
    check(len(proj) > 0, "sinkhorn: HiPPI made no projection in the source phase")
    err = 0.0
    for s, nr, nc, kw in proj:
        got = sinkhorn_batched(s, nr, nc, **kw)
        want = sinkhorn(s, nr, nc, **kw)
        check(bool(torch.isfinite(got).all()), "sinkhorn: non-finite output on HiPPI's input")
        err = max(err, (got - want).abs().max().item())
    s, nr, nc, kw = proj[0]
    t = float(kw["tau"])
    ok = err <= SINKHORN_ATOL
    log(f"sinkhorn on HiPPI's {len(proj)} projection inputs {tuple(s.shape)} (first: |s| up to "
        f"{s.abs().max().item():.3e}, tau {t:g}, nrows {nr.tolist()}, ncols {nc.tolist()}): "
        f"max_abs_err {err:.3e} (atol {SINKHORN_ATOL}) -> {'ok' if ok else 'FAIL'}")
    check(ok, f"sinkhorn: kernel disagrees with the plain version on HiPPI's input ({err})")

    # the HiPPI call with the most iterations, again with kernel D and with
    # the plain projection (these launches are not the main path's)
    W, U0, ms, n_univ, hkw = max(record["hippi"], key=lambda h: h[-1]["steps"])
    hkw = {k: v for k, v in hkw.items() if k != "steps"}
    U_k, steps_k = solvers.hippi(W, U0, ms, n_univ, **hkw)
    real = solvers.sinkhorn_batched
    solvers.sinkhorn_batched = sinkhorn
    try:
        U_p, steps_p = solvers.hippi(W, U0, ms, n_univ, **hkw)
    finally:
        solvers.sinkhorn_batched = real
    hippi_diff = (U_k - U_p).abs().max().item()
    log(f"sinkhorn: the longest HiPPI call of the source phase, rerun: {steps_k} iterations with "
        f"kernel D, {steps_p} with the plain projection, max |U diff| {hippi_diff:.3e}")

    gen = torch.Generator().manual_seed(3)
    N, n = 16, 60
    syn = (torch.rand((N, n, n), generator=gen) * 1e3).to(dev)
    counts = torch.tensor([60, 41, 22, 57, 60, 12, 33, 48], dtype=torch.int32)
    snr = torch.cat([counts, torch.full((N // 2,), 32, dtype=torch.int32)]).to(dev)
    snc = torch.cat([torch.full((N // 2,), 32, dtype=torch.int32), counts]).to(dev)
    tt = torch.tensor(tau, device=dev)
    got = sinkhorn_batched(syn, snr, snc, tau=tt, max_iter=iters, dummy_row=True)
    want = sinkhorn(syn, snr, snc, tau=tt, max_iter=iters, dummy_row=True)
    syn_err = (got - want).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and syn_err <= SINKHORN_ATOL
    log(f"sinkhorn synthetic ({N}, {n}, {n}), uniform scores in [0, 1e3), tau {tau:g}, mixed "
        f"valid counts: max_abs_err {syn_err:.3e} (atol {SINKHORN_ATOL}) -> {'ok' if ok else 'FAIL'}")
    check(ok, f"sinkhorn: kernel disagrees with the plain version ({syn_err})")

    ms_k = event_ms(torch, lambda: sinkhorn_batched(s, nr, nc, **kw), 200)
    plain_ms = event_ms(torch, lambda: sinkhorn(s, nr, nc, **kw), 20)
    # each entry: read once, written once; per iteration and live entry a
    # max, a subtract, an exp, an add and a final subtract (5 operations),
    # plus a log per live slice
    live = sum(int(max(a, b)) * int(b) for a, b in zip(nr.tolist(), nc.tolist()))
    flops = kw["max_iter"] * 5.0 * live
    nbytes = 2 * s.numel() * 4 + 2 * s.shape[0] * 4 + 4
    b_ms, b_by = bound(nbytes, flops)
    log(f"sinkhorn: kernel {ms_k:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
        f"({nbytes / 1e3:.1f} kB, {flops / 1e6:.2f} MFLOP)")
    return dict(max_abs_err=max(err, syn_err), ms=ms_k, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, projections_checked=len(proj),
                hippi_rerun={"iterations_kernel": steps_k, "iterations_plain": steps_p,
                             "max_abs_diff": hippi_diff},
                shape=f"{tuple(s.shape)} f32 from HiPPI's first projection of the source phase, "
                      f"nrows {nr.tolist()}, ncols {nc.tolist()}, tau {t:g}")


# -- phase 6: source training ------------------------------------------------------

SOURCE_COUNTERS = ("roi_pool", "roi_pool_backward", "sinkhorn")


def kernel_counters():
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_backward
    from ttdg_mgm_torch.ops.sinkhorn import sinkhorn_batched

    return {"roi_pool": multilevel_roi_pool, "gagm": ga_gm_fused,
            "roi_pool_backward": multilevel_roi_pool_backward, "sinkhorn": sinkhorn_batched}


def reset_counters():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_counters():
    return {k: fn.launches for k, fn in kernel_counters().items()}


def source_setup(torch, dev, size: int, B: int, steps: int, mask_res: int | None = None,
                 seed: int = 0, **model_kw):
    """The flagship model, ``make_source_step`` with the source solver's lr
    under bench.py's warm-up and clip, and ``steps`` labelled batches (GT
    masks on the source trainer's canvas unless ``mask_res`` is given)."""
    from ttdg_mgm_torch.build import SOURCE_SOLVER, build_model
    from ttdg_mgm_torch.engine.steps import make_source_step
    from ttdg_mgm_torch.solver.build import build_optimizer, warmup_multistep_schedule
    from ttdg_mgm_torch.synth import synth_batch

    model = build_model(device=dev, seed=seed, **model_kw)
    opt = build_optimizer(model, warmup_multistep_schedule(SOURCE_SOLVER["base_lr"],
                                                           **WARM_SCHEDULE), clip=WARM_CLIP)
    step = make_source_step(model, opt)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                synth_batch(size, B, seed=i, with_gt=True,
                            mask_res=mask_res or SOURCE_SOLVER["mask_res"]).items()}
               for i in range(steps)]
    return model, step, batches


def capture_hippi():
    """Wraps HiPPI (as ``graph/universe.py`` calls it) and its projection's
    kernel wrapper (as ``graph/solvers.py`` calls it) to keep a copy of each
    call's inputs.  Returns the record and the function that undoes it."""
    import ttdg_mgm_torch.graph.solvers as solvers
    import ttdg_mgm_torch.graph.universe as universe

    record = {"hippi": [], "projections": []}
    real_hippi, real_solve = universe.hippi, solvers.sinkhorn_batched

    def hippi(W, U0, ms, n_univ, **kw):
        out = real_hippi(W, U0, ms, n_univ, **kw)
        record["hippi"].append((W.detach().clone(), U0.detach().clone(), ms.clone(), n_univ,
                                {**kw, "steps": out[1]}))
        return out

    def solve(s, nrows, ncols, **kw):
        record["projections"].append((s.clone(), nrows.clone(), ncols.clone(), kw))
        return real_solve(s, nrows, ncols, **kw)

    def undo():
        universe.hippi, solvers.sinkhorn_batched = real_hippi, real_solve

    universe.hippi, solvers.sinkhorn_batched = hippi, solve
    return record, undo


def phase_source(torch, dev, size: int = 800, B: int | None = None, steps: int = 5,
                 profile: bool = False, **model_kw):
    from ttdg_mgm_torch.build import SOURCE_SOLVER

    B = B or SOURCE_SOLVER["ims_per_batch"]
    t0 = time.perf_counter()
    model, step, batches = source_setup(torch, dev, size, B, steps, **model_kw)
    log(f"source: R50-FPN {model_kw or 'flagship'} built in {time.perf_counter() - t0:.1f} s, "
        f"batch {tuple(batches[0]['image'].shape)} with GT, lr schedule of bench.py:warm_params, "
        f"global-norm clip 1.0, TF32 off")
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms, per_step, totals = [], [], []
    record, undo = capture_hippi()
    try:
        for i, batch in enumerate(batches):
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(batch, gen)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counters()
            per_step.append(launches)
            m = {k: float(v) for k, v in metrics.items()}
            totals.append(m["total_loss"])
            log(f"source step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in m.items())
                + f"; HiPPI steps {model.multi_matching_sup.last_hippi_steps}; launches "
                f"{launches}; {step_ms[-1]:.1f} ms")
            for k, v in m.items():
                check(math.isfinite(v), f"source step {i}: {k} = {v} is not finite")
            check(m["loss_matching"] > 0.0, f"source step {i}: loss_matching {m['loss_matching']}")
            for k in SOURCE_COUNTERS:
                check(launches[k] >= 1, f"source step {i}: kernel {k} was not launched")
    finally:
        undo()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_ms[1:])
    log(f"source: step ms {[round(t, 1) for t in step_ms]} (first includes warm-up); median "
        f"after warm-up {steady:.1f} ms = {B * 1e3 / steady:.2f} images/s; peak memory "
        f"{peak_gb:.2f} GiB; launches per step {per_step[-1]}")
    if profile:
        profile_source(torch, step, batches[-1], gen,
                       lambda: model.multi_matching_sup.last_hippi_steps)
    del model, step, batches
    torch.cuda.empty_cache()
    return dict(batch=B, step_ms=step_ms, steady_ms=steady, images_per_s=B * 1e3 / steady,
                total_loss=totals, peak_gib=peak_gb, launches_per_step=per_step,
                launches={k: sum(p[k] for p in per_step) for k in per_step[0]}, hippi=record)


def profile_source(torch, step, batch, gen, hippi_steps):
    """``--profile``: one more source step under ``torch.profiler``."""
    profile_call(torch, lambda: step(batch, gen), "source step",
                 lambda: f", HiPPI steps {hippi_steps()}")


# -- phase 3: GA-GM --------------------------------------------------------------

def phase_gagm(torch, dev, n: int = 60):
    from ttdg_mgm_torch.graph.solvers import ga_gm
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused
    from ttdg_mgm_torch.synth import planted_matching_problem

    cases = (("G4_M60", 4, n, 32, [n, n - 8, 30, n - 15]), ("G2_M60", 2, n, 32, [n, 28]),
             ("G4_ms_le_univ", 4, n, 32, [32, 20, 28, 32]))
    res = {}
    for seed, (name, G, n, univ, ms) in enumerate(cases):
        A, W, U0, ms, _ = planted_matching_problem(G, n, univ, ms, seed=seed)
        args = [torch.from_numpy(x).to(dev) for x in (A, W, U0, ms)]
        got, steps = ga_gm_fused(*args, univ, lap_iter_cap=200, return_steps=True, **GAGM_KW)
        want, want_steps = ga_gm(*args, univ, hung_iter_cap=200, return_steps=True, **GAGM_KW)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        binary = bool(((got == 0) | (got == 1)).all())
        same = bool(torch.equal(got, want))
        ok = binary and same and err <= GAGM_ATOL
        log(f"gagm {name}: steps kernel {steps} plain {want_steps}; max_abs_err {err:.3e} "
            f"(atol {GAGM_ATOL}, identical 0/1 assignments) -> {'ok' if ok else 'FAIL'}")
        check(ok, f"gagm {name}: kernel disagrees with the plain version")
        ms_k = event_ms(torch, lambda: ga_gm_fused(*args, univ, lap_iter_cap=200, **GAGM_KW), 5)
        plain_ms = host_ms(torch, lambda: ga_gm(*args, univ, hung_iter_cap=200, **GAGM_KW))
        T = G * n
        flops = gagm_flops(G, n, univ, sum(steps))
        nbytes = (G * n * n + T * T + 2 * T * univ + G) * 4
        b_ms, b_by = bound(nbytes, flops)
        log(f"gagm {name}: kernel {ms_k:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
            f"by {b_by} ({sum(steps)} power steps, {flops / 1e9:.3f} GFLOP)")
        res[name] = dict(max_abs_err=err, ms=ms_k, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, steps=steps,
                         shape=f"A, W ({T}, {T}) f32, U0 ({T}, {univ}), ms {list(map(int, ms))}")
    return res


def gagm_flops(G: int, M: int, univ: int, steps: int) -> float:
    """Float operations ``steps`` power steps need on a block-diagonal ``A``:
    per pair of graphs ``U_g U_j^T``, the two products with ``A``'s blocks
    and the product with ``U_j``; then ``W U``.  The zero blocks of ``A``
    need no multiply."""
    T = G * M
    return steps * (G * G * (4.0 * M ** 3 + 4.0 * M * M * univ) + 2.0 * T * T * univ)


def capture_gagm():
    """Wraps the solver as ``graph/mgm.py`` calls it to keep a copy of each
    call's inputs.  Returns the record and the function that undoes it."""
    import ttdg_mgm_torch.graph.mgm as mgm

    record, real = [], mgm.ga_gm_fused

    def solve(A, W, U0, ms, n_univ, **kw):
        record.append((A.clone(), W.clone(), U0.clone(), ms.clone(), n_univ,
                       {k: v for k, v in kw.items() if k != "return_steps"}))
        return real(A, W, U0, ms, n_univ, **kw)

    def undo():
        mgm.ga_gm_fused = real

    mgm.ga_gm_fused = solve
    return record, undo


def clock_split(clk, kind: str):
    """One kind of round (``"anneal"`` or ``"finale"``) of kernel B's clock
    table as microseconds per step, by phase."""
    mhz = (clk[14] - clk[15]) / (clk[13] / 1e3)  # SM cycles per microsecond
    o = 6 if kind == "finale" else 0
    steps = max(clk[o + 5], 1)
    names = ("products", "projection", "wait_products", "publish_U", "closing_barrier")
    out = {n: clk[o + i] / mhz / steps for i, n in enumerate(names)}
    if kind == "finale":
        out["lap_recurrence"] = clk[12] / mhz / steps
    out["steps"] = clk[o + 5]
    out["sm_mhz"] = mhz
    return out


def phase_gagm_main(torch, dev, record, dump_dir=None):
    """Kernel B on the inputs the TTA steps gave it (``record``, from
    :func:`capture_gagm`).  On the first: its time by CUDA events, its steps
    per round, its bound from those steps, and the in-kernel clock split of
    an annealed and of a finale step.  On every input, the two parts of the
    solve that are well-posed although the unconverged finale is chaotic:
    (a) the annealed rounds alone against the plain version; (b) one finale
    step from that U: the kernel's power step V against the plain one, and
    the kernel's 0/1 output against the host LAP of the kernel's own V."""
    from ttdg_mgm_torch.graph.solvers import _project_blocks, ga_gm
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused
    from ttdg_mgm_torch.ops.lap import lap_slots_to_nodes

    check(len(record) > 0, "gagm main path: the TTA steps made no solver call")
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        torch.save([(A.cpu(), W.cpu(), U0.cpu(), ms.cpu(), nu, kw)
                    for A, W, U0, ms, nu, kw in record], os.path.join(dump_dir, "gagm_inputs.pt"))
    A, W, U0, ms, nu, kw = record[0]
    G, T = ms.shape[0], A.shape[0]
    M = T // G
    _, steps, clk = ga_gm_fused(A, W, U0, ms, nu, return_steps=True, return_clocks=True, **kw)
    ms_k = event_ms(torch, lambda: ga_gm_fused(A, W, U0, ms, nu, **kw), 5)
    pkw = {("hung_iter_cap" if k == "lap_iter_cap" else k): v for k, v in kw.items()}
    plain_ms = host_ms(torch, lambda: ga_gm(A, W, U0, ms, nu, **pkw))
    flops = gagm_flops(G, M, nu, sum(steps))
    nbytes = (G * M * M + T * T + 2 * T * nu + G) * 4
    b_ms, b_by = bound(nbytes, flops)
    split = {k: clock_split(clk, k) for k in ("anneal", "finale")}
    log(f"gagm main path, first captured input (A, W ({T}, {T}), U0 ({T}, {nu}), ms "
        f"{ms.tolist()}): steps per round {steps}; kernel {ms_k:.4f} ms by events, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by} ({sum(steps)} power steps, "
        f"{flops / 1e9:.3f} GFLOP)")
    for kind, sp in split.items():
        log(f"gagm main path, in-kernel clocks of block 0, microseconds per {kind} step over "
            f"{sp['steps']} steps at {sp['sm_mhz']:.0f} MHz: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sp.items() if k not in ("steps", "sm_mhz")))

    worst_a, worst_v, differ_plain, lap_stats = 0.0, 0.0, 0, {}
    for i, (A, W, U0, ms, nu, kw) in enumerate(record):
        pkw = {("hung_iter_cap" if k == "lap_iter_cap" else k): v for k, v in kw.items()}
        # (a) the annealed rounds: soft assignments in [0, 1]; the products'
        # float32 summation order differs, V / tau at tau = 0.0125 amplifies
        # it 80 times per step over ~10 steps
        Ua, st_k = ga_gm_fused(A, W, U0, ms, nu, return_steps=True, **{**kw, "lap_iter_cap": 0})
        Up, st_p = ga_gm(A, W, U0, ms, nu, return_steps=True, **{**pkw, "hung_iter_cap": 0})
        err_a = (Ua - Up).abs().max().item()
        worst_a = max(worst_a, err_a)
        check(bool(torch.isfinite(Ua).all()) and err_a <= GAGM_ANNEAL_ATOL,
              f"gagm main path {i}: annealed rounds differ from the plain version by {err_a} "
              f"(steps {st_k} vs {st_p})")
        # (b) one finale step from the kernel's annealed U
        out, st, V = ga_gm_fused(A, W, Ua, ms, nu, return_steps=True, return_power_step=True,
                                 **{**kw, "mgm_iter": 0, "lap_iter_cap": 1})
        check(st[-1] == 1 and sum(st) == 1, f"gagm main path {i}: one-step mode took {st}")
        Vp = ((A @ ((Ua @ Ua.T) @ A)) @ Ua * (kw["quad_weight"] * 2.0) + W @ Ua) / G
        # the kernel computes, and the projection reads, each graph's valid rows
        rows = (torch.arange(M, device=dev)[None, :] < ms[:, None]).reshape(T)
        vmax = Vp[rows].abs().max().item()
        err_v = (V - Vp)[rows].abs().max().item() / vmax
        worst_v = max(worst_v, err_v)
        check(err_v <= GAGM_V_RTOL, f"gagm main path {i}: power step differs by {err_v} of "
                                    f"its largest entry")
        Vg = V.reshape(G, M, nu)
        want = lap_slots_to_nodes(Vg, ms, lap_stats).reshape(T, nu)
        same = [bool(torch.equal(out.reshape(G, M, nu)[g], want.reshape(G, M, nu)[g]))
                for g in range(G)]
        check(all(same), f"gagm main path {i}: the kernel's LAP differs from the host LAP of "
                         f"its own V in graphs {[g for g, ok in enumerate(same) if not ok]}")
        plain = _project_blocks(Vg, ms.long(), nu, tau=1.0, sk_iter=0, exact_hungarian=True)
        differ_plain += sum(1 for g in range(G)
                            if not torch.equal(out.reshape(G, M, nu)[g], plain[g]))
        log(f"gagm main path input {i}: annealed rounds steps kernel {st_k[:-1]} plain "
            f"{st_p[:-1]}, max |U diff| {err_a:.3e} (atol {GAGM_ANNEAL_ATOL}); one finale "
            f"step: |V diff| {err_v:.3e} of max|V| {vmax:.3e} (bound {GAGM_V_RTOL}), LAP equal "
            f"to the host LAP of the kernel's V in all {G} graphs")
    search_steps = lap_stats["search_steps"] / (G * len(record))
    log(f"gagm main path: the host LAP of one finale step takes {search_steps:.1f} search steps "
        f"per graph (mean over {G * len(record)} graphs)")
    log(f"gagm main path: {len(record)} inputs held; the plain projection, which solves "
        f"ms <= universe graphs in the other orientation, picks another assignment of the "
        f"same V in {differ_plain} of {G * len(record)} graphs")
    return dict(ms_main=ms_k, plain_ms_main=plain_ms, bound_ms_main=b_ms, bound_by_main=b_by,
                steps_main=steps, clock_split_us=split, anneal_max_abs_err=worst_a,
                power_step_rel_err=worst_v, inputs_checked=len(record),
                plain_lap_differs_in_graphs=differ_plain, lap_search_steps_per_graph=search_steps,
                shape_main=f"A, W ({T}, {T}) f32, U0 ({T}, {nu}), ms {ms.tolist()}")


# -- phase 4: end to end -----------------------------------------------------------

def phase_e2e(torch, dev, size: int = 800, profile: bool = False, **model_kw):
    from ttdg_mgm_torch.build import build_model
    from ttdg_mgm_torch.engine.steps import make_tta_step
    from ttdg_mgm_torch.solver.build import build_optimizer
    from ttdg_mgm_torch.synth import synth_batch

    t0 = time.perf_counter()
    model = build_model(device=dev, seed=0, **model_kw)
    opt = build_optimizer(model, lambda _: TTA_LR)
    step = make_tta_step(model, opt)
    data = synth_batch(size, 4, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    log(f"e2e: R50-FPN {model_kw or 'flagship'} built in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M parameters, "
        f"batch {tuple(batch['image'].shape)}, TF32 off")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    step_ms, losses = [], []
    gagm_inputs, undo = capture_gagm()
    try:
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = float(step(batch))
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            mgm = model.multi_matching_unsup
            nodes = mgm.last_node_counts
            log(f"e2e TTA step {i}: loss {loss:.6f}, valid nodes per graph {nodes}, "
                f"solver steps {mgm.last_solver_steps}, {step_ms[-1]:.1f} ms")
            check(math.isfinite(loss) and loss > 0.0,
                  f"step {i}: loss {loss} is not finite and > 0")
            check(sum(1 for c in nodes if c > 0) >= 2,
                  f"step {i}: fewer than two graphs with nodes")
    finally:
        undo()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.forward_inference(batch["image"], batch["image_sizes"])
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_ms[1:])
    log(f"e2e: TTA step ms {[round(t, 1) for t in step_ms]} (first includes warm-up); "
        f"median after warm-up {steady:.1f} ms = {4e3 / steady:.2f} images/s; forward_inference "
        f"{infer_ms:.1f} ms; peak memory {peak_gb:.2f} GiB; launches {launches}")
    check(launches["roi_pool"] >= 1, "the ROI pool kernel was not launched on the main path")
    check(launches["gagm"] == 3, f"the GA-GM kernel was launched {launches['gagm']} times in "
                                 f"3 TTA steps, not once per step")

    D = model.detections_per_image
    shapes = {"boxes": (4, D, 4), "scores": (4, D), "classes": (4, D), "valid": (4, D),
              "mask_probs": (4, D, 28, 28)}
    for k, shp in shapes.items():
        check(tuple(out[k].shape) == shp, f"forward_inference {k}: shape {tuple(out[k].shape)}")
        if out[k].is_floating_point():
            check(bool(torch.isfinite(out[k]).all()), f"forward_inference {k}: non-finite")
    mp = out["mask_probs"]
    check(bool(((mp >= 0) & (mp <= 1)).all()), "mask_probs outside [0, 1]")
    n_valid = int(out["valid"].sum())
    check(n_valid > 0, "no valid detections")
    log(f"e2e: forward_inference ok, {n_valid} valid detections")
    if profile:
        profile_step(torch, step, batch, lambda: model.multi_matching_unsup.last_solver_steps)
    del model, opt, step, out
    torch.cuda.empty_cache()
    return dict(step_ms=step_ms, steady_ms=steady, images_per_s=4e3 / steady, losses=losses,
                infer_ms=infer_ms, peak_gib=peak_gb, launches=launches,
                gagm_inputs=gagm_inputs)


def profile_step(torch, step, batch, solver_steps, extra_steps: int = 5):
    """``--profile``: ``extra_steps`` more timed TTA steps, then one step
    under ``torch.profiler``."""
    times = []
    for _ in range(extra_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"profile: {extra_steps} more TTA steps, ms {[round(t, 1) for t in times]}")
    return profile_call(torch, lambda: step(batch), "TTA step",
                        lambda: f", solver steps {solver_steps()}")


def profile_call(torch, fn, what: str, extra=lambda: "", top: int = 25):
    """One call of ``fn`` under ``torch.profiler``: device time by kernel and
    the device's busy share of the call's wall time (one stream, so kernels
    do not overlap).  Returns ``(wall ms, {kernel name: device ms})``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)

    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA" and dev_us(e) > 0]
    busy = sum(dev_us(e) for e in events) / 1e3
    log(f"profile: one {what} under the profiler, wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100.0 * busy / wall:.1f} %), {len(events)} distinct kernels{extra()}")
    ranked = sorted(events, key=lambda e: -dev_us(e))
    for e in ranked[:top] + [e for e in ranked[top:] if kernel_class(e.key) == "port kernels"]:
        log(f"profile:   {dev_us(e) / 1e3:9.3f} ms {e.count:6d} x  {e.key[:100]}")
    by_class = {}
    for e in events:
        c = kernel_class(e.key)
        by_class[c] = by_class.get(c, 0.0) + dev_us(e) / 1e3
    log("profile: device time by class: " + ", ".join(
        f"{c} {ms:.1f} ms" for c, ms in sorted(by_class.items(), key=lambda kv: -kv[1])))
    return wall, {e.key: dev_us(e) / 1e3 for e in events}


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel, by its name."""
    if any(k in name for k in ("roi_pool_kernel", "roi_pool_backward_kernel", "gagm_kernel",
                               "sinkhorn_kernel", "roi_geometry_kernel")):
        return "port kernels"
    if any(k in name for k in ("cudnn", "fft", "fprop", "dgrad", "wgrad", "winograd", "cf32",
                               "DSE::", "conv")):
        return "convolutions (cuDNN)"
    if "gemm" in name or "gemv" in name:
        return "matrix products"
    return "elementwise, reductions, copies, other"


def phase_small_reference(torch, dev):
    """A narrow model (flagship topology, small widths) with the same seeded
    weights on the GPU (kernels) and on the CPU (plain versions): the FPN
    features (tests/test_detector_parity.py tolerance, atol 1e-2 rtol 1e-3)
    and the 7x7 and 14x14 pools of the model at the CPU's proposal boxes
    (the same tolerance: features carry it); then ``loss_supervised`` on a
    labelled batch, both sides fed the same sampling uniforms, the CPU's
    proposals and the CPU's HiPPI target (both discrete: near-ties in the
    RPN scores and HiPPI's hard assignment follow float32 round-off; HiPPI's
    kernel path is held in phases 6 and 7): each loss within rtol 1e-3, and
    each parameter's gradient within 1e-2 of its largest value plus 1e-6 of
    the largest of any leaf (convolution algorithms, the backward kernel's
    atomics, and ReLUs whose input lies within round-off of 0 move the
    gradients of the layers before them)."""
    from ttdg_mgm_torch.build import build_model
    from ttdg_mgm_torch.synth import synth_batch

    kw = dict(resnet_width=64, fpn_channels=64, box_fc_dim=128, mask_conv_dim=64,
              pre_nms_topk_test=200, post_nms_topk=100, detections_per_image=16,
              pre_nms_topk_train=200, batch_size_per_image=64, mask_fg_cap=16, hippi_iters=10)
    cpu = build_model(device="cpu", seed=3, **kw)
    gpu = build_model(device=dev, seed=3, **kw)
    data = synth_batch(160, 2, seed=5, with_gt=True, mask_res=64)
    imgs, sizes = torch.from_numpy(data["image"]), torch.from_numpy(data["image_sizes"])
    with torch.no_grad():
        fc = cpu.extract_features(imgs)
        fg = gpu.extract_features(imgs.to(dev))
        worst = 0.0
        for k in fc:
            a, b = fg[k].cpu(), fc[k]
            check(torch.allclose(a, b, atol=1e-2, rtol=1e-3), f"small reference: {k} differs")
            worst = max(worst, (a - b).abs().max().item())
        nchw = {k: v.permute(0, 3, 1, 2) for k, v in fc.items()}
        _, (boxes, _, _) = cpu._proposals(nchw, sizes)
        for P in (7, 14):
            pc = cpu._pool(fc, boxes, P)
            pg = gpu._pool(fg, boxes.to(dev), P).cpu()
            check(torch.allclose(pg, pc, atol=1e-2, rtol=1e-3), f"small reference: pool P={P}")
            worst = max(worst, (pg - pc).abs().max().item())
    log(f"small reference (GPU kernels vs CPU plain, 2 x 160 px): features and pools agree, "
        f"max abs diff {worst:.3e} (atol 1e-2, rtol 1e-3)")
    n_anchors = 3 * sum(f.shape[1] * f.shape[2] for f in fc.values())
    small_reference_source(torch, dev, cpu, gpu, data, n_anchors)


def small_reference_source(torch, dev, cpu, gpu, data, n_anchors: int):
    import ttdg_mgm_torch.graph.universe as universe
    from ttdg_mgm_torch.solver.build import trainable_mask

    gen = torch.Generator().manual_seed(4)
    B = data["image"].shape[0]
    uniforms = {"rpn": torch.rand((B, n_anchors), generator=gen),
                "roi": torch.rand((B, cpu.post_nms_topk + data["gt_boxes"].shape[1]),
                                  generator=gen)}
    captured = {}
    real_hippi, real_proposals = universe.hippi, cpu._proposals

    def cpu_hippi(*a, **k):
        captured["hippi"] = real_hippi(*a, **k)
        return captured["hippi"]

    def cpu_props(*a, **k):
        out = real_proposals(*a, **k)
        captured["props"] = out[1]
        return out

    def gpu_props(nchw, sizes, *, train=False, real=gpu._proposals):
        rpn, _ = real(nchw, sizes, train=train)
        return rpn, tuple(t.to(dev) for t in captured["props"])

    results = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        mask = trainable_mask(model)
        for n, p in model.named_parameters():
            p.requires_grad_(mask[n])
        b = {k: torch.from_numpy(v).to(d) for k, v in data.items()}
        universe.hippi = cpu_hippi if name == "cpu" else (
            lambda *a, **k: tuple(t.to(dev) if torch.is_tensor(t) else t
                                  for t in captured["hippi"]))
        model._proposals = cpu_props if name == "cpu" else gpu_props
        try:
            losses = model.loss_supervised(b["image"], b["image_sizes"], b["gt_boxes"],
                                           b["gt_classes"], b["gt_masks"], b["gt_valid"],
                                           uniforms={k: v.to(d) for k, v in uniforms.items()})
            sum(losses.values()).backward()
        finally:
            universe.hippi = real_hippi
            del model._proposals
        results[name] = ({k: float(v.detach()) for k, v in losses.items()},
                         {n: p.grad.cpu() for n, p in model.named_parameters()
                          if p.grad is not None})
    (lc, gc), (lg, gg) = results["cpu"], results["gpu"]
    for k, v in lc.items():
        check(math.isfinite(lg[k]) and abs(lg[k] - v) <= 1e-3 * abs(v),
              f"small reference: {k} GPU {lg[k]} CPU {v}")
    check(set(gc) == set(gg) and len(gc) > 40, "small reference: gradient sets differ")
    floor = 1e-6 * max(g.abs().max().item() for g in gc.values())
    worst = 0.0
    for n, g in gc.items():
        err = (gg[n] - g).abs().max().item()
        scale = g.abs().max().item()
        check(err <= 1e-2 * scale + floor, f"small reference: gradient of {n}: {err} vs {scale}")
        worst = max(worst, err / (scale + floor))
    log(f"small reference loss_supervised: losses agree (rtol 1e-3): "
        + ", ".join(f"{k} {lg[k]:.6f}/{lc[k]:.6f}" for k in lc)
        + f"; {len(gc)} parameter gradients agree, worst {worst:.2e} of the leaf's largest "
        f"(bound 1e-2)")


# -- --warm: does the GA-GM finale converge on a trained detector? ------------------

def phase_warm(torch, dev, warm_steps: int = 120, warm_size: int = 320, tta_steps: int = 3):
    """``bench.py:warm_params``'s recipe on a fresh flagship model, then TTA
    steps at 800 px, batch 4: GA-GM power steps per round, and kernel B's
    share of one profiled TTA step."""
    from ttdg_mgm_torch.engine.steps import make_tta_step
    from ttdg_mgm_torch.solver.build import build_optimizer
    from ttdg_mgm_torch.synth import synth_batch

    model, step, _ = source_setup(torch, dev, warm_size, 4, 0, mask_res=128)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    for it in range(warm_steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in
                 synth_batch(warm_size, 4, seed=it, with_gt=True, mask_res=128).items()}
        m = step(batch, gen)
        if it % 20 == 19 or it == warm_steps - 1:
            lv = float(m["total_loss"])
            log(f"warm: source step {it + 1}/{warm_steps} total_loss {lv:.4f} "
                + ", ".join(f"{k} {float(v):.4f}" for k, v in m.items() if k != "total_loss")
                + f" ({time.perf_counter() - t0:.1f} s)")
            check(math.isfinite(lv), f"warm: source training diverged at step {it}")
    opt = build_optimizer(model, lambda _: TTA_LR)
    tta = make_tta_step(model, opt)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(800, 4, seed=0).items()}
    rounds = []
    for i in range(tta_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(tta(batch))
        torch.cuda.synchronize()
        mgm = model.multi_matching_unsup
        rounds.append(mgm.last_solver_steps)
        log(f"warm: TTA step {i}: loss {loss:.6f}, valid nodes per graph {mgm.last_node_counts}, "
            f"GA-GM power steps per round {mgm.last_solver_steps}, "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    wall, by_kernel = profile_call(
        torch, lambda: tta(batch), "warmed TTA step",
        lambda: f", GA-GM power steps per round {model.multi_matching_unsup.last_solver_steps}")
    rounds.append(model.multi_matching_unsup.last_solver_steps)
    gagm_ms = sum(v for k, v in by_kernel.items() if "gagm" in k)
    converged = all(r[-1] < 200 for r in rounds)
    log(f"warm: the LAP finale {'converges' if converged else 'does not converge'} "
        f"(finale steps {[r[-1] for r in rounds]} of a 200 cap); kernel B {gagm_ms:.1f} ms = "
        f"{100.0 * gagm_ms / wall:.1f} % of the profiled step's {wall:.1f} ms wall")
    del model, step, tta, opt
    torch.cuda.empty_cache()


# -- main ---------------------------------------------------------------------------

def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ttdg_mgm_torch", "csrc")):
        print("chip_smoke: ttdg_mgm_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", "0"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    check(smi.returncode == 0 and card != "", f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    from ttdg_mgm_torch.ops import _cuda

    t0 = time.perf_counter()
    _cuda.lib()
    log(f"kernels built from ttdg_mgm_torch/csrc in {_cuda.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s)")

    profile = "--profile" in sys.argv[1:]
    dump_dir = None
    if "--dump-dir" in sys.argv[1:]:
        dump_dir = sys.argv[sys.argv.index("--dump-dir") + 1]
    roi = phase_roi_pool(torch, dev, profile=profile)
    gagm = phase_gagm(torch, dev)
    e2e = phase_e2e(torch, dev, profile=profile)
    gagm_main = phase_gagm_main(torch, dev, e2e.pop("gagm_inputs"), dump_dir=dump_dir)
    phase_small_reference(torch, dev)
    roi_bwd, roi_train = phase_roi_backward(torch, dev)
    src = phase_source(torch, dev, profile=profile)
    sk = phase_sinkhorn(torch, dev, src.pop("hippi"))
    if "--warm" in sys.argv[1:]:
        phase_warm(torch, dev)

    box, mask, g4 = roi["box"], roi["mask"], gagm["G4_M60"]
    bbox, bmask = roi_bwd["box"], roi_bwd["mask"]
    by_path = {k: {"tta": e2e["launches"][k], "source": src["launches"][k]}
               for k in e2e["launches"]}
    kernels = [
        dict(name="roi_pool", route="cuda", source="ttdg_mgm_torch/csrc/roi_pool.cu",
             replaces="ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py:113",
             launches=e2e["launches"]["roi_pool"], launches_by_path=by_path["roi_pool"],
             max_abs_err=max(r["max_abs_err"] for r in (box, mask, *roi_train.values())),
             ms=box["ms"], plain_ms=box["plain_ms"], bound_ms=box["bound_ms"],
             bound_by=box["bound_by"], library_ms=None, shape=box["shape"],
             kernel_only_ms=box["kernel_only_ms"], args_ms=box["args_ms"],
             geometry_ulps=max(r["geometry_ulps"] for r in (box, mask, *roi_train.values())),
             mask_pool={k: mask[k] for k in ("ms", "kernel_only_ms", "args_ms", "plain_ms",
                                             "bound_ms", "bound_by", "max_abs_err", "shape")},
             train_pools=roi_train),
        dict(name="gagm", route="cuda", source="ttdg_mgm_torch/csrc/gagm.cu",
             replaces="ttdg_mgm_tpu/ops/pallas/gagm_pallas.py:53",
             launches=e2e["launches"]["gagm"], launches_by_path=by_path["gagm"],
             max_abs_err=max(r["max_abs_err"] for r in gagm.values()),
             ms=g4["ms"], plain_ms=g4["plain_ms"], bound_ms=g4["bound_ms"],
             bound_by=g4["bound_by"], library_ms=None, shape=g4["shape"],
             steps=g4["steps"], **gagm_main,
             other_cases={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "steps")}
                          for k, v in gagm.items() if k != "G4_M60"}),
        dict(name="roi_pool_backward", route="cuda",
             source="ttdg_mgm_torch/csrc/roi_pool_backward.cu",
             replaces="ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py:350",
             launches=src["launches"]["roi_pool_backward"],
             launches_by_path=by_path["roi_pool_backward"],
             max_abs_err=max(bbox["max_abs_err"], bmask["max_abs_err"]),
             ms=bbox["ms"], plain_ms=bbox["plain_ms"], bound_ms=bbox["bound_ms"],
             bound_by=bbox["bound_by"], library_ms=None, shape=bbox["shape"],
             design_bytes_ms=bbox["design_bytes_ms"], kernel_only_ms=bbox["kernel_only_ms"],
             args_ms=bbox["args_ms"],
             mask_pool={k: bmask[k] for k in ("ms", "kernel_only_ms", "args_ms", "plain_ms",
                                              "bound_ms", "bound_by",
                                              "design_bytes_ms", "max_abs_err", "shape")}),
        dict(name="sinkhorn", route="cuda", source="ttdg_mgm_torch/csrc/sinkhorn.cu",
             replaces="ttdg_mgm_tpu/ops/pallas/sinkhorn_pallas.py:31",
             launches=src["launches"]["sinkhorn"], launches_by_path=by_path["sinkhorn"],
             max_abs_err=sk["max_abs_err"], ms=sk["ms"], plain_ms=sk["plain_ms"],
             bound_ms=sk["bound_ms"], bound_by=sk["bound_by"], library_ms=None,
             shape=sk["shape"], projections_checked=sk["projections_checked"],
             hippi_rerun=sk["hippi_rerun"]),
    ]
    e2e_line = {k: e2e[k] for k in ("step_ms", "steady_ms", "images_per_s", "losses",
                                    "infer_ms", "peak_gib")}
    log(f"e2e summary: {json.dumps(e2e_line)}")
    src_line = {k: src[k] for k in ("batch", "step_ms", "steady_ms", "images_per_s", "total_loss",
                                    "peak_gib")}
    log(f"source summary: {json.dumps(src_line)}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                          "kind": torch.cuda.get_device_name(0),
                                          "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
