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
   from the bare kernel's; then all of it again on the rectangular levels of
   the 832 x 1216 canvas a Drishti-GS image pads onto at the test geometry
   (p2 208 x 304 down to p5 26 x 38), the ROIs stretched onto it; then both
   canvases again on the same draws rounded to bfloat16: kernel A's bf16
   variant (the bf16 compute policy) against its plain bf16 version, within
   1 bf16 ulp of the plain value or ``BF16_ATOL``, with its times and its
   bound at 2 bytes per feature and output value;
3. the fused GA-GM kernel (``csrc/gagm.cu``) against its plain version on
   planted problems at the flagship size (4 graphs of 60 nodes, a 32-slot
   universe), one with 2 graphs, one with every graph at or below the
   universe size;
4. the eval-only TTA path end to end: the flagship R50-FPN Mask R-CNN at
   full width with seeded random weights, 3 TTA steps and one
   ``forward_inference`` on 4 synthetic 800x800 images, in float32 and in
   bf16 (every parameter and gradient checked float32, the dtypes reaching
   kernel B logged), with the kernels' launch counters (float32 and bf16
   variants apart) read around it, keeping a copy of every input the TTA
   steps give the GA-GM solver; then kernel B on those inputs: its time by
   CUDA events, its steps per round and its bound from them, the in-kernel
   clock split of an annealed and of a finale step, and the checks that are
   well-posed although the unconverged finale is chaotic (the annealed
   rounds against the plain version, or, where a round runs to its cap
   unconverged and as chaotic, the rounds before it and one annealed step
   from the kernel's own U; one finale step: the power step against the
   plain one, and the 0/1 output against the host LAP of the kernel's own
   power step, bit for bit, graph 0 against its pin to the identity in the
   2-graph case); then a narrow copy of the model on
   the GPU and on the CPU (plain versions) compared on a small input;
5. the training pools at the flagship training shapes: levels of 8 images
   at 800 px, 256 channels; the box pool's 8 x 512 ROIs at P=7 and the mask
   pool's 8 x 128 at P=14, clustered around two boxes per image as sampled
   training ROIs are; the ROI pool kernel (forward) and the backward kernel
   (``csrc/roi_pool_backward.cu``) each against its plain version; the
   backward's device plan (each ROI's level and pixel footprint) against
   ``ops/roi_align.py:roi_footprints``, two backward launches bit for bit,
   and its bare launch into NaN-filled gradients (every element written);
   then all of it again on the same draws rounded to bfloat16 (kernels A
   and C's bf16 variants against their plain bf16 versions, kernel C's
   within 1 bf16 ulp or the smaller of ``BF16_BWD_ATOL`` and ``BWD_REL``
   of each level's largest value; bounds at 2 bytes per value); kernel C's
   absolute tolerance is at most ``BWD_REL`` of each level's largest
   value in float32 too, as on the source step's own small gradients;
6. source training end to end: the flagship at full width in float32 and
   in bf16 (kernels A and C's bf16 variants; the dtypes reaching kernel D
   logged), 5 ``make_source_step`` steps on 8 synthetic 800x800 disc images with GT
   (masks on a 256 canvas), the source solver (lr 0.0025) with the
   global-norm clip 1.0 and warm-up of ``bench.py:warm_params``, the launch
   counters of kernels A, C and D read around every step; a copy of the
   inputs of every HiPPI call and of every projection it makes is kept
   (device copies of a few hundred kB per projection); the narrow
   GPU-vs-CPU comparison of phase 4 also holds ``loss_supervised`` and its
   parameter gradients; then one more, untimed, step keeping the inputs
   kernel C gets there, and on them kernel C against its plain version, two
   launches bit for bit, its times, and what the data asks of it (ROIs per
   level, ROIs with an all-zero cotangent, the most ROIs on one tile);
7. the batched Sinkhorn kernel (``csrc/sinkhorn.cu``) against its plain
   version on every projection input HiPPI gave it in phase 6 (16 matrices
   of 60 x 60, tau 1/200 over the overflow guard's c, 20 iterations), timed
   on the first with its bound (bytes, float32 operations, transcendentals
   at the special-function rate) and the floor of its dependent chain; the
   HiPPI call that took the most iterations rerun with the plain projection;
   one synthetic batch with mixed valid counts on both of the kernel's
   paths (registers up to 64 x 64, shared memory beyond), and one of 100 x
   70 matrices;
8. the command line as a user runs the paper's method:
   ``train_net_torch.main(["--eval-only", "--config",
   "configs/test_segment.yaml", ...])`` in process, on a synthetic
   Drishti-GS test split written in the reference's layout (8 fundus-like
   PNG images of 800 x 1192 with disc and cup, RLE ground truth) with the
   flagship's seeded random weights saved as a d2 checkpoint, float32,
   ``TEST.DICE_THRES 0.0``: two TTA steps and the evaluation at batch 4 on
   the 832 x 1216 canvas; kernel counters read around the call; it fails
   unless ``result_ap.txt`` holds the split and its family mean, Dice, E and
   S are finite, a TTA loss is above 0, kernels A, B and the paste
   launched, and neither Pillow, OpenCV nor PyYAML was imported; with
   ``TEST.DRAW True``
   it holds the visualizer's dumps (one ``visual`` and one
   ``masks`` PNG per image at its size, read by the port's decoder; the
   masks the union of the image's pasted masks; the boxes equal to
   ``draw_detections`` re-run on the same detections) and logs their host
   seconds per image; it logs each TTA step's
   time, the evaluation's data, inference and evaluation seconds per image
   and the peak device memory; then the same command with no precision
   override (bf16, the config's default) on 2 fundus-like PNG images of
   2896 x 1944 (Drishti-GS's size: resized by the loader, scored at that
   size) with polygon ground truth and on a BKAI split of the 3 committed
   baseline 4:2:0 JPEGs of 1280 x 959 (``tests/fixtures/torch_jpeg``), with
   the host's decode and resize seconds per image;
9. determinism, in both precisions: two runs of 5 TTA steps and two of 5
   source steps from one saved state give bitwise-equal parameters and
   gradients under cuDNN's deterministic algorithms (what the entry points
   set, ``ttdg_mgm_torch.configure_torch``); the same runs under cuDNN's
   default algorithms report what differs first; then one run of 62 steps
   with the two settings alternated step by step gives the step-time cost
   of determinism (the median of 30 steps each, with quartiles);
10. source training through the command line, as a user trains the
   detector: ``train_net_torch.main(["--config",
   "configs/seg_res50fpn_source.yaml", ...])`` with the shipped config as
   it stands (R50-FPN, batch 8, bf16 by ``SOLVER.AMP.ENABLED``, the square
   800 canvas) and random weights, on synthetic splits of its
   ``DATASETS.TRAIN`` with polygon ground truth (the 3 committed JPEGs, 4
   uncompressed TIFF frames of 384 x 288, 3 LZW TIFF frames of 1225 x 966
   with the horizontal predictor, as the datasets ship them; the pixels
   are the PNG frames' of earlier versions) and a ``BKAI_test`` split for
   the validation loss: 4 steps (checkpoints and validation every 2), the
   same command to 6 steps resumed at step 4 bit for bit, the same again
   from a copy holding only the step-4 checkpoint whose final checkpoint
   equals the second call's bit for bit, and ``--eval-only`` with
   ``configs/test_segment.yaml`` on that final file (every tensor loaded,
   finite Dice, E and S); kernels A, C and D held against their plain
   versions on the first step's inputs, A and B on the eval call's
   (``hold_call_kernels``); each call fails unless every loss is finite, the
   checkpoints, ``metrics.json`` lines and validation losses are where
   they belong, kernels A and C (bf16) and D launched on every step, and
   neither Pillow, OpenCV nor PyYAML was imported; it logs per step the
   loader wait and the synchronized step time, s/iter, the validation
   loss's seconds, the checkpoint's size and its save and load seconds,
   the peak memory and the launches per step, and the train loader's own
   host time per batch on one thread, against the step time;
11. the mean-teacher trainer through the command line:
   ``train_net_torch.main(["--config", "configs/seg_res50fpn_MT.yaml",
   ...])`` with the shipped config (R50-FPN, batch 4 labelled + 4
   unlabelled, bf16, ``EMA_KEEP_RATE`` 0.9996, the discriminator on p2) and
   random weights on synthetic ``RIM_ONE_r3_train`` (labelled) and
   ``REFUGE_train`` (unlabelled) splits with polygon ground truth, with
   ``SEMISUPNET.BURN_UP_STEP 2`` and ``SEMISUPNET.BBOX_THRESHOLD 0.3``
   (each printed with its reason): 4 steps (2 burn-in, the teacher's copy
   at step 2 equal to the student bit for bit, the moving average at step
   3 equal to the host's within float32 round-off), resumed to 6 from the
   ensemble-layout file bit for bit (the restart from a copy of the step-4
   file is phase 12's), then ``--eval-only --config
   configs/test_segment_MT.yaml`` on the final file twice: the teacher
   (``TEST.EVAL_STU False``) and the student (the shipped ``True``), every
   tensor of the member loaded, kernel B launched, finite Dice, E and S,
   kernels A and B held on the first of these calls' inputs and A, C and D
   on the first MT step's;
   every MT loss finite, every parameter and gradient float32, on every MT
   step the teacher's forward-only pool and the training pools called and
   kernels A, C and D launched; it logs the steps' times, one MT step's
   split between the teacher's detection and the labelled, pseudo-labelled
   and domain passes, the pseudo-boxes per image, the launches per step,
   the peak memory and the two-crop loader's host time per batch (16
   views and the NumPy strong augmentation) on one thread;
12. the mean-teacher trainer with its cross-domain graph-matching head:
   phase 11's command and splits with ``SEMISUPNET.CROSS_DOMAIN_MATCHING
   True`` (printed with its reason): 4 steps (2 burn-in, 2 MT steps with
   the head's three losses, finite and printed; the class centers zero at
   step 2, threaded to step 3, step 3's equal to the moving average
   recomputed on the host; kernels A, C and D held against their plain
   versions on its MT steps' inputs), resumed to 6 bit for bit with the
   centers restarting at zero (not checkpointed, as in the JAX package),
   the same from a copy holding only the step-4 file ending in the same
   bits, then ``--eval-only --config configs/test_segment_MT.yaml`` on the
   final file (the student with its head loaded, kernel B launched, finite
   Dice, E and S); it logs the MT step's times and its split with the
   cross-domain pass as a fifth, the peak memory, the checkpoint's size and
   the final teacher's pseudo-labels against the unlabelled split's ground
   truth (``engine/probe.py``);
13. the VGG16-BN family (``MODEL.BACKBONE.NAME build_vgg_backbone``) at
   full width, its trunk float32 under the configs' bf16 policy as in the
   JAX package (``phase_vgg``): phase 10's calls with the override (4 steps
   resumed to 6 bit for bit, the restart from the step-4 copy,
   ``--eval-only`` on the final file); phase 11's calls with the override
   (the split by pass, resumed to 6, the student evaluated); and the
   legacy datasets through ``register_all_legacy`` on
   trees it writes: a VGG model with 8 classes trained 2 steps on foggy
   Cityscapes (2048 x 1024 frames, the 8 thing classes, a crowd region) and
   scored on its val split by the COCO evaluator (box and mask AP), and a
   box-only VGG model with 20 classes adapted (a TTA step without a mask
   head) and scored on Clipart1k (the committed JPEGs in VOC layout) by the
   VOC evaluator; A (bf16), C (bf16) and D launched on every VGG training
   step, B on every adaptation, no Pillow, OpenCV or PyYAML; on each of
   these paths, every kernel it launches held against its plain version on
   the path's own inputs (A, C and D on the first training step's, A and B
   on the adaptation's and the inference's); then the float32
   trunk's forward and backward timed against the same under autocast bf16,
   and the legacy test batches' peak memory split by pass;
14. data parallelism (``phase_dp``): phase 10's command at world size 1
   over NCCL, and two gloo ranks spawned on the one card taking source,
   TTA and MT-with-head steps on their shards, every kernel held on rank
   0's inputs;
15. the last slice: MGM-Mixture's TTA step (``phase_mixture``: the
   flagship at full width with ``multi_matching_unsup.num_clusters`` 2, 4
   images at 800 px, 2 steps in float32 and in bf16; a finite loss, a
   nonzero backbone gradient, kernel A launched and kernel B twice a step
   for the two passes' annealed rounds; kernel A held on the first step's
   box pool; each step's solve against the CPU's on its own inputs by
   ``hold_mixture``: the annealed rounds as phase 4 holds them, the LAP
   projections bit for bit, the affinity, the partition), then the long tail on CUDA tensors against the CPU
   (``phase_long_tail``: ``HyperGraphBlock`` at 248 nodes of 256 channels,
   spectral clustering on 4 x 4 and 8 x 8 affinities, the matching losses'
   values and gradients, ``gumbel_sinkhorn`` on given uniforms,
   ``sinkhorn_auto`` on mixed orientations);
16. the image formats the datasets ship (``phase_formats``):
   ``train_net_torch.main(["--eval-only", "--config",
   "configs/test_segment.yaml", ...])`` as shipped (bf16, batch 4) with
   ``TEST.DICE_THRES 0.0`` on ``ETIS_LaribPolypDB_test`` (2 LZW TIFF frames
   of 1225 x 966, written here) and ``Kvasir_SEG_test`` (2 committed
   progressive JPEGs of 720 x 576), finite Dice, E and S, kernels A (bf16)
   and B launched and held on the call's own inputs; every file of the
   splits, an uncompressed TIFF and a BMP of the first frame and the
   committed CMYK and 4:1:1 JPEGs decoded against the committed digests of
   Pillow's decode, each format's decode seconds per image logged;
17. the mask paste (``phase_paste``, ``csrc/mask_paste.cu``) at the TTA
   cell's shape (100 masks of 28 x 28 on 800 x 800): bit for bit the JAX
   package's NumPy paste on float32 and bfloat16 probabilities and at a
   width of 1944, one launch a call, its time against its bound (the bytes
   it writes) and against the plain version's;
18. kernel F (``phase_vit_attention``, ``csrc/vit_attention.cu``), the
   ViTDet attention with decomposed relative positions, at the ViTDet-B
   cell's shapes (windows of 196 tokens, the global 4,096): forward and
   backward against the plain version, bit for bit over two runs, three
   launches, the global shape's memory against one score matrix, and the
   forward's (wrapper's and bare launch's) and backward's times against
   their bounds, beside the plain version's and PyTorch's
   ``scaled_dot_product_attention`` with the bias as a mask.

TF32 is off for convolutions and matrix products throughout (parity
setting; the end-to-end times are taken with it off), and cuDNN runs its
deterministic algorithms (``configure_torch``) except where phase 9 turns
them off.  Bounds use the H100
SXM's published peaks: 3.35 TB/s of device memory, 67 TFLOP/s float32
outside the tensor cores, 16 transcendentals per clock per SM (4.18e12/s at
1.98 GHz).  The last lines are the card's name and power
limit (nvidia-smi), one JSON object with each kernel's numbers (its
launches on the TTA, source, eval-only command-line, train command-line,
mean-teacher and cross-domain mean-teacher command-line paths, the VGG
paths of phase 13, the DP paths of phase 14, the mixture's TTA steps of
phase 15 and the eval-only call of phase 16 under ``launches_by_path``;
the paste's launches are the eval-only command line's; the holds on the
command-line paths' own inputs under ``held_on_paths``), and the
device line ``{"ok": true, "device":
{...}}``.

``--profile`` adds, after each end-to-end phase, more timed steps and one
step under ``torch.profiler`` (device time by kernel, device busy share):
five TTA steps, and one source step.

``--dump-dir DIR`` saves the GA-GM inputs of the TTA steps to
``DIR/gagm_inputs.pt`` and HiPPI's first projection input to
``DIR/sinkhorn_input.pt`` and kernel C's inputs of one source step to
``DIR/pool_backward_inputs.pt`` (for ``scripts/time_kernels.py
--gagm-input``, ``--sinkhorn-input`` and ``--pool-input``).

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
import zlib

HERE = os.path.dirname(os.path.abspath(__file__))
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
# the special-function unit (exp, log): 16 per clock per SM, 132 SMs at the
# 1.98 GHz boost clock
SM_CLOCK_HZ = 1.98e9
PEAK_SFU_PER_S = 16 * 132 * SM_CLOCK_HZ
# one warp shuffle's latency, cycles (scripts/warp_latency.cu on the H100)
SHUFFLE_CYCLES = 32.3
ROI_TOL = dict(atol=2e-5, rtol=1e-4)
# the backward merges each pixel's sample weights and sums in ROI order, the
# plain version adds corner by corner (tests/test_pallas.py:253-255 bound for
# the windowed backward)
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
PRECISIONS = ("float32", "bfloat16")
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


def bound(bytes_: float, flops: float, sfu_ops: float = 0.0):
    """The least time for ``bytes_`` of device memory, ``flops`` float32
    operations and ``sfu_ops`` transcendentals (exp, log) on the
    special-function unit, which runs beside the float32 pipes: ``(ms, "bytes"
    or "operations")``."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOP_PER_S, sfu_ops / PEAK_SFU_PER_S) * 1e3
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


def roi_pool_work(torch, feats, rois, P: int, elem: int = 4):
    """Bytes and float operations this ROI pool needs on these inputs: each
    feature row (one pixel's C values of ``elem`` bytes) that some valid
    bilinear corner reads, read once; the output written once; 10 operations
    per valid sample and channel (4 corner FMAs, the weighted accumulate)."""
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
    out_bytes = B * K * P * P * C * elem
    return touched * C * elem + out_bytes + rois.numel() * 4, 10.0 * pairs * C


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
    or the backward's cotangent; the backward's bare launch (its plan kernel
    and its gather kernel) writes every element of ``feats_or_grads`` anew
    each time.  Returns ``(args_ms, kernel_only_ms)``."""
    from ttdg_mgm_torch.ops import _cuda
    from ttdg_mgm_torch.ops import roi_pool as rp

    name = "multilevel_roi_pool_backward" if backward else "multilevel_roi_pool"
    make = lambda: rp._kernel_args(name, feats_or_grads, shapes, rois, C, P,  # noqa: E731
                                   (4, 8, 16, 32), 0, 2)
    args_ms = event_ms(torch, make, 20)
    args = make()
    if backward:
        fn = _cuda.lib().ttdg_roi_pool_backward
        plan = torch.empty((rois.shape[0] * rois.shape[1], rp.plan_words(P, 0)),
                           dtype=torch.int32, device=rois.device)
        args.append(plan.data_ptr())
    else:
        fn = _cuda.lib().ttdg_roi_pool
    stream = _cuda.stream_ptr(rois.device)

    def launch():
        _cuda.check(fn(*args, other.data_ptr(), stream), name)

    return args_ms, event_ms(torch, launch, 20)


def check_roi_footprints(torch, rois, shapes, P: int, what: str):
    """Kernel C's plan (each ROI's level and pixel footprint, computed on the
    card) against its plain version ``ops/roi_align.py:roi_footprints`` on
    the same ROIs: equal."""
    from ttdg_mgm_torch.ops.roi_align import roi_footprints
    from ttdg_mgm_torch.ops.roi_pool import roi_footprints_device

    flat = rois.reshape(-1, 4)
    got = roi_footprints_device(flat, shapes, output_size=P)
    want = roi_footprints(flat, shapes, output_size=P)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
    level, y0, y1, x0, x1 = want
    side = ((y1 - y0 + 1).clamp(min=0) * (x1 - x0 + 1).clamp(min=0)).float().sqrt().mean()
    log(f"{what}: device footprints of {flat.shape[0]} ROIs "
        f"{'equal' if same else 'DIFFER FROM'} roi_footprints (mean side {side.item():.1f} px, "
        f"ROIs per level {torch.bincount(level.long(), minlength=len(shapes)).tolist()})")
    check(same, f"{what}: device footprints differ from roi_footprints")


def phase_roi_pool(torch, dev, B: int = 4, S: int = 800, C: int = 256,
                   box_rois: int = 1000, mask_rois: int = 100, profile: bool = False,
                   rect=(832, 1216), dtype: str = "float32"):
    """The pools on the square ``S`` canvas, then on the rectangular canvas
    ``rect`` (``(832, 1216)``: a Drishti-GS image at the test geometry), its
    ROIs the square's stretched onto it (results ``box_832x1216``, ...), on
    levels of ``dtype``: ``"bfloat16"`` rounds the same draws and holds
    kernel A's bf16 variant to its plain bf16 version."""
    gen = torch.Generator().manual_seed(1)
    dt = getattr(torch, dtype)
    res = {}
    for (Hc, Wc), tag in (((S, S), ""), (tuple(rect), f"_{rect[0]}x{rect[1]}")):
        feats = [torch.randn((B, Hc // s, Wc // s, C), generator=gen).to(dev).to(dt)
                 for s in (4, 8, 16, 32)]
        res.update(roi_pool_canvas(torch, dev, feats, gen, B, max(Hc, Wc), box_rois, mask_rois,
                                   tag, profile and not tag))
        del feats
        torch.cuda.empty_cache()
    return res


# bf16 outputs of kernel and plain version are each one rounding of float32
# sums taken in other orders: they agree within 1 bf16 ulp of the plain value
# (2**-8 to 2**-7 of it), or within an absolute floor where a value near zero
# makes the sums' float32 order differences larger than its ulp.  The pool
# sums up to 64 products of |f| < 6 (BF16_ATOL); the backward sums over every
# ROI that reaches a pixel (BF16_BWD_ATOL).
BF16_ATOL = 1e-5
BF16_BWD_ATOL = 1e-4
# The backward's absolute floor, in both dtypes, is at most BWD_REL of the
# level's largest plain value, so that the source step's gradients of about
# 1e-6 are held as tightly as unit-scale ones (a kernel that wrote zeros
# fails at the largest)
BWD_REL = 1e-3


def bf16_agreement(torch, got, want, atol: float):
    """``(max_abs_err, values beyond 1 ulp of want, values beyond 1 ulp +
    atol)`` of two bf16 tensors."""
    d = (got.float() - want.float()).abs()
    a = want.float().abs().clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return d.max().item(), int((d > ulp).sum()), int((d > ulp + atol).sum())


def pool_tolerance(bf16: bool, backward: bool = False) -> str:
    atol = BF16_BWD_ATOL if bf16 else ROI_BWD_TOL["atol"]
    floor = (f"min({atol}, {BWD_REL} x the level's largest |plain value|)" if backward
             else BF16_ATOL if bf16 else ROI_TOL["atol"])
    if bf16:
        return f"1 bf16 ulp of the plain value or {floor} absolute"
    return f"atol {floor}, rtol {(ROI_BWD_TOL if backward else ROI_TOL)['rtol']}"


def pool_agreement(torch, got, want, backward: bool = False):
    """Kernel A's output (``backward``: kernel C's level gradients) against
    its plain version's, by the rule :func:`pool_tolerance` states for their
    dtype.  Returns ``(ok, max_abs_err, values beyond 1 bf16 ulp or None)``."""
    pairs = list(zip(got, want)) if backward else [(got, want)]
    bf16 = pairs[0][0].dtype == torch.bfloat16
    ok, err, beyond = True, 0.0, 0
    for a, b in pairs:
        atol = BF16_BWD_ATOL if bf16 else ROI_BWD_TOL["atol"]
        if backward:
            atol = min(atol, BWD_REL * b.float().abs().max().item())
        if bf16:
            e, n_ulp, n_bad = bf16_agreement(torch, a, b, atol if backward else BF16_ATOL)
            ok, beyond = ok and n_bad == 0, beyond + n_ulp
        else:
            e = (a - b).abs().max().item()
            tol = dict(ROI_BWD_TOL, atol=atol) if backward else ROI_TOL
            ok = ok and torch.allclose(a, b, **tol)
        err = max(err, e)
    return ok, err, beyond if bf16 else None


def pool_fns(torch, dtype):
    """Kernel A's and C's plain versions for levels of ``dtype``: ``(forward,
    backward, short dtype name)``."""
    from ttdg_mgm_torch.ops import roi_align as ra

    if dtype == torch.bfloat16:
        return ra.multilevel_roi_align_bf16, ra.multilevel_roi_align_backward_bf16, "bf16"
    return ra.multilevel_roi_align, ra.multilevel_roi_align_backward, "f32"


def hold_pool(torch, feats, rois, P: int, what: str, shape: str):
    """Kernel A on ``feats`` and ``rois`` against its plain version for their
    dtype, then its wrapper's, bare launch's and plain version's times and
    its bound."""
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool

    plain, _, dt = pool_fns(torch, feats[0].dtype)
    C = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    got = multilevel_roi_pool(feats, rois, output_size=P)
    want = plain(feats, rois, output_size=P)
    torch.cuda.synchronize()
    check(got.dtype == feats[0].dtype and bool(torch.isfinite(got).all()),
          f"{what}: output {got.dtype} or non-finite")
    ok, err, beyond = pool_agreement(torch, got, want)
    del want
    tol = pool_tolerance(dt == "bf16")
    log(f"{what} pool {tuple(got.shape)}: max_abs_err {err:.3e} ({tol}"
        f"{'' if beyond is None else f'; {beyond} values beyond 1 bf16 ulp'}) -> "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"{what}: kernel disagrees with the plain version ({err})")
    ms = event_ms(torch, lambda: multilevel_roi_pool(feats, rois, output_size=P), 20)
    args_ms, only_ms = pool_split_ms(torch, feats, shapes, rois, P, C, got, False)
    plain_ms = event_ms(torch, lambda: plain(feats, rois, output_size=P), 2)
    torch.cuda.empty_cache()
    nbytes, flops = roi_pool_work(torch, feats, rois, P, elem=feats[0].element_size())
    b_ms, b_by = bound(nbytes, flops)
    log(f"{what}: wrapper {ms:.4f} ms (its argument set-up {args_ms:.4f} ms, the kernel alone "
        f"{only_ms:.4f} ms), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
        f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
    return dict(max_abs_err=err, beyond_ulp=beyond, ms=ms, kernel_only_ms=only_ms, args_ms=args_ms,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                shape=f"{shape} {dt}, rois ({rois.shape[0]}, {rois.shape[1]}, 4), P={P}")


def roi_pool_canvas(torch, dev, feats, gen, B, side, box_rois, mask_rois, tag, profile):
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool

    res = {}
    C = feats[0].shape[-1]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    Hc, Wc = shapes[0][0] * 4, shapes[0][1] * 4
    dt = pool_fns(torch, feats[0].dtype)[2]
    for name, K, P in (("box" + tag, box_rois, 7), ("mask" + tag, mask_rois, 14)):
        rois = make_rois(torch, gen, B, K, side)
        rois[..., 0::2] *= Wc / side
        rois[..., 1::2] *= Hc / side
        rois = rois.contiguous().to(dev)
        ulps = check_roi_geometry(torch, rois, shapes, P, f"roi_pool {dt} {name}")
        res[name] = hold_pool(torch, feats, rois, P, f"roi_pool {dt} {name}",
                              f"levels ({B}, {Hc // 4}..{Hc // 32}, {Wc // 4}..{Wc // 32}, {C})")
        res[name]["geometry_ulps"] = ulps
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


def roi_backward_work(torch, feats, rois, P: int, elem: int = 4):
    """Bytes and float operations the pool's backward needs on these inputs:
    the cotangent (``elem`` bytes per value) and the ROIs read once, every
    level gradient written once; 10 operations per valid sample and channel
    (the weighted value and four corner adds)."""
    touched_and_out, flops = roi_pool_work(torch, feats, rois, P)
    B, K = rois.shape[:2]
    C = feats[0].shape[-1]
    g_bytes = B * K * P * P * C * elem
    grad_bytes = sum(f.numel() for f in feats) * elem
    return g_bytes + grad_bytes + rois.numel() * 4, flops


def phase_roi_backward(torch, dev, B: int = 8, S: int = 800, C: int = 256,
                       box_rois: int = 512, mask_rois: int = 128, dtype: str = "float32"):
    """The training pools on levels of ``dtype``: the ROI pool kernel, then
    the backward kernel, each against its plain version for that dtype on
    the same levels and ROIs (``"bfloat16"``: the same draws rounded).
    Returns ``(backward results, forward results)``."""
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool_backward

    dt_ = getattr(torch, dtype)
    _, plain, dt = pool_fns(torch, dt_)
    gen = torch.Generator().manual_seed(2)
    feats = [torch.randn((B, S // s, S // s, C), generator=gen).to(dev).to(dt_)
             for s in (4, 8, 16, 32)]
    shapes = [(f.shape[1], f.shape[2]) for f in feats]
    levels = f"({B}, {S // 4}..{S // 32}, {S // 4}..{S // 32}, {C})"
    res, fwd = {}, {}
    for name, K, P in (("box", box_rois, 7), ("mask", mask_rois, 14)):
        rois = make_train_rois(torch, gen, B, K, S).to(dev)
        what = f"roi_pool train {dt} {name}"
        ulps = check_roi_geometry(torch, rois, shapes, P, what)
        fwd[name] = hold_pool(torch, feats, rois, P, what,
                              f"levels {levels}, clustered training ROIs")
        fwd[name]["geometry_ulps"] = ulps
        check_roi_footprints(torch, rois, shapes, P, f"roi_pool_backward {name}")
        what = f"roi_pool_backward {dt} {name}"
        g = torch.randn((B, K, P, P, C), generator=gen).to(dev).to(dt_)
        got = multilevel_roi_pool_backward(g, shapes, rois)
        again = multilevel_roi_pool_backward(g, shapes, rois)
        want = plain(g, shapes, rois)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, a2)) for a, a2 in zip(got, again))
        for a in got:
            check(a.dtype == dt_ and bool(torch.isfinite(a).all()),
                  f"{what}: gradient {a.dtype} or non-finite")
        ok, err, beyond = pool_agreement(torch, got, want, backward=True)
        del again, want
        log(f"{what} grads of {shapes}: max_abs_err {err:.3e} ({pool_tolerance(dt == 'bf16', True)}"
            f"{'' if beyond is None else f'; {beyond} values beyond 1 bf16 ulp'}) -> "
            f"{'ok' if ok else 'FAIL'}; two launches {'bit-identical' if same else 'DIFFER'}")
        check(ok, f"{what}: kernel disagrees with the plain version ({err})")
        check(same, f"{what}: two launches on the same inputs differ")
        ms = event_ms(torch, lambda: multilevel_roi_pool_backward(g, shapes, rois), 20)
        # the bare launch writes every element itself: into gradients filled
        # with NaN, it must give the wrapper's bits
        grads = [torch.full_like(f, float("nan")) for f in feats]
        args_ms, only_ms = pool_split_ms(torch, grads, shapes, rois, P, C, g, True)
        torch.cuda.synchronize()
        check(all(bool(torch.equal(a, b)) for a, b in zip(grads, got)),
              f"{what}: the bare launch into NaN-filled gradients left elements unwritten or "
              f"differs from the wrapper")
        del grads, got
        plain_ms = event_ms(torch, lambda: plain(g, shapes, rois), 2)
        torch.cuda.empty_cache()
        nbytes, flops = roi_backward_work(torch, feats, rois, P, elem=g.element_size())
        b_ms, b_by = bound(nbytes, flops)
        log(f"{what}: wrapper {ms:.4f} ms (its argument set-up {args_ms:.4f} ms, the plan and "
            f"gather kernels alone {only_ms:.4f} ms, written into NaN-filled gradients: every "
            f"element written), plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
            f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        res[name] = dict(max_abs_err=err, beyond_ulp=beyond, ms=ms, kernel_only_ms=only_ms,
                         args_ms=args_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         deterministic=same,
                         shape=f"g ({B}, {K}, {P}, {P}, {C}) {dt} -> levels {levels} {dt}, "
                               f"clustered training ROIs")
    return res, fwd


def tile_hits(torch, rois, shapes, P: int, tile: int = 8):
    """ROIs per level, and the most ROIs whose footprint meets one tile x
    tile pixel tile of one image and level (kernel C's tiles), from the plain
    footprints."""
    import numpy as np
    from ttdg_mgm_torch.ops.roi_align import roi_footprints

    B, K = rois.shape[:2]
    lv, y0, y1, x0, x1 = (t.cpu().numpy() for t in roi_footprints(
        rois.reshape(-1, 4), shapes, output_size=P))
    grids = [np.zeros((B, -(-h // tile), -(-w // tile)), np.int64) for h, w in shapes]
    for r in range(B * K):
        if y1[r] >= y0[r] and x1[r] >= x0[r]:
            grids[lv[r]][r // K, y0[r] // tile:y1[r] // tile + 1, x0[r] // tile:x1[r] // tile + 1] += 1
    return np.bincount(lv, minlength=len(shapes)).tolist(), int(max(g.max() for g in grids))


def phase_roi_backward_main(torch, dev, record, dump_dir=None, names=None):
    """Kernel C on the inputs a training path gave it (``record``, from
    :func:`capture_pool_backward`: each training pool's cotangent and ROIs
    of one step; by default the source step's box and mask pools, else one
    call per ``(rois, name)`` of ``names``, each named by its ROIs):
    against its plain version, two launches bit for bit,
    its wrapper's and bare launch's times, and what the data asks of it
    (ROIs per level, ROIs with an all-zero cotangent, the most ROIs on one
    tile).  A bfloat16 path's cotangents are held against the plain bf16
    version by the bf16 rule of :func:`pool_tolerance`, whose floor scales
    with the step's small gradients."""
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool_backward

    check(len(record) == (len(names) if names else 2),
          f"roi_pool_backward main path: {len(record)} calls in one step")
    if dump_dir:
        os.makedirs(dump_dir, exist_ok=True)
        torch.save([(g.cpu(), sh, r.cpu(), kw) for g, sh, r, kw in record],
                   os.path.join(dump_dir, "pool_backward_inputs.pt"))
    res = {}
    for g, shapes, rois, kw in record:
        B, K, P = g.shape[0], g.shape[1], g.shape[2]
        C = g.shape[-1]
        _, plain, dt = pool_fns(torch, g.dtype)
        key = "box" if P == 7 else "mask"
        if names:
            found = [n for r, n in names if r.shape == rois.shape and bool(torch.equal(r, rois))]
            check(len(found) == 1, f"roi_pool_backward main path: ROIs of {found} pools")
            key = found[0]
        name = key + (" bf16" if dt == "bf16" else "")
        check(tuple(kw.get("strides", (4, 8, 16, 32))) == (4, 8, 16, 32)
              and kw.get("sampling_ratio", 0) == 0 and kw.get("min_level", 2) == 2,
              f"roi_pool_backward main path: options {kw} are not the flagship's")
        check_roi_footprints(torch, rois, shapes, P, f"roi_pool_backward main path {name}")
        got = multilevel_roi_pool_backward(g, shapes, rois)
        again = multilevel_roi_pool_backward(g, shapes, rois)
        want = plain(g, shapes, rois)
        torch.cuda.synchronize()
        same = all(bool(torch.equal(a, a2)) for a, a2 in zip(got, again))
        ok, err, beyond = pool_agreement(torch, got, want, backward=True)
        peak = max(b.float().abs().max().item() for b in want)
        del got, again, want
        check(ok and same, f"roi_pool_backward main path {name}: max_abs_err {err} (largest "
                           f"|gradient| {peak:.3e}), bit-identical {same}")
        ms = event_ms(torch, lambda: multilevel_roi_pool_backward(g, shapes, rois), 20)
        grads = [torch.empty((B, h, w, C), dtype=g.dtype, device=dev) for h, w in shapes]
        _, only_ms = pool_split_ms(torch, grads, shapes, rois, P, C, g, True)
        del grads
        plain_ms = event_ms(torch, lambda: plain(g, shapes, rois), 2)
        torch.cuda.empty_cache()
        feats = [torch.empty((B, h, w, C), device="meta") for h, w in shapes]
        nbytes, flops = roi_backward_work(torch, feats, rois, P, elem=g.element_size())
        b_ms, b_by = bound(nbytes, flops)
        per_level, max_hits = tile_hits(torch, rois, shapes, P)
        zero = int((g.reshape(B * K, -1).abs().amax(1) == 0).sum())
        log(f"roi_pool_backward main path {name} (g {tuple(g.shape)}): max_abs_err {err:.3e} "
            f"({pool_tolerance(dt == 'bf16', True)}, largest |gradient| {peak:.3e}"
            f"{'' if beyond is None else f', {beyond} values beyond 1 bf16 ulp'}), two "
            f"launches bit-identical; wrapper {ms:.4f} ms, kernels alone {only_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}; ROIs per level {per_level}, "
            f"{zero} of {B * K} with an all-zero cotangent, at most {max_hits} on one 8 x 8 tile")
        res[key] = dict(ms=ms, kernel_only_ms=only_ms, plain_ms=plain_ms,
                                    bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                                    beyond_ulp=beyond, largest_abs_grad=peak,
                                    deterministic=same, rois_per_level=per_level,
                                    zero_cotangent_rois=zero, max_rois_per_tile=max_hits)
    return res


# -- phase 7: batched Sinkhorn -----------------------------------------------------

def sinkhorn_work(s, nr, nc, max_iter: int):
    """What kernel D needs for one batch: bytes (each entry read once and
    written once, the counts and tau), float32 operations (per sweep and live
    entry a max, a subtract, an add and the final subtract), transcendentals
    (an exp per sweep and live entry, a log per live slice, an exp per real
    entry at the end), and the floor of its dependent chain: ``max_iter``
    normalisations, each two butterflies of log2(8) = 3 shuffle stages over a
    slice's 8 lanes (``csrc/sinkhorn.cu``), at the measured shuffle latency."""
    rows = [int(max(a, b)) for a, b in zip(nr.tolist(), nc.tolist())]
    cols = [int(b) for b in nc.tolist()]
    live = sum(r * c for r, c in zip(rows, cols))
    real = sum(int(a) * int(b) for a, b in zip(nr.tolist(), nc.tolist()))
    slices = sum((r if it % 2 == 0 else c) for r, c in zip(rows, cols) for it in range(max_iter))
    nbytes = 2 * s.numel() * 4 + 2 * s.shape[0] * 4 + 4
    flops = 4.0 * max_iter * live
    sfu = float(max_iter * live + slices + real)
    chain_ms = max_iter * 2 * 3 * SHUFFLE_CYCLES / SM_CLOCK_HZ * 1e3
    return nbytes, flops, sfu, chain_ms


def sinkhorn_bare_ms(torch, s, nr, nc, tau, max_iter: int, dummy_row: bool = True,
                     generic=False, reps: int = 200) -> float:
    """Kernel D's bare launch through its C entry point, by CUDA events: its
    wrapper's host work (a few small tensor operations) outlasts the kernel.
    ``generic`` None calls a C entry point without that argument (a package
    older than the kernel's two paths)."""
    from ttdg_mgm_torch.ops import _cuda

    nr = nr.to(torch.int32).contiguous()
    nc = nc.to(torch.int32).contiguous()
    t = torch.as_tensor(tau, dtype=torch.float32, device=s.device).reshape(1).contiguous()
    out = torch.empty_like(s)
    flag = [] if generic is None else [int(generic)]
    args = [s.data_ptr(), nr.data_ptr(), nc.data_ptr(), t.data_ptr(), *s.shape, int(max_iter),
            int(dummy_row), *flag, out.data_ptr(), _cuda.stream_ptr(s.device)]
    fn = _cuda.lib().ttdg_sinkhorn
    return event_ms(torch, lambda: _cuda.check(fn(*args), "sinkhorn"), reps)


def hold_sinkhorn(torch, record, path: str):
    """Kernel D against the plain Sinkhorn on every projection input HiPPI
    gave it on ``path`` (``record``, from :func:`capture_hippi`), then the
    HiPPI call with the most iterations rerun with kernel D and with the
    plain projection (these launches are not the main path's).  Returns the
    largest error and the rerun's iterations and difference."""
    import ttdg_mgm_torch.graph.solvers as solvers
    from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched

    proj = record["projections"]
    check(len(proj) > 0, f"sinkhorn: HiPPI made no projection in {path}")
    err = 0.0
    for s, nr, nc, kw in proj:
        got = sinkhorn_batched(s, nr, nc, **kw)
        want = sinkhorn(s, nr, nc, **kw)
        check(bool(torch.isfinite(got).all()), f"sinkhorn: non-finite output on HiPPI's input in "
              f"{path}")
        err = max(err, (got - want).abs().max().item())
    s, nr, nc, kw = proj[0]
    ok = err <= SINKHORN_ATOL
    log(f"sinkhorn on HiPPI's {len(proj)} projection inputs {tuple(s.shape)} of {path} (first: "
        f"|s| up to {s.abs().max().item():.3e}, tau {float(kw['tau']):g}, nrows {nr.tolist()}, "
        f"ncols {nc.tolist()}): max_abs_err {err:.3e} (atol {SINKHORN_ATOL}) -> "
        f"{'ok' if ok else 'FAIL'}")
    check(ok, f"sinkhorn: kernel disagrees with the plain version on HiPPI's input in {path} "
          f"({err})")

    W, U0, ms, n_univ, hkw = max(record["hippi"], key=lambda h: h[-1]["steps"])
    hkw = {k: v for k, v in hkw.items() if k != "steps"}
    U_k, steps_k = solvers.hippi(W, U0, ms, n_univ, **hkw)
    real = solvers.sinkhorn_batched
    solvers.sinkhorn_batched = sinkhorn
    try:
        U_p, steps_p = solvers.hippi(W, U0, ms, n_univ, **hkw)
    finally:
        solvers.sinkhorn_batched = real
    diff = (U_k - U_p).abs().max().item()
    log(f"sinkhorn: the longest HiPPI call of {path}, rerun: {steps_k} iterations with kernel D, "
        f"{steps_p} with the plain projection, max |U diff| {diff:.3e}")
    return err, {"iterations_kernel": steps_k, "iterations_plain": steps_p, "max_abs_diff": diff}


def phase_sinkhorn(torch, dev, record, iters: int = 20, tau: float = 1 / 200, dump_dir=None):
    """Kernel D on the source phase's HiPPI inputs (:func:`hold_sinkhorn`),
    timed on the first projection; one synthetic batch with mixed valid
    counts, on the kernel's register path and on its shared-memory path,
    and a batch of matrices larger than 64 x 64 (that path's own)."""
    from ttdg_mgm_torch.ops.sinkhorn import sinkhorn, sinkhorn_batched

    proj = record["projections"]
    if dump_dir and proj:
        os.makedirs(dump_dir, exist_ok=True)
        s, nr, nc, kw = proj[0]
        torch.save((s.cpu(), nr.cpu(), nc.cpu(), {k: (v.cpu() if torch.is_tensor(v) else v)
                                                  for k, v in kw.items()}),
                   os.path.join(dump_dir, "sinkhorn_input.pt"))
    err, rerun = hold_sinkhorn(torch, record, "the source phase")
    s, nr, nc, kw = proj[0]
    t = float(kw["tau"])

    gen = torch.Generator().manual_seed(3)
    N, n = 16, 60
    syn = (torch.rand((N, n, n), generator=gen) * 1e3).to(dev)
    counts = torch.tensor([60, 41, 22, 57, 60, 12, 33, 48], dtype=torch.int32)
    snr = torch.cat([counts, torch.full((N // 2,), 32, dtype=torch.int32)]).to(dev)
    snc = torch.cat([torch.full((N // 2,), 32, dtype=torch.int32), counts]).to(dev)
    tt = torch.tensor(tau, device=dev)
    big = (torch.rand((4, 100, 70), generator=gen) * 1e3).to(dev)
    bnr = torch.tensor([100, 70, 31, 0], dtype=torch.int32, device=dev)
    bnc = torch.tensor([70, 70, 64, 70], dtype=torch.int32, device=dev)
    syn_err = 0.0
    for what, x, a, b, generic in (("synthetic (16, 60, 60)", syn, snr, snc, False),
                                   ("synthetic (16, 60, 60), shared-memory path", syn, snr, snc,
                                    True),
                                   ("synthetic (4, 100, 70)", big, bnr, bnc, False)):
        got = sinkhorn_batched(x, a, b, tau=tt, max_iter=iters, dummy_row=True, _generic=generic)
        want = sinkhorn(x, a, b, tau=tt, max_iter=iters, dummy_row=True)
        e = (got - want).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and e <= SINKHORN_ATOL
        log(f"sinkhorn {what}, uniform scores in [0, 1e3), tau {tau:g}, mixed valid counts: "
            f"max_abs_err {e:.3e} (atol {SINKHORN_ATOL}) -> {'ok' if ok else 'FAIL'}")
        check(ok, f"sinkhorn {what}: kernel disagrees with the plain version ({e})")
        syn_err = max(syn_err, e)

    ms_k = event_ms(torch, lambda: sinkhorn_batched(s, nr, nc, **kw), 200)
    only_ms = sinkhorn_bare_ms(torch, s, nr, nc, kw["tau"], kw["max_iter"], kw["dummy_row"])
    ms_generic = sinkhorn_bare_ms(torch, s, nr, nc, kw["tau"], kw["max_iter"], kw["dummy_row"],
                                  generic=True)
    plain_ms = event_ms(torch, lambda: sinkhorn(s, nr, nc, **kw), 20)
    nbytes, flops, sfu, chain_ms = sinkhorn_work(s, nr, nc, kw["max_iter"])
    b_ms, b_by = bound(nbytes, flops, sfu)
    log(f"sinkhorn: wrapper {ms_k:.4f} ms, the kernel alone {only_ms:.4f} ms (its shared-memory "
        f"path {ms_generic:.4f} ms), plain "
        f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} ({nbytes / 1e3:.1f} kB, "
        f"{flops / 1e6:.2f} MFLOP, {sfu / 1e6:.3f} M transcendentals at "
        f"{PEAK_SFU_PER_S / 1e12:.2f} T/s); dependent-chain floor {chain_ms:.5f} ms "
        f"({kw['max_iter']} normalisations x 6 shuffle stages x {SHUFFLE_CYCLES} cycles)")
    return dict(max_abs_err=max(err, syn_err), ms=ms_k, kernel_only_ms=only_ms,
                generic_path_ms=ms_generic,
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, chain_floor_ms=chain_ms,
                transcendentals=sfu, projections_checked=len(proj),
                hippi_rerun=rerun,
                shape=f"{tuple(s.shape)} f32 from HiPPI's first projection of the source phase, "
                      f"nrows {nr.tolist()}, ncols {nc.tolist()}, tau {t:g}")


# -- phase 6: source training ------------------------------------------------------

#: the kernels each source step must launch, per precision
SOURCE_COUNTERS = {"float32": ("roi_pool", "roi_pool_backward", "sinkhorn"),
                   "bfloat16": ("roi_pool_bf16", "roi_pool_backward_bf16", "sinkhorn")}


def kernel_counters():
    """Each kernel variant's launch counter: ``{name: (wrapper, attribute)}``;
    the pools count their float32 and bfloat16 launches apart."""
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused
    from ttdg_mgm_torch.ops.mask_paste import paste_masks
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_backward
    from ttdg_mgm_torch.ops.sinkhorn import sinkhorn_batched

    return {"roi_pool": (multilevel_roi_pool, "launches"),
            "roi_pool_bf16": (multilevel_roi_pool, "launches_bf16"),
            "gagm": (ga_gm_fused, "launches"),
            "roi_pool_backward": (multilevel_roi_pool_backward, "launches"),
            "roi_pool_backward_bf16": (multilevel_roi_pool_backward, "launches_bf16"),
            "sinkhorn": (sinkhorn_batched, "launches"),
            "paste_masks": (paste_masks, "launches")}


def pool_counter(name: str, prec: str) -> str:
    """The counter of a pool kernel's variant for ``prec``."""
    return name + "_bf16" if prec == "bfloat16" else name


def reset_counters():
    for fn, attr in kernel_counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {k: getattr(fn, attr) for k, (fn, attr) in kernel_counters().items()}


def check_f32_params(torch, model, what: str) -> None:
    """Every parameter and every gradient float32 (the bf16 policy keeps the
    parameters, and the casts' backward brings their gradients, in
    float32)."""
    bad = [n for n, p in model.named_parameters()
           if p.dtype != torch.float32 or (p.grad is not None and p.grad.dtype != torch.float32)]
    check(not bad, f"{what}: parameters or gradients not float32: {bad[:5]}")


def source_setup(torch, dev, size: int, B: int, steps: int, mask_res: int | None = None,
                 seed: int = 0, prec: str = "float32", **model_kw):
    """The flagship model, ``make_source_step`` with the source solver's lr
    under bench.py's warm-up and clip, and ``steps`` labelled batches (GT
    masks on the source trainer's canvas unless ``mask_res`` is given)."""
    from ttdg_mgm_torch.build import SOURCE_SOLVER, build_model
    from ttdg_mgm_torch.engine.steps import make_source_step
    from ttdg_mgm_torch.solver.build import build_optimizer, warmup_multistep_schedule
    from ttdg_mgm_torch.synth import synth_batch

    model = build_model(device=dev, seed=seed, compute_dtype=prec, **model_kw)
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


def capture_pool_backward():
    """Wraps kernel C's wrapper as the training pools' autograd backward calls
    it (``ops/roi_pool.py:_TrainPool``) to keep a copy of each call's inputs.
    Returns the record and the function that undoes it."""
    import ttdg_mgm_torch.ops.roi_pool as rp

    record, real = [], rp.multilevel_roi_pool_backward

    def backward(grad, level_shapes, rois, **kw):
        record.append((grad.detach().clone(), [tuple(s) for s in level_shapes], rois.clone(), kw))
        return real(grad, level_shapes, rois, **kw)

    def undo():
        real.launches, real.launches_bf16 = backward.launches, backward.launches_bf16
        rp.multilevel_roi_pool_backward = real

    # the wrapper counts its launches on the function the module name holds
    backward.launches, backward.launches_bf16 = real.launches, real.launches_bf16
    rp.multilevel_roi_pool_backward = backward
    return record, undo


def phase_source(torch, dev, size: int = 800, B: int | None = None, steps: int = 5,
                 profile: bool = False, prec: str = "float32", **model_kw):
    from ttdg_mgm_torch.build import SOURCE_SOLVER

    B = B or SOURCE_SOLVER["ims_per_batch"]
    t0 = time.perf_counter()
    model, step, batches = source_setup(torch, dev, size, B, steps, prec=prec, **model_kw)
    log(f"source {prec}: R50-FPN {model_kw or 'flagship'} built in "
        f"{time.perf_counter() - t0:.1f} s, batch {tuple(batches[0]['image'].shape)} with GT, "
        f"lr schedule of bench.py:warm_params, global-norm clip 1.0, TF32 off")
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
            log(f"source {prec} step {i}: " + ", ".join(f"{k} {v:.5f}" for k, v in m.items())
                + f"; HiPPI steps {model.multi_matching_sup.last_hippi_steps}; launches "
                f"{launches}; {step_ms[-1]:.1f} ms")
            for k, v in m.items():
                check(math.isfinite(v), f"source step {i}: {k} = {v} is not finite")
            check(m["loss_matching"] > 0.0, f"source step {i}: loss_matching {m['loss_matching']}")
            for k in SOURCE_COUNTERS[prec]:
                check(launches[k] >= 1, f"source step {i}: kernel {k} was not launched")
            check_f32_params(torch, model, f"source {prec} step {i}")
    finally:
        undo()
    dtypes = sorted({str(t.dtype) for rec in record["hippi"] for t in rec[:2]}
                    | {str(rec[0].dtype) for rec in record["projections"]})
    log(f"source {prec}: dtypes reaching HiPPI and kernel D (its projection input s): {dtypes}")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_ms[1:])
    log(f"source {prec}: step ms {[round(t, 1) for t in step_ms]} (first includes warm-up); median "
        f"after warm-up {steady:.1f} ms = {B * 1e3 / steady:.2f} images/s; peak memory "
        f"{peak_gb:.2f} GiB; launches per step {per_step[-1]}")
    if profile:
        profile_source(torch, step, batches[-1], gen,
                       lambda: model.multi_matching_sup.last_hippi_steps)
    # one more step, untimed, keeping the inputs kernel C gets on this path
    pools, undo = capture_pool_backward()
    try:
        step(batches[-1], gen)
    finally:
        undo()
    torch.cuda.synchronize()
    del model, step, batches
    torch.cuda.empty_cache()
    return dict(batch=B, step_ms=step_ms, steady_ms=steady, images_per_s=B * 1e3 / steady,
                total_loss=totals, peak_gib=peak_gb, launches_per_step=per_step,
                launches={k: sum(p[k] for p in per_step) for k in per_step[0]}, hippi=record,
                pools=pools, kernel_d_dtypes=dtypes)


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


def pin_two_graphs(torch, U, ms):
    """``U (G, M, universe)`` with, when G is 2, graph 0 pinned to the identity
    on its valid rows, as both GA-GM versions pin it after every projection
    (``graph/solvers.py:_gagm_round``, ``csrc/gagm.cu``)."""
    if U.shape[0] != 2:
        return U
    r = torch.arange(U.shape[1], device=U.device)[:, None]
    c = torch.arange(U.shape[2], device=U.device)[None, :]
    return torch.stack([((r == c) & (r < ms[0])).to(U.dtype), U[1]])


def hold_annealed(torch, A, W, U0, ms, nu, kw, what: str, plain_dev=None) -> dict:
    """Kernel B's annealed rounds alone (``lap_iter_cap`` 0) from ``U0``
    against the plain version's, run on ``plain_dev`` (the kernel's device
    when None): soft assignments in [0, 1]; the products' float32 summation
    order differs, and V / tau at tau = 0.0125 amplifies it 80 times per
    step over ~10 steps.  An annealed round that runs to its cap
    (``mgm_iter`` steps) without converging is as chaotic as the finale:
    there float32 round-off alone moves U by O(1) (the plain version in
    float32 against itself in float64), so it holds instead the rounds
    before it, and one annealed step at the last round's temperature from
    the kernel's own annealed U.  Returns the kernel's U and steps, the
    plain version's steps, the largest error held, whether a round ran to
    its cap, and a description of what was held."""
    from ttdg_mgm_torch.graph.solvers import anneal_taus, ga_gm
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused

    kw = {k: v for k, v in kw.items() if k != "lap_iter_cap"}
    plain_dev = plain_dev or A.device

    def plain(U, **over):
        Up, st = ga_gm(A.to(plain_dev), W.to(plain_dev), U.to(plain_dev), ms.to(plain_dev), nu,
                       return_steps=True, **{**kw, **over, "hung_iter_cap": 0})
        return Up.to(A.device), st

    Ua, st_k = ga_gm_fused(A, W, U0, ms, nu, return_steps=True, **{**kw, "lap_iter_cap": 0})
    Up, st_p = plain(U0)
    err_a = (Ua - Up).abs().max().item()
    check(bool(torch.isfinite(Ua).all()), f"{what}: non-finite annealed U")
    capped = [r for r, n in enumerate(st_k[:-1]) if n >= kw["mgm_iter"]]
    if not capped:
        check(err_a <= GAGM_ANNEAL_ATOL, f"{what}: annealed rounds differ from the plain "
              f"version by {err_a} (steps {st_k} vs {st_p})")
        return dict(U=Ua, steps=st_k, plain_steps=st_p, max_abs_err=err_a, chaotic=False,
                    held=f"max |U diff| {err_a:.3e} (atol {GAGM_ANNEAL_ATOL})")
    taus = anneal_taus(kw["sk_tau0"], kw["sk_gamma"], kw["min_tau"])
    parts, worst = [], 0.0
    if capped[0] > 0:
        cut = {"min_tau": taus[capped[0] - 1]}
        Uc, sc_k = ga_gm_fused(A, W, U0, ms, nu, return_steps=True,
                               **{**kw, **cut, "lap_iter_cap": 0})
        Ucp, sc_p = plain(U0, **cut)
        err_c = (Uc - Ucp).abs().max().item()
        worst = max(worst, err_c)
        check(err_c <= GAGM_ANNEAL_ATOL and sc_k == sc_p,
              f"{what}: the {capped[0]} converged annealed rounds differ from the plain version "
              f"by {err_c} (steps {sc_k} vs {sc_p})")
        parts.append(f"the {capped[0]} rounds before it steps {sc_k[:-1]}, max |U diff| "
                     f"{err_c:.3e}")
    one = {"sk_tau0": taus[-1], "min_tau": taus[-1], "mgm_iter": 1}
    U1, s1 = ga_gm_fused(A, W, Ua, ms, nu, return_steps=True, **{**kw, **one, "lap_iter_cap": 0})
    U1p, s1p = plain(Ua, **one)
    err_1 = (U1 - U1p).abs().max().item()
    worst = max(worst, err_1)
    check(err_1 <= GAGM_ANNEAL_ATOL and s1 == s1p == [1, 0],
          f"{what}: one annealed step from the kernel's U differs from the plain version's by "
          f"{err_1} (steps {s1} vs {s1p})")
    parts.append(f"one step at tau {taus[-1]:g} from the kernel's U, max |U diff| {err_1:.3e}")
    return dict(U=Ua, steps=st_k, plain_steps=st_p, max_abs_err=worst, chaotic=True,
                held=(f"round {capped[0] + 1} ran to its cap of {kw['mgm_iter']} steps "
                      f"(chaotic: max |U diff| {err_a:.3e}, not held); held instead: "
                      + "; ".join(parts) + f" (atol {GAGM_ANNEAL_ATOL})"))


def phase_gagm_main(torch, dev, record, dump_dir=None):
    """Kernel B on the inputs the TTA steps gave it (``record``, from
    :func:`capture_gagm`).  On the first: its time by CUDA events, its steps
    per round, its bound from those steps, and the in-kernel clock split of
    an annealed and of a finale step.  On every input, the two parts of the
    solve that are well-posed although the unconverged finale is chaotic:
    (a) the annealed rounds alone against the plain version
    (:func:`hold_annealed`); (b) one finale
    step from that U: the kernel's power step V against the plain one, and
    the kernel's 0/1 output against the host LAP of the kernel's own V (in
    the 2-graph case graph 0 against its pin to the identity, as both
    versions pin it)."""
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
    shape_main = f"A, W ({T}, {T}) f32, U0 ({T}, {nu}), ms {ms.tolist()}"
    log(f"gagm main path, first captured input (A, W ({T}, {T}), U0 ({T}, {nu}), ms "
        f"{ms.tolist()}): steps per round {steps}; kernel {ms_k:.4f} ms by events, plain "
        f"{plain_ms:.1f} ms, bound {b_ms:.4f} ms by {b_by} ({sum(steps)} power steps, "
        f"{flops / 1e9:.3f} GFLOP)")
    for kind, sp in split.items():
        log(f"gagm main path, in-kernel clocks of block 0, microseconds per {kind} step over "
            f"{sp['steps']} steps at {sp['sm_mhz']:.0f} MHz: "
            + ", ".join(f"{k} {v:.2f}" for k, v in sp.items() if k not in ("steps", "sm_mhz")))

    worst_a, worst_v, differ_plain, lap_stats, chaotic, graphs = 0.0, 0.0, 0, {}, 0, 0
    for i, (A, W, U0, ms, nu, kw) in enumerate(record):
        G, T = ms.shape[0], A.shape[0]
        M = T // G
        graphs += G
        # (a) the annealed rounds
        held = hold_annealed(torch, A, W, U0, ms, nu, kw, f"gagm main path {i}")
        Ua, st_k, st_p, held_a = held["U"], held["steps"], held["plain_steps"], held["held"]
        worst_a = max(worst_a, held["max_abs_err"])
        chaotic += held["chaotic"]
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
        want = pin_two_graphs(torch, lap_slots_to_nodes(Vg, ms, lap_stats), ms)
        same = [bool(torch.equal(out.reshape(G, M, nu)[g], want.reshape(G, M, nu)[g]))
                for g in range(G)]
        check(all(same), f"gagm main path {i}: the kernel's LAP differs from the host LAP of "
                         f"its own V in graphs {[g for g, ok in enumerate(same) if not ok]}")
        plain = pin_two_graphs(torch, _project_blocks(Vg, ms.long(), nu, tau=1.0, sk_iter=0,
                                                      exact_hungarian=True), ms)
        differ_plain += sum(1 for g in range(G)
                            if not torch.equal(out.reshape(G, M, nu)[g], plain[g]))
        log(f"gagm main path input {i} (ms {ms.tolist()}): annealed rounds steps kernel "
            f"{st_k[:-1]} plain {st_p[:-1]}, {held_a}; one finale step: |V diff| {err_v:.3e} of "
            f"max|V| {vmax:.3e} (bound {GAGM_V_RTOL}), LAP equal to the host LAP of the "
            f"kernel's V in all {G} graphs")
    search_steps = lap_stats["search_steps"] / graphs
    log(f"gagm main path: the host LAP of one finale step takes {search_steps:.1f} search steps "
        f"per graph (mean over {graphs} graphs)")
    log(f"gagm main path: {len(record)} inputs held ({chaotic} with an annealed round at its "
        f"cap); the plain projection, which solves ms <= universe graphs in the other "
        f"orientation, picks another assignment of the same V in {differ_plain} of {graphs} "
        f"graphs")
    return dict(ms_main=ms_k, plain_ms_main=plain_ms, bound_ms_main=b_ms, bound_by_main=b_by,
                steps_main=steps, clock_split_us=split, anneal_max_abs_err=worst_a,
                power_step_rel_err=worst_v, inputs_checked=len(record),
                inputs_with_an_annealed_round_at_its_cap=chaotic,
                plain_lap_differs_in_graphs=differ_plain, lap_search_steps_per_graph=search_steps,
                shape_main=shape_main)


# -- phase 4: end to end -----------------------------------------------------------

def phase_e2e(torch, dev, size: int = 800, profile: bool = False, prec: str = "float32",
              **model_kw):
    from ttdg_mgm_torch.build import build_model
    from ttdg_mgm_torch.engine.steps import make_tta_step
    from ttdg_mgm_torch.solver.build import build_optimizer
    from ttdg_mgm_torch.synth import synth_batch

    t0 = time.perf_counter()
    model = build_model(device=dev, seed=0, compute_dtype=prec, **model_kw)
    opt = build_optimizer(model, lambda _: TTA_LR)
    step = make_tta_step(model, opt)
    data = synth_batch(size, 4, seed=0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    log(f"e2e {prec}: R50-FPN {model_kw or 'flagship'} built in {time.perf_counter() - t0:.1f} s, "
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
            nodes = mgm.last_node_counts.tolist()
            log(f"e2e {prec} TTA step {i}: loss {loss:.6f}, valid nodes per graph {nodes}, "
                f"solver steps {mgm.last_solver_steps}, {step_ms[-1]:.1f} ms")
            check(math.isfinite(loss) and loss > 0.0,
                  f"step {i}: loss {loss} is not finite and > 0")
            check(sum(1 for c in nodes if c > 0) >= 2,
                  f"step {i}: fewer than two graphs with nodes")
            check_f32_params(torch, model, f"e2e {prec} TTA step {i}")
    finally:
        undo()
    gagm_dtypes = sorted({str(t.dtype) for rec in gagm_inputs for t in rec[:3]})
    log(f"e2e {prec}: dtypes reaching kernel B (A, W, U0): {gagm_dtypes}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.forward_inference(batch["image"], batch["image_sizes"])
    torch.cuda.synchronize()
    infer_ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steady = statistics.median(step_ms[1:])
    log(f"e2e {prec}: TTA step ms {[round(t, 1) for t in step_ms]} (first includes warm-up); "
        f"median after warm-up {steady:.1f} ms = {4e3 / steady:.2f} images/s; forward_inference "
        f"{infer_ms:.1f} ms; peak memory {peak_gb:.2f} GiB; launches {launches}")
    check(launches[pool_counter("roi_pool", prec)] >= 1,
          f"the {prec} ROI pool kernel was not launched on the main path")
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
                gagm_inputs=gagm_inputs, kernel_b_dtypes=gagm_dtypes)


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
                               "sinkhorn_kernel", "roi_geometry_kernel", "roi_plan_kernel")):
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
    summation order, and ReLUs whose input lies within round-off of 0 move
    the gradients of the layers before them)."""
    from ttdg_mgm_torch.build import build_model
    from ttdg_mgm_torch.synth import synth_batch

    kw = dict(resnet_width=64, fpn_channels=64, box_fc_dim=128, mask_conv_dim=64,
              pre_nms_topk_test=200, post_nms_topk=100, detections_per_image=16,
              pre_nms_topk_train=200, batch_size_per_image=64, mask_fg_cap=16, hippi_iters=10,
              compute_dtype="float32")
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
        log(f"warm: TTA step {i}: loss {loss:.6f}, "
            f"valid nodes per graph {mgm.last_node_counts.tolist()}, "
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


# -- phase 8: the command line ------------------------------------------------------

CLI_IMAGES = 8


def write_png(path: str, img) -> None:
    """``img (H, W, 3)`` uint8 as an RGB PNG (no row filters), with zlib."""
    import struct
    import zlib

    h, w = img.shape[:2]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    raw = b"".join(b"\0" + img[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1)) + chunk(b"IEND", b""))


def write_fundus_split(root: str, n: int, hw, seed: int = 0, polygons: bool = False,
                       split: str = "Drishti_GS_test") -> None:
    """``n`` fundus-like images of ``hw`` in the reference's layout of the
    fundus split ``split`` (its entry of ``ttdg_mgm_torch/data/builtin.py:SPLITS``;
    the Drishti-GS test split ``Fundus/Drishti_GS_test.json``,
    ``Fundus/Drishti_GS/test/image/`` by default): a dark red field of view
    with an optic disc and its cup, two ellipses per image; their masks are
    the ground truth (disc class 1, cup class 2), as RLE, or with
    ``polygons`` as 96-vertex polygon rings around the ellipses (the
    datasets' own annotation form)."""
    import numpy as np

    from ttdg_mgm_torch.data.builtin import SPLITS
    from ttdg_mgm_torch.utils.rle import rle_encode

    h, w = hw
    rng = np.random.RandomState(seed)
    json_rel, img_rel = SPLITS[split]
    img_dir = os.path.join(root, img_rel)
    os.makedirs(img_dir, exist_ok=True)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    fov = ((yy - h / 2) / (0.49 * h)) ** 2 + ((xx - w / 2) / (0.49 * h)) ** 2 <= 1
    images, anns = [], []
    for i in range(n):
        img = np.zeros((h, w, 3), np.float32)
        img[fov] = [140, 55, 25]
        img += rng.normal(0, 6, (h, w, 3)).astype(np.float32) * fov[..., None]
        cy, cx = rng.uniform(0.35, 0.65) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.08, 0.12) * h, rng.uniform(0.07, 0.11) * h
        disc = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        cup = ((yy - cy) / (0.5 * ry)) ** 2 + ((xx - cx) / (0.55 * rx)) ** 2 <= 1
        img[disc] = [225, 165, 85]
        img[cup] = [250, 225, 160]
        write_png(os.path.join(img_dir, f"d{i}.png"), np.clip(img, 0, 255).astype(np.uint8))
        images.append({"id": i, "file_name": f"d{i}.png", "height": h, "width": w})
        t = np.linspace(0.0, 2 * np.pi, 96, endpoint=False)
        for cat, m, (sy, sx) in ((1, disc, (ry, rx)), (2, cup, (0.5 * ry, 0.55 * rx))):
            ys, xs = np.nonzero(m)
            if polygons:
                ring = np.stack([cx + sx * np.cos(t), cy + sy * np.sin(t)], 1).reshape(-1)
                seg = [[round(float(v), 2) for v in ring]]
            else:
                seg = rle_encode(m)
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat, "iscrowd": 0,
                         "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                                  float(ys.max() - ys.min() + 1)],
                         "area": float(m.sum()), "segmentation": seg})
    with open(os.path.join(root, json_rel), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]}, f)


def capture_cli(torch):
    """Wraps the trainer's TTA step (timed, its loss kept) and its
    evaluation (the s/iter log line after every batch; each image's
    postprocessed boxes and the union of its masks), and listens to the
    package's log.  Returns the record and
    the function that undoes it."""
    import logging

    import ttdg_mgm_torch.engine.trainer as trainer

    import numpy as np

    record = {"tta_ms": [], "tta_loss": [], "eval": None, "total": None, "post_s": 0.0,
              "evals": [], "post_by_dataset": [], "detections": {}, "draw_s": None}
    real_step, real_eval = trainer.make_tta_step, trainer.evaluate_dataset
    real_post = trainer.postprocess_detections

    def make_tta_step(model, optimizer):
        step = real_step(model, optimizer)

        def timed(batch):
            dev = batch["image"].device
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            loss = step(batch)
            record["tta_loss"].append(float(loss))
            record["tta_ms"].append((time.perf_counter() - t0) * 1e3)
            return loss

        return timed

    def evaluate_dataset(*a, **k):
        record["post_by_dataset"].append(0.0)
        return real_eval(*a, **{**k, "log_every": 1})

    def postprocess_detections(det, meta, b, **k):
        # the paste on the card and the copies of its masks to the host
        t0 = time.perf_counter()
        out = real_post(det, meta, b, **k)
        record["post_s"] += time.perf_counter() - t0
        record["post_by_dataset"][-1] += time.perf_counter() - t0
        # what the visualizer draws: the boxes and the union of the masks
        union = (np.any(out["masks"], axis=0) if len(out["masks"])
                 else np.zeros((meta["orig_height"], meta["orig_width"]), bool))
        record["detections"][meta["image_id"]] = dict(
            boxes=out["boxes"].copy(), scores=out["scores"].copy(),
            classes=out["classes"].copy(), union=union)
        return out

    class Listen(logging.Handler):
        def emit(self, rec):
            if rec.msg.startswith("Inference done"):
                record["eval"] = rec.args
            elif rec.msg.startswith("Total inference time"):
                record["evals"].append(record["eval"])
                record["total"] = rec.args
            elif rec.msg.startswith("Visualization dumps"):
                record["draw_s"] = rec.args[2]

    lg = logging.getLogger("ttdg_mgm_torch")
    handler, level = Listen(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)

    def undo():
        trainer.make_tta_step, trainer.evaluate_dataset = real_step, real_eval
        trainer.postprocess_detections = real_post
        lg.removeHandler(handler)
        lg.setLevel(level)

    trainer.make_tta_step, trainer.evaluate_dataset = make_tta_step, evaluate_dataset
    trainer.postprocess_detections = postprocess_detections
    return record, undo


def check_dumps(out_dir: str, img_dir: str, detections: dict, hw) -> None:
    """The visualizer's dumps of a ``TEST.DRAW`` call: one ``visual`` and
    one ``masks`` PNG per evaluated image (``detections``, by image id),
    read by the port's ``decode_png`` at the image's size; the mask dump
    255 on the union of the image's pasted masks and 0 elsewhere; the
    ``visual`` dump equal to ``draw_detections`` re-run here on the image
    and the same detections."""
    import numpy as np

    from ttdg_mgm_torch.data.loader import load_image
    from ttdg_mgm_torch.data.png import decode_png
    from ttdg_mgm_torch.utils.visualize import draw_detections

    for kind in ("visual", "masks"):
        names = sorted(os.listdir(os.path.join(out_dir, kind)))
        want = sorted(f"{i}.png" for i in detections)
        check(names == want, f"TEST.DRAW: {kind}/ holds {names}, not {want}")
    for i, det in detections.items():
        with open(os.path.join(out_dir, "masks", f"{i}.png"), "rb") as f:
            m = decode_png(f.read())
        with open(os.path.join(out_dir, "visual", f"{i}.png"), "rb") as f:
            v = decode_png(f.read())
        check(m.shape == v.shape == (*hw, 3), f"TEST.DRAW image {i}: dumps {m.shape}, {v.shape}")
        check(np.array_equal(m, np.repeat(det["union"][..., None], 3, -1).astype(np.uint8) * 255),
              f"TEST.DRAW image {i}: the mask dump is not the union of its pasted masks")
        image = load_image(os.path.join(img_dir, f"d{i}.png"))
        again = draw_detections(image, det["boxes"], det["scores"], det["classes"])
        check(np.array_equal(v, again), f"TEST.DRAW image {i}: the box dump differs from "
                                        f"draw_detections on the same detections")


def phase_cli(torch, dev, card: str = "", hw=(800, 1192), opts=(), model_kw=None):
    """``train_net_torch.main`` in process, as a user runs the paper's
    method: ``--eval-only --config configs/test_segment.yaml`` on a
    synthetic Drishti-GS test split of ``CLI_IMAGES`` PNG images of ``hw``
    (800 x 1192: a Drishti-GS image after ``ResizeShortestEdge(800, 1333)``,
    so no resize; batches pad onto the 832 x 1216 canvas) with RLE ground
    truth, the flagship's seeded random weights saved as a d2 checkpoint,
    float32, Dice over every detection (``TEST.DICE_THRES 0.0``) and
    ``TEST.DRAW True`` (the dumps held by :func:`check_dumps`, their host
    seconds per image read from the evaluation's log).  Kernel
    counters are read around the call; the TTA steps are timed, the
    evaluation loop's data, inference and evaluation seconds per image read
    from its log."""
    import tempfile

    import train_net_torch
    from ttdg_mgm_torch.build import build_model

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_fundus_split(tmp, CLI_IMAGES, hw)
        weights = os.path.join(tmp, "model_final.pth")
        model = build_model(device="cpu", seed=0, **(model_kw or {}))
        torch.save({"model": model.state_dict()}, weights)
        del model
        out_dir = os.path.join(tmp, "out")
        argv = ["--eval-only", "--device", str(dev),
                "--config", os.path.join(HERE, "configs", "test_segment.yaml"),
                "--datasets-root", tmp, "DATASETS.TEST", '["Drishti_GS_test"]',
                "MODEL.WEIGHTS", weights, "TPU.PRECISION", "float32", "TEST.DICE_THRES", "0.0",
                "OUTPUT_DIR", out_dir, "TEST.DRAW", "True", *opts]
        log(f"cli: {CLI_IMAGES} images of {hw[0]}x{hw[1]} and the weights written in "
            f"{time.perf_counter() - t0:.1f} s; train_net_torch.main({' '.join(argv[:6])} ...)")
        record, undo = capture_cli(torch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counters()
        try:
            t0 = time.perf_counter()
            results = train_net_torch.main(argv)
            wall = time.perf_counter() - t0
        finally:
            undo()
        launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0
        with open(os.path.join(out_dir, "result_ap.txt")) as f:
            line = json.loads(f.read().strip().splitlines()[-1])
        t0 = time.perf_counter()
        check_dumps(out_dir, os.path.join(tmp, "Fundus", "Drishti_GS", "test", "image"),
                    record["detections"], hw)
        log(f"cli: TEST.DRAW dumps of {len(record['detections'])} images held in "
            f"{time.perf_counter() - t0:.1f} s: one visual and one masks PNG each at "
            f"{hw[0]}x{hw[1]}, the masks the union of the pasted masks, the boxes "
            f"draw_detections' on the same detections; the dumps took "
            f"{record['draw_s']:.4f} s per image on the host")
    check(set(line["results"]) >= {"Drishti_GS_test", "Drishti_mean"},
          f"result_ap.txt holds {sorted(line['results'])}")
    metrics = results["Drishti_GS_test"]
    check(len(metrics) == 3 and all(math.isfinite(v) for v in metrics.values()),
          f"Dice, E and S not all finite: {metrics}")
    check(any(v > 0 for v in record["tta_loss"]), f"TTA loss {record['tta_loss']} never > 0")
    check(launches["roi_pool"] >= 1 and launches["gagm"] >= 1 and launches["paste_masks"] >= 1,
          f"the CLI path launched kernel A {launches['roi_pool']}, kernel B "
          f"{launches['gagm']} and the paste {launches['paste_masks']} times")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2", "yaml"))
    check(not foreign, f"the CLI path imported {foreign[:5]}")
    n_img, data_s, infer_s, eval_s = record["eval"]
    total_s = record["total"][0]
    post_s = record["post_s"] / n_img
    log(f"cli ({card}): TTA step ms {[round(t, 1) for t in record['tta_ms']]}, losses "
        f"{[round(v, 6) for v in record['tta_loss']]}; evaluation of {n_img} images: data "
        f"{data_s:.4f}, inference {infer_s:.4f}, eval {eval_s:.4f} s per image (of which the "
        f"paste and its copy to the host {post_s:.4f}, Dice, E and S on the host the rest), "
        f"{total_s:.2f} s in all; main() {wall:.1f} s; peak memory {peak_gb:.2f} GiB; launches "
        f"{launches}; no PIL, cv2 or yaml imported")
    log(f"cli: results {json.dumps(results)}")
    return dict(tta_ms=record["tta_ms"], tta_loss=record["tta_loss"], eval_images=n_img,
                data_s_per_image=data_s, inference_s_per_image=infer_s,
                eval_s_per_image=eval_s, paste_s_per_image=post_s, eval_total_s=total_s,
                main_s=wall, peak_gib=peak_gb,
                launches=launches, metrics=metrics,
                draw_s_per_image=record["draw_s"])


# -- determinism --------------------------------------------------------------------

def _snapshot(model):
    """Device copies of every parameter and its gradient, by name."""
    return {n: (p.detach().clone(), None if p.grad is None else p.grad.detach().clone())
            for n, p in model.named_parameters()}


def _first_differences(torch, a, b, limit: int = 6):
    """Names (model order) whose parameter or gradient differs between two
    snapshots, with the largest difference of each."""
    out = []
    for n in a:
        for what, x, y in (("param", a[n][0], b[n][0]), ("grad", a[n][1], b[n][1])):
            if x is None or y is None or torch.equal(x, y):
                continue
            out.append(f"{what} {n} {float((x.float() - y.float()).abs().max()):.3g}")
    return len(out), out[:limit]


def _run_from(torch, model, state, make_step, batches, settings, keep: bool = True):
    """Load ``state``, make a fresh optimizer and step (``make_step(model) ->
    (step, call)``), take one step for each entry of ``settings``, under
    ``cudnn.deterministic`` set to it; returns each step's wall ms and, with
    ``keep``, a snapshot after each."""
    model.load_state_dict(state)
    step, call = make_step(model)
    times, snaps = [], []
    for i, det in enumerate(settings):
        torch.backends.cudnn.deterministic = det
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call(step, batches[i % len(batches)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if keep:
            snaps.append(_snapshot(model))
    return times, snaps


# steps of each bitwise-compared run; timed steps per cuDNN setting, the
# settings alternated step by step so that host noise falls on both alike
DET_STEPS = 5
DET_TIMED_STEPS = 30


def phase_determinism(torch, dev, tta_size: int = 800, src_size: int = 800, src_batch: int = 8,
                      **model_kw):
    """For each precision and cuDNN setting (``cudnn.deterministic``), two
    runs of ``DET_STEPS`` TTA steps and two of ``DET_STEPS`` source steps,
    each run from one saved state with a fresh optimizer (and, for the
    source step, a generator seeded alike), compared parameter by parameter
    and gradient by gradient after every step.  The gate: bitwise-equal runs
    under the deterministic setting.  The default setting is reported (what
    differs first), not gated.  Then the cost of the setting: one run from
    the state of ``2 * DET_TIMED_STEPS + 2`` steps with the two settings
    alternated step by step, the first step of each left out; the median
    step time of each setting with its quartiles, and the median difference
    of each deterministic step and the default step after it."""
    from ttdg_mgm_torch.build import SOURCE_SOLVER, build_model
    from ttdg_mgm_torch.engine.steps import make_source_step, make_tta_step
    from ttdg_mgm_torch.solver.build import build_optimizer, warmup_multistep_schedule
    from ttdg_mgm_torch.synth import synth_batch

    def tta_step(model):
        return make_tta_step(model, build_optimizer(model, lambda _: TTA_LR)), \
            lambda step, batch: step(batch)

    def source_step(model):
        opt = build_optimizer(model, warmup_multistep_schedule(SOURCE_SOLVER["base_lr"],
                                                               **WARM_SCHEDULE), clip=WARM_CLIP)
        gen = torch.Generator(device=dev).manual_seed(0)
        return make_source_step(model, opt), lambda step, batch: step(batch, gen)

    tta_batch = [{k: torch.from_numpy(v).to(dev) for k, v in
                  synth_batch(tta_size, 4, seed=0).items()}]
    src_batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                    synth_batch(src_size, src_batch, seed=i, with_gt=True,
                                mask_res=SOURCE_SOLVER["mask_res"]).items()}
                   for i in range(DET_STEPS)]
    result = {}
    old = torch.backends.cudnn.deterministic
    try:
        for prec in PRECISIONS:
            kw = dict(model_kw, compute_dtype=prec)
            for path, make, batches in (("tta", tta_step, tta_batch),
                                        ("source", source_step, src_batches)):
                model = build_model(device=dev, seed=0, **kw)
                state = {k: v.clone() for k, v in model.state_dict().items()}
                key = f"{path}_{prec}"
                res = result[key] = {}
                for det in (True, False):
                    setting = "det" if det else "nondet"
                    _, a = _run_from(torch, model, state, make, batches, [det] * DET_STEPS)
                    _, b = _run_from(torch, model, state, make, batches, [det] * DET_STEPS)
                    diffs = [_first_differences(torch, x, y) for x, y in zip(a, b)]
                    equal = all(n == 0 for n, _ in diffs)
                    res[f"{setting}_equal"] = equal
                    res[f"{setting}_differing"] = [n for n, _ in diffs]
                    log(f"determinism {key} {setting}: {'bitwise equal' if equal else 'DIFFERENT'}"
                        f" over {DET_STEPS} steps")
                    for i, (n, fd) in enumerate(diffs):
                        if n:
                            log(f"determinism {key} {setting}: after step {i} {n} tensors "
                                f"differ, first {fd}")
                    if det:
                        check(equal, f"determinism {key}: two runs from one state differ")
                    del a, b
                order = [i % 2 == 0 for i in range(2 * DET_TIMED_STEPS + 2)]
                t, _ = _run_from(torch, model, state, make, batches, order, keep=False)
                for det in (True, False):
                    setting = "det" if det else "nondet"
                    ts = [x for x, d in zip(t[2:], order[2:]) if d == det]
                    q1, med, q3 = statistics.quantiles(ts, n=4)
                    res[f"{setting}_ms"] = dict(median=med, q1=q1, q3=q3, min=min(ts),
                                                max=max(ts), steps=ts)
                cost = res["det_ms"]["median"] / res["nondet_ms"]["median"] - 1
                # each deterministic step less the default step after it
                paired = statistics.median(t[i] - t[i + 1] for i in range(2, len(t), 2))
                res["cost_of_determinism"] = cost
                res["paired_diff_ms"] = paired
                log(f"determinism {key}: step ms median (quartiles) deterministic "
                    f"{res['det_ms']['median']:.1f} ({res['det_ms']['q1']:.1f}-"
                    f"{res['det_ms']['q3']:.1f}), default {res['nondet_ms']['median']:.1f} "
                    f"({res['nondet_ms']['q1']:.1f}-{res['nondet_ms']['q3']:.1f}), "
                    f"{DET_TIMED_STEPS} steps each in turns: cost {100 * cost:+.1f} %, median of "
                    f"the paired differences {paired:+.1f} ms")
                del model, state
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = old
    return result


DRISHTI_HW = (1944, 2896)  # a Drishti-GS image, (h, w)
CLI_BF16_IMAGES = 2
JPEG_FIXTURES = os.path.join(HERE, "tests", "fixtures", "torch_jpeg")


def host_decode_s(paths, min_size: int = 800, max_size: int = 1333) -> float:
    """Mean host seconds per image of the test loader's decode and resize
    (``load_image`` and ``resize_shortest_edge``) on ``paths``: the work its
    prefetch thread does for each image."""
    from ttdg_mgm_torch.data.loader import load_image
    from ttdg_mgm_torch.data.transforms import resize_shortest_edge

    t0 = time.perf_counter()
    for p in paths:
        resize_shortest_edge(load_image(p), min_size, max_size)
    return (time.perf_counter() - t0) / len(paths)


def phase_cli_bf16(torch, dev, card: str = "", hw=DRISHTI_HW, opts=(), model_kw=None):
    """``train_net_torch.main`` with the flagship command as it stands,
    ``--eval-only --config configs/test_segment.yaml`` with no precision
    override, so the config's default ``TPU.PRECISION bfloat16`` (the bf16
    policy), with ``TEST.DICE_THRES 0.0`` as in the float32 CLI phase (the
    config's 0.9 scores no detection of random weights, whose class scores
    sit near 1/3, and Dice, E and S of no detection are NaN): on a synthetic
    Drishti-GS split of ``CLI_BF16_IMAGES`` fundus-like PNG images at the
    dataset's own 2896 x 1944 with polygon ground truth (resized to 800 x 1192
    by the loader, evaluated at 2896 x 1944), and on a BKAI split of the
    committed baseline 4:2:0 JPEGs of 1280 x 959 (``tests/fixtures/torch_jpeg``)
    with polygon ground truth.  Passes only if both splits give finite Dice,
    E and S, kernels A (bf16 variant) and B launched, and neither Pillow,
    OpenCV nor PyYAML was imported.  Logs the host's decode and resize
    seconds per image, the evaluation loop's data, inference and evaluation
    seconds per image at the original sizes, and the peak memory."""
    import shutil
    import tempfile

    import train_net_torch
    from ttdg_mgm_torch.build import build_model

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        write_fundus_split(tmp, CLI_BF16_IMAGES, hw, seed=1, polygons=True)
        jpg_dir = os.path.join(tmp, "Polyp", "BKAI", "test", "image")
        os.makedirs(jpg_dir)
        jpgs = sorted(f for f in os.listdir(JPEG_FIXTURES) if f.endswith(".jpg"))
        for f in jpgs:
            shutil.copy(os.path.join(JPEG_FIXTURES, f), jpg_dir)
        shutil.copy(os.path.join(JPEG_FIXTURES, "annotations.json"),
                    os.path.join(tmp, "Polyp", "BKAI_test.json"))
        weights = os.path.join(tmp, "model_final.pth")
        model = build_model(device="cpu", seed=0, **(model_kw or {}))
        torch.save({"model": model.state_dict()}, weights)
        del model
        png_dir = os.path.join(tmp, "Fundus", "Drishti_GS", "test", "image")
        decode_png_s = host_decode_s([os.path.join(png_dir, f) for f in
                                      sorted(os.listdir(png_dir))])
        decode_jpg_s = host_decode_s([os.path.join(jpg_dir, f) for f in jpgs])
        out_dir = os.path.join(tmp, "out")
        argv = ["--eval-only", "--device", str(dev),
                "--config", os.path.join(HERE, "configs", "test_segment.yaml"),
                "--datasets-root", tmp, "DATASETS.TEST", '["Drishti_GS_test", "BKAI_test"]',
                "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out_dir, "TEST.DICE_THRES", "0.0",
                *opts]
        log(f"cli bf16: {CLI_BF16_IMAGES} PNG images of {hw[1]}x{hw[0]} with "
            f"polygon ground truth and {len(jpgs)} JPEGs of 1280x959 written in "
            f"{time.perf_counter() - t0:.1f} s; host decode and resize per image: PNG "
            f"{decode_png_s:.4f} s, JPEG {decode_jpg_s:.4f} s; "
            f"train_net_torch.main({' '.join(argv[:6])} ...), no precision override")
        record, undo = capture_cli(torch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        reset_counters()
        try:
            t0 = time.perf_counter()
            results = train_net_torch.main(argv)
            wall = time.perf_counter() - t0
        finally:
            undo()
        launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0
    for name in ("Drishti_GS_test", "BKAI_test"):
        m = results.get(name, {})
        check(len(m) == 3 and all(math.isfinite(v) for v in m.values()),
              f"cli bf16: {name} Dice, E and S not all finite: {m}")
    check(launches["roi_pool_bf16"] >= 1 and launches["gagm"] >= 1 and launches["roi_pool"] == 0,
          f"cli bf16: kernel launches {launches}: kernel A's bf16 variant and kernel B must run, "
          f"the float32 pool must not")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2", "yaml"))
    check(not foreign, f"cli bf16: the CLI path imported {foreign[:5]}")
    check(len(record["evals"]) == 2, f"cli bf16: {len(record['evals'])} evaluation logs")
    per = {}
    for name, ev, post in zip(("png_2896x1944", "jpeg_1280x959"), record["evals"],
                              record["post_by_dataset"]):
        n_img, data_s, infer_s, eval_s = ev
        per[name] = dict(images=n_img, data_s_per_image=data_s, inference_s_per_image=infer_s,
                         eval_s_per_image=eval_s, paste_s_per_image=post / n_img)
    per["png_2896x1944"]["decode_resize_s_per_image"] = decode_png_s
    per["jpeg_1280x959"]["decode_resize_s_per_image"] = decode_jpg_s
    log(f"cli bf16 ({card}): TTA step ms {[round(t, 1) for t in record['tta_ms']]}, losses "
        f"{[round(v, 6) for v in record['tta_loss']]}; per split {json.dumps(per)}; main() "
        f"{wall:.1f} s; peak memory {peak_gb:.2f} GiB; launches {launches}; no PIL, cv2 or "
        f"yaml imported")
    log(f"cli bf16: results {json.dumps(results)}")
    return dict(tta_ms=record["tta_ms"], tta_loss=record["tta_loss"], splits=per, main_s=wall,
                peak_gib=peak_gb, launches=launches, metrics={k: results[k] for k in
                                                              ("Drishti_GS_test", "BKAI_test")})


# -- phase 10: source training through the command line --------------------------

#: the synthetic splits of configs/seg_res50fpn_source.yaml's DATASETS.TRAIN
#: other than BKAI (the committed JPEGs): (split, images, (h, w), LZW), as
#: the datasets ship them: TIFF frames, uncompressed or LZW-coded after the
#: horizontal predictor
POLYP_SPLITS = (("CVC_ClinicDB_train", 4, (288, 384), False),
                ("ETIS_LaribPolypDB_train", 3, (966, 1225), True))
#: the kernels each train step must launch under the bf16 policy
TRAIN_COUNTERS = ("roi_pool_bf16", "roi_pool_backward_bf16", "sinkhorn")
#: batches the train loader's host time is measured on
LOADER_BATCHES = 6


#: the code width of the k-th code after a Clear code in TIFF LZW (9 bits
#: up to the table's entry 510, then 10, 11 and 12; libtiff's early change)
def _lzw_width(k: int) -> int:
    return 9 if k < 254 else 10 if k < 766 else 11 if k < 1790 else 12


def lzw_encode(data: bytes) -> bytes:
    """TIFF LZW of ``data`` (libtiff's ``LZWEncode``): greedy matches, a Clear
    code first and whenever the table fills at 4094 entries, MSB-first codes
    at libtiff's widths, EOI last."""
    import numpy as np

    codes, ks = [256], [0]
    table, nxt, k = {}, 258, 0
    if data:
        get = table.get
        w = data[0]
        for c in data[1:]:
            key = (w << 8) | c
            v = get(key)
            if v is not None:
                w = v
                continue
            codes.append(w)
            ks.append(k)
            k += 1
            table[key] = nxt
            nxt += 1
            w = c
            if nxt == 4094:
                codes.append(256)
                ks.append(k)
                table.clear()
                nxt, k = 258, 0
        codes.append(w)
        ks.append(k)
        k += 1
    codes.append(257)
    ks.append(k)
    widths = np.array([_lzw_width(x) for x in range(max(ks) + 1)], np.int64)[np.array(ks)]
    start = np.concatenate([[0], np.cumsum(widths)[:-1]])
    j = np.arange(int(widths.sum())) - np.repeat(start, widths)
    bits = (np.repeat(np.array(codes, np.int64), widths) >> (np.repeat(widths, widths) - 1 - j)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def packbits_encode(data: bytes) -> bytes:
    """PackBits (TIFF compression 32773): runs of 3 to 128 equal bytes as a
    repeat, the rest in literal runs of up to 128."""
    out, i, n = bytearray(), 0, len(data)
    lit = bytearray()
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            if lit:
                out += bytes([len(lit) - 1]) + lit
                lit = bytearray()
            out += bytes([257 - (j - i), data[i]])
            i = j
        else:
            lit.append(data[i])
            i += 1
            if len(lit) == 128:
                out += bytes([127]) + lit
                lit = bytearray()
    if lit:
        out += bytes([len(lit) - 1]) + lit
    return bytes(out)


#: the coders of the TIFF compressions :func:`tiff_bytes` writes, by code:
#: none, LZW, Deflate (8 and Adobe's 32946) and PackBits
TIFF_CODERS = {1: bytes, 5: lzw_encode, 8: zlib.compress, 32946: zlib.compress,
               32773: packbits_encode}


def pack_samples(samples, bits: int, order: str = "<") -> bytes:
    """Rows of samples ``(h, w, n)`` as bytes at ``bits`` bits each (16-bit
    samples in byte order ``order``), each row starting on a byte."""
    import numpy as np

    h = samples.shape[0]
    flat = samples.reshape(h, -1).astype(np.int64)
    if bits == 16:
        return flat.astype(order + "u2").tobytes()
    if bits == 8:
        return flat.astype(np.uint8).tobytes()
    b = ((flat[..., None] >> np.arange(bits - 1, -1, -1)) & 1).reshape(h, -1)
    b = np.concatenate([b, np.zeros((h, -b.shape[1] % 8), np.int64)], 1)
    return np.packbits(b.astype(np.uint8), axis=1).tobytes()


def tiff_bytes(samples, photo: int = 2, bits: int = 8, order: str = "<", comp: int = 1,
               pred: int = 1, planar: int = 1, tile=None, rps: int = 16, extra=(),
               colormap=None, orientation=None) -> bytes:
    """A classic TIFF of ``samples (H, W, spp)`` with photometric
    interpretation ``photo`` at ``bits`` bits per sample, in byte order
    ``order`` (``"<"`` or ``">"``): strips of ``rps`` rows or tiles ``(tw,
    th)``, chunky or planar (``planar`` 2), each chunk coded by compression
    ``comp`` (:data:`TIFF_CODERS`) after the horizontal predictor with
    ``pred`` 2 (each sample less its left neighbour); ``extra`` samples,
    a ``colormap`` and an ``orientation`` as their fields give them.  A
    field's values stand in its entry when they fit in 4 bytes, as TIFF
    has it, and out of line otherwise."""
    import struct

    import numpy as np

    H, W, spp = samples.shape
    planes = [samples[..., p:p + 1] for p in range(spp)] if planar == 2 else [samples]
    chunks = []
    for plane in planes:
        if tile:
            tw, th = tile
            for y in range(0, H, th):
                for x in range(0, W, tw):
                    t = np.zeros((th, tw, plane.shape[2]), np.int64)
                    part = plane[y:y + th, x:x + tw]
                    t[:part.shape[0], :part.shape[1]] = part
                    chunks.append(t)
        else:
            chunks += [plane[y:y + rps].astype(np.int64) for y in range(0, H, rps)]
    data = []
    for c in chunks:
        if pred == 2:
            c = c.copy()
            c[:, 1:] = (c[:, 1:] - c[:, :-1]) % (1 << bits)
        data.append(TIFF_CODERS[comp](pack_samples(c, bits, order)))
    body = bytearray(b"II*\x00" if order == "<" else b"MM\x00*") + bytearray(4)
    offsets = []
    for d in data:
        offsets.append(len(body))
        body += d
    entries = [(256, 4, [W]), (257, 4, [H]), (258, 3, [bits] * spp), (259, 3, [comp]),
               (262, 3, [photo]), (277, 3, [spp]), (284, 3, [planar])]
    if tile:
        entries += [(322, 3, [tile[0]]), (323, 3, [tile[1]]), (324, 4, offsets),
                    (325, 4, [len(d) for d in data])]
    else:
        entries += [(273, 4, offsets), (278, 3, [rps]), (279, 4, [len(d) for d in data])]
    if pred != 1:
        entries.append((317, 3, [pred]))
    if extra:
        entries.append((338, 3, list(extra)))
    if colormap is not None:
        entries.append((320, 3, list(colormap)))
    if orientation is not None:
        entries.append((274, 3, [orientation]))
    entries.sort()
    fields = []
    for tag, typ, values in entries:
        code = {3: "H", 4: "I"}[typ]
        raw = struct.pack(f"{order}{len(values)}{code}", *values)
        if len(raw) > 4:
            body += bytes(len(body) % 2)
            fields.append((tag, typ, len(values), struct.pack(order + "I", len(body))))
            body += raw
        else:
            fields.append((tag, typ, len(values), raw + bytes(4 - len(raw))))
    body += bytes(len(body) % 2)
    struct.pack_into(order + "I", body, 4, len(body))
    body += struct.pack(order + "H", len(fields))
    for tag, typ, n, value in fields:
        body += struct.pack(order + "HHI", tag, typ, n) + value
    return bytes(body + bytes(4))


def bmp_rows(values, bits: int) -> bytes:
    """Rows ``(h, w)`` of ``bits``-bit values (or ``(h, w, n)`` bytes) as a
    BMP stores them: bottom-up, each padded to 4 bytes."""
    import numpy as np

    h, w = values.shape[:2]
    if values.ndim == 3:
        raw = values.astype(np.uint8).reshape(h, -1)
    elif bits == 16:
        raw = values.astype("<u2").view(np.uint8).reshape(h, -1)
    else:
        raw = np.frombuffer(pack_samples(values[..., None], bits), np.uint8).reshape(h, -1)
    stride = ((w * bits + 31) >> 3) & ~3
    out = np.zeros((h, stride), np.uint8)
    out[:, :raw.shape[1]] = raw
    return out[::-1].tobytes()


def bmp_bytes(w: int, h: int, bits: int, pixels: bytes, comp: int = 0, masks=None,
              header: int = 40, palette: bytes = b"", colors: int = 0,
              top_down: bool = False) -> bytes:
    """A BMP of ``w x h`` at ``bits`` bits per pixel with the pixel data
    ``pixels`` (:func:`bmp_rows`, or RLE with ``comp`` 1 or 2) under an
    info header of ``header`` bytes; ``masks`` go after a 40-byte header or
    inside a longer one."""
    import struct

    after = b""
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits, comp,
                           len(pixels), 2835, 2835, colors, 0)
        if masks is not None and header == 40:
            after = struct.pack("<3I", *masks[:3])
        elif masks is not None:
            info += struct.pack(f"<{len(masks)}I", *masks)
        info += bytes(header - len(info))
    off = 14 + len(info) + len(after) + len(palette)
    return (b"BM" + struct.pack("<IHHI", off + len(pixels), 0, 0, off) + info + after
            + palette + pixels)


def _polyp_record(i: int, fname: str, hw, ring, area: int) -> tuple[dict, dict]:
    x0, y0 = ring.min(0)
    x1, y1 = ring.max(0)
    return ({"id": i, "file_name": fname, "height": hw[0], "width": hw[1]},
            {"id": i + 1, "image_id": i, "category_id": 1, "iscrowd": 0,
             "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
             "area": float(area), "segmentation": [[round(float(v), 2) for v in ring.reshape(-1)]]})


def write_polyp_split(root: str, split: str, n: int, hw, seed: int, lzw: bool) -> None:
    """``n`` colonoscopy-like frames of ``hw`` in the reference's layout of
    ``split`` (its entry of ``ttdg_mgm_torch/data/builtin.py:SPLITS``) as
    RGB TIFFs, uncompressed or (``lzw``) LZW-coded after the horizontal
    predictor: a lit pink mucosa with darker folds and one polyp per frame,
    a raised red ellipse with a highlight; its 64-vertex polygon ring is the
    ground truth (class 1, "polyp"), the datasets' own annotation form.
    The pixels do not depend on the coding."""
    import numpy as np

    from ttdg_mgm_torch.data.builtin import SPLITS

    json_rel, img_rel = SPLITS[split]
    img_dir = os.path.join(root, img_rel)
    os.makedirs(img_dir, exist_ok=True)
    h, w = hw
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    light = 1.0 - 0.55 * (((yy - h / 2) / h) ** 2 + ((xx - w / 2) / w) ** 2)
    images, anns = [], []
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    for i in range(n):
        folds = 0.85 + 0.15 * np.sin(xx / (0.05 * w) + rng.uniform(0, 6)) * np.cos(yy / (0.07 * h))
        img = np.stack([225 * light * folds, 120 * light * folds, 110 * light * folds], -1)
        img += rng.normal(0, 5, (h, w, 3)).astype(np.float32)
        cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
        ry, rx = rng.uniform(0.1, 0.2) * h, rng.uniform(0.1, 0.2) * w
        polyp = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
        img[polyp] = img[polyp] * [0.9, 0.55, 0.5] + [20, 0, 0]
        spot = ((yy - cy + 0.4 * ry) / (0.15 * ry)) ** 2 + ((xx - cx) / (0.2 * rx)) ** 2 <= 1
        img[spot] = 245
        fname = f"p{i}.tif"
        img = np.clip(img, 0, 255).astype(np.uint8)
        with open(os.path.join(img_dir, fname), "wb") as f:
            f.write(tiff_bytes(img, comp=5, pred=2) if lzw else tiff_bytes(img))
        ring = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)
        im, ann = _polyp_record(i, fname, hw, ring, int(polyp.sum()))
        images.append(im)
        anns.append(ann)
    with open(os.path.join(root, json_rel), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "polyp"}]}, f)


def polyp_frame_int(hw, seed: int):
    """A colonoscopy-like frame of ``hw`` made with integer arithmetic only,
    so its bytes are the same on every host (the committed digests of its
    decode hold on any machine): a lit mucosa with folds (a triangle wave),
    uniform integer noise, one polyp (an integer ellipse) with a highlight.
    Returns the ``(H, W, 3)`` uint8 frame and the polyp's ``(cy, cx, ry,
    rx)``."""
    import numpy as np

    h, w = hw
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    yy, xx = yy.astype(np.int64), xx.astype(np.int64)
    light = 1000 - 550 * ((2 * yy - h) ** 2 * w * w + (2 * xx - w) ** 2 * h * h) // (
        4 * h * h * w * w)
    period = max(w // 12, 2)
    tri = np.abs((xx + int(rng.randint(period))) % period * 2 - period)
    shade = light * (700 + 300 * tri // period)                  # in millionths
    img = np.stack([225 * shade, 120 * shade, 110 * shade], -1) // 1000000
    img += rng.randint(-6, 7, (h, w, 3))
    cy, cx = int(rng.randint(3 * h // 10, 7 * h // 10)), int(rng.randint(3 * w // 10, 7 * w // 10))
    ry, rx = int(rng.randint(h // 10, h // 5)), int(rng.randint(w // 10, w // 5))
    polyp = ((yy - cy) * rx) ** 2 + ((xx - cx) * ry) ** 2 <= (rx * ry) ** 2
    img[polyp] = img[polyp] * np.array([9, 11, 10]) // np.array([10, 20, 20]) + [20, 0, 0]
    sy, sx = max(ry * 15 // 100, 1), max(rx * 20 // 100, 1)
    spot = ((yy - cy + 4 * ry // 10) * sx) ** 2 + ((xx - cx) * sy) ** 2 <= (sx * sy) ** 2
    img[spot] = 245
    return np.clip(img, 0, 255).astype(np.uint8), (cy, cx, ry, rx)


def copy_jpeg_split(root: str, split: str) -> None:
    """The committed 1280 x 959 baseline JPEGs with their polygon ground
    truth (``tests/fixtures/torch_jpeg``) in the reference's layout of
    ``split``."""
    import shutil

    from ttdg_mgm_torch.data.builtin import SPLITS

    json_rel, img_rel = SPLITS[split]
    os.makedirs(os.path.join(root, img_rel), exist_ok=True)
    for f in sorted(os.listdir(JPEG_FIXTURES)):
        if f.endswith(".jpg"):
            shutil.copy(os.path.join(JPEG_FIXTURES, f), os.path.join(root, img_rel))
    shutil.copy(os.path.join(JPEG_FIXTURES, "annotations.json"), os.path.join(root, json_rel))


def write_train_data(data: str) -> None:
    """Phase 10's synthetic splits of ``configs/seg_res50fpn_source.yaml``'s
    ``DATASETS.TRAIN`` and ``BKAI_test`` under ``data`` (the same files on
    every call)."""
    copy_jpeg_split(data, "BKAI_train")
    copy_jpeg_split(data, "BKAI_test")
    for i, (split, n, hw, lzw) in enumerate(POLYP_SPLITS):
        write_polyp_split(data, split, n, hw, i, lzw)


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in state.items()}


def capture_train(torch, dev, snapshots: bool = False, kernel_inputs: bool = False):
    """Wraps, in the modules the trainers call them from: the train and
    two-crop loaders (the seconds each ``next`` blocks), the source,
    burn-in and MT steps (their synchronized times, their losses, the
    kernel launches each adds, the forward-only and training pool calls of
    each, float32 parameters and gradients after each), the pseudo-labels
    (per image), the resume (a host copy of the trainer's state just
    restored, in its checkpoint layout), the trainers' training calls, the
    validation loss hook, the checkpointer's saves and loads (their
    seconds) and ``init_params`` (a host copy of the weights it gives the
    model); and listens to the log line of ``init_params``.  With
    ``snapshots``, host copies of the student and the teacher as each of
    the first two MT steps sees them; with ``kernel_inputs``, copies of what
    kernels A and C get on the first source or MT step (each pool call's
    levels and ROIs, :func:`capture_pool_backward`), of what HiPPI and
    kernel D get on every source or MT step (:func:`capture_hippi`), of the
    pool calls of ``test`` (the first call of each of
    :func:`test_pool_name`'s names, under ``"test_pools"``) and of every
    GA-GM input (:func:`capture_gagm`, under ``"gagm_inputs"``).  On a
    cross-domain MT step (``make_mt_step(..., with_cross_domain=True)``) it
    keeps host copies of the centers the step gets and returns
    (``"centers"``), and of the inputs and output of each center update
    (``"center_updates"``).  Keeps the model, teacher, batch, settings and
    centers of the last MT step under ``"last"``.  Returns the record and
    the function that undoes it."""
    import logging

    import ttdg_mgm_torch.build as build
    import ttdg_mgm_torch.engine.mean_teacher as mt
    import ttdg_mgm_torch.engine.steps as steps
    import ttdg_mgm_torch.engine.trainer as trainer
    import ttdg_mgm_torch.graph.cross_domain as cross_domain
    import ttdg_mgm_torch.models.rcnn as rcnn
    from ttdg_mgm_torch.checkpoint.save import Checkpointer
    from ttdg_mgm_torch.engine.hooks import LossEvalHook

    record = {"wait_s": [], "steps": [], "pseudo": [], "resumed": None, "train_s": [],
              "val_s": [], "save_s": [], "save_bytes": [], "load_s": [], "weights": None,
              "init": None, "seen": [], "kernel_inputs": None, "split_ms": None,
              "centers": [], "center_updates": [], "test_pools": {}, "gagm_inputs": []}
    pools = {"forward": 0, "training": 0}
    taking = {"pools": None, "where": None}
    patches = []

    def patch(obj, name, wrap):
        real = getattr(obj, name)
        patches.append((obj, name, real))
        setattr(obj, name, wrap(real))

    class TimedLoader:
        def __init__(self, loader):
            self.loader = loader

        def __next__(self):
            t0 = time.perf_counter()
            batch = next(self.loader)
            record["wait_s"].append(time.perf_counter() - t0)
            return batch

        def close(self):
            self.loader.close()

    def loader(real):
        def build_loader(*a, **k):
            record["loader_call"] = (real, a, k)
            return TimedLoader(real(*a, **k))
        return build_loader

    def timed(kind, model, step, kw):
        cd = kw.get("with_cross_domain", False)

        def run(*a, **k):
            take = kind in ("mt", "source") and kernel_inputs
            first = take and record["kernel_inputs"] is None
            if kind == "mt" and snapshots and len(record["seen"]) < 2:
                record["seen"].append((_host(model.state_dict()), _host(a[0].state_dict())))
            if take:
                hippi, undo_hippi = capture_hippi()
            if first:
                bwd, undo_bwd = capture_pool_backward()
                taking["pools"] = []
            before = read_counters()
            pools.update(forward=0, training=0)
            _sync(torch, dev)
            t0 = time.perf_counter()
            try:
                out = step(*a, **k)
                _sync(torch, dev)
            finally:
                if first:
                    undo_bwd()
                if take:
                    undo_hippi()
            ms = (time.perf_counter() - t0) * 1e3
            metrics = out[0] if cd else out
            after = read_counters()
            check_f32_params(torch, model, f"{kind} step")
            record["steps"].append(dict(
                kind=kind, ms=ms, losses={n: float(v) for n, v in metrics.items()},
                launches={n: after[n] - before[n] for n in after if after[n] > before[n]},
                pools=dict(pools), took_inputs=bool(take)))
            if first:
                record["kernel_inputs"] = dict(pools=taking["pools"], backward=bwd, hippi=hippi)
                taking["pools"] = None
            elif take:
                for k, v in hippi.items():
                    record["kernel_inputs"]["hippi"][k] += v
            if cd:
                record["centers"].append((a[1].detach().cpu().clone(),
                                          out[1].detach().cpu().clone()))
            if kind == "mt":
                record["last"] = (model, a[0], a[2] if cd else a[1], kw, out[1] if cd else None)
            return out
        return run

    def step_factory(kind):
        def wrap(real):
            def make(model, optimizer, **kw):
                return timed(kind, model, real(model, optimizer, **kw), kw)
            return make
        return wrap

    def pool(kind):
        def wrap(real):
            def call(levels, boxes, **k):
                pools[kind] += 1
                name = (test_pool_name(taking["where"], k.get("output_size", 7))
                        if kernel_inputs and taking["where"] is not None else None)
                if taking["pools"] is not None or (name and name not in record["test_pools"]):
                    copy = ([x.detach().clone() for x in levels], boxes.detach().clone(), k)
                    if taking["pools"] is not None:
                        taking["pools"].append((kind, *copy))
                    else:
                        record["test_pools"][name] = copy
                return real(levels, boxes, **k)
            return call
        return wrap

    def pseudo(real):
        def threshold_pseudo_labels(det, **kw):
            out = real(det, **kw)
            record["pseudo"].append(out[2].sum(1).tolist())
            return out
        return threshold_pseudo_labels

    def resume(real):
        def resume_or_load(self, checkpointer):
            resumed = real(self, checkpointer)
            if resumed:
                sd = self.state_dict()
                record["resumed"] = dict(
                    model=_host(sd["model"]), iteration=sd["iteration"],
                    optimizer={"state": {i: {"momentum_buffer": s["momentum_buffer"].detach()
                                             .cpu().clone()}
                                         for i, s in sd["optimizer"]["state"].items()}})
            return resumed
        return resume_or_load

    def training(real):
        def train(self, *a, **k):
            t0 = time.perf_counter()
            try:
                return real(self, *a, **k)
            finally:
                _sync(torch, dev)
                record["train_s"].append(time.perf_counter() - t0)
        return train

    def where(name, real):
        def call(*a, **k):
            before, taking["where"] = taking["where"], name
            try:
                return real(*a, **k)
            finally:
                taking["where"] = before
        return call

    def val(real):
        def call(self, it, metrics):
            t0 = time.perf_counter()
            n = len(self.history)
            out = real(self, it, metrics)
            if len(self.history) > n:
                record["val_s"].append(time.perf_counter() - t0)
            return out
        return call

    def save(real):
        def call(self, step, state):
            t0 = time.perf_counter()
            path = real(self, step, state)
            record["save_s"].append(time.perf_counter() - t0)
            record["save_bytes"].append(os.path.getsize(path))
            return path
        return call

    def restore(real):
        def call(self, step=None):
            t0 = time.perf_counter()
            out = real(self, step)
            if out is not None:
                record["load_s"].append(time.perf_counter() - t0)
            return out
        return call

    def centers(real):
        def update_centers(c, nodes, labels, mask, momentum):
            new = real(c, nodes, labels, mask, momentum)
            record["center_updates"].append(dict(
                centers=c.detach().cpu().clone(), nodes=nodes.detach().cpu().clone(),
                labels=labels.cpu().clone(), mask=mask.cpu().clone(), momentum=momentum,
                out=new.cpu().clone()))
            return new
        return update_centers

    def init(real):
        def init_params(cfg, model, seed=0):
            out = real(cfg, model, seed)
            record["init"] = _host(out.state_dict())
            return out
        return init_params

    class Listen(logging.Handler):
        def emit(self, rec):
            if rec.msg.startswith("loaded %d tensors"):
                record["weights"] = rec.args

    lg = logging.getLogger("ttdg_mgm_torch")
    handler, level = Listen(), lg.level
    lg.addHandler(handler)
    lg.setLevel(logging.INFO)
    patch(trainer, "build_train_loader", loader)
    patch(mt, "build_two_crop_loader", loader)
    patch(trainer, "make_source_step", step_factory("source"))
    patch(mt, "make_source_step", step_factory("burn-in"))
    patch(mt, "make_mt_step", step_factory("mt"))
    patch(rcnn, "multilevel_roi_pool", pool("forward"))
    patch(rcnn, "multilevel_roi_pool_train", pool("training"))
    patch(steps, "threshold_pseudo_labels", pseudo)
    patch(trainer.BaselineTrainer, "resume_or_load", resume)
    patch(trainer.BaselineTrainer, "train", training)
    patch(mt.ATeacherTrainer, "train_semisup", training)
    patch(LossEvalHook, "__call__", val)
    patch(Checkpointer, "save", save)
    patch(Checkpointer, "restore", restore)
    patch(build, "init_params", init)
    patch(cross_domain, "update_centers", centers)
    if kernel_inputs:
        patch(trainer.BaselineTrainer, "test", lambda real: where("tta", real))
        patch(trainer, "evaluate_dataset", lambda real: where("inference", real))
        record["gagm_inputs"], undo_gagm = capture_gagm()

    def undo():
        if kernel_inputs:
            undo_gagm()
        for obj, name, real in reversed(patches):
            setattr(obj, name, real)
        lg.removeHandler(handler)
        lg.setLevel(level)

    return record, undo


def _checkpoint_differences(torch, a: dict, b: dict) -> list:
    """Names whose tensors differ (or are missing) between two checkpoints
    of d2's layout: the weights, the momentum buffers and the step."""
    out = [k for k in a["model"].keys() | b["model"].keys()
           if k not in a["model"] or k not in b["model"]
           or not torch.equal(a["model"][k], b["model"][k])]
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    out += [f"momentum {i}" for i in sa.keys() | sb.keys()
            if i not in sa or i not in sb
            or not torch.equal(sa[i]["momentum_buffer"], sb[i]["momentum_buffer"])]
    return out + (["iteration"] if a["iteration"] != b["iteration"] else [])


def _log_train_call(record, what: str, card: str) -> None:
    ms = [s["ms"] for s in record["steps"]]
    mt_ms = [s["ms"] for s in record["steps"] if s["kind"] == "mt"]
    parts = [f"steps {[(s['kind'], round(s['ms'], 1)) for s in record['steps']]} ms",
             f"loader wait s {[round(x, 4) for x in record['wait_s']]}"]
    if ms:
        parts.append(f"{record['train_s'][0] / len(ms):.3f} s/iter over {len(ms)} steps "
                     f"(median step {statistics.median(ms[1:] or ms):.1f} ms, median wait "
                     f"{statistics.median(record['wait_s']):.3f} s)")
    if mt_ms:
        parts.append(f"median MT step {statistics.median(mt_ms):.1f} ms, pseudo-boxes per "
                     f"image {record['pseudo']}")
    if record["save_bytes"]:
        parts.append(f"checkpoint {record['save_bytes'][0] / 2 ** 20:.1f} MiB")
    parts += [f"validation loss s {[round(x, 3) for x in record['val_s']]}",
              f"save s {[round(x, 3) for x in record['save_s']]}, load s "
              f"{[round(x, 3) for x in record['load_s']]}",
              f"main() {record['main_s']:.1f} s", f"peak memory {record['peak_gib']:.2f} GiB",
              f"launches per step {[s['launches'] for s in record['steps']]}",
              f"pool calls per step {[s['pools'] for s in record['steps']]}"]
    log(f"{what} ({card}): " + "; ".join(parts))


def _train_call(torch, dev, argv, what: str, split_reps: int = 0, probe: bool = False,
                **capture):
    """``train_net_torch.main(argv)`` under :func:`capture_train` (with
    ``capture`` its options), with the kernel counters set to 0 just before
    and read just after, and the peak device memory over the call; with
    ``split_reps``, then the split of its last MT step between its passes;
    with ``probe``, the quality of the final teacher's pseudo-labels
    (:func:`probe_teacher`)."""
    import train_net_torch

    record, undo = capture_train(torch, dev, **capture)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    try:
        t0 = time.perf_counter()
        record["result"] = train_net_torch.main(argv)
        record["main_s"] = time.perf_counter() - t0
    finally:
        record["launches"] = read_counters()
        undo()
    record["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0
    last = record.pop("last", None)
    if split_reps and last is not None:
        record["split_ms"] = mt_pass_split(torch, dev, *last, reps=split_reps)
    if probe and last is not None:
        record["probe"] = probe_teacher(torch, dev, record, *last[1:4])
    del last
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2", "yaml"))
    check(not foreign, f"{what}: imported {foreign[:5]}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return record


def _check_train(record, what: str, kinds, ckdir: str, want_ckpts, counters, val_iters=None,
                 extra_losses=()):
    """The gates every training call passes: the source, burn-in and MT
    steps where they belong; every loss finite (the domain and ``_pseudo``
    losses included) and ``loss_matching`` positive; on every step each
    kernel of ``counters`` launched (the bf16 pool once per pool call); on
    every MT step the teacher's forward-only pool and the student's
    training pools called, and pseudo-boxes; the checkpoints at the
    expected steps (at most 5); with ``val_iters``, a finite validation loss
    at each period; on every MT step the losses of ``extra_losses`` too."""
    got = [s["kind"] for s in record["steps"]]
    check(got == list(kinds), f"{what}: steps {got}, expected {list(kinds)}")
    need = {"loss_D_img_s", "loss_D_img_t", "loss_cls_pseudo", "loss_rpn_cls_pseudo",
            "loss_box_reg_pseudo", "loss_rpn_loc_pseudo", "loss_matching", "total_loss",
            *extra_losses}
    for i, s in enumerate(record["steps"]):
        m = s["losses"]
        bad = {k: v for k, v in m.items() if not math.isfinite(v)}
        check(not bad, f"{what} step {i}: non-finite losses {bad}")
        check(m["loss_matching"] > 0.0, f"{what} step {i}: loss_matching {m['loss_matching']}")
        missing = [k for k in counters if s["launches"].get(k, 0) < 1]
        check(not missing, f"{what} step {i}: kernels {missing} not launched ({s['launches']})")
        check("roi_pool_bf16" not in counters
              or s["launches"].get("roi_pool_bf16", 0) == sum(s["pools"].values()),
              f"{what} step {i}: {s['launches']} for pool calls {s['pools']}")
        if s["kind"] == "mt":
            check(need <= set(m), f"{what} step {i}: losses {sorted(m)}")
            check(s["pools"]["forward"] >= 1 and s["pools"]["training"] >= 1,
                  f"{what} step {i}: pool calls {s['pools']}")
    if "mt" in kinds:
        check(record["pseudo"] and all(sum(p) > 0 for p in record["pseudo"]),
              f"{what}: pseudo-boxes per image {record['pseudo']}")
    names = sorted(f for f in os.listdir(ckdir) if f.endswith(".pth"))
    check(names == [f"model_{s:07d}.pth" for s in want_ckpts] and len(names) <= 5,
          f"{what}: checkpoints {names}, expected steps {list(want_ckpts)}")
    if val_iters is not None:
        val = record["result"]["validation_loss"]
        check([it for it, _ in val] == list(val_iters) and all(math.isfinite(v) for _, v in val),
              f"{what}: validation loss {val}, expected at {list(val_iters)}")


def loader_host_s(record, batches: int) -> tuple[list, list]:
    """The host seconds per batch of the call's train loader (same records,
    geometry and seed) on the calling thread, with no step or hook to hide
    them, and the seconds of each batch spent decoding files (in
    ``data/loader.py:load_image``)."""
    from ttdg_mgm_torch.data import loader as loader_mod

    build_loader, a, k = record["loader_call"]
    loader = build_loader(*a, **{**k, "prefetch": 0})
    load, spent = loader_mod.load_image, [0.0]

    def timed_load(path):
        t0 = time.perf_counter()
        try:
            return load(path)
        finally:
            spent[0] += time.perf_counter() - t0

    out, decode = [], []
    loader_mod.load_image = timed_load
    try:
        for _ in range(batches):
            spent[0] = 0.0
            t0 = time.perf_counter()
            next(loader)
            out.append(time.perf_counter() - t0)
            decode.append(spent[0])
    finally:
        loader_mod.load_image = load
        loader.close()
    return out, decode


def phase_train_cli(torch, dev, data: str, card: str = "", opts=(), eval_opts=(),
                    counters=TRAIN_COUNTERS, what: str = "train cli"):
    """Source training as a user runs it: ``train_net_torch.main(["--config",
    "configs/seg_res50fpn_source.yaml", ...])`` at full width with the
    shipped config (R50-FPN, batch 8, the bf16 policy of
    ``SOLVER.AMP.ENABLED``, ``BASE_LR`` 0.0025 with its warm-up,
    ``MIN_SIZE_TRAIN`` choice, the square 800 canvas, 32 GT slots), random
    weights (``MODEL.WEIGHTS ""``), on synthetic splits of its
    ``DATASETS.TRAIN`` in the reference's layout with polygon ground truth
    under ``data`` (:func:`write_train_data`):
    ``BKAI_train`` the 3 committed 1280 x 959 JPEGs, ``CVC_ClinicDB_train``
    4 uncompressed TIFF frames of 384 x 288, ``ETIS_LaribPolypDB_train`` 3
    LZW TIFF frames of 1225 x 966 with the horizontal predictor (10
    records; :data:`POLYP_SPLITS`), and ``BKAI_test`` the JPEGs again for the
    validation loss.  Call 1 trains 4 steps (checkpoints every 2, the
    validation loss every 2), its first step also copying its kernels'
    inputs; call 2 the same command to 6 steps, resumed at step 4 bit for
    bit; call 3 call 2 again from a directory that holds only the step-4
    checkpoint, its final checkpoint bit for bit call 2's (the loader, its
    prefetch thread and the generator restart deterministically); call 4
    ``--eval-only --config configs/test_segment.yaml`` (with
    ``eval_opts``) on call 2's final file (every tensor loaded, finite Dice,
    E and S on ``BKAI_test``).  Kernels A, C and D are held on call 1's
    first step's inputs, A and B on call 4's (:func:`hold_call_kernels`).
    ``opts`` follow the command line of every training call; ``what`` names
    the phase in the log.  Logs per step the loader wait and the
    synchronized step time, s/iter, the validation loss's seconds, the
    checkpoints' size and save and load seconds, the peak memory and the
    kernels' launches per step; then the train loader's host time per batch
    on one thread (the waits hide behind the first step's set-up and the
    validation loss) against the step time."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        cfg = os.path.join(HERE, "configs", "seg_res50fpn_source.yaml")
        out = os.path.join(tmp, "out")

        def argv(out_dir, max_iter):
            return ["--device", str(dev), "--config", cfg, "--datasets-root", data,
                    "MODEL.WEIGHTS", "", "OUTPUT_DIR", out_dir, "SOLVER.MAX_ITER", str(max_iter),
                    "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "2", *opts]

        log(f"{what}: 10 training records (3 JPEG 1280x959, 4 TIFF 384x288, 3 LZW TIFF "
            f"1225x966) and BKAI_test; train_net_torch.main({' '.join(argv(out, 4)[2:4])} ...)")
        ckdir = os.path.join(out, "checkpoints")
        calls = {}
        calls[1] = _train_call(torch, dev, argv(out, 4), f"{what} call 1", kernel_inputs=True)
        ck_mib = calls[1]["save_bytes"][0] / 2 ** 20
        _log_train_call(calls[1], f"{what} call 1", card)
        _check_train(calls[1], f"{what} call 1", ("source",) * 4, ckdir, (2, 4), counters, (2, 4))
        check(calls[1]["resumed"] is None, f"{what} call 1 resumed from a checkpoint")
        lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
        check([x["iteration"] for x in lines] == [3] and "total_loss" in lines[0],
              f"{what} call 1: metrics.json lines {lines}")
        held = hold_call_kernels(torch, dev, calls[1], f"{what} call 1", step_pools=SOURCE_POOLS)
        del calls[1]["kernel_inputs"], calls[1]["test_pools"], calls[1]["gagm_inputs"]
        out3 = os.path.join(tmp, "out3")
        os.makedirs(os.path.join(out3, "checkpoints"))
        shutil.copy(os.path.join(ckdir, "model_0000004.pth"), os.path.join(out3, "checkpoints"))

        calls[2] = _train_call(torch, dev, argv(out, 6), f"{what} call 2")
        _log_train_call(calls[2], f"{what} call 2", card)
        _check_train(calls[2], f"{what} call 2", ("source",) * 2, ckdir, (2, 4, 6), counters,
                     (6,))
        step4 = torch.load(os.path.join(ckdir, "model_0000004.pth"), map_location="cpu",
                           weights_only=False)
        res = calls[2]["resumed"]
        check(res is not None, f"{what} call 2 did not resume")
        diff = _checkpoint_differences(torch, res, step4)
        check(not diff, f"{what} call 2: the resumed state differs from the step-4 file in "
              f"{diff[:6]}")
        lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
        check([x["iteration"] for x in lines] == [3, 5], f"{what} call 2: metrics.json {lines}")
        weights = os.path.join(ckdir, "model_0000006.pth")
        final2 = torch.load(weights, map_location="cpu", weights_only=False)
        calls[3] = _train_call(torch, dev, argv(out3, 6), f"{what} call 3")
        _log_train_call(calls[3], f"{what} call 3", card)
        _check_train(calls[3], f"{what} call 3", ("source",) * 2,
                     os.path.join(out3, "checkpoints"), (4, 6), counters, (6,))
        final3 = torch.load(os.path.join(out3, "checkpoints", "model_0000006.pth"),
                            map_location="cpu", weights_only=False)
        diff = _checkpoint_differences(torch, final2, final3)
        check(not diff, f"{what} call 3: its final checkpoint differs from call 2's in {diff[:6]}")
        check([s["losses"]["total_loss"] for s in calls[3]["steps"]]
              == [s["losses"]["total_loss"] for s in calls[2]["steps"]],
              f"{what} call 3: losses differ from call 2's")
        host_s, decode_s = loader_host_s(calls[1], LOADER_BATCHES)

        # after 6 steps from random weights every polyp score is below the
        # config's SCORE_THRESH_TEST 0.05: no detection, and Dice, E and S of
        # nothing are NaN; a floor of 0 keeps the top detections scored
        ev = ["--eval-only", "--device", str(dev), "--config",
              os.path.join(HERE, "configs", "test_segment.yaml"), "--datasets-root", data,
              "MODEL.WEIGHTS", weights, "MODEL.ROI_HEADS.NUM_CLASSES", "1",
              "DATASETS.TEST", '["BKAI_test"]', "TEST.DICE_THRES", "0.0",
              "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
              "OUTPUT_DIR", os.path.join(tmp, "eval"), *eval_opts]
        calls[4] = _train_call(torch, dev, ev, f"{what} call 4", kernel_inputs=True)
        log(f"{what} call 4 ({card}): eval-only on the trained file {calls[4]['main_s']:.1f} "
            f"s, init_params {calls[4]['weights']}, results "
            f"{json.dumps(calls[4]['result'].get('BKAI_test'))}, launches "
            f"{ {k: v for k, v in calls[4]['launches'].items() if v} }")
        n_loaded, _, n_shape, n_absent = calls[4]["weights"] or (0, "", -1, -1)
        check(n_loaded == len(final2["model"]) and n_shape == 0 and n_absent == 0,
              f"{what} call 4: {n_loaded} of {len(final2['model'])} tensors loaded, "
              f"{n_shape} of another shape, {n_absent} absent")
        metrics = calls[4]["result"]["BKAI_test"]
        check(len(metrics) == 3 and all(math.isfinite(v) for v in metrics.values()),
              f"{what} call 4: Dice, E and S not all finite: {metrics}")
        held_eval = hold_call_kernels(torch, dev, calls[4], f"{what} call 4",
                                      test_pools=TEST_POOLS)
        del calls[4]["test_pools"], calls[4]["gagm_inputs"]

    trained = (1, 2, 3)
    summary = {}
    for c in trained:
        r = calls[c]
        summary[f"call{c}"] = dict(
            wait_s=r["wait_s"], step_ms=[s["ms"] for s in r["steps"]],
            s_per_iter=r["train_s"][0] / len(r["steps"]), train_s=r["train_s"][0],
            main_s=r["main_s"], val_s=r["val_s"], save_s=r["save_s"], load_s=r["load_s"],
            peak_gib=r["peak_gib"], total_loss=[s["losses"]["total_loss"] for s in r["steps"]],
            launches_per_step=[s["launches"] for s in r["steps"]], launches=r["launches"])
    steps = [s["ms"] for c in trained for s in calls[c]["steps"][1:]]
    ratio = statistics.median(host_s) * 1e3 / statistics.median(steps)
    log(f"{what} ({card}): the loader's host time per batch of 8 on one thread "
        f"{[round(x, 3) for x in host_s]} s, median {statistics.median(host_s):.3f} s, of it "
        f"decoding files {[round(x, 3) for x in decode_s]} s, against the median step after "
        f"the first {statistics.median(steps):.1f} ms: loader / step {ratio:.1f}")
    held["pools"].update(held_eval.pop("pools"))
    return dict(summary=summary, launches=calls[1]["launches"], checkpoint_mib=ck_mib,
                step_losses=[s["losses"] for s in calls[1]["steps"]],
                loader_host_s=host_s, loader_decode_s=decode_s, loader_over_step=ratio,
                eval_metrics=metrics,
                eval_main_s=calls[4]["main_s"], eval_launches=calls[4]["launches"],
                peak_gib=calls[1]["peak_gib"], held={**held, **held_eval})


# -- phase 11: the mean-teacher trainer through the command line ------------------

#: synthetic fundus splits of phase 11, ``(split, records, (h, w))``: the
#: labelled and unlabelled training splits of ``configs/seg_res50fpn_MT.yaml``
#: at RIM-ONE r3's and REFUGE's frame sizes, and a REFUGE test split (cut to
#: 800 x 800, so that scoring every detection stays cheap) for the eval calls
MT_SPLITS = (("RIM_ONE_r3_train", 5, (1424, 1072)), ("REFUGE_train", 5, (2056, 2124)),
             ("REFUGE_test", 4, (800, 800)))
#: overrides of the shipped MT config, each with its reason
MT_OVERRIDES = (
    ("SEMISUPNET.BURN_UP_STEP", "2", "the shipped config keeps the default 12000, above its "
     "MAX_ITER 10000, so it never leaves burn-in: 2 burn-in steps, then the copy and MT steps"),
    ("SEMISUPNET.BBOX_THRESHOLD", "0.3", "random weights score about 1/3 (2 classes and "
     "background), under the shipped 0.8: 0.3 gives the unlabelled pass pseudo-boxes"),
    ("SOLVER.CHECKPOINT_PERIOD", "2", "checkpoints inside a 4-step run, for the resume"),
)
MT_SPLIT_REPS = 3
MT_LOADER_BATCHES = 3


def mt_pass_split(torch, dev, model, teacher, batch, kw, centers, reps: int) -> dict:
    """The MT step's passes apart, each synchronized, median of ``reps``:
    the teacher's detection on the weak unlabelled views, the labelled pass
    (forward and backward), the pseudo-labelled pass and the two domain
    passes; on a cross-domain step (``centers`` given) a fifth, the
    cross-domain head's (``loss_cross_domain``: the backbone on both strong
    views, the nodes, the head, and their backward).  Gradients are dropped
    after each; no weight changes."""
    from ttdg_mgm_torch.engine.steps import threshold_pseudo_labels

    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"teacher": [], "labelled": [], "unlabelled": [], "domain": []}
    if centers is not None:
        out["cross_domain"] = []

    def timed(name, fn):
        _sync(torch, dev)
        t0 = time.perf_counter()
        res = fn()
        _sync(torch, dev)
        out[name].append((time.perf_counter() - t0) * 1e3)
        model.zero_grad(set_to_none=True)
        return res

    for _ in range(reps):
        det = timed("teacher", lambda: teacher.proposals_weak(batch["unlabel_weak"],
                                                              batch["unlabel_sizes"]))
        pb, pc, pv = threshold_pseudo_labels(det, threshold=kw["pseudo_threshold"],
                                             max_boxes=kw["gt_cap"])
        timed("labelled", lambda: sum(model.loss_supervised(
            batch["label_strong"], batch["label_sizes"], batch["gt_boxes"],
            batch["gt_classes"], batch["gt_masks"], batch["gt_valid"],
            generator=gen).values()).backward())

        def unlabelled():
            u = model.loss_supervised(batch["unlabel_strong"], batch["unlabel_sizes"], pb, pc,
                                      torch.zeros_like(batch["gt_masks"][:, :pb.shape[1]]), pv,
                                      generator=gen, source=False, with_mask=False)
            (u["loss_cls"] + u["loss_rpn_cls"]).backward()

        timed("unlabelled", unlabelled)
        timed("domain", lambda: sum(model.loss_domain(batch["label_weak"],
                                                      batch["unlabel_weak"]).values()).backward())
        if centers is not None:
            timed("cross_domain", lambda: sum(model.loss_cross_domain(
                batch["label_strong"], batch["label_sizes"], batch["gt_boxes"],
                batch["gt_classes"], batch["gt_valid"], batch["unlabel_strong"],
                batch["unlabel_sizes"], pb, pc, pv, centers,
                noise=model.cross_domain.draw_noise(gen, dev))[0].values()).backward())
    return {k: statistics.median(v) for k, v in out.items()}


def probe_teacher(torch, dev, record, teacher, batch, kw) -> dict:
    """The quality of ``teacher``'s pseudo-labels (``engine/probe.py``) on
    one batch of the call's unlabelled split with its synthetic ground
    truth: the train loader over that split at the call's geometry and
    seed (weak views: resize and flip), the teacher's detections above the
    step's threshold, cut to its GT slots."""
    from ttdg_mgm_torch.data.loader import build_train_loader
    from ttdg_mgm_torch.engine.probe import (probe_ood_accuracy, probe_pseudo_labels,
                                             probe_size_distribution)
    from ttdg_mgm_torch.engine.steps import threshold_pseudo_labels

    _, a, k = record["loader_call"]
    B = batch["unlabel_weak"].shape[0]
    loader = build_train_loader(a[1], batch_size=B, prefetch=0, **{
        n: k[n] for n in ("canvas", "min_size", "max_size", "gt_cap", "mask_res", "seed")})
    try:
        b = {n: torch.from_numpy(v).to(dev) for n, v in next(loader).items()}
    finally:
        loader.close()
    det = teacher.proposals_weak(b["image"], b["image_sizes"])
    pb, pc, pv = threshold_pseudo_labels(det, threshold=kw["pseudo_threshold"],
                                         max_boxes=kw["gt_cap"])
    ps = torch.where(det["valid"] & (det["scores"] > kw["pseudo_threshold"]), det["scores"],
                     0.0)[:, :kw["gt_cap"]]
    host = {n: v.cpu().numpy() for n, v in dict(pb=pb, pc=pc, pv=pv, ps=ps,
                                                 gb=b["gt_boxes"], gc=b["gt_classes"],
                                                 gv=b["gt_valid"]).items()}
    return dict(split=list(a[1]), images=B, threshold=kw["pseudo_threshold"],
                labels=probe_pseudo_labels(host["pb"], host["pc"], host["pv"], host["gb"],
                                           host["gc"], host["gv"]),
                sizes=probe_size_distribution(host["pb"], host["pv"]),
                ood=probe_ood_accuracy(host["ps"], host["pv"], host["pb"], host["gb"],
                                       host["gv"]))


def test_pool_name(where: str, P: int) -> str:
    """The name of a pool call of ``test``: ``where`` it runs (``"tta"``, the
    adaptation step; ``"inference"``, ``evaluate_dataset``) and what it
    pools."""
    return f"{where} {'box' if P == 7 else 'mask'}"


def hold_call_kernels(torch, dev, rec, what: str, step_pools=(), test_pools=()) -> dict:
    """Each kernel of one call on what the call gave it (``rec``, from
    :func:`capture_train` with ``kernel_inputs``), against its plain
    version; ``what`` names the call in the log.  With ``step_pools`` (the
    names of the first step's pool calls: ``"teacher box"``, the MT step's
    forward-only box pool; ``"labelled box"`` and ``"labelled mask"``, the
    training pools of the labelled pass; ``"pseudo-labelled box"``): A on
    each of those calls, C on that step's cotangents, D on every projection
    of HiPPI on every source or MT step, and the longest of those HiPPI
    calls rerun with the plain projection.  With ``test_pools`` (the names
    of :func:`test_pool_name`): A on the first pool call of each, and B on
    every GA-GM input of the call's adaptation (:func:`phase_gagm_main`).
    These launches are not the main path's."""
    out = {"pools": {}}
    if step_pools:
        ki = rec["kernel_inputs"]
        check(ki is not None, f"{what}: no step's kernel inputs were taken")
        names = []
        for kind, levels, rois, kw in ki["pools"]:
            P = kw.get("output_size", 7)
            check(kw.get("sampling_ratio", 0) == 0, f"{what}: pool options {kw} are not the "
                  "flagship's")
            if kind == "forward":
                name = "teacher box"
            else:
                name = "labelled " + ("box" if P == 7 else "mask")
                if name in out["pools"]:
                    name = "pseudo-labelled box"
                names.append((rois, name))
            B, K = rois.shape[:2]
            out["pools"][name] = hold_pool(
                torch, levels, rois, P, f"{what} roi_pool {name}",
                f"levels {tuple(levels[0].shape)}..{tuple(levels[-1].shape)}, {B} x {K} ROIs "
                "of one step")
        check(sorted(out["pools"]) == sorted(step_pools),
              f"{what}: pool calls of one step {sorted(out['pools'])}, expected "
              f"{sorted(step_pools)}")
        out["backward"] = phase_roi_backward_main(torch, dev, ki["backward"], names=names)
        steps = [h[-1]["steps"] for h in ki["hippi"]["hippi"]]
        log(f"{what}: {len(steps)} HiPPI calls on the steps, iterations {steps}")
        err, rerun = hold_sinkhorn(torch, ki["hippi"], f"{what}'s steps")
        out["sinkhorn"] = dict(max_abs_err=err, hippi_steps=steps,
                               projections_checked=len(ki["hippi"]["projections"]),
                               hippi_rerun=rerun)
    if test_pools:
        got = rec["test_pools"]
        check(sorted(got) == sorted(test_pools), f"{what}: pool calls of test {sorted(got)}, "
              f"expected {sorted(test_pools)}")
        for name, (levels, rois, kw) in got.items():
            B, K = rois.shape[:2]
            out["pools"][name] = hold_pool(
                torch, levels, rois, kw.get("output_size", 7), f"{what} roi_pool {name}",
                f"levels {tuple(levels[0].shape)}..{tuple(levels[-1].shape)}, {B} x {K} ROIs "
                "of the first such call of test")
        out["gagm"] = phase_gagm_main(torch, dev, rec["gagm_inputs"])
    return out


#: the pool calls of one step of each kind, and of ``test`` with and
#: without a mask head, as :func:`hold_call_kernels` names them
SOURCE_POOLS = ("labelled box", "labelled mask")
MT_POOLS = ("teacher box", "labelled box", "labelled mask", "pseudo-labelled box")
TEST_POOLS = ("tta box", "inference box", "inference mask")
BOX_TEST_POOLS = ("tta box", "inference box")


def write_mt_splits(data: str, splits=MT_SPLITS) -> None:
    """Phase 11's synthetic fundus splits under ``data`` (phase 12 reads
    them too)."""
    t0 = time.perf_counter()
    for i, (split, n, hw) in enumerate(splits):
        write_fundus_split(data, n, hw, seed=10 + i, polygons=True, split=split)
    log(f"mt cli: splits {[(s, n, hw) for s, n, hw in splits]} written in "
        f"{time.perf_counter() - t0:.1f} s")


def _mt_cli_calls(torch, dev, card: str, what: str, tmp: str, data: str, overrides, opts,
                  eval_opts, counters, eval_counters, split_reps: int, members, *,
                  extra_losses=(), restart: bool = False, on_call1=None, on_call2=None,
                  **capture):
    """The calls phases 11 and 12 share: ``train_net_torch.main`` on
    ``configs/seg_res50fpn_MT.yaml`` with ``overrides`` (``(key, value,
    reason)``, then ``opts``) on the splits under ``data``, writing under
    ``tmp``; ``what`` names the phase in the log.  Call 1 trains 4 steps (2
    burn-in, 2 MT) under ``capture`` (with the pass split over
    ``split_reps`` and the kernels' inputs): :func:`_check_train`'s gates
    (``extra_losses`` on its MT steps too), no resume, the step-4 file in
    the ensemble layout; then ``on_call1(record, step4)`` and kernels A, C
    and D held on its first MT step's inputs (:func:`hold_call_kernels`).  Call 2
    runs the same command to 6 steps, resumed at step 4 bit for bit; then
    ``on_call2(record)``.  With ``restart``, call 3 runs call 2 again from a
    directory that holds only the step-4 checkpoint, and its final
    checkpoint equals call 2's bit for bit.  Then one ``--eval-only
    --config configs/test_segment_MT.yaml`` call on call 2's final file, on
    a REFUGE test split, for each ``(member, extra overrides)`` of
    ``members``, numbered from 4: every tensor of the member loaded, the
    kernels of ``eval_counters`` launched, Dice, E and S finite; kernels A
    and B held on call 4's inputs.  The hooks return dicts that join the
    result.  Returns ``(result, calls)``."""
    import shutil

    cfg = os.path.join(HERE, "configs", "seg_res50fpn_MT.yaml")
    out = os.path.join(tmp, "out")
    over = [x for k, v, _ in overrides for x in (k, v)]

    def argv(out_dir, max_iter):
        return ["--device", str(dev), "--config", cfg, "--datasets-root", data,
                "MODEL.WEIGHTS", "", "OUTPUT_DIR", out_dir, "SOLVER.MAX_ITER", str(max_iter),
                *over, *opts]

    ckdir = os.path.join(out, "checkpoints")
    res = {}
    calls = {1: _train_call(torch, dev, argv(out, 4), f"{what} call 1", split_reps=split_reps,
                            kernel_inputs=True, **capture)}
    _log_train_call(calls[1], f"{what} call 1", card)
    _check_train(calls[1], f"{what} call 1", ("burn-in", "burn-in", "mt", "mt"), ckdir, (2, 4),
                 counters, extra_losses=extra_losses)
    check(calls[1]["resumed"] is None, f"{what} call 1 resumed from a checkpoint")
    log(f"{what} call 1: MT step split {calls[1]['split_ms']} ms")
    step4 = torch.load(os.path.join(ckdir, "model_0000004.pth"), map_location="cpu",
                       weights_only=False)
    keys = list(step4["model"])
    n_student = sum(k.startswith("modelStudent.") for k in keys)
    check(n_student and 2 * n_student == len(keys)
          and sum(k.startswith("modelTeacher.") for k in keys) == n_student,
          f"{what} call 1: checkpoint keys not in the ensemble layout: {keys[:3]}")
    if on_call1 is not None:
        res.update(on_call1(calls[1], step4) or {})
    held = hold_call_kernels(torch, dev, calls[1], f"{what} call 1", step_pools=MT_POOLS)
    del calls[1]["kernel_inputs"], calls[1]["test_pools"], calls[1]["gagm_inputs"]

    calls[2] = _train_call(torch, dev, argv(out, 6), f"{what} call 2")
    _log_train_call(calls[2], f"{what} call 2", card)
    _check_train(calls[2], f"{what} call 2", ("mt", "mt"), ckdir, (2, 4, 6), counters,
                 extra_losses=extra_losses)
    resumed = calls[2]["resumed"]
    check(resumed is not None, f"{what} call 2 did not resume")
    diff = _checkpoint_differences(torch, resumed, step4)
    check(not diff, f"{what} call 2: the resumed state differs from the step-4 file in "
          f"{diff[:6]}")
    if on_call2 is not None:
        res.update(on_call2(calls[2]) or {})
    final = os.path.join(ckdir, "model_0000006.pth")
    final2 = torch.load(final, map_location="cpu", weights_only=False)
    trained = (1, 2)
    if restart:
        out3 = os.path.join(tmp, "out3")
        os.makedirs(os.path.join(out3, "checkpoints"))
        shutil.copy(os.path.join(ckdir, "model_0000004.pth"), os.path.join(out3, "checkpoints"))
        calls[3] = _train_call(torch, dev, argv(out3, 6), f"{what} call 3")
        _log_train_call(calls[3], f"{what} call 3", card)
        _check_train(calls[3], f"{what} call 3", ("mt", "mt"), os.path.join(out3, "checkpoints"),
                     (4, 6), counters, extra_losses=extra_losses)
        final3 = torch.load(os.path.join(out3, "checkpoints", "model_0000006.pth"),
                            map_location="cpu", weights_only=False)
        diff = _checkpoint_differences(torch, final2, final3)
        check(not diff, f"{what} call 3: its final checkpoint differs from call 2's in "
              f"{diff[:6]}")
        log(f"{what} call 3: the final checkpoint equals call 2's bit for bit")
        trained = (1, 2, 3)

    ev = ["--eval-only", "--device", str(dev), "--config",
          os.path.join(HERE, "configs", "test_segment_MT.yaml"), "--datasets-root", data,
          "MODEL.WEIGHTS", final, "DATASETS.TEST", '["REFUGE_test"]',
          "TEST.DICE_THRES", "0.0", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
          "OUTPUT_DIR", os.path.join(tmp, "eval"), *eval_opts]
    evals = {}
    for c, (member, extra) in enumerate(members, start=4):
        calls[c] = _train_call(torch, dev, ev + extra, f"{what} call {c}", kernel_inputs=c == 4)
        want = {k[len(member) + 1:]: v for k, v in final2["model"].items()
                if k.startswith(member + ".")}
        got = calls[c]["init"]
        diff = [k for k in want if k not in got or not torch.equal(got[k], want[k])]
        check(len(got) == len(want) and not diff,
              f"{what} call {c}: {member} not loaded: {len(got)} tensors, differing {diff[:5]}")
        metrics = calls[c]["result"]["REFUGE_test"]
        log(f"{what} call {c} ({card}): eval-only {' '.join(extra) or 'as shipped'}: "
            f"{member} loaded ({len(want)} tensors), {calls[c]['main_s']:.1f} s, results "
            f"{json.dumps(metrics)}, launches "
            f"{ {k: v for k, v in calls[c]['launches'].items() if v} }")
        check(all(calls[c]["launches"][k] >= 1 for k in eval_counters),
              f"{what} call {c}: kernels {list(eval_counters)} not all launched")
        check(len(metrics) == 3 and all(math.isfinite(v) for v in metrics.values()),
              f"{what} call {c}: Dice, E and S not all finite: {metrics}")
        evals[c] = dict(main_s=calls[c]["main_s"], metrics=metrics,
                        launches=calls[c]["launches"])
        if c == 4:
            held_eval = hold_call_kernels(torch, dev, calls[c], f"{what} call {c}",
                                          test_pools=TEST_POOLS)
            held["pools"].update(held_eval.pop("pools"))
            held.update(held_eval)
            del calls[c]["test_pools"], calls[c]["gagm_inputs"]

    # the MT steps that also copied their kernels' inputs are left out
    mt_steps = [s["ms"] for c in trained for s in calls[c]["steps"]
                if s["kind"] == "mt" and not s["took_inputs"]]
    summary = {f"call{c}": dict(
        steps=[(s["kind"], s["ms"]) for s in calls[c]["steps"]], wait_s=calls[c]["wait_s"],
        main_s=calls[c]["main_s"], peak_gib=calls[c]["peak_gib"], save_s=calls[c]["save_s"],
        total_loss=[s["losses"]["total_loss"] for s in calls[c]["steps"]],
        extra_losses=[{k: s["losses"][k] for k in extra_losses} for s in calls[c]["steps"]
                      if s["kind"] == "mt"],
        launches_per_step=[s["launches"] for s in calls[c]["steps"]],
        pools_per_step=[s["pools"] for s in calls[c]["steps"]],
        pseudo_per_image=calls[c]["pseudo"]) for c in trained}
    res.update(summary=summary, held=held, mt_step_median_ms=statistics.median(mt_steps),
               launches={k: calls[1]["launches"][k] + calls[4]["launches"][k]
                         for k in calls[1]["launches"]},
               split_ms=calls[1]["split_ms"], peak_gib=calls[1]["peak_gib"],
               checkpoint_mib=calls[1]["save_bytes"][0] / 2 ** 20, eval=evals)
    return res, calls


def phase_mt_cli(torch, dev, card: str = "", opts=(), eval_opts=(), counters=TRAIN_COUNTERS,
                 eval_counters=("gagm",), splits=MT_SPLITS, split_reps: int = MT_SPLIT_REPS,
                 data: str | None = None):
    """The mean-teacher trainer as a user runs it: ``train_net_torch.main([
    "--config", "configs/seg_res50fpn_MT.yaml", ...])`` at full width with
    the shipped config (R50-FPN, batch 4 labelled + 4 unlabelled, the bf16
    policy of ``TPU.PRECISION``, ``EMA_KEEP_RATE`` 0.9996, the discriminator
    on p2, focal loss, the square 800 canvas), random weights
    (``MODEL.WEIGHTS ""``), on synthetic ``RIM_ONE_r3_train`` (labelled) and
    ``REFUGE_train`` (unlabelled) splits in the reference's layout with
    polygon ground truth, with the overrides of ``MT_OVERRIDES`` (each
    printed with its reason), through :func:`_mt_cli_calls`.  Call 1 trains
    4 steps: 2 burn-in steps, the teacher's copy at step 2 (equal to the
    student bit for bit), MT steps 2 and 3 (step 3's teacher the moving
    average of step 2's teacher and step 3's student, recomputed on the
    host), and kernels A, C and D held against their plain versions on the
    inputs of its MT steps (the MT step median leaves out the steps that
    copied them); call 2 the same command to 6 steps, resumed at step 4 bit
    for bit from the ensemble-layout file (the restart from a copy of the
    step-4 file is phase 12's, on the same MT path with the head); calls 4
    and 5 ``--eval-only --config configs/test_segment_MT.yaml`` on call 2's
    final file with ``TEST.EVAL_STU False`` (the teacher; the shipped file
    sets True) and as shipped (the student), kernel B launched.  Logs the
    step times, the split of one MT step between its passes, the loader's
    waits, the pseudo-boxes per image, the launches and pool calls per
    step, the peak memory, and the two-crop loader's host time per batch
    on one thread.  The splits are written under ``data``, or read from
    there when given (:func:`write_mt_splits`)."""
    import tempfile

    import numpy as np

    from ttdg_mgm_torch.config import setup_cfg

    keep = np.float32(setup_cfg(os.path.join(HERE, "configs", "seg_res50fpn_MT.yaml"),
                                []).SEMISUPNET.EMA_KEEP_RATE)

    def copy_and_ema(record, step4):
        (s2, t2), (s3, t3) = record.pop("seen")
        diff = [k for k in s2 if not torch.equal(s2[k], t2[k])]
        check(not diff, f"mt cli call 1: the teacher differs from the student at the copy in "
              f"{diff[:5]}")
        worst = 0.0
        for k in s3:
            if k.endswith(("running_mean", "running_var")):
                check(torch.equal(t3[k], t2[k]), f"mt cli call 1: {k} moved")
                continue
            want = t2[k].numpy() * keep + s3[k].numpy() * (np.float32(1) - keep)
            err = np.abs(t3[k].numpy() - want) / np.maximum(np.abs(want), 1e-30)
            worst = max(worst, float(err.max()) if err.size else 0.0)
        check(worst <= 2 ** -23, f"mt cli call 1: the step-3 teacher is {worst:.3g} (relative) "
              "from t * keep + s * (1 - keep)")
        moved = sum(not torch.equal(s2[k], s3[k]) for k in s2)
        log(f"mt cli call 1: teacher == student at step 2 ({len(s2)} tensors); step-3 teacher "
            f"within {worst:.3g} of the host's moving average; {moved} tensors of the student "
            "moved at step 2")

    with tempfile.TemporaryDirectory() as tmp:
        if data is None:
            data = os.path.join(tmp, "data")
            write_mt_splits(data, splits)
        for k, v, why in MT_OVERRIDES:
            log(f"mt cli: override {k} {v}: {why}")
        log("mt cli: override SOLVER.MAX_ITER 4, then 6 (resumed at 4): the smoke run's depth, "
            "cut from the shipped 10000")
        res, calls = _mt_cli_calls(
            torch, dev, card, "mt cli", tmp, data, MT_OVERRIDES, opts, eval_opts, counters,
            eval_counters, split_reps, (("modelTeacher", ["TEST.EVAL_STU", "False"]),
                                        ("modelStudent", [])),
            on_call1=copy_and_ema, snapshots=True)
        host_s, decode_s = loader_host_s(calls[1], MT_LOADER_BATCHES)

    med = res["mt_step_median_ms"]
    ratio = statistics.median(host_s) * 1e3 / med
    log(f"mt cli ({card}): the two-crop loader's host time per batch (4 + 4 records, 16 views, "
        f"one thread) {[round(x, 3) for x in host_s]} s, median {statistics.median(host_s):.3f} "
        f"s, of it decoding files {[round(x, 3) for x in decode_s]} s, against the median MT "
        f"step {med:.1f} ms: loader / step {ratio:.1f}")
    return dict(res, loader_host_s=host_s, loader_decode_s=decode_s, loader_over_step=ratio)


# -- phase 12: the mean-teacher trainer with its cross-domain head ------------------------

#: phase 12's override beyond phase 11's ``MT_OVERRIDES``, with its reason
MT_CD_OVERRIDES = (
    ("SEMISUPNET.CROSS_DOMAIN_MATCHING", "True", "the option under test: the cross-domain "
     "graph-matching head (False in every shipped config)"),
)
HEAD_LOSSES = ("loss_node_cls", "loss_cross_matching", "loss_topology")
#: the step's class centers against the host's moving average (float64 on the
#: host; the card's per-class sums are a float32 matrix product)
CENTER_RTOL = 1e-5


def host_center_ema(update) -> "object":
    """The class centers' moving average recomputed on the host in float64
    from one update's inputs (:func:`capture_train`'s ``center_updates``):
    each class's mean node (invalid nodes as class 0) moves its center by
    ``1 - momentum``; a class with no node keeps it."""
    import numpy as np

    c = update["centers"].double().numpy()
    nodes = update["nodes"].double().numpy()
    onehot = np.eye(c.shape[0])[np.where(update["mask"].numpy(), update["labels"].numpy(), 0)]
    n = onehot.sum(0)
    batch = onehot.T @ nodes / np.maximum(n, 1.0)[:, None]
    m = update["momentum"]
    return np.where((n > 0)[:, None], m * c + (1 - m) * batch, c)


def phase_mt_cd_cli(torch, dev, card: str = "", data: str | None = None, opts=(), eval_opts=(),
                    counters=TRAIN_COUNTERS, eval_counters=("gagm",),
                    split_reps: int = MT_SPLIT_REPS):
    """The mean-teacher trainer with its cross-domain graph-matching head,
    as a user runs it: phase 11's command (``configs/seg_res50fpn_MT.yaml``
    at full width, bf16, 4 + 4 images on the square 800 canvas, random
    weights, ``MT_OVERRIDES``) with ``SEMISUPNET.CROSS_DOMAIN_MATCHING
    True`` (``MT_CD_OVERRIDES``, printed with its reason), on phase 11's
    splits (``data``, written here when None), through phase 11's calls
    (:func:`_mt_cli_calls`) with the head's three losses gated finite on
    every MT step.  Call 1 (4 steps: 2 burn-in, 2 MT with the head): the
    class centers start at zero, step 3 gets step 2's, and step 3's equal
    the moving average recomputed on the host from the update's own inputs
    (:func:`host_center_ema`, ``CENTER_RTOL``); both members carry the
    head's 40 tensors; the pass split with the cross-domain pass as a
    fifth; the final teacher's pseudo-labels probed against the unlabelled
    split's ground truth (:func:`probe_teacher`).  Call 2 resumes at step 4
    and runs to 6; its centers restart at zero (not checkpointed, as in the
    JAX package).  Call 3 runs call 2 again from a copy of the step-4 file,
    bit for bit.  Call 4: ``--eval-only`` on the final file as shipped (the
    student, head included), kernel B launched.  Logs the head's losses,
    the MT step median, the split, peak memory, the checkpoint's size and
    the probe."""
    import tempfile

    def centers(record, step4):
        head = [{k: s["losses"][k] for k in HEAD_LOSSES} for s in record["steps"]
                if s["kind"] == "mt"]
        log(f"mt cd cli call 1: the head's losses on MT steps 2 and 3: {head}")
        cs, ups = record["centers"], record["center_updates"]
        check(len(cs) == 2 and len(ups) == 2,
              f"mt cd cli call 1: {len(cs)} MT steps with centers, {len(ups)} center updates")
        check(not cs[0][0].any(), "mt cd cli call 1: step 2's centers did not start at zero")
        check(torch.equal(cs[1][0], cs[0][1]), "mt cd cli call 1: step 3 did not get step 2's "
              "centers")
        for i, (u, (_, c_out)) in enumerate(zip(ups, cs)):
            check(torch.equal(u["out"], c_out), f"mt cd cli call 1: MT step {i + 2} returned "
                  "other centers than its update gave")
        want = host_center_ema(ups[1])
        err = float(abs(cs[1][1].double().numpy() - want).max() / max(abs(want).max(), 1e-30))
        check(err <= CENTER_RTOL, f"mt cd cli call 1: step 3's centers are {err:.3g} (relative "
              f"to their largest) from the host's moving average, over {CENTER_RTOL}")
        moved = [int(i) for i in range(len(want)) if not torch.equal(cs[1][1][i], cs[1][0][i])]
        n_head = sum(k.startswith("modelStudent.cross_domain.") for k in step4["model"])
        check(n_head == 40 and sum(k.startswith("modelTeacher.cross_domain.")
                                   for k in step4["model"]) == 40,
              f"mt cd cli call 1: {n_head} cross-domain tensors per member in the checkpoint")
        log(f"mt cd cli call 1: centers {tuple(cs[1][1].shape)} zero at step 2, threaded to step "
            f"3, step 3's within {err:.3g} of the host's moving average (momentum "
            f"{ups[1]['momentum']}, classes moved {moved}, node rows {len(ups[1]['nodes'])}); "
            f"probe {json.dumps(record['probe'])}")
        return dict(center_err=err, probe=record["probe"])

    def restart_at_zero(record):
        check(not record["centers"][0][0].any(), "mt cd cli call 2: the centers did not "
              "restart at zero")
        log("mt cd cli call 2: resumed at step 4 bit for bit; the centers restart at zero (not "
            "checkpointed, as in the JAX package)")

    with tempfile.TemporaryDirectory() as tmp:
        if data is None:
            data = os.path.join(tmp, "data")
            write_mt_splits(data)
        for k, v, why in MT_CD_OVERRIDES:
            log(f"mt cd cli: override {k} {v}: {why}")
        log("mt cd cli: phase 11's overrides " + ", ".join(f"{k} {v}" for k, v, _ in MT_OVERRIDES)
            + " (their reasons above), SOLVER.MAX_ITER 4, then 6 (resumed at 4), on phase "
            "11's splits")
        res, _ = _mt_cli_calls(
            torch, dev, card, "mt cd cli", tmp, data, (*MT_OVERRIDES, *MT_CD_OVERRIDES), opts,
            eval_opts, counters, eval_counters, split_reps, (("modelStudent", []),),
            extra_losses=HEAD_LOSSES, restart=True, on_call1=centers, on_call2=restart_at_zero,
            probe=True)
    log(f"mt cd cli ({card}): median MT step with the head {res['mt_step_median_ms']:.1f} ms; "
        f"split {res['split_ms']} ms; peak {res['peak_gib']:.2f} GiB; checkpoint "
        f"{res['checkpoint_mib']:.1f} MiB")
    return res


# -- phase 13: the VGG16-BN family and the legacy datasets -------------------------------

#: phase 13's trunk, with its reason
VGG_OVERRIDE = ("MODEL.BACKBONE.NAME", "build_vgg_backbone", "the option under test: the "
                "VGG16-BN trunk (JAX build.py:40; every shipped config names the R50)")
#: foggy-Cityscapes frames of phase 13: (split, frames); 2048 x 1024 each
CITY_SPLITS = (("train", 8), ("val", 2))
CITY_HW = (1024, 2048)
#: Clipart1k's VOC objects on the 3 committed JPEGs: (id, [(class, difficult,
#: xmin, ymin, xmax, ymax)], 1-indexed corners)
CLIPART_OBJECTS = (("p0", (("dog", 0, 101, 211, 640, 700), ("person", 1, 700, 100, 1100, 900))),
                   ("p1", (("car", 0, 51, 61, 500, 400), ("bicycle", 0, 600, 500, 900, 800))),
                   ("p2", (("cat", 0, 300, 200, 1000, 800), ("bird", 0, 20, 20, 200, 150))))


def write_cityscapes_foggy(root: str, seed: int = 0) -> None:
    """Foggy-Cityscapes splits of ``CITY_SPLITS`` in the dataset's layout
    under ``root/cityscapes_foggy`` (what ``register_all_legacy`` reads):
    ``leftImg8bit/{split}/aachen/*_leftImg8bit_foggy_beta_0.02.png`` frames
    of 2048 x 1024 (a hazy street: road, sky and one block per object) and
    ``gtFine/{split}/aachen/*_gtFine_polygons.json`` with one polygon of each
    of the 8 thing classes, a ``cargroup`` crowd region, a ``deleted`` car
    and a ``sky`` region."""
    import numpy as np

    from ttdg_mgm_torch.data.datasets.cityscapes_foggy import CITYSCAPES_THING_CLASSES

    h, w = CITY_HW
    rng = np.random.RandomState(seed)
    yy = np.mgrid[:h, :1][0].astype(np.float32)
    for split, n in CITY_SPLITS:
        img_dir = os.path.join(root, "cityscapes_foggy", "leftImg8bit", split, "aachen")
        gt_dir = os.path.join(root, "cityscapes_foggy", "gtFine", split, "aachen")
        os.makedirs(img_dir, exist_ok=True)
        os.makedirs(gt_dir, exist_ok=True)
        for i in range(n):
            base = np.where(yy < 0.45 * h, 200.0, 90.0 + 40 * yy / h)
            img = np.repeat(np.repeat(base[:, :, None], w, 1), 3, 2)
            objs = []
            for c, name in enumerate(CITYSCAPES_THING_CLASSES):
                x0 = (0.03 + 0.12 * c + rng.uniform(0, 0.02)) * w
                y0 = rng.uniform(0.35, 0.5) * h
                x1, y1 = x0 + rng.uniform(0.04, 0.1) * w, y0 + rng.uniform(0.1, 0.3) * h
                img[int(y0):int(y1), int(x0):int(x1)] = rng.uniform(20, 160, 3)
                objs.append({"label": name, "polygon": [[x0, y0], [x1, y0], [x1, y1],
                                                        [(x0 + x1) / 2, y1 + 8], [x0, y1]]})
            objs += [{"label": "cargroup", "polygon": [[0.55 * w, 0.75 * h], [0.95 * w, 0.75 * h],
                                                       [0.95 * w, 0.95 * h], [0.55 * w, 0.95 * h]]},
                     {"label": "car", "deleted": 1, "polygon": [[10, 600], [90, 600], [90, 660]]},
                     {"label": "sky", "polygon": [[0, 0], [w, 0], [w, 0.3 * h], [0, 0.3 * h]]}]
            fog = 0.6 * img + 0.4 * 210 + rng.normal(0, 3, img.shape)
            stem = f"aachen_{i:06d}_000019_"
            write_png(os.path.join(img_dir, stem + "leftImg8bit_foggy_beta_0.02.png"),
                      np.clip(fog, 0, 255).astype(np.uint8))
            with open(os.path.join(gt_dir, stem + "gtFine_polygons.json"), "w") as f:
                json.dump({"imgHeight": h, "imgWidth": w, "objects": objs}, f)


def write_clipart(root: str) -> None:
    """Clipart1k's test split in VOC layout under ``root/clipart``: the 3
    committed 1280 x 959 JPEGs with ``CLIPART_OBJECTS`` (one difficult)."""
    import shutil

    d = os.path.join(root, "clipart")
    for sub in ("JPEGImages", "Annotations", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    for fid, objs in CLIPART_OBJECTS:
        shutil.copy(os.path.join(JPEG_FIXTURES, fid + ".jpg"), os.path.join(d, "JPEGImages"))
        xml = "".join(f"<object><name>{c}</name><difficult>{df}</difficult><bndbox><xmin>{x0}"
                      f"</xmin><ymin>{y0}</ymin><xmax>{x1}</xmax><ymax>{y1}</ymax></bndbox>"
                      "</object>" for c, df, x0, y0, x1, y1 in objs)
        with open(os.path.join(d, "Annotations", fid + ".xml"), "w") as f:
            f.write("<annotation><size><width>1280</width><height>959</height><depth>3</depth>"
                    f"</size>{xml}</annotation>")
    with open(os.path.join(d, "ImageSets", "Main", "test.txt"), "w") as f:
        f.write("".join(fid + "\n" for fid, _ in CLIPART_OBJECTS))


def _legacy_run(torch, dev, what: str, config: str, opts, train: bool, dataset: str,
                tta_batch: int, counters, test_pools):
    """``build_trainer`` on ``configs/{config}`` with ``opts`` (a VGG model
    with random weights) under :func:`capture_train` with the kernels'
    inputs; with ``train``, 2 source steps on ``cityscapes_foggy_train``
    (every loss finite, the kernels of ``counters`` launched on each); then
    ``test([dataset])`` with one TTA step per batch of ``tta_batch`` and the
    dataset's own evaluator.  The kernel counters are set to 0 just before
    and read just after.  Then each kernel is held on what the run gave it
    (:func:`hold_call_kernels`): A, C and D on the first source step's
    inputs, A on ``test_pools`` and B on the adaptation's.  Returns the
    record, with the results and the holds."""
    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.config import setup_cfg

    cfg = setup_cfg(os.path.join(HERE, "configs", config), list(opts))
    record, undo = capture_train(torch, dev, kernel_inputs=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counters()
    try:
        t0 = time.perf_counter()
        trainer = build_trainer(cfg, device=dev)
        if train:
            trainer.train(["cityscapes_foggy_train"], max_iter=2,
                          batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=cfg.SEED)
        t1 = time.perf_counter()
        record["result"] = trainer.test([dataset], ttt=True, tta_batch=tta_batch)[dataset]
        record["test_s"] = time.perf_counter() - t1
        record["main_s"] = time.perf_counter() - t0
    finally:
        record["launches"] = read_counters()
        undo()
    record["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0
    for i, s in enumerate(record["steps"]):
        bad = {k: v for k, v in s["losses"].items() if not math.isfinite(v)}
        check(not bad, f"{what} step {i}: non-finite losses {bad}")
        missing = [k for k in counters if s["launches"].get(k, 0) < 1]
        check(not missing, f"{what} step {i}: kernels {missing} not launched ({s['launches']})")
    check(len(record["steps"]) == (2 if train else 0), f"{what}: {len(record['steps'])} steps")
    check(record["launches"]["gagm"] >= 1, f"{what}: the TTA step did not launch kernel B")
    record["held"] = hold_call_kernels(torch, dev, record, what,
                                       step_pools=SOURCE_POOLS if train else (),
                                       test_pools=test_pools)
    del record["kernel_inputs"], record["test_pools"], record["gagm_inputs"]
    return record


#: the VGG trunk's measured batch, the source step's (images, height, width)
VGG_TRUNK_SHAPE = (8, 800, 800)
#: the legacy test batches whose peak memory is split by pass: (name,
#: classes, mask head, images, canvas height, width), as phase 13 runs them,
#: and the Clipart1k batch at 1 image (how the peak grows with the batch)
VGG_TEST_SHAPES = (("cityscapes", 8, True, 2, 832, 1344), ("clipart", 20, False, 3, 832, 1088),
                   ("clipart_1", 20, False, 1, 832, 1088))


def vgg_costs(torch, dev, trunk_shape=VGG_TRUNK_SHAPE, test_shapes=VGG_TEST_SHAPES,
              reps: int = 3) -> dict:
    """Two measurements of phase 13's VGG paths, outside its counted runs.
    (1) The cost of the float32 trunk: its forward and backward on the
    source step's batch (``trunk_shape``), float32 with TF32 off as the port
    and the JAX model run it, against the same under ``torch.autocast`` in
    bf16 (what a bf16 trunk would take; no path of the port): the mean time
    of ``reps`` by CUDA events and the peak memory of each.  (2) Where the
    legacy test batches' peak goes: for each of ``test_shapes`` a full-width
    VGG model with random weights, its classes and mask head, and a batch
    on the test canvas: the peak of ``forward_inference`` and of one
    ``loss_ttt`` forward and backward apart, over what the model holds,
    beside the card's memory: with box inference as it is (the class-aware
    NMS on the valid candidates) and as it was (``dense``:
    ``batched_nms_mask`` over all ``K x classes`` candidates in its place),
    the detections of the two equal bit for bit."""
    import contextlib

    import ttdg_mgm_torch.models.roi_heads as roi_heads
    from ttdg_mgm_torch.build import build_model
    from ttdg_mgm_torch.ops.nms import batched_nms_mask
    from ttdg_mgm_torch.models.vgg import VGG16FPNBackbone

    def peak_of(fn):
        _sync(torch, dev)
        torch.cuda.reset_peak_memory_stats()
        fn()
        _sync(torch, dev)
        return torch.cuda.max_memory_allocated() / 2 ** 30

    out = {"trunk": {}, "test": {}, "card_gib": torch.cuda.mem_get_info(dev)[1] / 2 ** 30}
    B, H, W = trunk_shape
    trunk = VGG16FPNBackbone().to(dev)
    x = torch.randn(B, 3, H, W, device=dev)
    modes = (("float32", contextlib.nullcontext),
             ("autocast_bf16", lambda: torch.autocast(dev.type, dtype=torch.bfloat16)))
    for mode, ctx in modes:
        def fwd_bwd(ctx=ctx):
            trunk.zero_grad(set_to_none=True)
            with ctx():
                feats = trunk(x)
            sum(f.float().mean() for f in feats.values()).backward()

        gib = peak_of(fwd_bwd)
        out["trunk"][mode] = dict(ms=event_ms(torch, fwd_bwd, reps), peak_gib=gib)
    del trunk, x
    compact = roi_heads.compact_batched_nms_mask
    for name, classes, mask_on, n, h, w in test_shapes:
        model = build_model(device=dev, seed=0, backbone_name="vgg16", num_classes=classes,
                            mask_on=mask_on, score_thresh_test=0.0)
        images = torch.rand(n, h, w, 3, device=dev) * 255
        sizes = torch.tensor([[float(h), float(w)]] * n, device=dev)
        held = torch.cuda.memory_allocated() / 2 ** 30 if dev.type == "cuda" else 0.0
        row, dets = dict(batch=f"{n} x {h} x {w}", model_gib=held), {}
        for mode, fn in (("dense_", batched_nms_mask), ("", compact)):
            roi_heads.compact_batched_nms_mask = fn
            try:
                row[mode + "inference_peak_gib"] = peak_of(
                    lambda: dets.__setitem__(mode, model.forward_inference(images, sizes)))
                row[mode + "tta_peak_gib"] = peak_of(
                    lambda: model.loss_ttt(images, sizes).backward())
            finally:
                roi_heads.compact_batched_nms_mask = compact
            model.zero_grad(set_to_none=True)
        differs = [k for k in dets[""] if not torch.equal(dets[""][k], dets["dense_"][k])]
        check(not differs, f"vgg costs {name}: the detections differ from the dense NMS's in "
              f"{differs}")
        out["test"][name] = row
        del model, images, dets
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    t = out["trunk"]
    log(f"vgg costs: the trunk's forward and backward on {B} x {H} x {W}: float32 (TF32 off) "
        f"{t['float32']['ms']:.2f} ms, peak {t['float32']['peak_gib']:.2f} GiB; under autocast "
        f"bf16 {t['autocast_bf16']['ms']:.2f} ms, peak {t['autocast_bf16']['peak_gib']:.2f} GiB; "
        f"peak by pass of the legacy test batches {json.dumps(out['test'])}, of the card's "
        f"{out['card_gib']:.2f} GiB")
    return out


def phase_vgg(torch, dev, train_data: str, card: str = "", mt_data: str | None = None, opts=(),
              eval_opts=(), counters=TRAIN_COUNTERS, legacy_opts=(), split_reps: int = 1):
    """The VGG16-BN family at full width (FPN 256, box head 1024, mask head
    256, 1000 proposals, universe 32, 60 nodes per graph; the trunk float32
    under each config's bf16 policy, as the JAX model's), with
    ``MODEL.BACKBONE.NAME build_vgg_backbone`` (``VGG_OVERRIDE``, printed
    with its reason) on the shipped configs, through the entry points a user
    calls:

    1. source training through the command line, phase 10's calls
       (:func:`phase_train_cli`) with the override: 4 steps of
       ``configs/seg_res50fpn_source.yaml`` (batch 8, square 800 canvas) on
       phase 10's synthetic splits (``train_data``), resumed to 6 bit for
       bit, the same from a copy of the step-4 file, then ``--eval-only --config
       configs/test_segment.yaml`` on the final file (every tensor loaded,
       finite Dice, E and S); kernels A (bf16), C (bf16) and D launched on
       every step;
    2. the mean-teacher trainer through the command line, phase 11's calls
       (:func:`_mt_cli_calls`) with the override on phase 11's splits
       (``mt_data``): 4 steps (2 burn-in, 2 MT), the split by pass, resumed
       to 6 bit for bit, ``--eval-only`` on the student;
    3. the legacy datasets through ``register_all_legacy`` on trees written
       under a temporary root: foggy Cityscapes (8 train and 2 val frames of
       2048 x 1024, the 8 thing classes, a crowd region, a deleted object): a
       VGG model with 8 classes (``seg_res50fpn_source.yaml``) takes 2
       source steps on ``cityscapes_foggy_train``, then ``test`` on
       ``cityscapes_foggy_val`` (a TTA step, COCO box and mask AP, finite);
       Clipart1k (the 3 committed JPEGs in VOC layout, one difficult box): a
       VGG model with 20 classes and ``MODEL.MASK_ON False``
       (``test_segment.yaml``) adapts with a TTA step without a mask head,
       as the JAX package does, and is scored by the VOC evaluator (finite
       mAP).  Neither Pillow, OpenCV nor PyYAML is imported;
    4. :func:`vgg_costs`: the float32 trunk's cost against a bf16 one, and
       the legacy test batches' peak memory split between inference and the
       TTA step.

    On each path of 1-3 every kernel it launches is held against its plain
    version on the path's own inputs (:func:`hold_call_kernels`): A, C and
    D on the first training step's, A and B on the adaptation's and the
    inference's.

    Random weights score near 1/(classes + 1), so ``SCORE_THRESH_TEST`` is 0
    on the legacy runs (printed with its reason)."""
    import tempfile

    from ttdg_mgm_torch.data.builtin import register_all_legacy

    key, value, why = VGG_OVERRIDE
    log(f"vgg: override {key} {value}: {why}")
    vgg = [key, value]
    src = phase_train_cli(torch, dev, train_data, card, opts=[*vgg, *opts], eval_opts=[*vgg, *eval_opts],
                          counters=counters, what="vgg train cli")
    log(f"vgg train cli ({card}): checkpoint {src['checkpoint_mib']:.1f} MiB, peak "
        f"{src['peak_gib']:.2f} GiB, eval-only {src['eval_main_s']:.1f} s "
        f"{json.dumps(src['eval_metrics'])}")

    with tempfile.TemporaryDirectory() as tmp:
        if mt_data is None:
            mt_data = os.path.join(tmp, "data")
            write_mt_splits(mt_data)
        mt, _ = _mt_cli_calls(
            torch, dev, card, "vgg mt cli", tmp, mt_data, (*MT_OVERRIDES, VGG_OVERRIDE), opts,
            [*vgg, *eval_opts], counters, ("gagm",), split_reps, (("modelStudent", []),))
    log(f"vgg mt cli ({card}): median MT step {mt['mt_step_median_ms']:.1f} ms; split "
        f"{mt['split_ms']} ms; peak {mt['peak_gib']:.2f} GiB; checkpoint "
        f"{mt['checkpoint_mib']:.1f} MiB")

    log("vgg legacy: override MODEL.ROI_HEADS.SCORE_THRESH_TEST 0.0: random weights score "
        "near 1/(classes + 1), at or under the configs' 0.05")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_cityscapes_foggy(root)
        write_clipart(root)
        register_all_legacy(root)
        log(f"vgg legacy: foggy Cityscapes {CITY_SPLITS} frames of {CITY_HW[1]} x {CITY_HW[0]} "
            f"and Clipart1k's 3 JPEGs written and registered in {time.perf_counter() - t0:.1f} s")
        common = [*vgg, "MODEL.WEIGHTS", "", "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0",
                  "OUTPUT_DIR", os.path.join(root, "out"), *legacy_opts]
        city = _legacy_run(torch, dev, "vgg cityscapes", "seg_res50fpn_source.yaml",
                           [*common, "MODEL.ROI_HEADS.NUM_CLASSES", "8"], True,
                           "cityscapes_foggy_val", 2, counters, TEST_POOLS)
        clip = _legacy_run(torch, dev, "vgg clipart", "test_segment.yaml",
                           [*common, "MODEL.ROI_HEADS.NUM_CLASSES", "20", "MODEL.MASK_ON",
                            "False"], False, "Clipart1k_test", 3, (), BOX_TEST_POOLS)
    for what, r, keys in (("cityscapes", city, ("bbox_AP", "bbox_AP50", "segm_AP")),
                          ("clipart", clip, ("bbox_AP50",))):
        res = r["result"]
        check(all(math.isfinite(res.get(k, float("nan"))) for k in keys),
              f"vgg {what}: {keys} not all finite in {res}")
        log(f"vgg {what} ({card}): steps {[round(s['ms'], 1) for s in r['steps']]} ms, loader "
            f"waits {[round(x, 3) for x in r['wait_s']]} s, test {r['test_s']:.1f} s, results "
            f"{ {k: res[k] for k in keys} }, peak {r['peak_gib']:.2f} GiB, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }")
    check(not any(k.startswith("segm") for k in clip["result"]),
          f"vgg clipart: a box-only model scored masks {sorted(clip['result'])}")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("PIL", "cv2", "yaml"))
    check(not foreign, f"vgg: imported {foreign[:5]}")
    launches = {k: src["launches"][k] + src["eval_launches"][k] + mt["launches"][k]
                + city["launches"][k] + clip["launches"][k] for k in src["launches"]}
    return dict(source=src, mt=mt, launches=launches, costs=vgg_costs(torch, dev),
                cityscapes=dict(step_ms=[s["ms"] for s in city["steps"]], wait_s=city["wait_s"],
                                test_s=city["test_s"], results=city["result"],
                                peak_gib=city["peak_gib"], launches=city["launches"],
                                held=city["held"]),
                clipart=dict(test_s=clip["test_s"], results=clip["result"],
                             peak_gib=clip["peak_gib"], launches=clip["launches"],
                             held=clip["held"]))


# -- phase 14: data parallelism ----------------------------------------------------

#: the kernels each data-parallel step kind must launch on every rank
DP_COUNTERS = {"source": ("roi_pool_bf16", "roi_pool_backward_bf16", "sinkhorn"),
               "tta": ("roi_pool_bf16", "gagm"),
               "mt_cd": ("roi_pool_bf16", "roi_pool_backward_bf16", "sinkhorn")}
#: each kind's pool calls held on rank 0's first step (:func:`hold_call_kernels`)
DP_POOLS = {"source": dict(step_pools=SOURCE_POOLS), "tta": dict(test_pools=("tta box",)),
            "mt_cd": dict(step_pools=MT_POOLS)}
DP_TIMEOUT_S = 900
DP_SEED = 0


def capture_step_kernels():
    """Wraps the pools (as ``models/rcnn.py`` calls them), kernel C's, HiPPI's
    and the GA-GM solver's entry points to keep copies of what one step
    gives each kernel, in the layout :func:`hold_call_kernels` reads:
    ``kernel_inputs`` (every pool call with its kind, C's, HiPPI's and D's
    inputs), ``test_pools`` (the first forward-only box pool, as ``"tta
    box"``) and ``gagm_inputs``.  Returns the record and the function that
    undoes it."""
    import ttdg_mgm_torch.models.rcnn as rcnn

    pools, test_pools = [], {}
    reals = (rcnn.multilevel_roi_pool, rcnn.multilevel_roi_pool_train)

    def pool(kind, real):
        def call(levels, boxes, **k):
            copy = ([x.detach().clone() for x in levels], boxes.detach().clone(), k)
            pools.append((kind, *copy))
            if kind == "forward" and k.get("output_size", 7) == 7:
                test_pools.setdefault("tta box", copy)
            return real(levels, boxes, **k)
        return call

    rcnn.multilevel_roi_pool = pool("forward", reals[0])
    rcnn.multilevel_roi_pool_train = pool("training", reals[1])
    bwd, undo_bwd = capture_pool_backward()
    hippi, undo_hippi = capture_hippi()
    gagm, undo_gagm = capture_gagm()

    def undo():
        undo_gagm()
        undo_hippi()
        undo_bwd()
        rcnn.multilevel_roi_pool, rcnn.multilevel_roi_pool_train = reals

    return dict(kernel_inputs=dict(pools=pools, backward=bwd, hippi=hippi),
                test_pools=test_pools, gagm_inputs=gagm), undo


def dp_kind(torch, dev, kind: str, size: int, **model_kw):
    """One data-parallel step kind at full width (bf16): a fresh flagship
    model (seed 0) with its optimizer and step, the global batch on the
    host, and for the MT kind the teacher and centers.  ``source``: 8
    labelled disc images (the source solver's lr under bench.py's warm-up
    and clip 1.0); ``tta``: 4 images, lr ``TTA_LR``; ``mt_cd``: 4 labelled
    + 4 unlabelled images with their strong views, the cross-domain head,
    pseudo-threshold 0.3 (random weights score near 1/3).  ``run(batch,
    generator)`` takes a step and returns its metrics and new centers;
    ``reset()`` puts the centers back to zero."""
    import copy

    from ttdg_mgm_torch.build import SOURCE_SOLVER, build_model
    from ttdg_mgm_torch.engine.steps import make_mt_step, make_source_step, make_tta_step
    from ttdg_mgm_torch.solver.build import build_optimizer, warmup_multistep_schedule
    from ttdg_mgm_torch.synth import synth_batch

    model = build_model(device=dev, seed=0, **model_kw)
    mask_res = SOURCE_SOLVER["mask_res"]
    if kind == "source":
        opt = build_optimizer(model, warmup_multistep_schedule(SOURCE_SOLVER["base_lr"],
                                                               **WARM_SCHEDULE), clip=WARM_CLIP)
        step = make_source_step(model, opt)
        batch = synth_batch(size, 8, seed=0, with_gt=True, mask_res=mask_res)
        return dict(model=model, opt=opt, batch=batch, reset=lambda: None,
                    run=lambda b, gen: (step(b, gen), None))
    if kind == "tta":
        opt = build_optimizer(model, lambda _: TTA_LR)
        step = make_tta_step(model, opt)
        batch = synth_batch(size, 4, seed=0)
        return dict(model=model, opt=opt, batch=batch, reset=lambda: None,
                    run=lambda b, gen: ({"loss": step(b)}, None))
    opt = build_optimizer(model, lambda _: SOURCE_SOLVER["base_lr"])
    step = make_mt_step(model, opt, pseudo_threshold=0.3, with_cross_domain=True)
    lab, unl = (synth_batch(size, 4, seed=s, with_gt=True, mask_res=mask_res) for s in (1, 2))
    batch = {"label_strong": lab["image"] * 0.9 + 10, "label_weak": lab["image"],
             "label_sizes": lab["image_sizes"], "gt_boxes": lab["gt_boxes"],
             "gt_classes": lab["gt_classes"], "gt_masks": lab["gt_masks"],
             "gt_valid": lab["gt_valid"],
             "unlabel_strong": (unl["image"] * 1.1 - 5).clip(0, 255).astype(unl["image"].dtype),
             "unlabel_weak": unl["image"], "unlabel_sizes": unl["image_sizes"]}
    teacher = copy.deepcopy(model)
    state = {}

    def reset():
        state["centers"] = torch.zeros((model.num_classes + 1, model.cross_domain.dim),
                                       device=dev)

    def run(b, gen):
        metrics, state["centers"] = step(teacher, state["centers"], b, gen)
        return metrics, state["centers"]

    reset()
    return dict(model=model, opt=opt, batch=batch, run=run, reset=reset)


def _flat_params(torch, model):
    return torch.cat([v.detach().reshape(-1).float().cpu() for v in model.state_dict().values()
                      if v.is_floating_point()])


def dp_rank(out_dir: str, size: int, hold: bool, dev_type: str = "cuda",
            model_kw=None) -> None:
    """One rank of phase 14(b), in a process of its own (gloo, the card
    shared with the other rank): for each of :data:`DP_POOLS`' kinds, a
    fresh model takes two steps on this rank's shard of the global batch
    (``mesh.shard_batch``) with the rank's generator (seed ``DP_SEED +
    rank * 2**32``, ``engine/trainer.py:rank_seed``), the kernel counters
    set to 0 before and read after; the ranks' weights after each step are
    gathered and compared bit for bit; after the first step rank 0
    recomputes it as one process without the group (each shard's gradients
    and losses from the same weights, averaged ``(a + b) / 2``, one
    optimizer step) and compares bit for bit, then, with ``hold``, holds
    each kernel against its plain version on what the step gave it.
    Saves what it measured to ``out_dir/rank{r}.pt``.  ``dev_type`` "cpu"
    and a small ``model_kw`` rehearse it on the CPU (without ``hold``)."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, HERE)
    from ttdg_mgm_torch import configure_torch

    configure_torch()
    from ttdg_mgm_torch.ops import _cuda
    from ttdg_mgm_torch.parallel import mesh

    model_kw = model_kw or {}
    cuda = dev_type == "cuda"
    if cuda:
        _cuda.lib()
    dev = torch.device("cuda", torch.cuda.current_device()) if cuda else torch.device("cpu")
    r, w = mesh.rank(), mesh.world_size()
    real_reduce, reduce_s = mesh.all_reduce_mean, []

    def timed_reduce(ts):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = real_reduce(ts)
        _sync(torch, dev)
        reduce_s.append(time.perf_counter() - t0)
        return out

    def gathered_equal(model):
        flat = _flat_params(torch, model)
        got = [torch.empty_like(flat) for _ in range(w)]
        dist.all_gather(got, flat)
        return all(torch.equal(got[0], g) for g in got[1:])

    out = {"rank": r, "world": w, "backend": dist.get_backend(), "kinds": {}, "held": {}}
    mesh.all_reduce_mean = timed_reduce
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    try:
        for kind in DP_POOLS:
            k = dp_kind(torch, dev, kind, size, **model_kw)
            shard = {n: torch.from_numpy(v.copy()).to(dev)
                     for n, v in mesh.shard_batch(k["batch"]).items()}
            gen = torch.Generator(device=dev).manual_seed(DP_SEED + (r << 32))
            start = _flat_params(torch, k["model"])
            rec = {"ms": [], "reduce_s": [], "equal_ranks": [], "launches": []}
            for i in range(2):
                if i == 0 and hold and r == 0:
                    taken, undo = capture_step_kernels()
                reduce_s.clear()
                reset_counters()
                _sync(torch, dev)
                t0 = time.perf_counter()
                try:
                    metrics, centers = k["run"](shard, gen)
                    _sync(torch, dev)
                finally:
                    if i == 0 and hold and r == 0:
                        undo()
                rec["ms"].append((time.perf_counter() - t0) * 1e3)
                rec["launches"].append({n: v for n, v in read_counters().items() if v})
                rec["reduce_s"].append(sum(reduce_s))
                rec["equal_ranks"].append(gathered_equal(k["model"]))
                if i == 0:
                    rec["losses"] = {n: float(v) for n, v in metrics.items()}
                    rec["moved"] = not torch.equal(start, _flat_params(torch, k["model"]))
                    if r == 0:
                        rec["shard_average"] = dp_shard_average(
                            torch, dev, kind, size, k, metrics, centers, w, model_kw)
                        if hold:
                            out["held"][kind] = hold_call_kernels(
                                torch, dev, taken, f"dp {kind} rank 0", **DP_POOLS[kind])
                            del taken
                    dist.barrier()
            out["kinds"][kind] = rec
            del k, shard
            if cuda:
                torch.cuda.empty_cache()
    finally:
        mesh.all_reduce_mean = real_reduce
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else 0.0
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def dp_shard_average(torch, dev, kind: str, size: int, k: dict, metrics, centers,
                     w: int, model_kw) -> dict:
    """Rank 0's single-process recomputation of the first step of ``kind``:
    a fresh model of the same seed; each shard's gradients and losses (the
    shard's own generator), with the process group out of the step's
    sight; the average ``(a + b) / 2`` in rank order and one optimizer
    step.  Returns what differs from the data-parallel step (``k``, its
    ``metrics`` and ``centers``): nothing, when it holds bit for bit."""
    from ttdg_mgm_torch.parallel import mesh

    ref = dp_kind(torch, dev, kind, size, **model_kw)
    opt = ref["opt"]
    grads, losses, new_centers = [], [], []
    n = next(iter(ref["batch"].values())).shape[0] // w
    real_active = mesh.active
    opt.step = lambda: grads.append([torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                     for p in opt.params])
    mesh.active = lambda: False
    try:
        for s in range(w):
            shard = {name: torch.from_numpy(v[s * n:(s + 1) * n].copy()).to(dev)
                     for name, v in ref["batch"].items()}
            gen = torch.Generator(device=dev).manual_seed(DP_SEED + (s << 32))
            ref["reset"]()  # each shard's step starts from the centers both ranks had
            m, c = ref["run"](shard, gen)
            losses.append(m)
            new_centers.append(c)
    finally:
        mesh.active = real_active
        del opt.step
    for i, p in enumerate(opt.params):
        p.grad = (grads[0][i] + grads[1][i]) / w
    opt.step()
    diff = [f"loss {name}" for name in losses[0]
            if not torch.equal((losses[0][name] + losses[1][name]) / w, metrics[name])]
    want, got = ref["model"].state_dict(), k["model"].state_dict()
    diff += [name for name in want if not torch.equal(want[name], got[name])]
    if centers is not None and not torch.equal((new_centers[0] + new_centers[1]) / w, centers):
        diff.append("centers")
    del ref
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"differs": diff[:8], "n_differs": len(diff)}


def phase_dp(torch, dev, data: str, card: str = "", phase10_losses=None, opts=(), size: int = 800,
             hold: bool = True, counters=TRAIN_COUNTERS, dp_counters=DP_COUNTERS,
             model_kw=None) -> dict:
    """Data parallelism (``ttdg_mgm_torch/parallel/``) on the one card:

    (a) NCCL at world size 1: ``train_net_torch.main`` with phase 10's
    command (``configs/seg_res50fpn_source.yaml`` as shipped, on its splits
    under ``data``) and ``--dist-url tcp://127.0.0.1:<free
    port> --num-machines 1``, 2 steps: a process group exists, so the
    reduction runs (its calls, backend and world checked, timed); the
    logged losses of both steps must equal phase 10's first two
    (``phase10_losses``) bit for bit, a sum over one rank divided by 1
    being exact; the process group is gone after the call;

    (b) two ranks on the one card over gloo (NCCL refuses two ranks on one
    device), spawned by ``multihost.launch`` (:func:`dp_rank`): a source
    step of 8 images (4 per rank), a TTA step of 4 (2 per rank, so kernel
    B solves G = 2 graphs) and an MT step of 4 + 4 with the cross-domain
    head, bf16 at full width, two of each; the ranks' weights after every
    step equal bit for bit, equal after the first to one process averaging
    both shards' gradients bit for bit (rank 0), every kernel of the kind
    launched on every step of every rank, and each held against its plain
    version on rank 0's own first-step inputs (``hold``).

    Logs the step times per kind, the reduction's seconds per step and the
    peak memory of each rank; ``opts`` follow (a)'s command line.  On the
    CPU (a rehearsal: small ``opts`` and ``model_kw``, ``hold`` False,
    empty ``counters`` and ``dp_counters``) (a) runs gloo and (b) CPU
    ranks."""
    import tempfile

    import torch.distributed as dist

    from ttdg_mgm_torch.parallel import mesh, multihost

    real_reduce, calls = mesh.all_reduce_mean, []

    def timed_reduce(ts):
        _sync(torch, dev)
        t0 = time.perf_counter()
        res = real_reduce(ts)
        _sync(torch, dev)
        calls.append(dict(s=time.perf_counter() - t0, backend=dist.get_backend(),
                          world=mesh.world_size(), tensors=len(ts)))
        return res

    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--dist-url", f"tcp://127.0.0.1:{multihost.free_port()}", "--num-machines", "1",
                "--device", str(dev), "--config",
                os.path.join(HERE, "configs", "seg_res50fpn_source.yaml"), "--datasets-root",
                data, "MODEL.WEIGHTS", "", "OUTPUT_DIR", os.path.join(tmp, "out"),
                "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "2", "TEST.EVAL_PERIOD", "0",
                *opts]
        log(f"dp nccl: train_net_torch.main({' '.join(argv[:4])} ...) with phase 10's command")
        mesh.all_reduce_mean = timed_reduce
        try:
            nccl = _train_call(torch, dev, argv, "dp nccl")
        finally:
            mesh.all_reduce_mean = real_reduce
        _log_train_call(nccl, "dp nccl", card)
        _check_train(nccl, "dp nccl", ("source",) * 2, os.path.join(tmp, "out", "checkpoints"),
                     (2,), counters)
    check(not mesh.active(), "dp nccl: the process group outlived the call")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    check([(c["backend"], c["world"]) for c in calls] == [(backend, 1)] * 2,
          f"dp nccl: reductions {calls}, expected one per step over NCCL at world size 1")
    got = [s["losses"] for s in nccl["steps"]]
    if phase10_losses is not None:
        check(got == phase10_losses[:2], f"dp nccl: losses {got} differ from phase 10's first "
              f"two {phase10_losses[:2]}")
    log(f"dp nccl ({card}): losses equal phase 10's first two bit for bit: "
        f"{phase10_losses is not None}; all-reduce s per step {[round(c['s'], 4) for c in calls]} "
        f"over {calls[0]['tensors']} tensors")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        multihost.launch(dp_rank, 2, dist_url=f"file://{os.path.join(tmp, 'store')}",
                         device=dev.type, backend="gloo",
                         args=(tmp, size, hold, dev.type, model_kw), timeout_s=DP_TIMEOUT_S)
        spawn_s = time.perf_counter() - t0
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
    check([(x["backend"], x["world"], x["rank"]) for x in ranks]
          == [("gloo", 2, 0), ("gloo", 2, 1)], "dp gloo: the ranks' world")
    kinds = {}
    for kind in DP_POOLS:
        recs = [x["kinds"][kind] for x in ranks]
        for r, rec in enumerate(recs):
            check(all(rec["equal_ranks"]), f"dp gloo {kind}: the ranks' weights differ after "
                  f"steps {rec['equal_ranks']}")
            check(rec["moved"], f"dp gloo {kind} rank {r}: the step left the weights as they were")
            bad = {n: v for n, v in rec["losses"].items() if not math.isfinite(v)}
            check(not bad, f"dp gloo {kind} rank {r}: non-finite losses {bad}")
            for i, launches in enumerate(rec["launches"]):
                missing = [n for n in dp_counters.get(kind, ()) if launches.get(n, 0) < 1]
                check(not missing, f"dp gloo {kind} rank {r} step {i}: kernels {missing} not "
                      f"launched ({launches})")
        check(recs[0]["losses"] == recs[1]["losses"], f"dp gloo {kind}: the ranks' averaged "
              f"losses differ: {recs[0]['losses']} {recs[1]['losses']}")
        avg = recs[0]["shard_average"]
        check(avg["n_differs"] == 0, f"dp gloo {kind}: {avg['n_differs']} tensors differ from "
              f"the single-process shard average, first {avg['differs']}")
        kinds[kind] = dict(step_ms=[rec["ms"] for rec in recs],
                           median_ms=statistics.median(recs[0]["ms"] + recs[1]["ms"]),
                           reduce_s=[rec["reduce_s"] for rec in recs],
                           losses=recs[0]["losses"], launches=recs[0]["launches"])
    launches = {n: sum(st.get(n, 0) for rec in ranks[0]["kinds"].values()
                       for st in rec["launches"]) for n in read_counters()}
    peaks = [x["peak_gib"] for x in ranks]
    times = {k: {n: v[n] for n in ("step_ms", "median_ms", "reduce_s")} for k, v in kinds.items()}
    log(f"dp gloo ({card}): 2 ranks on one card, spawned and joined in {spawn_s:.1f} s; per "
        f"kind the step ms by rank, their median, the reduction's s per step by rank "
        f"{json.dumps(times)}; peak memory by rank {[round(p, 2) for p in peaks]} GiB; rank 0's "
        f"launches {launches}")
    return dict(nccl=dict(losses=got, reduce_s=[c["s"] for c in calls], main_s=nccl["main_s"],
                          step_ms=[s["ms"] for s in nccl["steps"]], peak_gib=nccl["peak_gib"],
                          launches=nccl["launches"]),
                gloo=dict(kinds=kinds, spawn_s=spawn_s, peak_gib=peaks, launches=launches),
                launches=launches, held=ranks[0]["held"])


# -- main ---------------------------------------------------------------------------

# -- phase 15: the last slice ----------------------------------------------------

MIX_CLUSTERS = 2
MIX_STEPS = 2
#: the long tail on CUDA tensors against the CPU: float32 values and
#: gradients, relative to each result's largest entry (other summation
#: orders, TF32 off)
LONG_TAIL_RTOL = 1e-5
#: ``HyperGraphBlock`` at the cross-domain head's size: 248 nodes (2 x 124
#: per MT step) of 256 channels
HG_NODES, HG_DIM = 248, 256


def capture_mixture():
    """Wraps ``ga_gm_mixture`` as ``graph/mgm.py`` calls it to keep each
    call's inputs (copies) and outputs.  Returns the record and the function
    that undoes it."""
    import ttdg_mgm_torch.graph.mgm as mgm

    record, real = [], mgm.ga_gm_mixture

    def solve(A, W, U0, ms, n_univ, num_clusters, **kw):
        inputs = (A.detach().clone(), W.detach().clone(), U0.detach().clone(), ms.clone())
        out = real(A, W, U0, ms, n_univ, num_clusters, **kw)
        record.append(dict(inputs=inputs, n_univ=n_univ, num_clusters=num_clusters,
                           kw=dict(kw), out=out))
        return out

    def undo():
        mgm.ga_gm_mixture = real

    mgm.ga_gm_mixture = solve
    return record, undo


def _same_partition(a, b) -> bool:
    a, b = list(a), list(b)
    return all((a[i] == a[j]) == (b[i] == b[j]) for i in range(len(a)) for j in range(len(a)))


def mixture_solver_kw(kw: dict) -> dict:
    """The GA-GM settings ``ga_gm_mixture`` runs its rounds with: its own
    defaults, then the caller's."""
    import inspect

    from ttdg_mgm_torch.graph.solvers import ga_gm_mixture

    names = ("quad_weight", "mgm_iter", "sk_iter", "sk_tau0", "sk_gamma", "min_tau", "tol")
    sig = inspect.signature(ga_gm_mixture).parameters
    return {n: kw.get(n, sig[n].default) for n in names}


def hold_mixture(torch, entry: dict, what: str) -> dict:
    """The card's ``ga_gm_mixture`` call ``entry`` (from
    :func:`capture_mixture`) against the CPU's on the same inputs: each
    pass's annealed rounds (kernel B, finale cap 0) held against the plain
    rounds on the CPU from the pass's own start (``U0``, then the card's
    projected U) as :func:`hold_annealed` holds them; each exact LAP
    projection bit for bit against the host LAP of the card's own annealed
    U; the graph affinity against the CPU's on the card's projected U; the
    card's clusters the same partition as the CPU's spectral clustering of
    the card's affinity.  The whole solve is not run again on the CPU: the
    annealed rounds of flat blocks leave the LAP to round-off, so its first
    projection, and all that follows it, may differ; the stages above are
    each held on the card's own inputs."""
    from ttdg_mgm_torch.graph.solvers import _cluster_affinity, _project_blocks
    from ttdg_mgm_torch.graph.spectral import spectral_clustering

    cpu = torch.device("cpu")
    A, W, U0, ms = entry["inputs"]
    nu, k, kw = entry["n_univ"], entry["num_clusters"], entry["kw"]
    _, c_card, trace = entry["out"]
    G, T = ms.shape[0], A.shape[0]
    M = T // G
    gkw = mixture_solver_kw(kw)
    starts = (U0, trace["projected"][0])
    passes, worst, chaotic = [], 0.0, []
    for p in range(2):
        held = hold_annealed(torch, A, W, starts[p], ms, nu, gkw, f"{what} pass {p + 1}",
                             plain_dev=cpu)
        check(torch.equal(held["U"], trace["annealed"][p]),
              f"{what} pass {p + 1}: the kernel's annealed U differs from its own earlier run")
        proj = _project_blocks(trace["annealed"][p].cpu().reshape(G, M, nu), ms.cpu().long(), nu,
                               tau=1.0, sk_iter=0, exact_hungarian=True).reshape(T, nu)
        check(torch.equal(proj, trace["projected"][p].cpu()),
              f"{what} pass {p + 1}: the projection differs from the host LAP of the card's U")
        worst = max(worst, held["max_abs_err"])
        chaotic.append(held["chaotic"])
        passes.append(f"pass {p + 1}: steps kernel {held['steps'][:-1]} CPU "
                      f"{held['plain_steps'][:-1]}, {held['held']}, LAP projection bit for bit")
    alpha_cpu = _cluster_affinity(A.cpu(), W.cpu(), trace["projected"][0].cpu(), ms.cpu(), G, M,
                                  quad_weight=kw.get("cluster_quad_weight", 1.0))
    alpha = trace["alpha"].cpu()
    err_alpha = ((alpha - alpha_cpu).abs().max() / alpha_cpu.abs().max().clamp(min=1e-30)).item()
    check(err_alpha <= LONG_TAIL_RTOL, f"{what}: the affinity differs from the CPU's by "
                                       f"{err_alpha} of its largest entry")
    c_own = spectral_clustering(alpha, k, normalized=True)
    check(_same_partition(c_own.tolist(), c_card.tolist()),
          f"{what}: clusters {c_card.tolist()} against the CPU's {c_own.tolist()} on the same "
          f"affinity")
    log(f"{what} (ms {ms.tolist()}): clusters {c_card.tolist()}, the CPU's on the same affinity "
        f"{c_own.tolist()}; " + "; ".join(passes) + f"; affinity {err_alpha:.3e} of its largest "
        f"entry")
    return dict(clusters=c_card.tolist(), anneal_max_abs_err=worst, affinity_rel_err=err_alpha,
                chaotic_passes=sum(chaotic))


def phase_mixture(torch, dev, prec: str = "float32", size: int = 800, steps: int = MIX_STEPS,
                  counters=("roi_pool", "gagm"), **model_kw):
    """MGM-Mixture's TTA step at full width: the flagship with its
    ``multi_matching_unsup.num_clusters`` set to ``MIX_CLUSTERS`` (the JAX
    ``MGM3Unsup.num_clusters``; no config key sets it), ``steps`` TTA steps
    on 4 synthetic images: a finite loss, a nonzero backbone gradient,
    kernel A launched and kernel B twice a step (the two passes' annealed
    rounds), the step's time; then kernel A held on the first step's box
    pool (its levels and ROIs, copied as the step gave them) and every
    step's solve held by :func:`hold_mixture`."""
    import ttdg_mgm_torch.models.rcnn as rcnn
    from ttdg_mgm_torch.build import build_model
    from ttdg_mgm_torch.engine.steps import make_tta_step
    from ttdg_mgm_torch.solver.build import build_optimizer
    from ttdg_mgm_torch.synth import synth_batch

    model = build_model(device=dev, seed=0, compute_dtype=prec, **model_kw)
    model.multi_matching_unsup.num_clusters = MIX_CLUSTERS
    opt = build_optimizer(model, lambda _: TTA_LR)
    step = make_tta_step(model, opt)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in synth_batch(size, 4, seed=0).items()}
    _sync(torch, dev)
    reset_counters()
    record, undo = capture_mixture()
    real_pool, pools = rcnn.multilevel_roi_pool, []

    def pool(levels, boxes, **k):
        if not pools and k.get("output_size", 7) == 7:
            pools.append(([x.detach().clone() for x in levels], boxes.detach().clone(), k))
        return real_pool(levels, boxes, **k)

    rcnn.multilevel_roi_pool = pool
    step_ms, losses, grads = [], [], []
    try:
        for i in range(steps):
            _sync(torch, dev)
            t0 = time.perf_counter()
            loss = float(step(batch))
            _sync(torch, dev)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            g = sum(float(p.grad.abs().sum()) for n, p in model.named_parameters()
                    if n.startswith("backbone.") and p.grad is not None)
            mgm = model.multi_matching_unsup
            losses.append(loss)
            grads.append(g)
            log(f"mixture {prec} TTA step {i}: loss {loss:.6f}, backbone |grad|_1 {g:.4e}, "
                f"clusters {mgm.last_clusters}, valid nodes {mgm.last_node_counts.tolist()}, "
                f"GA-GM steps per pass {mgm.last_solver_steps}, {step_ms[-1]:.1f} ms")
            check(math.isfinite(loss) and loss > 0.0, f"mixture {prec} step {i}: loss {loss}")
            check(g > 0.0 and math.isfinite(g), f"mixture {prec} step {i}: backbone gradient {g}")
            check_f32_params(torch, model, f"mixture {prec} TTA step {i}")
    finally:
        rcnn.multilevel_roi_pool = real_pool
        undo()
    launches = read_counters()
    check(len(record) == steps, f"mixture {prec}: {len(record)} solves in {steps} steps")
    for name in counters:
        key = pool_counter(name, prec) if name == "roi_pool" else name
        want_n = 2 * steps if name == "gagm" else 1
        check(launches[key] >= want_n if name == "roi_pool" else launches[key] == want_n,
              f"mixture {prec}: kernel {key} launched {launches[key]} times in {steps} steps")
    check(len(pools) == 1, f"mixture {prec}: no box pool call in {steps} steps")
    levels, rois, _ = pools[0]
    B, K = rois.shape[:2]
    held_pools = {"tta box": hold_pool(
        torch, levels, rois, 7, f"mixture {prec} roi_pool tta box",
        f"levels {tuple(levels[0].shape)}..{tuple(levels[-1].shape)}, {B} x {K} ROIs of the "
        "first step")}
    del pools, levels, rois
    held = [hold_mixture(torch, e, f"mixture {prec} step {i}") for i, e in enumerate(record)]
    del model, opt, step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return dict(step_ms=step_ms, losses=losses, backbone_grad_l1=grads, launches=launches,
                held=held, held_pools=held_pools)


def _rel_err(torch, got, want) -> float:
    got, want = got.detach().cpu().double(), want.detach().cpu().double()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def phase_long_tail(torch, dev, hg_nodes: int = HG_NODES, hg_dim: int = HG_DIM) -> dict:
    """The long tail on CUDA tensors against the CPU on the same inputs:
    ``HyperGraphBlock`` at the cross-domain head's node count and width
    (its time), ``spectral_clustering`` on a 4 x 4 and an 8 x 8 affinity
    (the same partition), each matching loss's value and gradient,
    ``gumbel_sinkhorn`` on given uniforms and ``sinkhorn_auto`` on mixed
    orientations, within ``LONG_TAIL_RTOL`` of each result's largest
    entry."""
    import copy

    from ttdg_mgm_torch.graph import losses as L
    from ttdg_mgm_torch.graph.hypergraph import HyperGraphBlock, knn_hypergraph_laplacian
    from ttdg_mgm_torch.graph.spectral import spectral_clustering
    from ttdg_mgm_torch.ops.sinkhorn import gumbel_sinkhorn, sinkhorn_auto

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    errs = {}

    def hold(name, fn, *args, grad=True):
        outs = []
        for d in (cpu, dev):
            xs = [a.detach().clone().to(d).requires_grad_(grad and a.is_floating_point())
                  if torch.is_tensor(a) else a for a in args]
            y = fn(*xs)
            gs = []
            if grad:
                # a weighted sum: the plain sum of a doubly-stochastic
                # matrix is constant, its gradient round-off alone
                wts = torch.rand(y.shape, generator=torch.Generator().manual_seed(1))
                (y * wts.to(d)).sum().backward()
                gs = [x.grad for x in xs if torch.is_tensor(x) and x.grad is not None]
            outs.append((y, gs))
        (yc, gc), (yd, gd) = outs
        errs[name] = max([_rel_err(torch, yd, yc)] + [_rel_err(torch, b, a)
                                                      for a, b in zip(gc, gd)])
        check(errs[name] <= LONG_TAIL_RTOL and len(gc) == len(gd),
              f"long tail {name}: CUDA against the CPU {errs[name]:.3e}")

    x = torch.randn(hg_nodes, hg_dim, generator=gen)
    torch.manual_seed(0)
    blk = HyperGraphBlock(hg_dim)
    blk_d = copy.deepcopy(blk).to(dev)
    hold("knn_hypergraph_laplacian", lambda t: knn_hypergraph_laplacian(t, 10), x, grad=False)
    out_c = blk(x)
    out_d = blk_d(x.to(dev))
    errs["HyperGraphBlock"] = _rel_err(torch, out_d, out_c)
    check(errs["HyperGraphBlock"] <= LONG_TAIL_RTOL,
          f"long tail HyperGraphBlock: {errs['HyperGraphBlock']:.3e}")
    hg_ms = event_ms(torch, lambda: blk_d(x.to(dev)), 5) if dev.type == "cuda" else None
    parts = {}
    for n in (4, 8):
        lab = torch.arange(n) % 2
        sim = torch.rand(n, n, generator=gen) + 2.0 * (lab[:, None] == lab[None, :])
        sim = (sim + sim.T) / 2 * (1 - torch.eye(n))
        for k in (2, 3):
            a = spectral_clustering(sim, k, normalized=True).tolist()
            b = spectral_clustering(sim.to(dev), k, normalized=True).tolist()
            check(_same_partition(a, b), f"long tail spectral {n}x{n} k={k}: {b} vs {a}")
            parts[f"{n}x{n}_k{k}"] = b
    p = torch.rand(3, 6, 7, generator=gen) * 0.96 + 0.02
    t = torch.zeros(3, 6, 7)
    t[:, torch.arange(6), torch.arange(6)] = 1.0
    m = torch.ones(3, 6, 7, dtype=torch.bool)
    m[1, 4:] = False
    hold("permutation_loss", lambda a, b, c: L.permutation_loss(a, b, c), p, t, m)
    hold("cross_entropy_perm_loss", lambda a, b, c: L.cross_entropy_perm_loss(a, b, c.any(-1)),
         p, t, m)
    hold("hamming_loss", L.hamming_loss, p, t, m)
    hold("inner_product_loss", L.inner_product_loss, p, t, m)
    hold("focal_perm_loss", lambda a, b, c: L.focal_perm_loss(a, b, c, gamma=2.0), p, t, m)
    hold("ilp_attention_loss", lambda a, b: L.ilp_attention_loss(a, b), p, t)
    pts_s, pts_t = torch.rand(3, 6, 2, generator=gen) * 50, torch.rand(3, 7, 2, generator=gen) * 50
    hold("displacement_offset_loss", lambda s, a, b: L.offset_loss(
        L.displacement(s, a, b, torch.tensor([6, 4, 5], device=s.device))[0],
        torch.zeros(3, 6, 2, device=s.device), norm=7.0), p, pts_s, pts_t)
    hold("concat_matrix", lambda a: L.concat_matrix(a, [(1, 0), (2, 0), (2, 1)], 3),
         p[:, :6, :6].contiguous())
    s = torch.randn(2, 9, 9, generator=gen)
    u = torch.rand(4, 2, 9, 9, generator=gen)
    hold("gumbel_sinkhorn", lambda a, b: gumbel_sinkhorn(a, b, tau=0.3, max_iter=12,
                                                         sample_num=4), s, u)
    nr, nc = torch.tensor([9, 4]), torch.tensor([5, 9])
    hold("sinkhorn_auto", lambda a: sinkhorn_auto(a, nr.to(a.device), nc.to(a.device), tau=0.2,
                                                  max_iter=15), s)
    log(f"long tail on {dev} against the CPU (largest error relative to each result's largest "
        f"entry, values and gradients; tolerance {LONG_TAIL_RTOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; spectral partitions {parts}; HyperGraphBlock ({hg_nodes} x {hg_dim}) "
        + (f"{hg_ms:.4f} ms" if hg_ms is not None else "not timed"))
    return dict(rel_err=errs, hypergraph_ms=hg_ms, spectral=parts)


# -- phase 16: eval-only TTA on TIFF and progressive-JPEG polyp splits ----------

FORMATS_DIR = os.path.join(HERE, "tests", "fixtures", "torch_formats")
#: phase 16's TIFF split: (split, frames, (h, w)), ETIS-LaribPolypDB's size,
#: and the seed of its first frame (:func:`polyp_frame_int`)
FORMATS_TIFF = ("ETIS_LaribPolypDB_test", 2, (966, 1225))
FORMATS_SEED = 200
#: phase 16's JPEG split: the committed progressive JPEGs of 720 x 576
FORMATS_JPEG = ("Kvasir_SEG_test", ("k0.jpg", "k1.jpg"))
#: committed files decoded only for their time and digest: CMYK and 4:1:1
FORMATS_TIMED = ("cmyk.jpg", "h4v1.jpg")


def write_formats_data(root: str) -> dict:
    """Phase 16's splits under ``root`` in the reference's layout:
    ``ETIS_LaribPolypDB_test``, ``FORMATS_TIFF``'s frames of
    :func:`polyp_frame_int` as LZW TIFFs with the horizontal predictor, each
    with its polyp's 64-vertex polygon ring (class 1), and
    ``Kvasir_SEG_test``, the committed progressive JPEGs with their polygon
    ground truth.  Returns each file's path by its key in
    ``tests/fixtures/torch_formats/digests.json``."""
    import shutil

    import numpy as np

    from ttdg_mgm_torch.data.builtin import SPLITS

    files = {}
    split, n, hw = FORMATS_TIFF
    json_rel, img_rel = SPLITS[split]
    os.makedirs(os.path.join(root, img_rel), exist_ok=True)
    images, anns = [], []
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    for i in range(n):
        img, (cy, cx, ry, rx) = polyp_frame_int(hw, FORMATS_SEED + i)
        fname = f"p{i}.tif"
        files[f"{split}/{fname}"] = path = os.path.join(root, img_rel, fname)
        with open(path, "wb") as f:
            f.write(tiff_bytes(img, comp=5, pred=2))
        ring = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)
        im, ann = _polyp_record(i, fname, hw, ring, int(np.pi * rx * ry))
        images.append(im)
        anns.append(ann)
    with open(os.path.join(root, json_rel), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "polyp"}]}, f)
    split, names = FORMATS_JPEG
    json_rel, img_rel = SPLITS[split]
    os.makedirs(os.path.join(root, img_rel), exist_ok=True)
    for fname in names:
        files[fname] = os.path.join(root, img_rel, fname)
        shutil.copy(os.path.join(FORMATS_DIR, fname), files[fname])
    shutil.copy(os.path.join(FORMATS_DIR, "annotations.json"), os.path.join(root, json_rel))
    return files


def image_digest(img) -> str:
    """SHA-256 of a decoded ``(H, W, 3)`` uint8 image's bytes, with its shape."""
    import hashlib

    return f"{img.shape[0]}x{img.shape[1]}x{img.shape[2]}:" + hashlib.sha256(
        img.tobytes()).hexdigest()


def decode_timed(paths: dict, digests: dict) -> dict:
    """Each file of ``paths`` decoded by ``load_image`` (the best of 2 runs,
    in seconds) and held against its committed digest of Pillow's decode
    (``digests``, by the same key)."""
    from ttdg_mgm_torch.data.loader import load_image

    out = {}
    for key, path in paths.items():
        best = math.inf
        for _ in range(2):
            t0 = time.perf_counter()
            img = load_image(path)
            best = min(best, time.perf_counter() - t0)
        got = image_digest(img)
        check(got == digests[key], f"formats: {key} decodes to {got}, Pillow's digest is "
                                   f"{digests[key]}")
        out[key] = best
    return out


def phase_formats(torch, dev, card: str = "", opts=(), model_kw=None,
                  counters=("roi_pool_bf16", "gagm"), hold: bool = True) -> dict:
    """Eval-only TTA on the image formats the datasets ship, as a user runs
    it: ``train_net_torch.main(["--eval-only", "--config",
    "configs/test_segment.yaml", ...])`` with no precision override (bf16),
    the flagship's seeded random weights and ``TEST.DICE_THRES 0.0`` (as in
    phase 8), ``TEST.BATCH`` 4, on ``ETIS_LaribPolypDB_test`` (2 LZW TIFF
    frames of 1225 x 966 with the horizontal predictor) and
    ``Kvasir_SEG_test`` (2 committed progressive JPEGs of 720 x 576), each
    with polygon ground truth (:func:`write_formats_data`).  Before the call
    every file of the splits, an uncompressed TIFF and a 24-bit BMP of the
    first TIFF frame's pixels, and the committed CMYK and 4:1:1 JPEGs are
    decoded by ``load_image`` and held against the committed SHA-256
    digests of Pillow's decode (``tests/fixtures/torch_formats/
    digests.json``, made where Pillow is), each format's decode seconds per
    image logged.  Passes only if both splits give finite Dice, E and S,
    the kernels of ``counters`` launched and the float32 pool did not, no
    Pillow, OpenCV or PyYAML was imported, and (with ``hold``) kernels A and
    B equal their plain versions on the call's own inputs
    (:func:`hold_call_kernels`).  Logs the evaluation's data, inference
    and evaluation seconds per image by split and the peak memory."""
    import tempfile

    from ttdg_mgm_torch.build import build_model

    with open(os.path.join(FORMATS_DIR, "digests.json")) as f:
        digests = json.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        files = write_formats_data(tmp)
        write_s = time.perf_counter() - t0
        tiff0 = files[f"{FORMATS_TIFF[0]}/p0.tif"]
        from ttdg_mgm_torch.data.loader import load_image

        frame = load_image(tiff0)
        extra = {"tiff_none": os.path.join(tmp, "p0_none.tif"),
                 "bmp24": os.path.join(tmp, "p0.bmp")}
        with open(extra["tiff_none"], "wb") as f:
            f.write(tiff_bytes(frame))
        with open(extra["bmp24"], "wb") as f:
            f.write(bmp_bytes(frame.shape[1], frame.shape[0], 24, bmp_rows(frame[..., ::-1], 24)))
        want = {**digests, "tiff_none": digests[f"{FORMATS_TIFF[0]}/p0.tif"],
                "bmp24": digests[f"{FORMATS_TIFF[0]}/p0.tif"]}
        timed = decode_timed({**files, **extra, **{k: os.path.join(FORMATS_DIR, k)
                                                   for k in FORMATS_TIMED}}, want)
        tiff_keys = [k for k in files if k.endswith(".tif")]
        decode_s = {
            "tiff_lzw_predictor_1225x966": statistics.mean(timed[k] for k in tiff_keys),
            "tiff_none_1225x966": timed["tiff_none"], "bmp24_1225x966": timed["bmp24"],
            "jpeg_progressive_720x576": statistics.mean(timed[k] for k in FORMATS_JPEG[1]),
            "jpeg_cmyk_720x576": timed["cmyk.jpg"], "jpeg_411_720x576": timed["h4v1.jpg"]}
        log(f"formats: {len(files)} files written in {write_s:.1f} s; every decode equals its "
            f"Pillow digest; decode s per image {json.dumps(decode_s)}")
        weights = os.path.join(tmp, "model_final.pth")
        model = build_model(device="cpu", seed=0, **(model_kw or {}))
        torch.save({"model": model.state_dict()}, weights)
        del model
        splits = [FORMATS_TIFF[0], FORMATS_JPEG[0]]
        argv = ["--eval-only", "--device", str(dev),
                "--config", os.path.join(HERE, "configs", "test_segment.yaml"),
                "--datasets-root", tmp, "DATASETS.TEST", json.dumps(splits),
                "MODEL.WEIGHTS", weights, "OUTPUT_DIR", os.path.join(tmp, "out"),
                "TEST.DICE_THRES", "0.0", *opts]
        log(f"formats: train_net_torch.main({' '.join(argv[:6])} ...) on {splits}, no "
            "precision override")
        cli, undo = capture_cli(torch)
        try:
            rec = _train_call(torch, dev, argv, "formats cli", kernel_inputs=hold)
        finally:
            undo()
        results, launches = rec["result"], rec["launches"]
        for name in splits:
            m = results.get(name, {})
            check(len(m) == 3 and all(math.isfinite(v) for v in m.values()),
                  f"formats: {name} Dice, E and S not all finite: {m}")
        missing = [k for k in counters if launches.get(k, 0) < 1]
        check(not missing and launches.get("roi_pool", 0) == 0,
              f"formats: kernel launches {launches}: {list(counters)} must run, the float32 "
              "pool must not")
        check(len(cli["evals"]) == 2, f"formats: {len(cli['evals'])} evaluation logs")
        held = (hold_call_kernels(torch, dev, rec, "formats cli", test_pools=TEST_POOLS)
                if hold else {})
    per = {}
    for name, ev, post in zip(splits, cli["evals"], cli["post_by_dataset"]):
        n_img, data_s, infer_s, eval_s = ev
        per[name] = dict(images=n_img, data_s_per_image=data_s, inference_s_per_image=infer_s,
                         eval_s_per_image=eval_s, paste_s_per_image=post / n_img)
    log(f"formats cli ({card}): TTA step ms {[round(t, 1) for t in cli['tta_ms']]}, losses "
        f"{[round(v, 6) for v in cli['tta_loss']]}; per split {json.dumps(per)}; main() "
        f"{rec['main_s']:.1f} s; peak memory {rec['peak_gib']:.2f} GiB; launches "
        f"{ {k: v for k, v in launches.items() if v} }; no PIL, cv2 or yaml imported")
    log(f"formats cli: results {json.dumps({k: results[k] for k in splits})}")
    return dict(decode_s_per_image=decode_s, write_s=write_s, tta_ms=cli["tta_ms"],
                tta_loss=cli["tta_loss"], splits=per, main_s=rec["main_s"],
                peak_gib=rec["peak_gib"], launches=launches,
                metrics={k: results[k] for k in splits}, held=held)


# -- phase 17: the mask paste -------------------------------------------------------

def paste_masks_np(masks, boxes, height: int, width: int, threshold: float = 0.5):
    """``ttdg_mgm_tpu/ops/mask_paste.py:paste_masks_np`` line for line (the
    JAX package's module imports JAX, which the card's machine lacks): the
    NumPy paste the kernel equals bit for bit.  ``tests/test_torch_eval.py``
    holds the two equal on the CPU."""
    import numpy as np

    K, M, _ = masks.shape
    out = np.zeros((K, height, width), np.uint8)
    for k in range(K):
        x1, y1, x2, y2 = boxes[k]
        w = max(x2 - x1, 1e-6)
        h = max(y2 - y1, 1e-6)
        y0i = max(int(np.floor(y1)), 0)
        y1i = min(int(np.ceil(y2)) + 1, height)
        x0i = max(int(np.floor(x1)), 0)
        x1i = min(int(np.ceil(x2)) + 1, width)
        if y1i <= y0i or x1i <= x0i:
            continue
        ys = (np.arange(y0i, y1i) + 0.5 - y1) / h * M - 0.5
        xs = (np.arange(x0i, x1i) + 0.5 - x1) / w * M - 0.5
        gy, gx = np.meshgrid(ys, xs, indexing="ij")
        y0 = np.floor(gy)
        x0 = np.floor(gx)

        def g(yy, xx):
            ok = (yy >= 0) & (yy < M) & (xx >= 0) & (xx < M)
            yi = np.clip(yy, 0, M - 1).astype(np.int64)
            xi = np.clip(xx, 0, M - 1).astype(np.int64)
            return np.where(ok, masks[k][yi, xi], 0.0)

        ly = gy - y0
        lx = gx - x0
        v = (
            g(y0, x0) * (1 - ly) * (1 - lx)
            + g(y0, x0 + 1) * (1 - ly) * lx
            + g(y0 + 1, x0) * ly * (1 - lx)
            + g(y0 + 1, x0 + 1) * ly * lx
        )
        out[k, y0i:y1i, x0i:x1i] = (v >= threshold).astype(np.uint8)
    return out


def paste_boxes(rng, K: int, H: int, W: int):
    """``(K, 4)`` float32 boxes of 0.3-3x the image, many crossing its
    border or larger than 28 px, a few thinner than a pixel."""
    import numpy as np

    c = rng.uniform([-0.2 * W, -0.2 * H], [1.1 * W, 1.1 * H], (K, 2))
    s = rng.uniform(0.3, 1.0, (K, 2)) * rng.choice([0.05, 0.5, 3.0], (K, 1)) * [W, H]
    s[: K // 8] *= 0.01
    return np.concatenate([c, c + s], 1).astype(np.float32)


def phase_paste(torch, dev, K: int = 100, M: int = 28, H: int = 800, W: int = 800,
                odd_w: int = 1944, reps: int = 50, seed: int = 0) -> dict:
    """The mask-paste kernel (``csrc/mask_paste.cu``) at the TTA cell's
    shape (K detections of M x M on an H x W image): bit for bit
    :func:`paste_masks_np` on :func:`paste_boxes` clamped to the image (as
    ``postprocess_detections`` clamps detections) on float32 probabilities
    and on the same rounded to bfloat16, then at the odd width ``odd_w``
    (Drishti-GS's, not a multiple of 16) on the boxes unclamped (over the
    border, thinner than a pixel); one launch a call; its time (the
    wrapper's and the bare launch's, CUDA events over ``reps`` calls)
    against its bound, the ``(K, H, W)`` bytes it writes, and the plain
    version's time (one call, host clock: its loop syncs)."""
    import numpy as np

    from ttdg_mgm_torch.ops import _cuda
    from ttdg_mgm_torch.ops.mask_paste import paste_masks, paste_masks_plain

    rng = np.random.RandomState(seed)
    probs = rng.rand(K, M, M).astype(np.float32)
    loose = paste_boxes(rng, K, H, W)
    boxes = loose.copy()
    boxes[:, 0::2] = boxes[:, 0::2].clip(0, W)
    boxes[:, 1::2] = boxes[:, 1::2].clip(0, H)
    m, b = torch.from_numpy(probs).to(dev), torch.from_numpy(boxes).to(dev)
    rounded = m.to(torch.bfloat16)
    cases = {"float32": (m, probs, b, boxes, W),
             "bfloat16": (rounded, rounded.float().cpu().numpy(), b, boxes, W),
             f"float32_w{odd_w}": (m, probs, torch.from_numpy(loose).to(dev), loose, odd_w)}
    mismatches, ones = {}, {}
    for name, (mt, mn, bt, bn, width) in cases.items():
        before = paste_masks.launches
        got = paste_masks(mt, bt, H, width, 0.5)
        _sync(torch, dev)
        check(paste_masks.launches == before + 1,
              f"paste {name}: {paste_masks.launches - before} kernel launches, not 1")
        want = paste_masks_np(mn, bn, H, width, 0.5)
        mismatches[name] = int((got.cpu().numpy() != want).sum())
        ones[name] = int(want.sum())
    check(not any(mismatches.values()) and all(ones.values()),
          f"paste: pixels differing from paste_masks_np {mismatches} (pasted ones {ones})")
    win = [max(0, min(math.ceil(y2) + 1, H) - max(math.floor(y1), 0))
           * max(0, min(math.ceil(x2) + 1, W) - max(math.floor(x1), 0))
           for x1, y1, x2, y2 in boxes.tolist()]
    ms = event_ms(torch, lambda: paste_masks(m, b, H, W, 0.5), reps)
    out = torch.empty((K, H, W), dtype=torch.uint8, device=dev)
    lib, stream = _cuda.lib(), _cuda.stream_ptr(dev)

    def bare():
        return lib.ttdg_paste_masks(m.data_ptr(), b.data_ptr(), K, M, H, W, 0.5, out.data_ptr(),
                                    stream)

    _cuda.check(bare(), "paste_masks kernel")
    bare_ms = event_ms(torch, bare, reps)
    plain_ms = host_ms(torch, lambda: paste_masks_plain(m, b, H, W, 0.5))
    bound_ms, bound_by = bound(K * H * W + probs.nbytes + boxes.nbytes, 0.0)
    res = dict(ms=ms, kernel_only_ms=bare_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, shape=[K, M, H, W], window_share=sum(win) / (K * H * W),
               mismatches=mismatches, pasted_ones=ones)
    log(f"paste: kernel {ms:.4f} ms a call ({bare_ms:.4f} bare), bound {bound_ms:.4f} ms by "
        f"{bound_by} ({100 * bound_ms / bare_ms:.1f} % of it), plain {plain_ms:.1f} ms, at K {K}, "
        f"M {M}, {H} x {W}, windows {100 * res['window_share']:.1f} % of the pixels; bit for "
        f"bit paste_masks_np in {sorted(cases)}")
    return res


def vit_attention_work(BH: int, N: int, Kh: int, Kw: int, backward: bool):
    """Bytes and operations kernel F's forward (or backward) needs at a
    shape: FLOPs of the two products the result needs, 4 BH N^2 64 forward
    and 8 BH N^2 64 backward (no recomputation counted); q, k, v, o (and
    backward dO, dq, dk, dv) in bf16, the log-sum-exp, rel_h and rel_w (and
    their gradients) in float32, each once."""
    d = 64
    flops = (8.0 if backward else 4.0) * BH * N * N * d
    tensors = 8 if backward else 4
    rel = BH * N * (Kh + Kw) * 4 * (2 if backward else 1)
    return tensors * BH * N * d * 2 + BH * N * 4 + rel, flops


def vit_attention_bound_ms(BH: int, N: int, Kh: int, Kw: int, backward: bool):
    """The least time of :func:`vit_attention_work` on the H100: bytes at
    3.35 TB/s, FLOPs on the bf16 tensor cores at 989 TFLOP/s."""
    nbytes, flops = vit_attention_work(BH, N, Kh, Kw, backward)
    t_bytes, t_ops = nbytes / 3.35e12 * 1e3, flops / 989e12 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: kernel F's shapes on the ViTDet-B cell's path (TEST.BATCH 4): the
#: windowed blocks' 4 images x 25 windows x 12 heads of 196 tokens (14 x 14),
#: the global blocks' 4 x 12 slices of 4,096 tokens (64 x 64)
VIT_ATTN_SHAPES = {"window": (1200, 196, 14, 14), "global": (48, 4096, 64, 64)}


def vit_attention_inputs(torch, dev, BH: int, N: int, Kh: int, Kw: int, seed: int = 0):
    """Seeded inputs of kernel F: q, k, v bf16 N(0, 1) (scores of unit
    spread at the scale 1/8), rel_h and rel_w float32 N(0, 0.5^2), and an
    output gradient bf16 N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, std=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(dtype)

    q, k, v = rnd(BH, N, 64), rnd(BH, N, 64), rnd(BH, N, 64)
    rh = rnd(BH, N, Kh, std=0.5, dtype=torch.float32)
    rw = rnd(BH, N, Kw, std=0.5, dtype=torch.float32)
    return q, k, v, rh, rw, rnd(BH, N, 64)


def vit_attention_errors(torch, got: dict, want: dict) -> dict:
    """Each output's largest gap over the reference's largest magnitude."""
    return {k: float((got[k].float() - want[k].float()).abs().max()
                     / want[k].float().abs().max().clamp(min=1e-30)) for k in want}


def vit_attention_run(torch, fn, q, k, v, rh, rw, grad, scale: float) -> dict:
    """``fn``'s output and the gradients into its five inputs."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, rh, rw)]
    out = fn(*leaves, scale)
    out.backward(grad)
    return dict(zip(("out", "dq", "dk", "dv", "drel_h", "drel_w"),
                    [out.detach()] + [t.grad for t in leaves]))


def phase_vit_attention(torch, dev, shapes=None, reps: int = 20) -> dict:
    """Kernel F (``csrc/vit_attention.cu``) at the ViTDet-B cell's shapes
    (:data:`VIT_ATTN_SHAPES`): forward and backward against the plain
    version on the same bf16 inputs (each output's largest gap over its
    largest magnitude), two runs bit for bit, one launch a forward and two
    a backward, the peak memory of a forward and backward above its inputs
    against one ``BH x N x N`` float32 score matrix (at the global shape,
    where the scores would dwarf the inputs), and the times (CUDA
    events over ``reps`` calls) of the wrapper's forward, the bare forward
    launch and the backward against their bounds
    (:func:`vit_attention_bound_ms`), beside the plain version's and, as a
    yardstick, PyTorch's ``scaled_dot_product_attention`` with the bias as
    a materialised mask (forward only)."""
    from ttdg_mgm_torch.ops import _cuda
    from ttdg_mgm_torch.ops.vit_attention import VitAttention, vit_attention, vit_attention_plain

    out = {}
    for name, (BH, N, Kh, Kw) in (shapes or VIT_ATTN_SHAPES).items():
        scale = 64 ** -0.5
        q, k, v, rh, rw, grad = vit_attention_inputs(torch, dev, BH, N, Kh, Kw)
        before = VitAttention.launches
        got = vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, scale)
        _sync(torch, dev)
        launches = VitAttention.launches - before
        check(launches == 3, f"vit attention {name}: {launches} launches for a forward and "
                             "backward, not 3")
        again = vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, scale)
        same = all(torch.equal(got[key], again[key]) for key in got)
        check(same, f"vit attention {name}: two runs differ")
        want = vit_attention_run(torch, vit_attention_plain, q, k, v, rh, rw, grad, scale)
        err = vit_attention_errors(torch, got, want)
        del want, again
        torch.cuda.empty_cache()
        _sync(torch, dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        vit_attention_run(torch, vit_attention, q, k, v, rh, rw, grad, scale)
        _sync(torch, dev)
        extra = torch.cuda.max_memory_allocated(dev) - base
        scores = BH * N * N * 4
        check(N < 1024 or extra < scores / 4, f"vit attention {name}: {extra} bytes above "
                                              f"the inputs, against {scores} of one score "
                                              "matrix")
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v, rh, rw)]
        fwd_ms = event_ms(torch, lambda: vit_attention(q, k, v, rh, rw, scale), reps)
        o = torch.empty_like(q)
        lse = torch.empty((BH, N), dtype=torch.float32, device=dev)
        lib, stream = _cuda.lib(), _cuda.stream_ptr(dev)

        def bare():
            return lib.ttdg_vit_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), rh.data_ptr(),
                                         rw.data_ptr(), BH, N, Kh, Kw, scale, o.data_ptr(),
                                         lse.data_ptr(), stream)

        _cuda.check(bare(), "vit attention forward kernel")
        bare_ms = event_ms(torch, bare, reps)
        fb = vit_attention(*leaves, scale)
        bwd_ms = event_ms(torch, lambda: torch.autograd.grad(fb, leaves, grad, retain_graph=True),
                          reps)
        plain_ms = host_ms(torch, lambda: vit_attention_run(
            torch, vit_attention_plain, q, k, v, rh, rw, grad, scale))
        bias = (rh[..., :, None] + rw[..., None, :]).reshape(BH, N, N).to(torch.bfloat16)
        lib_ms = event_ms(torch, lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=scale), reps)
        del bias, fb, leaves
        torch.cuda.empty_cache()
        f_bound, f_by = vit_attention_bound_ms(BH, N, Kh, Kw, False)
        b_bound, b_by = vit_attention_bound_ms(BH, N, Kh, Kw, True)
        res = dict(shape=[BH, N, 64, Kh, Kw], ms=fwd_ms, kernel_only_ms=bare_ms, bwd_ms=bwd_ms,
                   bound_ms=f_bound, bound_by=f_by, bwd_bound_ms=b_bound, bwd_bound_by=b_by,
                   roofline_pct=100 * f_bound / bare_ms, bwd_roofline_pct=100 * b_bound / bwd_ms,
                   plain_fwd_bwd_ms=plain_ms, library_ms=lib_ms, max_rel_err=err,
                   peak_extra_bytes=int(extra), score_matrix_bytes=scores)
        log(f"vit attention {name} {res['shape']}: forward {fwd_ms:.4f} ms ({bare_ms:.4f} bare), "
            f"bound {f_bound:.4f} by {f_by} ({res['roofline_pct']:.1f} %); backward "
            f"{bwd_ms:.4f} ms, bound {b_bound:.4f} by {b_by} ({res['bwd_roofline_pct']:.1f} %); "
            f"plain forward and backward {plain_ms:.1f} ms; SDPA with a mask {lib_ms:.4f} ms; "
            f"errors {json.dumps(err)}; {extra} bytes above the inputs (one score matrix "
            f"{scores}); bit for bit over two runs")
        out[name] = res
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "ttdg_mgm_torch", "csrc")):
        print("chip_smoke: ttdg_mgm_torch/ not found beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ttdg_mgm_torch import configure_torch

    configure_torch()
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

    argv = sys.argv[1:]
    profile = "--profile" in argv
    dump_dir = argv[argv.index("--dump-dir") + 1] if "--dump-dir" in argv else None
    t_run = time.perf_counter()

    def done(phase):
        log(f"phase {phase} done at {time.perf_counter() - t_run:.1f} s")

    roi = phase_roi_pool(torch, dev, profile=profile)
    roi16 = phase_roi_pool(torch, dev, dtype="bfloat16")
    done(2)
    gagm = phase_gagm(torch, dev)
    done(3)
    e2e = phase_e2e(torch, dev, profile=profile)
    gagm_main = phase_gagm_main(torch, dev, e2e.pop("gagm_inputs"), dump_dir=dump_dir)
    e2e16 = phase_e2e(torch, dev, profile=profile, prec="bfloat16")
    del e2e16["gagm_inputs"]
    phase_small_reference(torch, dev)
    done(4)
    roi_bwd, roi_train = phase_roi_backward(torch, dev)
    roi_bwd16, roi_train16 = phase_roi_backward(torch, dev, dtype="bfloat16")
    done(5)
    src = phase_source(torch, dev, profile=profile)
    bwd_main = phase_roi_backward_main(torch, dev, src.pop("pools"), dump_dir=dump_dir)
    done(6)
    sk = phase_sinkhorn(torch, dev, src.pop("hippi"), dump_dir=dump_dir)
    done(7)
    src16 = phase_source(torch, dev, profile=profile, prec="bfloat16")
    del src16["hippi"]
    bwd_main16 = phase_roi_backward_main(torch, dev, src16.pop("pools"))
    done("6 (bf16)")
    det = phase_determinism(torch, dev)
    done(9)
    cli = phase_cli(torch, dev, card)
    cli16 = phase_cli_bf16(torch, dev, card)
    done(8)
    import tempfile

    with tempfile.TemporaryDirectory() as train_data, tempfile.TemporaryDirectory() as mt_data:
        t0 = time.perf_counter()
        write_train_data(train_data)
        log(f"train data: phase 10's splits written in {time.perf_counter() - t0:.1f} s, read "
            "again by phases 13 and 14")
        train = phase_train_cli(torch, dev, train_data, card)
        done(10)
        write_mt_splits(mt_data)
        mtc = phase_mt_cli(torch, dev, card, data=mt_data)
        done(11)
        mtcd = phase_mt_cd_cli(torch, dev, card, data=mt_data)
        done(12)
        vgg = phase_vgg(torch, dev, train_data, card, mt_data=mt_data)
        done(13)
        dp = phase_dp(torch, dev, train_data, card, phase10_losses=train["step_losses"])
        done(14)
    mix = phase_mixture(torch, dev, "float32")
    mix16 = phase_mixture(torch, dev, "bfloat16")
    tail = phase_long_tail(torch, dev)
    done(15)
    fmts = phase_formats(torch, dev, card)
    done(16)
    paste = phase_paste(torch, dev)
    done(17)
    vit = phase_vit_attention(torch, dev)
    done(18)
    if "--warm" in argv:
        phase_warm(torch, dev)

    g4 = gagm["G4_M60"]
    paths = {"tta": e2e, "source": src, "cli": cli, "tta_bf16": e2e16, "source_bf16": src16,
             "cli_bf16": cli16, "train_cli": train, "mt_cli": mtc, "mt_cd_cli": mtcd,
             "vgg_train_cli": vgg["source"], "vgg_eval_cli": {"launches": vgg["source"][
                 "eval_launches"]}, "vgg_mt_cli": vgg["mt"], "vgg_cityscapes": vgg["cityscapes"],
             "vgg_clipart": vgg["clipart"], "dp_nccl": dp["nccl"], "dp_gloo": dp["gloo"],
             "mixture_tta": mix, "mixture_tta_bf16": mix16, "formats_cli": fmts}
    by_path = {k: {p: r["launches"][k] for p, r in paths.items()} for k in e2e["launches"]}
    pick = ("ms", "kernel_only_ms", "args_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "shape")

    # each kernel's holds on the command-line paths' own inputs, by path
    held = {"train_cli": train.pop("held"), "mt_cli": mtc.pop("held"),
            "mt_cd_cli": mtcd.pop("held"), "vgg_train_cli": vgg["source"].pop("held"),
            "vgg_mt_cli": vgg["mt"].pop("held"), "vgg_cityscapes": vgg["cityscapes"].pop("held"),
            "vgg_clipart": vgg["clipart"].pop("held"),
            **{f"dp_gloo_{kind}": h for kind, h in dp.pop("held").items()},
            "mixture_tta_bf16": {"pools": mix16.pop("held_pools")},
            "formats_cli": fmts.pop("held")}

    def held_by_path(part):
        return {p: h[part] for p, h in held.items() if part in h}

    def pool_kernel(name, pools, train, tta, on_paths=None):
        box, mask = pools["box"], pools["mask"]
        on_paths = on_paths or {}
        return dict(name=name, route="cuda", source="ttdg_mgm_torch/csrc/roi_pool.cu",
                    replaces="ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py:113",
                    launches=tta["launches"][name], launches_by_path=by_path[name],
                    max_abs_err=max(r["max_abs_err"] for r in (
                        *pools.values(), *train.values(),
                        *(r for calls in on_paths.values() for r in calls.values()))),
                    tolerance=pool_tolerance(name.endswith("bf16")),
                    ms=box["ms"], plain_ms=box["plain_ms"], bound_ms=box["bound_ms"],
                    bound_by=box["bound_by"], library_ms=None, shape=box["shape"],
                    kernel_only_ms=box["kernel_only_ms"], args_ms=box["args_ms"],
                    geometry_ulps=max(r["geometry_ulps"] for r in (*pools.values(),
                                                                  *train.values())),
                    mask_pool={k: mask[k] for k in pick}, train_pools=train,
                    held_on_paths=on_paths,
                    rect_canvas={k: v for k, v in pools.items() if k not in ("box", "mask")})

    def backward_kernel(name, bwd, main_path, source, on_paths=None):
        box, mask = bwd["box"], bwd["mask"]
        on_paths = on_paths or {}
        return dict(name=name, route="cuda", source="ttdg_mgm_torch/csrc/roi_pool_backward.cu",
                    replaces="ttdg_mgm_tpu/ops/pallas/roi_pool_pallas.py:350",
                    launches=source["launches"][name], launches_by_path=by_path[name],
                    max_abs_err=max(r["max_abs_err"] for r in (
                        box, mask, *main_path.values(),
                        *(r for calls in on_paths.values() for r in calls.values()))),
                    tolerance=pool_tolerance(name.endswith("bf16"), backward=True),
                    ms=box["ms"], plain_ms=box["plain_ms"], bound_ms=box["bound_ms"],
                    bound_by=box["bound_by"], library_ms=None, shape=box["shape"],
                    kernel_only_ms=box["kernel_only_ms"], args_ms=box["args_ms"],
                    deterministic=box["deterministic"] and mask["deterministic"],
                    main_path=main_path, held_on_paths=on_paths,
                    mask_pool={k: mask[k] for k in pick})

    sk_held = held_by_path("sinkhorn")
    kernels = [
        pool_kernel("roi_pool", roi, roi_train, e2e, {"mixture_tta": mix.pop("held_pools")}),
        pool_kernel("roi_pool_bf16", roi16, roi_train16, e2e16, held_by_path("pools")),
        dict(name="gagm", route="cuda", source="ttdg_mgm_torch/csrc/gagm.cu",
             replaces="ttdg_mgm_tpu/ops/pallas/gagm_pallas.py:53",
             launches=e2e["launches"]["gagm"], launches_by_path=by_path["gagm"],
             max_abs_err=max(r["max_abs_err"] for r in gagm.values()),
             ms=g4["ms"], plain_ms=g4["plain_ms"], bound_ms=g4["bound_ms"],
             bound_by=g4["bound_by"], library_ms=None, shape=g4["shape"],
             steps=g4["steps"], input_dtypes_bf16_path=e2e16["kernel_b_dtypes"], **gagm_main,
             other_cases={k: {f: v[f] for f in ("ms", "plain_ms", "bound_ms", "steps")}
                          for k, v in gagm.items() if k != "G4_M60"},
             held_on_paths=held_by_path("gagm"),
             mixture_rounds={p: dict(steps=len(r["held"]), anneal_max_abs_err=max(
                 h["anneal_max_abs_err"] for h in r["held"]), chaotic_passes=sum(
                 h["chaotic_passes"] for h in r["held"])) for p, r in (("float32", mix),
                                                                       ("bfloat16", mix16))}),
        backward_kernel("roi_pool_backward", roi_bwd, bwd_main, src),
        backward_kernel("roi_pool_backward_bf16", roi_bwd16, bwd_main16, src16,
                        held_by_path("backward")),
        dict(name="sinkhorn", route="cuda", source="ttdg_mgm_torch/csrc/sinkhorn.cu",
             replaces="ttdg_mgm_tpu/ops/pallas/sinkhorn_pallas.py:31",
             launches=src["launches"]["sinkhorn"], launches_by_path=by_path["sinkhorn"],
             max_abs_err=max(sk["max_abs_err"], *(r["max_abs_err"] for r in sk_held.values())),
             ms=sk["ms"], plain_ms=sk["plain_ms"],
             bound_ms=sk["bound_ms"], bound_by=sk["bound_by"], library_ms=None,
             shape=sk["shape"], chain_floor_ms=sk["chain_floor_ms"],
             transcendentals=sk["transcendentals"], kernel_only_ms=sk["kernel_only_ms"],
             generic_path_ms=sk["generic_path_ms"],
             input_dtypes_bf16_path=src16["kernel_d_dtypes"],
             projections_checked=sk["projections_checked"], hippi_rerun=sk["hippi_rerun"],
             held_on_paths=sk_held),
        dict(name="paste_masks", route="cuda", source="ttdg_mgm_torch/csrc/mask_paste.cu",
             replaces=None, launches=cli["launches"]["paste_masks"],
             launches_by_path=by_path["paste_masks"], max_abs_err=0.0,
             **{k: paste[k] for k in ("ms", "kernel_only_ms", "plain_ms", "bound_ms", "bound_by",
                                      "shape", "window_share", "mismatches")},
             library_ms=None),
        dict(name="vit_attention", route="cuda", source="ttdg_mgm_torch/csrc/vit_attention.cu",
             replaces=None, max_rel_err={k: v["max_rel_err"] for k, v in vit.items()},
             **{k: vit["global"][k] for k in ("ms", "kernel_only_ms", "bwd_ms", "bound_ms",
                                              "bound_by", "bwd_bound_ms", "shape", "library_ms")},
             window={k: vit["window"][k] for k in ("ms", "kernel_only_ms", "bwd_ms", "bound_ms",
                                                   "bwd_bound_ms", "shape", "library_ms")},
             plain_ms=vit["global"]["plain_fwd_bwd_ms"]),
    ]
    e2e_keys = ("step_ms", "steady_ms", "images_per_s", "losses", "infer_ms", "peak_gib")
    src_keys = ("batch", "step_ms", "steady_ms", "images_per_s", "total_loss", "peak_gib")
    for what, keys, runs in (("e2e", e2e_keys, (e2e, e2e16)), ("source", src_keys, (src, src16))):
        line = {p: {k: r[k] for k in keys} for p, r in zip(PRECISIONS, runs)}
        log(f"{what} summary: {json.dumps(line)}")
    log(f"determinism summary: {json.dumps(det)}")
    cli_line = {k: cli[k] for k in ("tta_ms", "tta_loss", "data_s_per_image",
                                    "inference_s_per_image", "eval_s_per_image",
                                    "paste_s_per_image", "eval_total_s",
                                    "main_s", "peak_gib", "metrics", "draw_s_per_image")}
    log(f"cli summary ({card}): {json.dumps(cli_line)}")
    log(f"cli bf16 summary ({card}): {json.dumps(cli16)}")
    log(f"train cli summary ({card}): {json.dumps(train)}")
    log(f"mt cli summary ({card}): {json.dumps(mtc)}")
    log(f"mt cd cli summary ({card}): {json.dumps(mtcd)}")
    log(f"vgg summary ({card}): {json.dumps(vgg)}")
    log(f"dp summary ({card}): {json.dumps(dp)}")
    log(f"mixture summary ({card}): {json.dumps({p: r for p, r in zip(PRECISIONS, (mix, mix16))})}")
    log(f"long tail summary ({card}): {json.dumps(tail)}")
    log(f"formats summary ({card}): {json.dumps(fmts)}")
    log(f"chip_smoke ran in {time.perf_counter() - t_run:.1f} s after the kernel build")
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
