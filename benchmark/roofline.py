"""The yardstick's arithmetic: the H100's published peaks, the least time of
a piece of work, the bytes and operations of the port's kernels computed
from their inputs' shapes, and the FLOPs of a pass split by the dtype they
run in.

``bound``, ``roi_pool_work``, ``roi_backward_work``, ``gagm_flops`` and
``sinkhorn_work`` are frozen copies of ``chip_smoke.py``'s; the ROI
geometry they read is the reference's copy (``reference/ops/roi_align.py``).
"""

from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: NVIDIA's data sheet, H100 SXM, dense, at the 700 W limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
#: the SM clock under load and the special-function units' rate (16 per SM)
SM_CLOCK_HZ = 1.98e9
PEAK_SFU_PER_S = 16 * 132 * SM_CLOCK_HZ
#: a warp shuffle's latency in cycles, as measured on the card
SHUFFLE_CYCLES = 32.3


def bound(bytes_: float, flops: float, sfu_ops: float = 0.0):
    """The least time for ``bytes_`` of device memory, ``flops`` float32
    operations and ``sfu_ops`` transcendentals: ``(ms, "bytes" or
    "operations")``."""
    t_bytes = bytes_ / PEAK_BYTES_PER_S * 1e3
    t_ops = max(flops / PEAK_F32_FLOP_PER_S, sfu_ops / PEAK_SFU_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roi_pool_work(feats_shapes, C: int, rois: torch.Tensor, P: int, elem: int = 4):
    """Bytes and float operations an ROI pool needs on these inputs: each
    feature row (one pixel's ``C`` values of ``elem`` bytes) that some valid
    bilinear corner reads, read once; the output written once; 10 operations
    per valid sample and channel.  ``feats_shapes`` are the levels'
    ``(B, H, W)``."""
    from reference.ops.roi_align import roi_geometry

    B, K = rois.shape[:2]
    shapes = [(h, w) for _, h, w in feats_shapes]
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


def roi_backward_work(feats_shapes, C: int, rois: torch.Tensor, P: int, elem: int = 4):
    """Bytes and float operations the pool's backward needs on these inputs:
    the cotangent (``elem`` bytes per value) and the ROIs read once, every
    level gradient written once; 10 operations per valid sample and
    channel."""
    _, flops = roi_pool_work(feats_shapes, C, rois, P, elem)
    B, K = rois.shape[:2]
    g_bytes = B * K * P * P * C * elem
    grad_bytes = sum(b * h * w for b, h, w in feats_shapes) * C * elem
    return g_bytes + grad_bytes + rois.numel() * 4, flops


def gagm_flops(G: int, M: int, univ: int, steps: int) -> float:
    """Float operations ``steps`` power steps need on a block-diagonal ``A``:
    per pair of graphs ``U_g U_j^T``, the two products with ``A``'s blocks
    and the product with ``U_j``; then ``W U``."""
    T = G * M
    return steps * (G * G * (4.0 * M ** 3 + 4.0 * M * M * univ) + 2.0 * T * T * univ)


def sinkhorn_work(s, nr, nc, max_iter: int):
    """What kernel D needs for one batch: bytes, float32 operations,
    transcendentals and the floor of its dependent chain (ms)."""
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


class DtypeFlops(TorchDispatchMode):
    """Counts the FLOPs of every operation that ``torch.utils.flop_counter``
    knows (convolutions, matrix products and their backward passes), by the
    dtype of the operation's first input."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self.registry = flop_registry
        self.flops = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self.registry:
            first = next((a for a in args if isinstance(a, torch.Tensor)), None)
            dtype = str(first.dtype).replace("torch.", "") if first is not None else "float32"
            self.flops[dtype] += float(self.registry[packet](*args, **kwargs, out_val=out))
        return out


def least_seconds(flops_by_dtype: dict) -> float:
    """The least time of FLOPs by dtype: bf16 and fp16 on the tensor cores at
    989 TFLOP/s, the rest at the float32 rate (TF32 is off)."""
    t = 0.0
    for dtype, f in flops_by_dtype.items():
        rate = PEAK_BF16_FLOP_PER_S if dtype in ("bfloat16", "float16") else PEAK_F32_FLOP_PER_S
        t += f / rate
    return t
