"""Mask pasting: per-detection ``M x M`` mask probabilities -> binary masks
over the whole image, on the tensors' device.

Semantics of ``ttdg_mgm_tpu/ops/mask_paste.py:paste_masks_np`` (d2
``_do_paste_mask``): image pixel ``(y + 0.5)`` maps to mask coordinate
``(y + 0.5 - y1) / box_h * M - 0.5``, sampled bilinearly with zeros outside
the ``M x M`` grid, then ``>= threshold``; only the window ``[floor(y1),
ceil(y2) + 1) x [floor(x1), ceil(x2) + 1)`` (clamped to the image) is
written.

* :func:`paste_masks`: the mask-paste kernel ``csrc/mask_paste.cu`` on CUDA
  tensors (all boxes of an image in one launch, the boxes read on the
  device, no host synchronisation; bit for bit ``paste_masks_np``), the
  plain version on CPU tensors.  No TPU kernel computes this: the JAX
  package pastes with a jitted ``vmap`` or its NumPy twin.
* :func:`paste_masks_plain`: plain PyTorch, one loop turn per box on the
  host.  Bilinear sampling with zero padding is separable, so a box's
  window is ``Wy @ mask @ Wx^T`` with ``Wy (h, M)`` and ``Wx (w, M)``
  holding each pixel's two interpolation weights, in float64; the matmul's
  summation order differs from NumPy's, so a pixel whose value lies within
  about 1e-6 of the threshold may differ from ``paste_masks_np``.
"""

from __future__ import annotations

import math

import torch

from ttdg_mgm_torch.ops import _cuda


def _axis_weights(coords: torch.Tensor, M: int) -> torch.Tensor:
    """``(n, M)`` bilinear weights of the sample positions ``coords`` on an
    axis of ``M`` cells, zero outside it."""
    c0 = torch.floor(coords)
    frac = coords - c0
    rows = torch.arange(coords.shape[0], device=coords.device)
    w = torch.zeros((coords.shape[0], M), dtype=coords.dtype, device=coords.device)
    for idx, wt in ((c0, 1.0 - frac), (c0 + 1.0, frac)):
        ok = (idx >= 0) & (idx < M)
        w.index_put_((rows[ok], idx[ok].long()), wt[ok], accumulate=True)
    return w


def paste_masks_plain(masks: torch.Tensor, boxes: torch.Tensor, height: int, width: int,
                      threshold: float = 0.5) -> torch.Tensor:
    """masks ``(K, M, M)`` probabilities, boxes ``(K, 4)`` xyxy in image
    pixels -> ``(K, height, width)`` uint8 on the masks' device."""
    K, M = masks.shape[0], masks.shape[-1]
    dev = masks.device
    out = torch.zeros((K, height, width), dtype=torch.uint8, device=dev)
    probs = masks.to(torch.float64)
    boxes = boxes.detach().to("cpu", torch.float32)
    # box sides in the boxes' own precision, as the NumPy version takes them
    sides = (boxes[:, 2:] - boxes[:, :2]).tolist()
    for k, (x1, y1, x2, y2) in enumerate(boxes.tolist()):
        y0i, y1i = max(math.floor(y1), 0), min(math.ceil(y2) + 1, height)
        x0i, x1i = max(math.floor(x1), 0), min(math.ceil(x2) + 1, width)
        if y1i <= y0i or x1i <= x0i:
            continue
        w, h = max(sides[k][0], 1e-6), max(sides[k][1], 1e-6)
        ys = (torch.arange(y0i, y1i, dtype=torch.float64, device=dev) + 0.5 - y1) / h * M - 0.5
        xs = (torch.arange(x0i, x1i, dtype=torch.float64, device=dev) + 0.5 - x1) / w * M - 0.5
        v = _axis_weights(ys, M) @ probs[k] @ _axis_weights(xs, M).T
        out[k, y0i:y1i, x0i:x1i] = (v >= threshold).to(torch.uint8)
    return out


def paste_masks(masks: torch.Tensor, boxes: torch.Tensor, height: int, width: int,
                threshold: float = 0.5) -> torch.Tensor:
    """masks ``(K, M, M)`` probabilities, boxes ``(K, 4)`` xyxy in image
    pixels -> ``(K, height, width)`` uint8 on the masks' device: the kernel
    on CUDA tensors, :func:`paste_masks_plain` on CPU tensors.  The kernel
    reads the masks in float32 (exact for float32, bfloat16 and float16
    probabilities) and the boxes in float32, on the masks' device."""
    if masks.device.type == "cpu":
        return paste_masks_plain(masks, boxes, height, width, threshold)
    dev = masks.device
    if dev.type != "cuda":
        raise ValueError(f"paste_masks runs on CPU or CUDA tensors, got {dev}")
    if masks.dim() != 3 or masks.shape[1] != masks.shape[2]:
        raise ValueError(f"paste_masks takes masks (K, M, M), got {tuple(masks.shape)}")
    K, M = masks.shape[0], masks.shape[-1]
    if tuple(boxes.shape) != (K, 4):
        raise ValueError(f"paste_masks takes boxes ({K}, 4), got {tuple(boxes.shape)}")
    out = torch.empty((K, height, width), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    m = masks.detach().to(torch.float32).contiguous()
    b = boxes.detach().to(dev, torch.float32).contiguous()
    err = _cuda.lib().ttdg_paste_masks(m.data_ptr(), b.data_ptr(), K, M, int(height), int(width),
                                       float(threshold), out.data_ptr(), _cuda.stream_ptr(dev))
    _cuda.check(err, "paste_masks kernel")
    paste_masks.launches += 1
    return out


#: kernel launches since the count was last reset (plain CPU calls not counted)
paste_masks.launches = 0
