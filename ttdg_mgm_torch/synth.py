"""Seeded synthetic inputs for smoke runs and tests.

* :func:`synth_batch`: the bright-disc batch of the JAX package's
  benchmark (``bench.py:synth_batch``), the same pixels for the same seed,
  with its GT boxes, classes and masks padded to ``MAX_GT_PER_IMAGE`` when
  asked for;
* :func:`planted_matching_problem`: a well-separated multi-graph matching
  problem (a planted per-graph assignment plus noise), the kind of input on
  which the GA-GM solver's discrete result is unambiguous.

Both return NumPy arrays, so the two frameworks can be fed the same data.
"""

from __future__ import annotations

import numpy as np

#: GT slots per image of a training batch (``ttdg_mgm_tpu/config.py``
#: ``TPU.MAX_GT_PER_IMAGE``)
MAX_GT_PER_IMAGE = 32


def synth_batch(size: int, B: int, seed: int = 0, *, with_gt: bool = False,
                mask_res: int = 128) -> dict:
    """``{"image": (B, size, size, 3) float32 RGB 0-255, "image_sizes": (B,
    2)}``: dark noise with two bright discs per image.  With ``with_gt``
    also the discs as GT, padded to ``G = MAX_GT_PER_IMAGE`` slots:
    ``gt_boxes (B, G, 4)`` float32, ``gt_classes (B, G)`` int64 (disc k is
    class k), ``gt_valid (B, G)`` bool and ``gt_masks (B, G, mask_res,
    mask_res)`` uint8 on a canvas over the whole image."""
    max_gt = MAX_GT_PER_IMAGE
    rng = np.random.RandomState(seed)
    imgs = rng.randint(20, 45, (B, size, size, 3)).astype(np.float32)
    boxes = np.zeros((B, max_gt, 4), np.float32)
    classes = np.zeros((B, max_gt), np.int64)
    valid = np.zeros((B, max_gt), bool)
    masks = np.zeros((B, max_gt, mask_res, mask_res), np.uint8)
    yy, xx = np.mgrid[:size, :size]
    ym, xm = np.mgrid[:mask_res, :mask_res]
    sc = mask_res / size
    for b in range(B):
        for k in range(2):
            r = rng.randint(size // 10, size // 5)
            cx = rng.randint(r + 2, size - r - 2)
            cy = rng.randint(r + 2, size - r - 2)
            disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            imgs[b][disc] = [210 - 40 * k, 170, 150 + 30 * k]
            boxes[b, k] = (cx - r, cy - r, cx + r, cy + r)
            classes[b, k] = k
            valid[b, k] = True
            masks[b, k] = (ym - cy * sc) ** 2 + (xm - cx * sc) ** 2 <= (r * sc) ** 2
    out = {"image": imgs, "image_sizes": np.full((B, 2), float(size), np.float32)}
    if with_gt:
        out.update(gt_boxes=boxes, gt_classes=classes, gt_valid=valid, gt_masks=masks)
    return out


def planted_matching_problem(G: int, n: int, univ: int, ms, seed: int, a_scale: float = 0.05):
    """GA-GM inputs with a planted answer.  Node ``i`` of graph ``g`` maps to
    slot ``perm_g[i]`` for its first ``min(n, univ, ms[g])`` nodes; the
    pairwise ``W`` is built from those maps plus noise, ``A`` is a weak
    block-diagonal adjacency and ``U0`` a noisy seed.  Rows past ``ms[g]``
    are zero.  Returns ``(A (T, T), W (T, T), U0 (T, univ), ms (G,) int32,
    Ugt (G, n, univ))`` with ``T = G * n``."""
    rng = np.random.RandomState(seed)
    Ugt = np.zeros((G, n, univ), np.float32)
    for g in range(G):
        perm = rng.permutation(univ)
        for i in range(min(n, univ, ms[g])):
            Ugt[g, i, perm[i]] = 1.0
    valid = np.arange(n)[None, :] < np.asarray(ms)[:, None]
    T = G * n
    W = np.zeros((T, T), np.float32)
    A = np.zeros((T, T), np.float32)
    for i in range(G):
        for j in range(G):
            blk = Ugt[i] @ Ugt[j].T + 0.05 * rng.rand(n, n)
            W[i * n:(i + 1) * n, j * n:(j + 1) * n] = blk * (valid[i][:, None] & valid[j][None])
        a = a_scale * rng.rand(n, n)
        A[i * n:(i + 1) * n, i * n:(i + 1) * n] = a * (valid[i][:, None] & valid[i][None])
    U0 = (Ugt + 0.3 * rng.rand(G, n, univ)) * valid[..., None]
    return A, W, U0.reshape(T, univ).astype(np.float32), np.asarray(ms, np.int32), Ugt
