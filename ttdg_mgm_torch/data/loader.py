"""Static-shape batching of the test path: records -> fixed-size batches.

This package's own copy of ``load_image``, ``prepare_sample``,
``CANVAS_BUCKETS``, ``canvas_bucket``, ``pack_batch`` and
``build_test_loader`` of ``ttdg_mgm_tpu/data/loader.py``, giving the same
arrays and metas:

* ``image (B, H, W, 3)`` float32 RGB 0-255 on a canvas (a square side, or a
  ``CANVAS_BUCKETS`` pair per batch under ``canvas="auto"``);
* ``image_sizes (B, 2)`` the valid ``(h, w)`` of each image;
* with ``with_gt``, GT padded to ``gt_cap`` slots and masks rasterized on a
  ``(mask_res, mask_res)`` grid over the padded canvas.

:func:`load_image` decodes PNG with :mod:`ttdg_mgm_torch.data.png` (no
Pillow); other formats, and PNG variants that decoder does not read, go
through Pillow, imported at that point.  The train and two-crop loaders are
not ported yet.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

from ttdg_mgm_torch.data.catalog import DatasetCatalog
from ttdg_mgm_torch.data.png import SIGNATURE, UnsupportedPNG, decode_png
from ttdg_mgm_torch.data.transforms import hflip, resize_shortest_edge, scale_annotations
from ttdg_mgm_torch.utils.rle import polygons_to_mask, segmentation_to_mask


def load_image(path: str) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB, as ``PIL.Image.open(path).convert("RGB")``."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(SIGNATURE):
        try:
            return decode_png(data)
        except UnsupportedPNG:
            pass
    import io

    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


class _Prefetcher:
    """Prefetch on a background thread (``depth`` items ahead): image
    decoding and resizing overlap the device step.  An exception in the
    producer is raised again in the consumer."""

    def __init__(self, gen, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._thread = threading.Thread(target=self._run, args=(gen,), daemon=True)
        self._thread.start()

    def _run(self, gen):
        try:
            for item in gen:
                self._q.put(("item", item))
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            self._q.put(("err", e))
        else:
            self._q.put(("done", None))

    def __iter__(self):
        return self

    def __next__(self):
        kind, val = self._q.get()
        if kind == "item":
            return val
        if kind == "err":
            raise val
        raise StopIteration


def _maybe_prefetch(gen, depth: int):
    return _Prefetcher(gen, depth) if depth > 0 else gen


def prepare_sample(record: dict, *, canvas: int | None = 800, min_size: int = 800,
                   max_size: int = 1333, flip: bool = False,
                   image: np.ndarray | None = None) -> dict:
    """Load and resize (and flip) one record; annotations follow the geometry.

    ``canvas=None`` is d2's ``ResizeShortestEdge(min_size, max_size)`` and
    nothing more (the test path then pads onto a per-batch bucket); an
    integer ``canvas`` also shrinks an image whose long side exceeds it (the
    square canvas)."""
    img = image if image is not None else load_image(record["file_name"])
    anns = [a for a in record["annotations"] if not a.get("iscrowd", 0)]
    boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
    classes = np.asarray([a["category_id"] for a in anns], np.int32)
    polys = [a.get("segmentation") for a in anns]

    img, (sy, sx) = resize_shortest_edge(img, min_size, max_size)
    boxes, polys = scale_annotations(boxes, polys, sy, sx)
    h, w = img.shape[:2]
    if canvas is not None and max(h, w) > canvas:
        s = canvas / max(h, w)
        img, _ = resize_shortest_edge(img, int(round(min(h, w) * s)), canvas)
        boxes, polys = scale_annotations(boxes, polys, img.shape[0] / h, img.shape[1] / w)
    if flip:
        img, boxes, polys = hflip(img, boxes, polys)
    return {
        "image": img,
        "boxes": boxes,
        "classes": classes,
        "polygons": polys,
        "segmentations": [a.get("segmentation") for a in record["annotations"]],
        "image_id": record["image_id"],
        "orig_height": record["height"],
        "orig_width": record["width"],
        "scale": (img.shape[0] / record["height"], img.shape[1] / record["width"]),
        "flipped": flip,
    }


#: per-dimension canvas buckets of the test geometry: 832 covers the
#: uncapped shortest edge (800), 1344 the max_size cap (1333), 128-px steps
#: between; the small buckets (steps of 32) serve small test models, where a
#: batch-1 bucket equals d2's size_divisibility=32 canvas
CANVAS_BUCKETS = (64, 96, 128, 160, 192, 256, 384, 512, 640,
                  832, 960, 1088, 1216, 1344)


def canvas_bucket(x: int) -> int:
    for b in CANVAS_BUCKETS:
        if x <= b:
            return b
    return -(-x // 128) * 128


def pack_batch(samples: list[dict], *, canvas: int | tuple[int, int] = 800,
               gt_cap: int = 20, mask_res: int = 256, with_gt: bool = True) -> dict:
    """Stack prepared samples into one fixed-shape batch dict.  ``canvas``
    is a square side or ``(height, width)``; GT masks rasterize on a square
    ``(mask_res, mask_res)`` grid over the padded canvas with per-axis
    scales."""
    if isinstance(canvas, int):
        canvas = (canvas, canvas)
    B = len(samples)
    image = np.zeros((B, canvas[0], canvas[1], 3), np.float32)
    sizes = np.zeros((B, 2), np.float32)
    out = {"image": image, "image_sizes": sizes}
    if with_gt:
        gt_boxes = np.zeros((B, gt_cap, 4), np.float32)
        gt_classes = np.zeros((B, gt_cap), np.int32)
        gt_valid = np.zeros((B, gt_cap), bool)
        gt_masks = np.zeros((B, gt_cap, mask_res, mask_res), np.uint8)
        out.update(gt_boxes=gt_boxes, gt_classes=gt_classes, gt_valid=gt_valid,
                   gt_masks=gt_masks)

    mscale_y = mask_res / canvas[0]
    mscale_x = mask_res / canvas[1]
    for b, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        image[b, :h, :w] = s["image"]
        sizes[b] = (h, w)
        if not with_gt:
            continue
        n = min(len(s["boxes"]), gt_cap)
        if n:
            gt_boxes[b, :n] = s["boxes"][:n]
            gt_classes[b, :n] = s["classes"][:n]
            gt_valid[b, :n] = True
            for k in range(n):
                segs = s["polygons"][k]
                if not segs:
                    continue
                if isinstance(segs, dict):
                    from PIL import Image

                    full = segmentation_to_mask(segs, s["orig_height"], s["orig_width"])
                    m = np.asarray(Image.fromarray(full * 255).resize(
                        (int(round(w * mscale_x)), int(round(h * mscale_y))),
                        Image.BILINEAR)) > 127
                    gt_masks[b, k, :m.shape[0], :m.shape[1]] = m
                else:
                    scaled = [(np.asarray(p, np.float64).reshape(-1, 2)
                               * (mscale_x, mscale_y)).reshape(-1).tolist() for p in segs]
                    gt_masks[b, k] = polygons_to_mask(scaled, mask_res, mask_res)
    return out


def build_test_loader(dataset_name: str, *, batch_size: int = 1, canvas: int | str = "auto",
                      min_size: int = 800, max_size: int = 1333, prefetch: int = 2):
    """Sequential test loader yielding ``(batch, metas)``: ``batch_size`` is
    ``TEST.BATCH`` while adapting, else 1.  The last partial batch repeats
    its final sample to keep shapes static; each meta carries the true count
    as ``n_real``.  ``canvas="auto"`` is d2's test geometry: no shrink to
    fit, each batch padded onto a ``CANVAS_BUCKETS`` pair; an integer keeps
    the square fit."""
    records = DatasetCatalog.get(dataset_name)
    auto = canvas == "auto"

    def gen():
        for start in range(0, len(records), batch_size):
            chunk = records[start:start + batch_size]
            n_real = len(chunk)
            while len(chunk) < batch_size:
                chunk = chunk + [chunk[-1]]
            samples = [prepare_sample(r, canvas=None if auto else canvas, min_size=min_size,
                                      max_size=max_size) for r in chunk]
            if auto:
                cv: int | tuple[int, int] = (
                    canvas_bucket(max(s["image"].shape[0] for s in samples)),
                    canvas_bucket(max(s["image"].shape[1] for s in samples)))
            else:
                cv = canvas
            batch = pack_batch(samples, canvas=cv, with_gt=False)
            metas = [dict(s, n_real=n_real) for s in samples]
            yield batch, metas

    return _maybe_prefetch(gen(), prefetch)
