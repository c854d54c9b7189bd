"""Static-shape batching: records -> fixed-size batches.

This package's own copy of ``load_image``, ``prepare_sample``,
``CANVAS_BUCKETS``, ``canvas_bucket``, ``pack_batch``,
``_prepare_with_fallback``, ``build_train_loader``, ``build_test_loader``,
``divide_label_unlabel`` and ``build_two_crop_loader`` of
``ttdg_mgm_tpu/data/loader.py``, giving the same arrays and metas:

* ``image (B, H, W, 3)`` float32 RGB 0-255 on a canvas (a square side, or a
  ``CANVAS_BUCKETS`` pair per batch under ``canvas="auto"``);
* ``image_sizes (B, 2)`` the valid ``(h, w)`` of each image;
* with ``with_gt``, GT padded to ``gt_cap`` slots and masks rasterized on a
  ``(mask_res, mask_res)`` grid over the padded canvas.

:func:`load_image` decodes PNG (:mod:`ttdg_mgm_torch.data.png`), JPEG
(:mod:`ttdg_mgm_torch.data.jpeg`: sequential and progressive Huffman, gray,
colour and CMYK), TIFF (:mod:`ttdg_mgm_torch.data.tiff`) and BMP
(:mod:`ttdg_mgm_torch.data.bmp`) in NumPy, equal to Pillow's
``convert("RGB")``; the resize (:mod:`ttdg_mgm_torch.data.resample`) and the
polygon fill (``utils/polyfill.py``) equal Pillow's and OpenCV's, and so
does the strong augmentation (``data/enhance.py``).  Nothing here imports
Pillow or OpenCV.

Two differences from the JAX package, both where it fails:

* RLE ground truth of a flipped sample is mirrored in :func:`pack_batch`,
  after its resize to the mask grid, within the sample's valid width (the
  JAX package's ``scale_annotations`` raises on RLE before any flip);
* :func:`build_train_loader` and :func:`build_two_crop_loader` raise
  ``ValueError`` when the records are fewer than the batch, where the JAX
  train loader's epoch loop yields nothing and spins forever and its
  two-crop loader yields short batches.

Spans (``utils/profiling.py``), the same in every loader: ``data.sample``
(keyed by the record's ``image_id``) around :func:`prepare_sample`, over
``data.decode``, ``data.resize`` (the resizes and the flip) and
``data.annotations``; ``data.pack`` around :func:`pack_batch`, over
``data.gt_raster`` (the GT boxes and masks); with a prefetch thread,
``data.wait`` where the consumer blocks on it and ``data.blocked`` where the
thread blocks on a full queue.
"""

from __future__ import annotations

import logging
import queue
import threading

import numpy as np

from ttdg_mgm_torch.data.catalog import DatasetCatalog
from ttdg_mgm_torch.data import bmp, jpeg, png, tiff
from ttdg_mgm_torch.data.resample import resize_bilinear
from ttdg_mgm_torch.data.transforms import (build_strong_augmentation, hflip,
                                            resize_shortest_edge, scale_annotations)
from ttdg_mgm_torch.utils.profiling import span
from ttdg_mgm_torch.utils.rle import polygons_to_mask, segmentation_to_mask

logger = logging.getLogger("ttdg_mgm_torch")


#: leading bytes of the image formats the loader does not read, for the error
_OTHER_FORMATS = ((b"GIF8", "GIF"), (b"RIFF", "WebP"), (b"\x00\x00\x00\x0cjP", "JPEG 2000"),
                  (b"\xff\x4f\xff\x51", "JPEG 2000"), (b"II+\x00", "BigTIFF"),
                  (b"MM\x00+", "BigTIFF"))


def load_image(path: str) -> np.ndarray:
    """``(H, W, 3)`` uint8 RGB, as ``PIL.Image.open(path).convert("RGB")``,
    for PNG, JPEG, TIFF and BMP files, told apart by their leading bytes.
    A variant a decoder does not read raises ``ValueError`` naming the file
    and the variant (``UnsupportedJPEG``, ``UnsupportedTIFF``, ...); any
    other format raises ``ValueError`` naming it."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(png.SIGNATURE):
        return png.decode_png(data)
    if data.startswith(jpeg.SIGNATURE):
        return jpeg.decode_jpeg(data, path)
    if data.startswith(tiff.SIGNATURES):
        return tiff.decode_tiff(data, path)
    if data.startswith(bmp.SIGNATURE):
        return bmp.decode_bmp(data, path)
    kind = next((k for sig, k in _OTHER_FORMATS if data.startswith(sig)), "unknown")
    raise ValueError(f"{path}: {kind} image format; the loader reads PNG, JPEG, TIFF and BMP")


class _Prefetcher:
    """Prefetch on a background thread (``depth`` items ahead): image
    decoding and resizing overlap the device step.  An exception in the
    producer is raised again in the consumer.  :meth:`close` drops the
    batches made ahead and lets the thread of an endless generator end
    after the batch it is making, without waiting for it."""

    def __init__(self, gen, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(gen,), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        if self._stop.is_set():
            return False
        try:
            self._q.put_nowait(item)
            return True
        except queue.Full:
            pass
        with span("data.blocked"):
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
        return False

    def _drain(self):
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def _run(self, gen):
        try:
            for item in gen:
                if not self._put(("item", item)) or self._stop.is_set():
                    break
            else:
                self._put(("done", None))
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            self._put(("err", e))
        if self._stop.is_set():
            self._drain()

    def close(self):
        self._stop.set()
        self._drain()

    def __iter__(self):
        return self

    def __next__(self):
        with span("data.wait"):
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
    with span("data.sample", record["image_id"]):
        img = image
        if img is None:
            with span("data.decode"):
                img = load_image(record["file_name"])
        with span("data.resize"):
            img, (sy, sx) = resize_shortest_edge(img, min_size, max_size)
            h, w = img.shape[:2]
            shrunk = canvas is not None and max(h, w) > canvas
            if shrunk:
                s = canvas / max(h, w)
                img, _ = resize_shortest_edge(img, int(round(min(h, w) * s)), canvas)
        with span("data.annotations"):
            anns = [a for a in record["annotations"] if not a.get("iscrowd", 0)]
            boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
            classes = np.asarray([a["category_id"] for a in anns], np.int32)
            polys = [a.get("segmentation") for a in anns]
            boxes, polys = scale_annotations(boxes, polys, sy, sx)
            if shrunk:
                boxes, polys = scale_annotations(boxes, polys, img.shape[0] / h, img.shape[1] / w)
        if flip:
            with span("data.resize"):
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
    with span("data.pack"):
        if isinstance(canvas, int):
            canvas = (canvas, canvas)
        B = len(samples)
        image = np.zeros((B, canvas[0], canvas[1], 3), np.float32)
        sizes = np.zeros((B, 2), np.float32)
        for b, s in enumerate(samples):
            h, w = s["image"].shape[:2]
            image[b, :h, :w] = s["image"]
            sizes[b] = (h, w)
        out = {"image": image, "image_sizes": sizes}
        if with_gt:
            with span("data.gt_raster"):
                out.update(_raster_gt(samples, gt_cap, mask_res, mask_res / canvas[0],
                                      mask_res / canvas[1]))
        return out


def _raster_gt(samples, gt_cap, mask_res, mscale_y, mscale_x) -> dict:
    """The batch's GT arrays: each sample's first ``gt_cap`` boxes, classes
    and masks, the masks on the ``(mask_res, mask_res)`` grid."""
    B = len(samples)
    out = {"gt_boxes": np.zeros((B, gt_cap, 4), np.float32),
           "gt_classes": np.zeros((B, gt_cap), np.int32),
           "gt_valid": np.zeros((B, gt_cap), bool),
           "gt_masks": np.zeros((B, gt_cap, mask_res, mask_res), np.uint8)}
    for b, s in enumerate(samples):
        h, w = s["image"].shape[:2]
        n = min(len(s["boxes"]), gt_cap)
        if not n:
            continue
        out["gt_boxes"][b, :n] = s["boxes"][:n]
        out["gt_classes"][b, :n] = s["classes"][:n]
        out["gt_valid"][b, :n] = True
        for k in range(n):
            segs = s["polygons"][k]
            if not segs:
                continue
            if isinstance(segs, dict):
                full = segmentation_to_mask(segs, s["orig_height"], s["orig_width"])
                m = resize_bilinear(full * 255, (int(round(h * mscale_y)),
                                                 int(round(w * mscale_x)))) > 127
                if s.get("flipped"):
                    m = m[:, ::-1]
                out["gt_masks"][b, k, :m.shape[0], :m.shape[1]] = m
            else:
                scaled = [(np.asarray(p, np.float64).reshape(-1, 2)
                           * (mscale_x, mscale_y)).reshape(-1).tolist() for p in segs]
                out["gt_masks"][b, k] = polygons_to_mask(scaled, mask_res, mask_res)
    return out


def _prepare_with_fallback(records, i, rng, good, **kw):
    """``prepare_sample`` of record ``i``; a record whose image or
    annotation fails to load (``OSError``, ``ValueError``: the decoders
    raise ``ValueError`` on a truncated or corrupt file) is replaced by a
    random known-good record, up to 4 attempts (reference
    ``MapDataset.__getitem__``).  Other errors stay fatal."""
    for attempt in range(4):
        try:
            s = prepare_sample(records[i], **kw)
            good.add(int(i))
            return s
        except (OSError, ValueError) as e:
            logger.warning("failed to load record %s (attempt %d, %s); substituting a fallback "
                           "sample", records[i].get("file_name", i), attempt + 1, e)
            good.discard(int(i))
            pool = list(good) if good else list(range(len(records)))
            i = pool[rng.randint(len(pool))]
    raise RuntimeError("no loadable training records (4 substitutions failed)")


def build_train_loader(dataset_names, *, batch_size: int = 8, canvas: int | str = 800,
                       min_size: int = 800, max_size: int = 1333, gt_cap: int = 20,
                       mask_res: int = 256, seed: int = 0, flip_prob: float = 0.5,
                       prefetch: int = 2, min_size_choices=None):
    """Endless shuffled loader of labelled batches: each epoch a permutation
    of the records of ``dataset_names``, cut into full batches (a partial
    tail is dropped).  Each sample draws its shortest-edge target from
    ``min_size_choices`` (d2's "choice" sampling of ``INPUT.MIN_SIZE_TRAIN``;
    ``min_size`` when None) and is flipped with probability ``flip_prob``.
    Every draw comes from one ``np.random.RandomState(seed)`` in the JAX
    package's order, so the batches equal its own.  An integer ``canvas``
    is the square canvas (an image larger than it is shrunk to fit);
    ``"auto"`` is d2's geometry, each batch padded onto a ``CANVAS_BUCKETS``
    pair.  Raises ``ValueError`` when the records are fewer than
    ``batch_size``."""
    records = []
    for name in dataset_names:
        records.extend(DatasetCatalog.get(name))
    if len(records) < batch_size:
        raise ValueError(f"{len(records)} training records in {list(dataset_names)} are fewer "
                         f"than the batch of {batch_size}: no full batch can be drawn")
    rng = np.random.RandomState(seed)
    good: set = set()
    sizes = [int(s) for s in min_size_choices] if min_size_choices else [int(min_size)]
    auto = canvas == "auto"

    def gen():
        while True:
            idx = rng.permutation(len(records))
            for start in range(0, len(idx) - batch_size + 1, batch_size):
                samples = [
                    _prepare_with_fallback(records, i, rng, good,
                                           canvas=None if auto else canvas,
                                           min_size=sizes[rng.randint(len(sizes))],
                                           max_size=max_size, flip=rng.rand() < flip_prob)
                    for i in idx[start:start + batch_size]]
                if auto:
                    cv: int | tuple[int, int] = (
                        canvas_bucket(max(s["image"].shape[0] for s in samples)),
                        canvas_bucket(max(s["image"].shape[1] for s in samples)))
                else:
                    cv = canvas
                yield pack_batch(samples, canvas=cv, gt_cap=gt_cap, mask_res=mask_res)

    return _maybe_prefetch(gen(), prefetch)


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


def divide_label_unlabel(records, sup_percent: float, seed: int = 0,
                         seed_indices: dict | None = None):
    """Split one record list into labelled and unlabelled records
    (reference ``divide_label_unlabel``; ``DATALOADER.SUP_PERCENT`` and
    ``RANDOM_DATA_SEED``): ``int(sup_percent / 100 * n)`` labelled, picked
    by ``seed_indices[str(sup_percent)][str(seed)]`` when given, else by a
    permutation of ``np.random.RandomState(seed)``.  Both lists keep the
    records' order."""
    n = len(records)
    num_label = int(sup_percent / 100.0 * n)
    if seed_indices is not None:
        labeled_idx = set(seed_indices[str(sup_percent)][str(seed)])
        if len(labeled_idx) != num_label:
            raise ValueError(f"{len(labeled_idx)} labelled indices for {sup_percent} % of "
                             f"{n} records, expected {num_label}")
    else:
        labeled_idx = set(np.random.RandomState(seed).permutation(n)[:num_label].tolist())
    label = [r for i, r in enumerate(records) if i in labeled_idx]
    unlabel = [r for i, r in enumerate(records) if i not in labeled_idx]
    return label, unlabel


def build_two_crop_loader(label_names, unlabel_names, *, batch_size: int = 4,
                          canvas: int | str = 800, min_size: int = 800, max_size: int = 1333,
                          gt_cap: int = 20, mask_res: int = 256, seed: int = 0,
                          prefetch: int = 2, sup_percent: float | None = None,
                          split_seed: int = 0):
    """Endless loader of the mean-teacher step's batches (reference
    ``DatasetMapperTwoCropSeparate``): each batch draws ``batch_size``
    labelled and ``batch_size`` unlabelled records (a permutation's head of
    each, from ``np.random.RandomState(seed)``), flips each with probability
    0.5 and makes its weak view (resize and flip) and its strong view (the
    weak view through ``build_strong_augmentation(seed)``), so the two views
    share their geometry.  Yields ``{"label_strong", "label_weak",
    "label_sizes", "gt_boxes", "gt_classes", "gt_masks", "gt_valid",
    "unlabel_strong", "unlabel_weak", "unlabel_sizes"}``, the ground truth
    that of the labelled views.  Under ``canvas="auto"`` the four views of
    a batch share one ``CANVAS_BUCKETS`` pair.

    With ``sup_percent`` and no unlabelled records, the labelled records
    are split by :func:`divide_label_unlabel` with ``split_seed``.  Raises
    ``ValueError`` when either record list is shorter than
    ``batch_size``."""
    label_records = [r for n in label_names for r in DatasetCatalog.get(n)]
    unlabel_records = [r for n in unlabel_names for r in DatasetCatalog.get(n)]
    if sup_percent is not None and not unlabel_records:
        label_records, unlabel_records = divide_label_unlabel(label_records, sup_percent,
                                                              split_seed)
    for what, recs, names in (("labelled", label_records, label_names),
                              ("unlabelled", unlabel_records, unlabel_names)):
        if len(recs) < batch_size:
            raise ValueError(f"{len(recs)} {what} records in {list(names)} are fewer than the "
                             f"batch of {batch_size}: no full batch can be drawn")
    rng = np.random.RandomState(seed)
    strong_aug = build_strong_augmentation(seed)
    auto = canvas == "auto"

    def two_views(record):
        weak = prepare_sample(record, canvas=None if auto else canvas, min_size=min_size,
                              max_size=max_size, flip=rng.rand() < 0.5)
        return weak, dict(weak, image=strong_aug(weak["image"]))

    def gen():
        while True:
            li = rng.permutation(len(label_records))[:batch_size]
            ui = rng.permutation(len(unlabel_records))[:batch_size]
            lw, ls = zip(*(two_views(label_records[i]) for i in li))
            uw, us = zip(*(two_views(unlabel_records[i]) for i in ui))
            if auto:
                views = lw + uw
                cv: int | tuple[int, int] = (
                    canvas_bucket(max(s["image"].shape[0] for s in views)),
                    canvas_bucket(max(s["image"].shape[1] for s in views)))
            else:
                cv = canvas
            lw_b = pack_batch(list(lw), canvas=cv, with_gt=False)
            ls_b = pack_batch(list(ls), canvas=cv, gt_cap=gt_cap, mask_res=mask_res)
            uw_b = pack_batch(list(uw), canvas=cv, with_gt=False)
            us_b = pack_batch(list(us), canvas=cv, with_gt=False)
            yield {"label_strong": ls_b["image"], "label_weak": lw_b["image"],
                   "label_sizes": ls_b["image_sizes"], "gt_boxes": ls_b["gt_boxes"],
                   "gt_classes": ls_b["gt_classes"], "gt_masks": ls_b["gt_masks"],
                   "gt_valid": ls_b["gt_valid"], "unlabel_strong": us_b["image"],
                   "unlabel_weak": uw_b["image"], "unlabel_sizes": us_b["image_sizes"]}

    return _maybe_prefetch(gen(), prefetch)
