"""Visualization dumps: boxes and labels over the image, and mask images.

Counterpart of ``ttdg_mgm_tpu/utils/visualize.py`` (the reference's
``TEST.DRAW`` dumps under ``OUTPUT_DIR/visual`` and ``OUTPUT_DIR/masks``),
with the same arguments, colours, channel order and drawing order, on the
port's own rasterizers (``utils/draw.py``) and PNG writer
(``data/png.py:encode_png``), with no OpenCV.  The boxes are OpenCV's pixel
for pixel; the label text is the port's bitmap font, one colour, in the
band ``utils/draw.py:label_box`` gives (OpenCV 5 draws it anti-aliased).
"""

from __future__ import annotations

import os

import numpy as np

from ttdg_mgm_torch.data.png import encode_png
from ttdg_mgm_torch.utils.draw import put_label, rectangle

_COLORS = [(66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
           (171, 71, 188), (0, 172, 193)]


def label_text(label: str, score: float) -> str:
    return f"{label} {score:.2f}"


def label_origin(box) -> tuple:
    """Where a box's label starts (its bottom-left corner): 4 pixels above
    the box, at row 10 or below."""
    x1, y1 = (int(round(v)) for v in np.asarray(box)[:2])
    return x1, max(y1 - 4, 10)


def draw_detections(image: np.ndarray, boxes, scores=None, classes=None,
                    class_names=None, score_floor: float = 0.0) -> np.ndarray:
    """``image (H, W, 3)`` uint8 RGB with each box at or above
    ``score_floor`` outlined (thickness 2) and labelled ``"<name> <score>"``
    in the colour of its class.  The colours are blue-green-red triples,
    drawn on the blue-green-red copy of the image, as OpenCV draws them."""
    out = np.ascontiguousarray(image[..., ::-1].copy())  # RGB -> BGR
    for i, box in enumerate(np.asarray(boxes).reshape(-1, 4)):
        s = float(scores[i]) if scores is not None else 1.0
        if s < score_floor:
            continue
        c = int(classes[i]) if classes is not None else 0
        color = _COLORS[c % len(_COLORS)]
        x1, y1, x2, y2 = (int(round(v)) for v in box)
        rectangle(out, (x1, y1), (x2, y2), color, 2)
        label = class_names[c] if class_names else str(c)
        put_label(out, label_text(label, s), label_origin(box), color)
    return out[..., ::-1]


def overlay_masks(image: np.ndarray, masks, classes=None, alpha: float = 0.45) -> np.ndarray:
    """Masks blended over ``image`` at ``alpha`` in their class colours
    (the triple reversed, as the JAX package reverses it)."""
    out = image.astype(np.float32).copy()
    for i, m in enumerate(masks):
        c = int(classes[i]) if classes is not None else i
        color = np.asarray(_COLORS[c % len(_COLORS)], np.float32)[::-1]
        mm = np.asarray(m, bool)
        out[mm] = out[mm] * (1 - alpha) + color * alpha
    return out.astype(np.uint8)


def mask_image(image: np.ndarray, masks) -> np.ndarray:
    """White masks on a black canvas the size of the image (the reference's
    per-image mask dump, one file per evaluated image even with no
    detection)."""
    out = np.zeros_like(np.asarray(image), dtype=np.uint8)
    for m in masks:
        out[np.asarray(m, bool)] = 255
    return out


def dump_visualization(output_dir: str, image_id, image, detections, class_names=None):
    """Write ``<output_dir>/visual/<image_id>.png`` (the boxes over the
    image) and ``<output_dir>/masks/<image_id>.png`` (:func:`mask_image`),
    creating the directories.  ``detections`` holds ``boxes``, ``scores``,
    ``classes`` and, optionally, ``masks``."""
    vis_dir = os.path.join(output_dir, "visual")
    mask_dir = os.path.join(output_dir, "masks")
    os.makedirs(vis_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    boxed = draw_detections(image, detections["boxes"], detections["scores"],
                            detections["classes"], class_names)
    with open(os.path.join(vis_dir, f"{image_id}.png"), "wb") as f:
        f.write(encode_png(np.ascontiguousarray(boxed)))
    masked = mask_image(image, detections.get("masks", []))
    with open(os.path.join(mask_dir, f"{image_id}.png"), "wb") as f:
        f.write(encode_png(masked))
