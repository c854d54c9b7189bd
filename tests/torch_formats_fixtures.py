"""Writes ``tests/fixtures/torch_formats/``: the files phase 16 of
``chip_smoke.py`` reads besides the TIFF frames it writes itself, and the
digests of Pillow's decode of every file that phase decodes.

    python3 tests/torch_formats_fixtures.py

* ``k0.jpg``, ``k1.jpg``: progressive JPEGs (Pillow, quality 85, 4:2:0) of
  720 x 576, a Kvasir-SEG frame size, of ``chip_smoke.polyp_frame_int``
  frames, and ``annotations.json``, their polygon ground truth (one polyp
  each) in the reference's COCO layout;
* ``cmyk.jpg`` (Pillow's CMYK JPEG, Adobe marker, inverted samples) and
  ``h4v1.jpg`` (OpenCV's 4:1:1 JPEG) of the first frame, decoded only for
  their time and digest;
* ``digests.json``: for each of these and for the LZW TIFF frames that
  ``chip_smoke.write_formats_data`` writes, ``chip_smoke.image_digest`` of
  ``PIL.Image.open(path).convert("RGB")``.

The card's machine has no Pillow: the digests let it check that the port's
decoders give Pillow's bits there.  ``tests/test_torch_formats.py``
recomputes every digest with Pillow and with the port.
"""

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import chip_smoke  # noqa: E402

OUT = os.path.join(HERE, "fixtures", "torch_formats")
KVASIR_HW = (576, 720)
KVASIR_SEED = 100


def kvasir_frames():
    """The two Kvasir-size frames and their polyps ``(cy, cx, ry, rx)``."""
    return [chip_smoke.polyp_frame_int(KVASIR_HW, KVASIR_SEED + i) for i in range(2)]


def pillow_digest(path: str) -> str:
    from PIL import Image

    with Image.open(path) as im:
        return chip_smoke.image_digest(np.asarray(im.convert("RGB")))


def main() -> None:
    import cv2
    from PIL import Image

    os.makedirs(OUT, exist_ok=True)
    images, anns = [], []
    t = np.linspace(0.0, 2 * np.pi, 64, endpoint=False)
    frames = kvasir_frames()
    for i, (img, (cy, cx, ry, rx)) in enumerate(frames):
        name = f"k{i}.jpg"
        Image.fromarray(img).save(os.path.join(OUT, name), quality=85, progressive=True)
        ring = np.stack([cx + rx * np.cos(t), cy + ry * np.sin(t)], 1)
        im, ann = chip_smoke._polyp_record(i, name, KVASIR_HW, ring, int(np.pi * rx * ry))
        images.append(im)
        anns.append(ann)
    with open(os.path.join(OUT, "annotations.json"), "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": 1, "name": "polyp"}]}, f)
    Image.fromarray(frames[0][0]).convert("CMYK").save(os.path.join(OUT, "cmyk.jpg"),
                                                       quality=85)
    ok, enc = cv2.imencode(".jpg", frames[0][0][..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    if not ok:
        raise RuntimeError("OpenCV did not encode the 4:1:1 JPEG")
    with open(os.path.join(OUT, "h4v1.jpg"), "wb") as f:
        f.write(enc.tobytes())
    digests = {k: pillow_digest(os.path.join(OUT, k))
               for k in ("k0.jpg", "k1.jpg") + chip_smoke.FORMATS_TIMED}
    with tempfile.TemporaryDirectory() as tmp:
        for key, path in chip_smoke.write_formats_data(tmp).items():
            digests[key] = pillow_digest(path)
    with open(os.path.join(OUT, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
