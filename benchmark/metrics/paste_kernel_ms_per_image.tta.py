"""Device milliseconds per evaluated image in the mask-paste kernel
(``ops/mask_paste.py`` -> ``csrc/mask_paste.cu``): the summed device time of
the trace's launches named ``paste_masks_kernel``, over the images of the
window.  None where the program has no such kernel."""

UNIT = "ms"
MOVES = "tta_images_per_s"


def read(record):
    launches = [k for k in record["kernels"] if "paste_masks_kernel" in k[0]]
    n = record["counts"].get("images")
    if not launches or not n:
        return None
    return 1e3 * sum(e - s for _, s, e in launches) / n
