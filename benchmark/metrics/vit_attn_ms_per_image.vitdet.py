"""Device milliseconds per adapted and evaluated image in kernel F
(``ops/vit_attention.py`` -> ``csrc/vit_attention.cu``, forward and
backward): the summed device time of the trace's launches named
``vit_attn_*_kernel``, over the images of the window.  None where the
program has no such kernel."""

UNIT = "ms"
MOVES = "tta_images_per_s"


def read(record):
    launches = [k for k in record["kernels"] if "vit_attn_" in k[0] and "_kernel" in k[0]]
    n = record["counts"].get("images")
    if not launches or not n:
        return None
    return 1e3 * sum(e - s for _, s, e in launches) / n
