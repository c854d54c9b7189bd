"""Kernel F's share of its roofline over the window: the least time of every
call the captures recorded (``captures/vitdet.py:least_seconds``: bytes at
3.35 TB/s or FLOPs at 989 TFLOP/s, recomputation not counted), summed, over
the summed device time of the trace's launches named ``vit_attn_*_kernel``
(forward, and the backward's dQ and dK/dV passes).  None where the program
has no such kernel."""

UNIT = "%"
MOVES = "tta_images_per_s"


def read(record):
    work = record["work"].get("vit_attn")
    launches = [k for k in record["kernels"] if "vit_attn_" in k[0] and "_kernel" in k[0]]
    if not work or not work["forward"] or not launches:
        return None
    return 100.0 * work["least_s"] / sum(e - s for _, s, e in launches)
