"""The least time the window's source steps need on the H100, over the
window's seconds: FLOPs of one step (forward and backward) counted on the
plain reference at the cell's shapes (``roofline.DtypeFlops``), bf16 at 989
TFLOP/s and float32 at 67 TFLOP/s (TF32 off)."""

from roofline import least_seconds

UNIT = "%"
MOVES = "peak_mem_gib"


def read(record):
    flops = record["work"].get("flops", {})
    if "source_step" not in flops or "train_steps" not in record["counts"]:
        return None
    need = record["counts"]["train_steps"] * least_seconds(flops["source_step"])
    return 100.0 * need / record["window_s"]
