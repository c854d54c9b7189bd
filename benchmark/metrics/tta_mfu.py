"""The least time the window's work needs on the H100, over the window's
seconds: each TTA step (forward, and backward as far as the gradient
reaches) and each inference pass, their FLOPs counted on the plain
reference at the cell's shapes (``roofline.DtypeFlops``), bf16 at 989
TFLOP/s and float32 at 67 TFLOP/s (TF32 off)."""

from roofline import least_seconds

UNIT = "%"
MOVES = "tta_images_per_s"


def read(record):
    flops = record["work"].get("flops", {})
    c = record["counts"]
    if "tta_step" not in flops or "inference" not in flops or "tta_steps" not in c:
        return None
    need = (c["tta_steps"] * least_seconds(flops["tta_step"])
            + c["inference_batches"] * least_seconds(flops["inference"]))
    return 100.0 * need / record["window_s"]
