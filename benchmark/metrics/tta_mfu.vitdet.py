"""``tta_mfu``'s arithmetic in a ViTDet cell: the least time of the window's
TTA steps and inference passes, their FLOPs counted on the plain reference
(``roofline.DtypeFlops``), over the window's seconds; but the reference's
attention products, which it computes in float32 and the program on the
bf16 tensor cores (kernel F), count at the bf16 rate
(``captures/vitdet.py``: ``vit_attn_reference_f32``)."""

from roofline import least_seconds

UNIT = "%"
MOVES = "tta_images_per_s"


def _bf16(flops: dict, moved: float) -> dict:
    out = dict(flops)
    out["float32"] = out.get("float32", 0.0) - moved
    out["bfloat16"] = out.get("bfloat16", 0.0) + moved
    return out


def read(record):
    flops = record["work"].get("flops", {})
    moved = record["work"].get("vit_attn_reference_f32")
    c = record["counts"]
    if "tta_step" not in flops or "inference" not in flops or not moved or "tta_steps" not in c:
        return None
    need = (c["tta_steps"] * least_seconds(_bf16(flops["tta_step"], moved["tta_step"]))
            + c["inference_batches"] * least_seconds(_bf16(flops["inference"],
                                                           moved["inference"])))
    return 100.0 * need / record["window_s"]
