"""Kernel B's share of its roofline on the window's first two launches: the
least time of ``roofline.gagm_flops`` at the power steps the reference's
plain GA-GM takes on the same inputs (float32, 67 TFLOP/s), over the two
launches' device time in the profiler's trace."""

from roofline import PEAK_F32_FLOP_PER_S, gagm_flops

UNIT = "%"
MOVES = "tta_images_per_s"


def read(record):
    solves = record["work"].get("gagm", [])
    launches = [k for k in record["kernels"] if "gagm_kernel" in k[0]][:len(solves)]
    if not solves or len(launches) < len(solves):
        return None
    need = sum(gagm_flops(s["G"], s["M"], s["univ"], s["steps"]) for s in solves)
    took = sum(e - s for _, s, e in launches)
    return 100.0 * need / PEAK_F32_FLOP_PER_S / took
