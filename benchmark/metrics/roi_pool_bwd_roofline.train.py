"""Kernel C's share of its roofline over the window: the byte bound of every
launch (``roofline.roi_backward_work``: the cotangent and the ROIs read
once, every level gradient written once, at 3.35 TB/s), summed, over the
summed device time of its plan and gather kernels in the profiler's
trace."""

from roofline import bound

UNIT = "%"
MOVES = "peak_mem_gib"


def read(record):
    work = record["work"].get("pool_bwd_work", [])
    launches = [k for k in record["kernels"]
                if "roi_pool_backward_kernel" in k[0] or "roi_plan_kernel" in k[0]]
    if not work or not launches:
        return None
    need = sum(bound(b, f)[0] for b, f in work) * 1e-3
    return 100.0 * need / sum(e - s for _, s, e in launches)
