"""Kernel A's share of its roofline over the window: the byte bound of every
launch (``roofline.roi_pool_work``: each feature row a valid sample reads,
read once, the output written once, at 3.35 TB/s), summed, over the
launches' summed device time in the profiler's trace."""

from roofline import bound

UNIT = "%"
MOVES = "tta_images_per_s"


def read(record):
    work = record["work"].get("pool_work", [])
    launches = [k for k in record["kernels"] if "roi_pool_kernel" in k[0]]
    if not work or not launches:
        return None
    need = sum(bound(b, f)[0] for b, f in work) * 1e-3
    return 100.0 * need / sum(e - s for _, s, e in launches)
