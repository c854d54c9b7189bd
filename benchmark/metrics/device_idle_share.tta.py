"""One minus the union of the device's kernel and copy intervals in the
profiler's trace, over the traced window, in an eval-only TTA cell."""

from spans import busy_seconds

UNIT = "%"
MOVES = "tta_images_per_s"


def read(record):
    if not record["kernels"] or "passes" not in record["counts"]:
        return None
    busy = busy_seconds(record["kernels"], record["t0"], record["t1"])
    return 100.0 * (1.0 - busy / record["window_s"])
