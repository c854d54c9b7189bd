"""One minus the union of the device's kernel and copy intervals in the
profiler's trace, over the traced window, in a training cell."""

from spans import busy_seconds

UNIT = "%"
MOVES = "peak_mem_gib"


def read(record):
    if not record["kernels"] or "train_images" not in record["counts"]:
        return None
    busy = busy_seconds(record["kernels"], record["t0"], record["t1"])
    return 100.0 * (1.0 - busy / record["window_s"])
