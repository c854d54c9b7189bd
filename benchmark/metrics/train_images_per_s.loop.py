"""Training images consumed by the loop's completed iterations in the
window, over the window's seconds, loader included.  A per-layer reading:
the rate is set by the loader's one host thread, whose pace on a shared
host spreads too widely between runs for an end-to-end bound; ``MOVES``
names the cell's one other end-to-end metric."""

UNIT = "images/s"
MOVES = "peak_mem_gib"


def read(record):
    if "train_images" not in record["counts"]:
        return None
    return record["counts"]["train_images"] / record["window_s"]
