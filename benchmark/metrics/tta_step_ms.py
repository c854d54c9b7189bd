"""Median host-clock time of one TTA step (``engine/steps.py:make_tta_step``)
in the window, each ending in a device synchronise."""

import statistics

UNIT = "ms"
MOVES = "tta_images_per_s"


def read(record):
    spans = [s[2] - s[1] for s in record["spans"] if s[0] == "tta.step"]
    return 1e3 * statistics.median(spans) if spans else None
