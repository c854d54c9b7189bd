"""Median host-clock time of one source step
(``engine/steps.py:make_source_step``) in the window, each ending in a
device synchronise."""

import statistics

UNIT = "ms"
MOVES = "peak_mem_gib"


def read(record):
    spans = [s[2] - s[1] for s in record["spans"] if s[0] == "train.step"]
    return 1e3 * statistics.median(spans) if spans else None
