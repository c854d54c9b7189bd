"""Median host-clock time of one mean-teacher step
(``engine/steps.py:make_mt_step``, the teacher's pseudo-labels, the
student's four passes and the SGD step) in the window, each ending in a
device synchronise."""

import statistics

UNIT = "ms"
MOVES = "peak_mem_gib"


def read(record):
    spans = [s[2] - s[1] for s in record["spans"] if s[0] == "mt.step"]
    return 1e3 * statistics.median(spans) if spans else None
