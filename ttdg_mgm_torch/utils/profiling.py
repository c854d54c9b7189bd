"""Profiling helpers: a warm-up-aware step timer, a ``torch.profiler``
trace, and named regions.

Counterpart of ``ttdg_mgm_tpu/utils/profiling.py``: :class:`StepTimer` is
its copy; :func:`trace` records a ``torch.profiler`` trace (the CPU and,
when CUDA is available, the device) and writes it into ``log_dir`` as a
Chrome trace, viewable in Perfetto; :func:`annotate` names a region on that
timeline (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import os
import time


class StepTimer:
    """Running averages of named phases, the first ``warmup`` steps left
    out (the reference's s/iter breakdown)."""

    def __init__(self, warmup: int = 5):
        self.warmup = warmup
        self.counts = 0
        self.totals = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if self.counts >= self.warmup:
                self.totals[name] = self.totals.get(name, 0.0) + dt

    def step(self):
        self.counts += 1

    def averages(self) -> dict:
        n = max(self.counts - self.warmup, 1)
        return {k: v / n for k, v in self.totals.items()}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` and write
    ``<log_dir>/trace_<pid>_<time>.json`` (Chrome trace format); yields the
    profiler."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A named region on the profiler's timeline, as a context manager."""
    import torch

    return torch.profiler.record_function(name)
