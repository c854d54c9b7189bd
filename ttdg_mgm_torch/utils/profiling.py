"""The port's tracer: spans and counters inside the program, named regions,
and a ``torch.profiler`` trace.

:func:`span` times a block of the program and :func:`count` adds to a
counter of every span open in the calling thread.  The tracer is off by
default: :func:`span` then returns one shared no-op context after a single
flag check, and :func:`count` returns at once.  Between :func:`enable` and
:func:`disable` each span leaves one record, which :func:`drain` returns
(and clears) as a dict:

* ``name``, and ``key``, which the spans of one request share (the TTA
  batch index, the training iteration, the evaluated ``image_id``);
* ``t0`` and ``t1`` on ``time.perf_counter()``, the host clock that a
  device trace can be mapped onto through a kernel launched at a known time;
* ``thread`` (``threading.get_ident()``) and ``parent``, the name of the
  enclosing span of the same thread (None at the top): each thread has its
  own stack, so a loader's producer thread nests its spans on their own;
* ``cpu_s``, the thread's CPU seconds (``time.thread_time()``) inside the
  span, which against ``t1 - t0`` says whether the thread worked or waited;
* ``counts``, each counter added inside the span, the span's children
  included.

``host_syncs`` counts the host's waits on the device.  While the tracer is
on it counts every warning of torch's synchronising-call debug mode, which
:func:`enable` sets to ``"warn"`` when CUDA is present, as one
``host_syncs`` on the spans open in the thread that made it; those warnings
are counted and not printed, every repeat of them, and every other warning
prints as before.  An explicit ``torch.cuda.synchronize()`` is not such a
call.  :func:`disable` restores the debug mode and the warning handling.

While the tracer is on, each span also opens :func:`annotate` under its
name, so a ``torch.profiler`` timeline shows the program's spans beside the
device's kernels.  An operator's profile of a run::

    from ttdg_mgm_torch.utils import profiling

    profiling.enable()
    with profiling.trace("output/trace"):
        trainer.test(...)
    profiling.disable()
    spans = profiling.drain()

writes a Chrome trace (viewable in Perfetto) in which the program's spans
are named regions, and keeps the spans with their counts.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
import warnings

#: the start of the warning torch's synchronising-call debug mode gives
SYNC_WARNING = "called a synchronizing CUDA operation"

#: what :func:`span` returns while the tracer is off
_NOOP = contextlib.nullcontext()


class _State:
    """The process's one tracer."""

    def __init__(self):
        self.on = False
        self.records: list = []
        self.local = threading.local()      # each thread's stack of open spans
        self.catch = None                   # the warnings' state to restore
        self.sync_mode = None               # the debug mode to restore


_S = _State()


def _stack() -> list:
    st = getattr(_S.local, "stack", None)
    if st is None:
        st = _S.local.stack = []
    return st


class _Span:
    __slots__ = ("name", "key", "counts", "_t0", "_c0", "_region")

    def __init__(self, name: str, key):
        self.name = name
        self.key = key
        self.counts: dict = {}

    def __enter__(self):
        self._region = annotate(self.name)
        self._region.__enter__()
        _stack().append(self)
        self._c0 = time.thread_time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        c1 = time.thread_time()
        st = _stack()
        st.pop()
        _S.records.append({"name": self.name, "key": self.key, "t0": self._t0, "t1": t1,
                           "thread": threading.get_ident(),
                           "parent": st[-1].name if st else None,
                           "cpu_s": c1 - self._c0, "counts": self.counts})
        self._region.__exit__(*exc)
        return False


def span(name: str, key=None):
    """A context that records the span ``name`` (with ``key``) while the
    tracer is on; the shared no-op context while it is off."""
    if not _S.on:
        return _NOOP
    return _Span(name, key)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of every span open in this thread
    (nothing while the tracer is off)."""
    if not _S.on:
        return
    for s in _stack():
        s.counts[name] = s.counts.get(name, 0) + n


def _showwarning(show):
    """``warnings.showwarning`` that counts torch's synchronising-call
    warnings and hands every other warning to ``show``."""

    def hook(message, category, filename, lineno, file=None, line=None):
        if issubclass(category, UserWarning) and str(message).startswith(SYNC_WARNING):
            count("host_syncs")
        else:
            show(message, category, filename, lineno, file, line)

    return hook


def enable() -> None:
    """Turn the tracer on (a no-op when it is on)."""
    if _S.on:
        return
    import torch

    _S.catch = warnings.catch_warnings()
    _S.catch.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING, category=UserWarning)
    warnings.showwarning = _showwarning(warnings.showwarning)
    if torch.cuda.is_available():
        _S.sync_mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    _S.on = True


def disable() -> None:
    """Turn the tracer off and restore the synchronising-call debug mode and
    the warning handling (a no-op when it is off)."""
    if not _S.on:
        return
    _S.on = False
    if _S.sync_mode is not None:
        import torch

        torch.cuda.set_sync_debug_mode(_S.sync_mode)
        _S.sync_mode = None
    _S.catch.__exit__(None, None, None)
    _S.catch = None


def drain() -> list:
    """The spans recorded so far, oldest end first; clears them."""
    out, _S.records = _S.records, []
    return out


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with ``torch.profiler`` (the CPU and, when CUDA is
    available, the device) and write ``<log_dir>/trace_<pid>_<time>.json``
    (Chrome trace format); yields the profiler."""
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
