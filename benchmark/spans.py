"""Spans around the program's layers, from the benchmark's own files, and the
reduction of a profiler trace to device time.

:class:`Recorder` wraps module attributes of the program (the way
``chip_smoke.py``'s ``capture_*`` functions do) so that each call leaves a
span ``(name, start, end, thread)`` on the host's ``perf_counter`` clock;
it edits no file of the program and undoes every wrap on :meth:`close`.
:func:`device_intervals` reads the CUDA kernels and copies of a
``torch.profiler`` run and puts them on the same clock through an anchor
kernel launched at a known host time.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict


class Recorder:
    """Spans and counts of one run.  With ``on`` False every wrap is a no-op,
    so an untraced run pays nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.spans: list = []
        self.counts: dict = defaultdict(float)
        self._undo: list = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.spans.append((name, t0, t1, threading.get_ident()))

    def wrap(self, owner, attr: str, name: str, *, sync=None, force: bool = False) -> None:
        """Replace ``owner.attr`` (a module's function or an object's method)
        by one that records a span ``name`` around each call.  ``sync``, a
        function, runs before the span closes (a device synchronise, so a
        step's span holds its device work)."""
        if not (self.on or force):
            return
        real = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                if sync is not None:
                    sync()
                self.add(name, t0, time.perf_counter())

        self.replace(owner, attr, wrapped)

    def replace(self, owner, attr: str, new) -> None:
        """Set ``owner.attr`` to ``new`` until :meth:`close`."""
        self._undo.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def wrap_iter(self, it, name: str):
        """An iterator over ``it`` recording a span ``name`` around each
        ``next`` (the time a loop blocks on its loader)."""
        if not self.on:
            return it
        rec = self

        class Timed:
            def __iter__(self):
                return self

            def __next__(self):
                t0 = time.perf_counter()
                try:
                    return next(it)
                finally:
                    rec.add(name, t0, time.perf_counter())

            def close(self):
                if hasattr(it, "close"):
                    it.close()

        return Timed()

    def close(self) -> None:
        while self._undo:
            owner, attr, real = self._undo.pop()
            setattr(owner, attr, real)

    def in_window(self, name: str, t0: float, t1: float) -> list:
        """The spans ``name`` that start inside ``[t0, t1]``."""
        return [s for s in self.spans if s[0] == name and t0 <= s[1] <= t1]


#: the characters of a device operation's name kept in the breakdown (a
#: templated kernel's full name runs to a thousand)
NAME_CHARS = 160
#: the anchor kernel's name: ``torch.cuda._sleep`` launches it
ANCHOR_KERNEL = "spin_kernel"


def launch_anchor(torch) -> float:
    """Synchronise, launch the anchor kernel on an idle device and return
    the host time of the launch; the kernel starts a few microseconds
    later."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    return t


def device_intervals(prof, anchor_host: float) -> list:
    """``[(name, start, end)]`` of every CUDA kernel, copy and set of the
    profiler run ``prof`` on the host's ``perf_counter`` clock (seconds),
    sorted by start.  The anchor kernel (the first one named
    :data:`ANCHOR_KERNEL`) fixes the offset between the clocks."""
    from torch.autograd import DeviceType

    events = []
    # the profiler's own records: building its event list (``prof.events()``)
    # for a window of a million launches takes minutes
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            events.append((e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9))
    if not events:
        return []
    events.sort(key=lambda e: e[1])
    anchor = next((e for e in events if ANCHOR_KERNEL in e[0]), events[0])
    off = anchor_host - anchor[1]
    return [(n, s + off, t + off) for n, s, t in events if ANCHOR_KERNEL not in n]


def busy_seconds(intervals: list, t0: float, t1: float) -> float:
    """Seconds of ``[t0, t1]`` in which some interval ran (their union)."""
    busy, end = 0.0, t0
    for _, s, e in intervals:
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return busy


def idle_gaps(intervals: list, t0: float, t1: float) -> list:
    """The idle stretches ``(start, end)`` of ``[t0, t1]``."""
    gaps, end = [], t0
    for _, s, e in intervals:
        if s > end and s <= t1:
            gaps.append((end, min(s, t1)))
        end = max(end, e)
        if end >= t1:
            break
    if end < t1:
        gaps.append((end, t1))
    return gaps


def breakdown(intervals: list, spans: list, t0: float, t1: float, top: int = 10) -> dict:
    """The device operations that took most time in ``[t0, t1]``, and the
    idle time grouped by the innermost span the host was in at each gap's
    middle (``host`` when it was in none), each list at most ``top`` long."""
    ops = defaultdict(float)
    for n, s, e in intervals:
        if s >= t0 and e <= t1:
            ops[n[:NAME_CHARS]] += e - s
    idle = defaultdict(float)
    for g0, g1 in idle_gaps(intervals, t0, t1):
        mid = (g0 + g1) / 2
        inner = [sp for sp in spans if sp[1] <= mid <= sp[2]]
        label = min(inner, key=lambda sp: sp[2] - sp[1])[0] if inner else "host"
        idle[label] += g1 - g0
    by = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": by(ops), "idle_gaps": by(idle)}
