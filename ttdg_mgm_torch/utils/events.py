"""Event storage and writers of the train loop.

This package's own copy of ``ttdg_mgm_tpu/utils/events.py``: a scalar store
scoped to the train loop (d2 ``EventStorage``), a JSON-lines writer
(``metrics.json``: one line per write with ``iteration``, the latest value
of every scalar and ``time``), a terminal writer on the package's logger,
and a TensorBoard writer.  The TensorBoard writer uses
``torch.utils.tensorboard``, imported when one is made, never at import;
it raises ``ImportError`` naming the missing package when that package
(``tensorboard``) is absent.  As in the JAX package, it is not among the
trainer's default writers.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict


class EventStorage:
    _current = None

    def __init__(self, start_iter: int = 0):
        self.iter = start_iter
        self._history = defaultdict(list)
        self._latest = {}

    def put_scalar(self, name: str, value):
        value = float(value)
        self._history[name].append((self.iter, value))
        self._latest[name] = value

    def put_scalars(self, **kwargs):
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def latest(self) -> dict:
        return dict(self._latest)

    def history(self, name: str):
        return list(self._history[name])

    def step(self):
        self.iter += 1

    def __enter__(self):
        EventStorage._current = self
        return self

    def __exit__(self, *a):
        EventStorage._current = None

    @classmethod
    def current(cls) -> "EventStorage | None":
        return cls._current


class JSONWriter:
    """Appends one JSON line per write to ``path`` (opened for that write
    only, so no file stays open between writes)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter, **storage.latest(), "time": time.time()}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


class TerminalWriter:
    def __init__(self, logger=None):
        self.logger = logger or logging.getLogger("ttdg_mgm_torch")

    def write(self, storage: EventStorage):
        items = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(storage.latest().items()))
        self.logger.info("iter %d  %s", storage.iter, items)


class TensorboardWriter:
    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError("TensorboardWriter needs the 'tensorboard' package "
                              f"(torch.utils.tensorboard): {e}") from e
        self._w = SummaryWriter(log_dir)

    def write(self, storage: EventStorage):
        for k, v in storage.latest().items():
            self._w.add_scalar(k, v, global_step=storage.iter)
        self._w.flush()

    def close(self):
        self._w.close()
