"""Checkpoints of the train state, with resume.

Counterpart of ``ttdg_mgm_tpu/checkpoint/save.py`` (orbax) in detectron2's
own layout, so a trained file is read back as ``MODEL.WEIGHTS``
(``checkpoint/bridge.py:load_reference_checkpoint`` takes its ``"model"``)
as the reference's ``model_final.pth`` is.  Each save is one ``torch.save``
file ``model_{step:07d}.pth`` holding ``{"model": the d2-named state dict,
"optimizer": the SGD state dict (its momentum buffers), "iteration":
step}``.  It is written under a temporary name and then renamed with
``os.replace``, so a save cut short leaves no partial file under a
checkpoint's name; ``last_checkpoint`` (written the same way) names the
newest file, and only the ``max_to_keep`` newest files are kept.

Data parallel (``parallel/mesh.py``): the ranks hold the same state, so
only the main process writes, and every rank waits at a barrier after each
save; on resume every rank reads the same file.
"""

from __future__ import annotations

import os
import re

import torch

from ttdg_mgm_torch.parallel import mesh

_NAME = re.compile(r"^model_(\d{7})\.pth$")
LAST = "last_checkpoint"


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class Checkpointer:
    def __init__(self, directory: str, *, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"model_{int(step):07d}.pth")

    def steps(self) -> list[int]:
        """The steps of the checkpoint files in the directory, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def save(self, step: int, state: dict) -> str:
        """Write ``state`` (``{"model", "optimizer", "iteration"}``) as the
        checkpoint of ``step``, name it in ``last_checkpoint`` and drop all
        but the ``max_to_keep`` newest files (on the main process; every
        rank then waits at a barrier).  Returns its path."""
        path = self.path(step)
        if mesh.is_main_process():
            _atomic_write(path, lambda p: torch.save(state, p))

            def write_last(p):
                with open(p, "w") as f:
                    f.write(os.path.basename(path))

            _atomic_write(os.path.join(self.directory, LAST), write_last)
            for old in self.steps()[:-self.max_to_keep]:
                os.remove(self.path(old))
        mesh.barrier()
        return path

    def latest_step(self) -> int | None:
        """The step ``last_checkpoint`` names, else the newest file's, else
        None."""
        last = os.path.join(self.directory, LAST)
        if os.path.exists(last):
            with open(last) as f:
                m = _NAME.match(f.read().strip())
            if m and os.path.exists(self.path(int(m.group(1)))):
                return int(m.group(1))
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None) -> dict | None:
        """The checkpoint of ``step`` (the latest when None) on the CPU, or
        None when there is none.  Checkpoints are pickles: restore only
        files from a trusted source."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        return torch.load(self.path(step), map_location="cpu", weights_only=False)

    def resume_or_load(self) -> tuple[dict | None, bool]:
        """``(state, True)`` from the latest checkpoint when one exists, else
        ``(None, False)``: the caller keeps the weights it was built with
        (``MODEL.WEIGHTS``), as the reference's ``resume_or_load``."""
        state = self.restore()
        return state, state is not None
