"""The port's side of the data-parallel tests (``tests/test_torch_parallel.py``):
the steps of one rank, and the single-process average they are held
against.  This module imports no JAX, so the ranks that
``ttdg_mgm_torch.parallel.multihost.launch`` spawns start quickly.

The inputs come from the test as one ``torch.save`` file: the model's
keyword arguments, its d2 state dict, the learning rate, the MT settings,
the step kinds to run, and per kind its global batch and each shard's draws (the JAX mesh
step's own uniforms and completion noise, shard by shard).
"""

from __future__ import annotations

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import copy
import os

import numpy as np
import torch

from ttdg_mgm_torch.checkpoint.bridge import load_d2_state_dict
from ttdg_mgm_torch.engine.steps import make_mt_step, make_source_step, make_tta_step
from ttdg_mgm_torch.models.rcnn import MaskRCNN
from ttdg_mgm_torch.parallel import mesh, multihost
from ttdg_mgm_torch.solver.build import build_optimizer

def _tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def setup(inputs: dict, kind: str):
    """A fresh model with the inputs' weights, its optimizer, and for the MT
    kinds the teacher (a copy) and the class centers (zeros)."""
    model = MaskRCNN(**inputs["kw"])
    load_d2_state_dict(model, inputs["sd"])
    opt = build_optimizer(model, lambda _: inputs["lr"])
    teacher = copy.deepcopy(model) if kind.startswith("mt") else None
    centers = (torch.zeros((model.num_classes + 1, model.cross_domain.dim))
               if kind == "mt_cd" else None)
    return model, opt, teacher, centers


def run_step(inputs: dict, kind: str, state, batch: dict, draws):
    """One step of ``kind`` (``"source"``, ``"tta"``, ``"mt"`` or ``"mt_cd"``)
    on ``batch`` with the shard's ``draws``; returns the metrics and the new
    centers."""
    model, opt, teacher, centers = state
    b = _tensors(batch)
    if kind == "source":
        return make_source_step(model, opt)(b, uniforms=draws), None
    if kind == "tta":
        return {"loss": make_tta_step(model, opt)(b)}, None
    step = make_mt_step(model, opt, with_cross_domain=kind == "mt_cd", **inputs["mt"])
    if kind == "mt_cd":
        return step(teacher, centers, b, uniforms=draws)
    return step(teacher, b, uniforms=draws), None


def grads_of(model) -> dict:
    """The gradients the optimizer stepped with (left in ``.grad``: the
    averaged ones on a rank of a group)."""
    return {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def shard_of(batch: dict, r: int, w: int) -> dict:
    n = next(iter(batch.values())).shape[0] // w
    return {k: v[r * n:(r + 1) * n] for k, v in batch.items()}


def rank_main(path: str, out_dir: str) -> None:
    """A rank of the process group: each step kind of the inputs, from fresh
    weights, on this rank's shard (``mesh.shard_batch``) with its draws;
    saves the metrics, the weights and the centers after each, whether an
    indivisible batch was refused, and every rank's rank as
    ``allgather_metrics`` gathers it."""
    inputs = torch.load(path, weights_only=False)
    r = mesh.rank()
    out = {}
    for kind in inputs["kinds"]:
        state = setup(inputs, kind)
        shard = mesh.shard_batch(inputs["batches"][kind])
        metrics, centers = run_step(inputs, kind, state, shard, inputs["draws"][kind][r])
        out[kind] = dict(metrics={k: v.clone() for k, v in metrics.items()},
                         params={k: v.detach().clone()
                                 for k, v in state[0].state_dict().items()},
                         grads=grads_of(state[0]), centers=centers)
    try:
        mesh.shard_batch({"x": np.zeros((3, 2))})
        out["indivisible"] = "accepted"
    except AssertionError as e:
        out["indivisible"] = str(e)
    out["world"] = (mesh.world_size(), r)
    out["gathered"] = multihost.allgather_metrics({"rank": r})
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def shard_average(inputs: dict, kind: str) -> dict:
    """One process computing each shard's gradients and losses from the same
    weights, then the average ``(a + b) / 2`` in rank order and one
    optimizer step: what the ranks' step should give bit for bit."""
    w = 2
    state = setup(inputs, kind)
    model, opt = state[0], state[1]
    grads, metrics, centers = [], [], []
    opt.step = lambda: grads.append([torch.zeros_like(p) if p.grad is None else p.grad.clone()
                                     for p in opt.params])
    batch = inputs["batches"][kind]
    for r in range(w):
        m, c = run_step(inputs, kind, state, shard_of(batch, r, w), inputs["draws"][kind][r])
        metrics.append(m)
        centers.append(c)
    del opt.step
    for i, p in enumerate(opt.params):
        p.grad = (grads[0][i] + grads[1][i]) / w
    opt.step()
    return dict(metrics={k: (metrics[0][k] + metrics[1][k]) / w for k in metrics[0]},
                params={k: v.detach().clone() for k, v in model.state_dict().items()},
                centers=None if centers[0] is None else (centers[0] + centers[1]) / w)


def draw_rank_main(argv: list, marks: str) -> None:
    """A rank of the process group running ``train_net_torch.py``'s command
    ``argv`` (an eval-only run with ``TEST.DRAW True``); each call of the
    trainer's ``dump_visualization`` on this rank leaves a file
    ``<marks>/rank<r>_<image_id>``."""
    import train_net_torch
    from ttdg_mgm_torch.engine import trainer

    real = trainer.dump_visualization

    def marked(output_dir, image_id, image, detections, class_names=None):
        open(os.path.join(marks, f"rank{mesh.rank()}_{image_id}"), "w").close()
        return real(output_dir, image_id, image, detections, class_names)

    trainer.dump_visualization = marked
    train_net_torch.run(train_net_torch.parse_args(argv))
