"""What the jobs share: the program's configuration from the cell's tree, the
trainable parameters by name, and the first gradient the optimizer got."""

from __future__ import annotations

import gc

import torch


def program_cfg(cfg_dict: dict):
    """The program's configuration: its defaults with the cell's tree merged
    over them."""
    from ttdg_mgm_torch.config import get_cfg

    cfg = get_cfg()
    cfg.merge_from_other(cfg_dict)
    return cfg


def trainable(trainer) -> dict:
    """The optimizer's parameters by their names in the model."""
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return {names[id(p)]: p for p in trainer.optimizer.params}


def first_gradient(sgd, params: dict) -> dict:
    """The gradient the optimizer got on its first step: its momentum
    buffers (zero where it holds none)."""
    out = {}
    for n, p in params.items():
        buf = sgd.state.get(p, {}).get("momentum_buffer")
        out[n] = (buf if buf is not None else torch.zeros_like(p)).detach().to("cpu", copy=True)
    return out


def free_program(run) -> None:
    """Drop the program's trainer and give its device memory back."""
    run.state.pop("trainer", None)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def flop_counter(run):
    """A context factory that counts the reference's FLOPs by dtype under a
    name, into ``run.work["flops"]``."""
    from contextlib import contextmanager

    from roofline import DtypeFlops

    flops = run.work.setdefault("flops", {})

    @contextmanager
    def counter(name):
        mode = DtypeFlops()
        with mode:
            yield
        flops[name] = dict(mode.flops)

    return counter
