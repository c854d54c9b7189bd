"""The source-training job: ``BaselineTrainer.train`` as ``train_net_torch.py``
calls it, on the cell's training splits.

Set-up builds the trainer with ``build.py:build_trainer`` from the cell's
configuration, loads the benchmark's weights and trains its first three
iterations through ``train`` (loader, sampling generator and step seeded
from the run's seed): the steps the reference follows (each step's total
loss, the first gradient the optimizer got, the parameters after the
third).  The window calls ``train`` again on the same trainer, from the
optimizer's count on, with a hook that counts each iteration and ends the
loop once the window's seconds have passed.
"""

from __future__ import annotations

import functools
import time

import torch

import compare
from jobs.common import first_gradient, flop_counter, free_program, program_cfg, trainable

#: source steps the reference follows (the change is taken after the third)
FOLLOW = 3


class WindowClosed(Exception):
    """Raised by the window's hook to end the training loop."""


def _register(run) -> None:
    from ttdg_mgm_torch.data.builtin import register_all_legacy, register_all_medical
    from ttdg_mgm_torch.data.catalog import DatasetCatalog

    kinds = {s["kind"] for s in run.traffic["splits"]}
    if "cityscapes_foggy" in kinds:
        for split in ("train", "val", "test"):
            DatasetCatalog.remove(f"cityscapes_foggy_{split}")
        for name in ("coco_2017_unlabel", "coco_2017_for_voc20", "Clipart1k_train",
                     "Clipart1k_test", "Watercolor_train", "Watercolor_test"):
            DatasetCatalog.remove(name)
        register_all_legacy(run.data_root)
    else:
        register_all_medical(run.data_root, force=True)


def _train(run, max_iter: int, hooks) -> None:
    """``train`` as ``train_net_torch.py`` calls it: the loader and the
    sampling generator seeded with the configuration's ``SEED``, so every
    run draws the same sizes, flips and batches in the same order, and the
    run's seed changes the frames' content and the weights."""
    cfg = run.state["cfg"]
    run.state["trainer"].train(cfg.DATASETS.TRAIN, max_iter=max_iter,
                               batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=cfg.SEED,
                               log_every=10 ** 9, hooks=hooks)


def setup(run) -> None:
    from ttdg_mgm_torch import configure_torch
    from ttdg_mgm_torch.build import build_trainer

    from decisions import Decisions
    from ttdg_mgm_torch.graph import solvers as solvers_mod
    from ttdg_mgm_torch.graph import universe as universe_mod
    from ttdg_mgm_torch.models import rcnn as rcnn_mod

    configure_torch()
    cfg = program_cfg(run.cfg)
    _register(run)
    trainer = build_trainer(cfg, device=run.device)
    trainer.model.load_state_dict({k: v.to(run.device) for k, v in run.weights.items()})
    run.state = {"cfg": cfg, "trainer": trainer}
    params = trainable(trainer)
    got = {"losses": []}
    dec = Decisions([(rcnn_mod, "generate_proposals", "proposals"),
                     (universe_mod, "hippi", "hippi"), (solvers_mod, "sinkhorn_batched", "sk")],
                    keep_args=("sk",))
    real_step = trainer._source_step

    def step(*a, **kw):
        dec.begin()
        try:
            return real_step(*a, **kw)
        finally:
            dec.end()

    def capture(it, metrics):
        got["losses"].append(float(metrics["total_loss"]))
        k = len(got["losses"])
        if k == 1:
            got["grad"] = first_gradient(trainer.optimizer.sgd, params)
        if k == FOLLOW:
            got["params"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}

    trainer._source_step = step
    try:
        _train(run, FOLLOW, [capture])
    finally:
        trainer._source_step = real_step
        dec.close()
    got["steps"] = dec.steps
    run.state["got"] = got
    _instrument(run)


def _instrument(run) -> None:
    """The spans and captures of a traced run (no-ops otherwise)."""
    from ttdg_mgm_torch.data import loader as loader_mod
    from ttdg_mgm_torch.engine import trainer as trainer_mod
    from ttdg_mgm_torch.ops import roi_pool as roi_pool_mod

    rec = run.recorder
    if not rec.on:
        return
    trainer = run.state["trainer"]
    dev = run.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
    rec.wrap(trainer, "_source_step", "train.step", sync=sync)
    rec.wrap(loader_mod, "load_image", "decode")
    real_loader = trainer_mod.build_train_loader

    def timed_loader(*a, **kw):
        return rec.wrap_iter(real_loader(*a, **kw), "train.loader_wait")

    rec.replace(trainer_mod, "build_train_loader", timed_loader)
    pools = run.work.setdefault("pools_bwd", [])
    real_bwd = roi_pool_mod.multilevel_roi_pool_backward

    def backward(grad, level_shapes, rois, **kw):
        B, K, P = rois.shape[0], rois.shape[1], grad.shape[2]
        pools.append(([(B, h, w) for h, w in level_shapes], grad.shape[-1], rois.detach().clone(),
                      P, grad.element_size()))
        return real_bwd(grad, level_shapes, rois, **kw)

    # the wrapper takes the place of the module's name, which the function
    # itself reads for its launch counters
    functools.update_wrapper(backward, real_bwd)
    rec.replace(roi_pool_mod, "multilevel_roi_pool_backward", backward)


def window(run, seconds: float) -> None:
    t0 = time.perf_counter()
    iters = 0

    def hook(it, metrics):
        nonlocal iters
        iters += 1
        if time.perf_counter() - t0 >= seconds:
            raise WindowClosed

    try:
        _train(run, 10 ** 9, [hook])
    except WindowClosed:
        pass
    batch = run.state["cfg"].SOLVER.IMS_PER_BATCH
    run.counts.update(train_steps=iters, train_images=iters * batch, attempted=iters * batch,
                      failed=0)


def reference(run, fp8: bool = False, follow: dict | None = None, counter=None,
              alter=None) -> dict:
    """The plain reference over the first :data:`FOLLOW` steps, from the
    same seed, following the proposals and HiPPI targets of ``follow`` (the
    program's run) when it is given; ``alter`` plants a fault at a choice
    point."""
    from reference import cell

    cell.register(run.traffic, run.data_root)
    return cell.run_source(run.cfg, run.cfg["DATASETS"]["TRAIN"], run.device, run.weights,
                           FOLLOW, run.cfg["SEED"], fp8=fp8, follow=follow, counter=counter,
                           alter=alter, model_module=run.model_module)


def check_choosers(got: dict, device, alter=None) -> None:
    """HiPPI's chooser by itself, into ``got``: the first batched Sinkhorn
    projection of each step (the program's kernel D) against the plain
    Sinkhorn on the same inputs, the largest gap of the doubly stochastic
    output (a continuous, well-posed stage; HiPPI's fixed point after it is
    the program's, ``decisions.py``)."""
    from reference.ops.sinkhorn import sinkhorn

    gap = 0.0
    for rec in got["steps"]:
        (s, *rest), kw = rec["sk"]["args"]
        want = sinkhorn(s.to(device), *(r.to(device) if torch.is_tensor(r) else r
                                        for r in rest), **kw).cpu()
        gap = max(gap, float((rec["sk"]["out"] - want).abs().max()))
    got["sinkhorn"] = gap


def _proposal_scores(got_props, ref_props):
    """The first step's RPN proposals of both sides as ``{image: {"scores":
    ...}}`` for :func:`compare.score_gap`: the objectness of each image's
    valid proposals, squashed to (0, 1), as many of the highest as both
    sides hold (NMS keeps one more or one fewer when a last bit flips an
    overlap).  The first step is the one whose weights both sides share;
    later steps' proposals are the program's on both."""
    def per_image(props, n):
        _, scores, valid = props
        return {b: {"scores": torch.sigmoid(scores[b][valid[b]]).sort(descending=True)
                    .values[:n[b]].numpy()} for b in range(scores.shape[0])}

    if got_props[2].shape[0] != ref_props[2].shape[0]:       # another batch: no image matches
        return {}, {0: {"scores": [1.0]}}
    n = [min(int(a), int(b)) for a, b in zip(got_props[2].sum(1), ref_props[2].sum(1))]
    return per_image(got_props, n), per_image(ref_props, n)


def numbers(got: dict, ref: dict, run, log=None) -> dict:
    p0 = {k: run.weights[k] for k in ref["grad"]}
    keep = compare.moving_leaves(ref["grad"], run.cfg["SOLVER"]["WEIGHT_DECAY"], p0)
    change_p, change_r = compare.change(got["params"], p0), compare.change(ref["params"], p0)
    if log is not None:
        log(f"losses: got {got['losses']}, reference {ref['losses']}")
        log(f"worst leaf's change gap {compare.worst_leaf(change_p, change_r, keep)!r}; leaves "
            "whose change differs most: " + ", ".join(
                f"{k} {v:.4g}" for k, v in compare.leaf_gaps(change_p, change_r, keep)[:4]))
    return {
        "proposal_gap": compare.score_gap(*_proposal_scores(got["steps"][0]["proposals"]["out"],
                                                            ref["steps"][0]["proposals"]["out"])),
        "sinkhorn_gap": got["sinkhorn"],
        "loss_gap": compare.loss_gap(got["losses"], ref["losses"]),
        "grad_gap": compare.worst_leaf(got["grad"], ref["grad"], keep),
        "median_change_gap": compare.median_leaf(change_p, change_r, keep),
    }


def check(run) -> dict:
    got = run.state["got"]
    free_program(run)
    counter = None
    if run.trace:
        counter = flop_counter(run)
    check_choosers(got, run.device)
    ref = reference(run, follow=got, counter=counter)
    if run.trace:
        from roofline import roi_backward_work

        run.work["pool_bwd_work"] = [roi_backward_work(shapes, C, rois, P, elem)
                                     for shapes, C, rois, P, elem in run.work.pop("pools_bwd", [])]
    return numbers(got, ref, run, log=run.log)
