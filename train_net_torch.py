#!/usr/bin/env python3
"""Command line of the PyTorch/CUDA port (``ttdg_mgm_torch``), with the
arguments of ``train_net.py``:

    python3 train_net_torch.py --config configs/seg_res50fpn_source.yaml [opts ...]
    python3 train_net_torch.py --config configs/seg_res50fpn_MT.yaml [opts ...]
    python3 train_net_torch.py --eval-only --config configs/test_segment.yaml \
        MODEL.WEIGHTS <ckpt> [opts ...]

Both read the config (defaults, YAML with ``_BASE_``, overrides), register
the medical datasets under ``--datasets-root`` and build the trainer of
``ttdg_mgm_torch/build.py``.

Training (without ``--eval-only``) follows ``SEMISUPNET.Trainer``.  The
baseline trainer trains on ``DATASETS.TRAIN`` in batches of
``SOLVER.IMS_PER_BATCH``; the mean-teacher trainer (``"ateacher"``) runs
``ATeacherTrainer.train_semisup`` on ``DATASETS.TRAIN_LABEL`` and
``DATASETS.TRAIN_UNLABEL`` in batches of ``SOLVER.IMG_PER_BATCH_LABEL``
of each (the JAX package's ``train_net.py`` calls ``train`` on
``DATASETS.TRAIN`` for both, which the MT configs leave empty), and its
checkpoints hold the student and the teacher in d2's ``EnsembleTSModel``
layout; ``SEMISUPNET.CROSS_DOMAIN_MATCHING True`` adds the cross-domain
graph-matching head's losses to its MT steps (its class centers are not
checkpointed and restart at zero on resume, as in the JAX package).
Checkpoints go to
``OUTPUT_DIR/checkpoints`` (``model_{step:07d}.pth`` in d2's layout, the 5
newest kept, ``last_checkpoint`` naming the newest) every
``SOLVER.CHECKPOINT_PERIOD`` steps and once at the end.  Resume is forced,
as in the reference: a run restores the weights, the momentum and the step
count of the latest checkpoint there and trains on to ``SOLVER.MAX_ITER``;
its loader and sampling generator restart from ``SEED``, as in the JAX
package.  The losses go to ``OUTPUT_DIR/metrics.json`` every 20 steps and
after the last; with ``TEST.EVAL_PERIOD > 0`` the validation loss on
``DATASETS.TEST[0]`` is logged at that period.  A final checkpoint feeds
``--eval-only`` as ``MODEL.WEIGHTS``.

Eval-only test-time adaptation: per test dataset, one TTA step per batch of
``TEST.BATCH`` images followed by evaluation (Dice, or COCO or VOC AP by the
dataset's type or ``TEST.EVALUATOR``).  The results are printed and
appended, with the weights' path, as one JSON line to
``OUTPUT_DIR/result_ap.txt``.  The mean-teacher trainer adapts and scores
its teacher, which starts from the member of a teacher-student
``MODEL.WEIGHTS`` that ``TEST.EVAL_STU`` picks (the teacher, or the
student), as in the JAX package.

It runs on CUDA unless ``--device cpu`` is given, with TF32 off for
convolutions and matrix products and cuDNN restricted to deterministic
algorithms (``ttdg_mgm_torch.configure_torch``, set before the first CUDA
call), so two runs of one command give the same bits.  ``TPU.PRECISION``
defaults to ``"bfloat16"`` as in the JAX package: the bf16 compute policy
(``TPU.PRECISION float32`` computes in float32).  Images are read as PNG or
baseline JPEG by the port's own decoders.

Data parallel (``ttdg_mgm_torch/parallel/``): ``TPU.MESH_SHAPE`` (``[-1]``,
every visible GPU, by default) sets the processes per machine.  On a
machine with more than one GPU the command starts one process per GPU
(``torch.multiprocessing.spawn``, detectron2's ``launch``); they join an
NCCL process group at ``--dist-url`` (a free local port when it is not
given), and each trains or adapts on its shard of every batch with the
gradients averaged.  Several machines run the same command with
``--num-machines``, their own ``--machine-rank`` and one ``--dist-url``
(``tcp://host:port`` of machine 0).  On one GPU a ``--dist-url`` makes a
process group of one rank.  ``--device cpu`` with ``--dist-url`` runs gloo
ranks on the CPU (``TPU.MESH_SHAPE [n]`` of them per machine).  Only the
main process writes checkpoints, ``metrics.json`` and ``result_ap.txt``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", "--config", dest="config_file", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--datasets-root", default=None,
                   help="root of the Fundus/Polyp dataset tree (or TTDG_DATASETS)")
    p.add_argument("--num-machines", type=int, default=1)
    p.add_argument("--machine-rank", type=int, default=0)
    p.add_argument("--dist-url", default=None,
                   help="rendezvous of the process group: tcp://host:port of machine 0 (or "
                        "file://<path>)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain versions "
                        "of the kernels)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command line ``argv`` (``sys.argv[1:]`` when None); returns
    the results of an eval-only run, or of training ``{"iteration",
    "checkpoint", "validation_loss"}`` (the main process's, when it starts
    one process per device)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")

    from ttdg_mgm_torch.build import local_data_ranks
    from ttdg_mgm_torch.config import setup_cfg
    from ttdg_mgm_torch.parallel import multihost

    local = local_data_ranks(setup_cfg(args.config_file, args.opts), args.device)
    if args.num_machines > 1 and not args.dist_url:
        raise ValueError("--num-machines above 1 needs --dist-url (machine 0's tcp://host:port)")
    if local == 1 and args.num_machines == 1 and not args.dist_url:
        return run(args)
    dist_url = args.dist_url or f"tcp://127.0.0.1:{multihost.free_port()}"
    if local == 1:
        multihost.initialize_multihost(dist_url, args.num_machines, args.machine_rank,
                                       device=args.device)
        try:
            return run(args)
        finally:
            multihost.shutdown()
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").SimpleQueue()
    multihost.launch(_rank_run, local, dist_url=dist_url, num_machines=args.num_machines,
                     machine_rank=args.machine_rank, device=args.device, args=(args, results))
    return results.get()


def _rank_run(args, results) -> None:
    """One spawned rank of :func:`main`; the main process hands back its
    result."""
    from ttdg_mgm_torch.parallel.mesh import is_main_process

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    out = run(args)
    if is_main_process():
        results.put(out)


def run(args) -> dict:
    """The command of ``args`` in this process (a rank of the process group
    when one exists)."""
    from ttdg_mgm_torch import configure_torch
    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.config import setup_cfg
    from ttdg_mgm_torch.data.builtin import register_all_medical
    from ttdg_mgm_torch.parallel.mesh import is_main_process

    configure_torch()
    cfg = setup_cfg(args.config_file, args.opts)
    register_all_medical(args.datasets_root or cfg.DATASETS.ROOT, force=True)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    trainer = build_trainer(cfg, device=args.device)
    if not args.eval_only:
        return train(cfg, trainer)
    results = trainer.test(
        cfg.DATASETS.TEST,
        ttt=cfg.TEST.TTT,
        tta_batch=cfg.TEST.BATCH,
        min_batch_num=cfg.TEST.MIN_BATCH_NUM,
        dice_threshold=cfg.TEST.DICE_THRES,
        # TEST.EVALUATOR forces one evaluator; the reference default "COCOeval"
        # keeps each dataset's own
        evaluator_type=(cfg.TEST.EVALUATOR if cfg.TEST.EVALUATOR in
                        ("coco", "dice", "pascal_voc", "pascal_voc_water") else None),
        # the dumps are the main process's, as in train_net.py
        draw_dir=cfg.OUTPUT_DIR if cfg.TEST.DRAW and is_main_process() else None,
    )
    if is_main_process():
        with open(os.path.join(cfg.OUTPUT_DIR, "result_ap.txt"), "a") as f:
            f.write(json.dumps({"weights": cfg.MODEL.WEIGHTS, "results": results}) + "\n")
        print(json.dumps(results, indent=2))
    return results


def train(cfg, trainer) -> dict:
    """Training as ``train_net.py`` runs it: forced resume, the default
    hooks, the validation loss when ``TEST.EVAL_PERIOD > 0``, and a final
    checkpoint; the mean-teacher trainer trains on the labelled and
    unlabelled datasets."""
    from ttdg_mgm_torch.checkpoint.save import Checkpointer
    from ttdg_mgm_torch.engine.hooks import LossEvalHook
    from ttdg_mgm_torch.engine.mean_teacher import ATeacherTrainer

    ckpt = Checkpointer(os.path.join(cfg.OUTPUT_DIR, "checkpoints"))
    trainer.resume_or_load(ckpt)
    hooks = trainer.default_hooks(checkpointer=ckpt,
                                  checkpoint_period=cfg.SOLVER.CHECKPOINT_PERIOD,
                                  output_dir=cfg.OUTPUT_DIR)
    val = None
    if cfg.TEST.EVAL_PERIOD > 0 and cfg.DATASETS.TEST:
        val = LossEvalHook(trainer, cfg.DATASETS.TEST[0], cfg.TEST.EVAL_PERIOD)
        hooks.append(val)
    if isinstance(trainer, ATeacherTrainer):
        trainer.train_semisup(cfg.DATASETS.TRAIN_LABEL, cfg.DATASETS.TRAIN_UNLABEL,
                              max_iter=cfg.SOLVER.MAX_ITER,
                              batch_size=cfg.SOLVER.IMG_PER_BATCH_LABEL, seed=cfg.SEED,
                              hooks=hooks)
    else:
        trainer.train(cfg.DATASETS.TRAIN, max_iter=cfg.SOLVER.MAX_ITER,
                      batch_size=cfg.SOLVER.IMS_PER_BATCH, seed=cfg.SEED, hooks=hooks)
    path = ckpt.save(trainer.optimizer.count, trainer.state_dict())
    return {"iteration": trainer.optimizer.count, "checkpoint": path,
            "validation_loss": val.history if val is not None else []}


if __name__ == "__main__":
    try:
        main()
    except NotImplementedError as e:
        print(f"train_net_torch: {e}", file=sys.stderr)
        sys.exit(2)
