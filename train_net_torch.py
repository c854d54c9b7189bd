#!/usr/bin/env python3
"""Command line of the PyTorch/CUDA port (``ttdg_mgm_torch``), with the
arguments of ``train_net.py``:

    python3 train_net_torch.py --eval-only --config configs/test_segment.yaml \
        MODEL.WEIGHTS <ckpt> TPU.PRECISION float32 [opts ...]

Eval-only test-time adaptation: the config (defaults, YAML with
``_BASE_``, overrides), the medical dataset registry under
``--datasets-root``, the trainer of ``ttdg_mgm_torch/build.py``, then per
test dataset one TTA step per batch of ``TEST.BATCH`` images followed by
Dice evaluation.  The results are printed and appended, with the weights'
path, as one JSON line to ``OUTPUT_DIR/result_ap.txt``.

It runs on CUDA unless ``--device cpu`` is given, with TF32 off for
convolutions and matrix products, in float32 only: ``TPU.PRECISION``
defaults to ``"bfloat16"`` as in the JAX package, and the port refuses it
until the bf16 policy is ported, so pass ``TPU.PRECISION float32``.
Training and multi-machine runs are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import torch


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
    p.add_argument("--dist-url", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the plain versions "
                        "of the kernels)")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the command line ``argv`` (``sys.argv[1:]`` when None); returns
    the results of the eval-only run."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    if args.num_machines > 1 or args.dist_url:
        raise NotImplementedError("multi-machine runs are not ported to ttdg_mgm_torch yet "
                                  "(ROADMAP.md, Queue 1: data parallelism)")
    if not args.eval_only:
        raise NotImplementedError("training is not ported to ttdg_mgm_torch yet (ROADMAP.md, "
                                  "Queue 1: the source train loop); pass --eval-only")

    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.config import setup_cfg
    from ttdg_mgm_torch.data.builtin import register_all_medical

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = setup_cfg(args.config_file, args.opts)
    register_all_medical(args.datasets_root or cfg.DATASETS.ROOT, force=True)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    trainer = build_trainer(cfg, device=args.device)
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
        draw_dir=cfg.OUTPUT_DIR if cfg.TEST.DRAW else None,
    )
    with open(os.path.join(cfg.OUTPUT_DIR, "result_ap.txt"), "a") as f:
        f.write(json.dumps({"weights": cfg.MODEL.WEIGHTS, "results": results}) + "\n")
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    try:
        main()
    except NotImplementedError as e:
        print(f"train_net_torch: {e}", file=sys.stderr)
        sys.exit(2)
