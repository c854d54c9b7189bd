#!/usr/bin/env python3
"""Time the port's kernel wrappers on one NVIDIA GPU, for comparing two
versions of the package inside one run on one card.

    python3 scripts/time_kernels.py [--root DIR] [--gagm-input FILE] [--tag NAME]

``--root`` is a directory that holds the ``ttdg_mgm_torch`` package to time
(default: this repository).  To compare a commit with the working tree,
unpack it beside the tree and run the script on both in turns:

    mkdir -p _ab/parent && git archive <commit> ttdg_mgm_torch | tar -x -C _ab/parent
    for r in _ab/parent . . _ab/parent; do python3 scripts/time_kernels.py --root $r; done

Timed, by CUDA events after a warm-up, at the shapes ``chip_smoke.py`` uses
(its generators make the inputs): the ROI pool wrapper at the TTA shapes
(4 x 1000 ROIs at P=7, 4 x 100 at P=14) and the training shapes (8 x 512,
8 x 128), the pool's backward wrapper at the training shapes, and the fused
GA-GM solver on the three planted problems and, with ``--gagm-input`` (the
file ``chip_smoke.py --dump-dir`` writes), on the first input a TTA step gave
it, with the steps per round and a checksum of the result.  Prints one JSON
line; every time is milliseconds per call, the card's name and power limit
beside them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--gagm-input", default=None)
    ap.add_argument("--tag", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)   # chip_smoke's input generators
    sys.path.insert(0, root)   # the package under test, found first
    import chip_smoke as cs
    from ttdg_mgm_torch.ops import _cuda
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_backward
    from ttdg_mgm_torch.synth import planted_matching_problem

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                           "-i", "0"], capture_output=True, text=True, timeout=60).stdout.strip()
    _cuda.lib()
    res = {"tag": args.tag or os.path.relpath(root, HERE), "card": card,
           "build_s": round(_cuda.build_seconds, 1)}

    for label, seed, B, shapes, make in (
            ("tta", 1, 4, (("box", 1000, 7), ("mask", 100, 14)), cs.make_rois),
            ("train", 2, 8, (("box", 512, 7), ("mask", 128, 14)), cs.make_train_rois)):
        gen = torch.Generator().manual_seed(seed)
        feats = [torch.randn((B, 800 // s, 800 // s, 256), generator=gen).to(dev)
                 for s in (4, 8, 16, 32)]
        lshapes = [(f.shape[1], f.shape[2]) for f in feats]
        for name, K, P in shapes:
            rois = make(torch, gen, B, K, 800).to(dev)
            res[f"roi_pool_{label}_{name}_ms"] = cs.event_ms(
                torch, lambda: multilevel_roi_pool(feats, rois, output_size=P), 50)
            if label == "train":
                g = torch.randn((B, K, P, P, 256), generator=gen).to(dev)
                res[f"roi_pool_backward_{name}_ms"] = cs.event_ms(
                    torch, lambda: multilevel_roi_pool_backward(g, lshapes, rois), 20)
                del g
        del feats
        torch.cuda.empty_cache()

    def checksum(out):
        idx = torch.arange(out.numel(), device=dev).reshape(out.shape) % 977
        return float((out.double() * idx).sum())

    cases = (("G4_M60", 4, 60, 32, [60, 52, 30, 45]), ("G2_M60", 2, 60, 32, [60, 28]),
             ("G4_ms_le_univ", 4, 60, 32, [32, 20, 28, 32]))
    for seed, (name, G, n, univ, ms) in enumerate(cases):
        A, W, U0, ms, _ = planted_matching_problem(G, n, univ, ms, seed=seed)
        targs = [torch.from_numpy(x).to(dev) for x in (A, W, U0, ms)]
        out, steps = ga_gm_fused(*targs, univ, lap_iter_cap=200, return_steps=True, **cs.GAGM_KW)
        res[f"gagm_{name}_ms"] = cs.event_ms(
            torch, lambda: ga_gm_fused(*targs, univ, lap_iter_cap=200, **cs.GAGM_KW), 10)
        res[f"gagm_{name}_steps"] = steps
        res[f"gagm_{name}_checksum"] = checksum(out)
    if args.gagm_input:
        A, W, U0, ms, nu, kw = torch.load(args.gagm_input)[0]
        targs = [t.to(dev) for t in (A, W, U0, ms)]
        out, steps = ga_gm_fused(*targs, nu, return_steps=True, **kw)
        res["gagm_main_ms"] = cs.event_ms(torch, lambda: ga_gm_fused(*targs, nu, **kw), 10)
        res["gagm_main_steps"] = steps
        res["gagm_main_checksum"] = checksum(out)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
