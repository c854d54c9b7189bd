"""The readings a cell's limits are set from, at the cell's own size on the
card; the benchmark's own runs do not run them.

* The control: the plain reference computed one precision step below the
  configuration's (float8 inputs and weights where the configuration states
  bf16), put in the program's place and compared with the reference as a
  run compares the program.
* ``--fault``: the bf16 reference with a fault planted at a choice point
  (:data:`FAULTS`) in the program's place.
* ``--program``: the program's own runs (set-up, a window of ``--seconds``,
  the comparison), one per seed in one process, with ``--plant`` a fault
  planted in the program (:data:`PROGRAM_FAULTS`): the sound runs' numbers
  and the faults' as the harness reads them; with ``--choosers`` (a TTA
  cell) only set-up and the matching's numbers, ``match_gap`` and
  ``finale_gap``, with no window and no reference.
* ``--nudge``: the reference against itself with every weight moved by one
  float32 ulp, following the first's decisions: how far a last-bit
  difference alone moves each number, leaf by leaf.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [mode]

prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import functools
import importlib
import json
import shutil
import sys
import tempfile
import time

from decisions import perturb_projection, shift_assignments


#: planted faults, by name: the choice point each alters, and how
FAULTS = {"matching": {"U": shift_assignments}, "sinkhorn": {"sk": perturb_projection}}


# -- faults planted in the program, each through ``patch(owner, name, value)`` --

def _no_update(patch):
    """A step that returns its state unchanged: the optimizer steps on
    nothing."""
    from ttdg_mgm_torch.solver.build import Optimizer

    patch(Optimizer, "step", lambda self: setattr(self, "count", self.count + 1))


def _altered_projection(patch):
    """HiPPI's Sinkhorn projection's answer altered where it is produced
    (kernel D's output rows rolled by one)."""
    from ttdg_mgm_torch.graph import solvers

    real = solvers.sinkhorn_batched

    def project(*a, **kw):
        return perturb_projection(real(*a, **kw))

    patch(solvers, "sinkhorn_batched", functools.update_wrapper(project, real))


def _half_batch(patch):
    """Half of the batch left out: the step sees the first half only, and
    its losses are the mean over it."""
    from ttdg_mgm_torch.parallel import mesh

    def first_half(batch):
        return {k: v[:max(len(v) // 2, 1)] for k, v in batch.items()}

    patch(mesh, "shard_batch", first_half)


def _altered_answer(patch):
    """An answer altered where it is produced: every detection's score
    raised by 0.05 in the pasted output."""
    from ttdg_mgm_torch.engine import trainer as trainer_mod

    real = trainer_mod.postprocess_detections

    def post(*a, **kw):
        out = real(*a, **kw)
        out["scores"] = out["scores"] + 0.05
        return out

    patch(trainer_mod, "postprocess_detections", post)


def _altered_matching(patch):
    """The matching's answer altered where it is produced: each graph's
    GA-GM assignments moved one node on."""
    from ttdg_mgm_torch.graph import mgm
    from ttdg_mgm_torch.ops import gagm

    real = gagm.ga_gm_fused

    def solve(*a, **kw):
        return shift_assignments(real(*a, **kw), *a)

    # the kernel reads its launch counter through the name it takes
    functools.update_wrapper(solve, real)
    patch(mgm, "ga_gm_fused", solve)
    patch(gagm, "ga_gm_fused", solve)


#: faults planted in the program, by name
PROGRAM_FAULTS = {f.__name__: f for f in (_no_update, _altered_projection, _half_batch,
                                          _altered_answer, _altered_matching)}


def _choosers(spec, seed: int, device, log) -> dict:
    """A TTA cell's set-up, then its matching's numbers on the steps set-up
    took, against the program's kernel B."""
    from datagen import write_traffic
    from harness import Run
    from jobs.common import free_program
    from ttdg_mgm_torch.ops import gagm

    job = importlib.import_module("jobs." + spec.job)
    root = tempfile.mkdtemp(prefix="bench_choosers_")
    try:
        run = Run(spec, seed, device, False, root, log)
        write_traffic(root, spec.traffic, run.data_seed)
        run.make_weights()
        job.setup(run)
        got = run.state["got"]
        free_program(run)
        job.check_choosers(got, device, solve=gagm.ga_gm_fused)
        return {"match_gap": got["match"], "finale_gap": got["finale"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def program_numbers(spec, seed: int, device, seconds: float, log=print,
                    plant: str | None = None, choosers: bool = False) -> dict:
    """One run of the program through the harness (or, with ``choosers``,
    :func:`_choosers`), with the fault ``plant`` (a key of
    :data:`PROGRAM_FAULTS`) planted for its length."""
    from harness import execute

    undo = []

    def patch(owner, name, value):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    try:
        if plant:
            PROGRAM_FAULTS[plant](patch)
        if choosers:
            return _choosers(spec, seed, device, log)
        result = execute(spec, seed, seconds, False, device, time.perf_counter(), log=log)
    finally:
        for owner, name, value in reversed(undo):
            setattr(owner, name, value)
    return {"correct": result["correct"], "checks": result["checks"]}


def nudge_numbers(spec, seed: int, device, log=print) -> dict:
    """The reference against itself with every float weight moved one ulp
    up, following the first's decisions: the loss and first-gradient gaps,
    and the change's worst and median leaves with the four widest named."""
    import torch

    import compare
    from datagen import write_traffic
    from harness import Run

    job = importlib.import_module("jobs." + spec.job)
    root = tempfile.mkdtemp(prefix="bench_nudge_")
    try:
        run = Run(spec, seed, device, False, root, log)
        write_traffic(root, spec.traffic, run.data_seed)
        run.make_weights()
        w = run.weights
        a = job.reference(run)
        run.weights = {k: torch.nextafter(v, torch.full_like(v, float("inf")))
                       if v.is_floating_point() else v for k, v in w.items()}
        b = job.reference(run, follow=a)
        keep = compare.moving_leaves(a["grad"], run.cfg["SOLVER"]["WEIGHT_DECAY"], w)
        ca = compare.change(a["params"], w)
        cb = compare.change(b["params"], {k: run.weights[k] for k in b["params"]})
        gaps = compare.leaf_gaps(cb, ca, keep)
        return {"loss_gap": compare.loss_gap(b["losses"], a["losses"]),
                "grad_gap": compare.worst_leaf(b["grad"], a["grad"], keep),
                "worst_change_gap": gaps[0][1],
                "median_change_gap": compare.median_leaf(cb, ca, keep),
                "widest": [[k, v] for k, v in gaps[:4]]}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def control_numbers(spec, seed: int, device, log=print, fault: str | None = None) -> dict:
    """The control's numbers for ``spec`` at ``seed``; with ``fault``
    (a key of :data:`FAULTS`: ``"matching"`` in a TTA cell, ``"sinkhorn"``
    in a source cell) the bf16 reference with that fault planted at its
    choice point stands in the program's place instead."""
    from datagen import write_traffic
    from harness import Run

    job = importlib.import_module("jobs." + spec.job)
    root = tempfile.mkdtemp(prefix="bench_control_")
    try:
        run = Run(spec, seed, device, False, root, log)
        write_traffic(root, spec.traffic, run.data_seed)
        run.make_weights()
        alter = FAULTS[fault] if fault else None
        low = job.reference(run, alter=alter) if fault else job.reference(run, fp8=True)
        job.check_choosers(low, device, alter)
        ref = job.reference(run, follow=low)
        return job.numbers(low, ref, run, log=log)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--fault", choices=sorted(FAULTS), default=None,
                      help="plant this fault in the reference instead of lowering its precision")
    mode.add_argument("--program", action="store_true",
                      help="run the program itself, with --plant's fault if given")
    mode.add_argument("--nudge", action="store_true",
                      help="the reference against itself with its weights moved one ulp")
    p.add_argument("--plant", choices=sorted(PROGRAM_FAULTS), default=None)
    p.add_argument("--choosers", action="store_true",
                   help="with --program in a TTA cell: set-up and the matching's numbers only")
    p.add_argument("--seconds", type=float, default=1.0, help="the window of --program's runs")
    args = p.parse_args(argv)
    import harness

    sys.path.insert(0, harness.ROOT)
    harness.set_cache_dirs(harness.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.Spec(args.workload)
    dev = torch.device("cuda", 0)
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    for seed in args.seeds:
        if args.program:
            out = {"plant": args.plant,
                   "program": program_numbers(spec, seed, dev, args.seconds, log, args.plant,
                                              args.choosers)}
        elif args.nudge:
            out = {"nudge": nudge_numbers(spec, seed, dev, log)}
        else:
            out = {"fault": args.fault,
                   "control": control_numbers(spec, seed, dev, log, fault=args.fault)}
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
