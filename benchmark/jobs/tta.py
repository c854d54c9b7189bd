"""The eval-only TTA job: ``BaselineTrainer.test`` as
``train_net_torch.py --eval-only`` calls it, over the cell's test split.

Set-up builds the trainer with ``build.py:build_trainer`` from the cell's
configuration, loads the benchmark's weights and runs one whole pass (one
TTA step per batch, then inference, paste and scoring of every image); that
pass is also what the reference follows: each TTA step's loss, the first
gradient the optimizer got, the parameters after the third step, and the
first batch's pasted detections.  The window repeats the pass, the weights
adapting on, as over a long test set.
"""

from __future__ import annotations

import time

import torch

import compare
from jobs.common import first_gradient, flop_counter, free_program, program_cfg, trainable

#: TTA steps the reference follows (the change is taken after the third)
FOLLOW = 3


def _images(run) -> int:
    return sum(s["n"] for s in run.traffic["splits"])


def _steps(run) -> int:
    return -(-_images(run) // run.cfg["TEST"]["BATCH"])


def _test(run):
    cfg = run.state["cfg"]
    return run.state["trainer"].test(
        cfg.DATASETS.TEST, ttt=cfg.TEST.TTT, tta_batch=cfg.TEST.BATCH,
        min_batch_num=cfg.TEST.MIN_BATCH_NUM, dice_threshold=cfg.TEST.DICE_THRES)


def setup(run) -> None:
    from ttdg_mgm_torch import configure_torch
    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.data.builtin import register_all_medical
    from ttdg_mgm_torch.engine import trainer as trainer_mod

    configure_torch()
    cfg = program_cfg(run.cfg)
    register_all_medical(run.data_root, force=True)
    trainer = build_trainer(cfg, device=run.device)
    trainer.model.load_state_dict({k: v.to(run.device) for k, v in run.weights.items()})
    run.state = {"cfg": cfg, "trainer": trainer}
    run.state["images_per_pass"] = _images(run)
    run.state["steps_per_pass"] = _steps(run)

    # the warm-up pass, which the reference follows afterwards
    from decisions import Decisions
    from ttdg_mgm_torch.graph import mgm as mgm_mod

    got = {"losses": [], "detections": {}}
    params = trainable(trainer)
    real_step = trainer._tta_step
    dec = Decisions([(trainer.model, "_box_inference", "det"), (mgm_mod, "ga_gm_fused", "U")],
                    keep_args=("U",))

    def step(batch):
        dec.begin()
        loss = real_step(batch)
        dec.end()
        got["losses"].append(float(loss))
        k = len(got["losses"])
        if k == 1:
            got["grad"] = first_gradient(trainer.optimizer.sgd, params)
        if k == FOLLOW:
            got["params"] = {n: p.detach().to("cpu", copy=True) for n, p in params.items()}
        return loss

    real_post = trainer_mod.postprocess_detections

    def post(det, meta, b, **kw):
        out = real_post(det, meta, b, **kw)
        if len(got["detections"]) < cfg.TEST.BATCH:
            got["detections"][meta["image_id"]] = out
        return out

    trainer._tta_step = step
    trainer_mod.postprocess_detections = post
    try:
        _test(run)
    finally:
        trainer._tta_step = real_step
        trainer_mod.postprocess_detections = real_post
        dec.close()
    got["steps"] = dec.steps
    run.state["got"] = got
    _instrument(run)


def _instrument(run) -> None:
    """The spans and captures of a traced run (no-ops otherwise)."""
    from ttdg_mgm_torch.data import loader as loader_mod
    from ttdg_mgm_torch.engine import trainer as trainer_mod
    from ttdg_mgm_torch.graph import mgm as mgm_mod
    from ttdg_mgm_torch.models import rcnn as rcnn_mod

    rec = run.recorder
    if not rec.on:
        return
    trainer = run.state["trainer"]
    dev = run.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else None
    rec.wrap(trainer, "_tta_step", "tta.step", sync=sync)
    rec.wrap(trainer.model, "forward_inference", "tta.inference", sync=sync)
    rec.wrap(loader_mod, "load_image", "decode")
    rec.wrap(trainer_mod, "postprocess_detections", "eval.paste")
    real_loader = trainer_mod.build_test_loader

    def timed_loader(*a, **kw):
        return rec.wrap_iter(real_loader(*a, **kw), "tta.loader_wait")

    rec.replace(trainer_mod, "build_test_loader", timed_loader)
    real_eval = trainer_mod.build_evaluator

    def evaluator(*a, **kw):
        ev, etype = real_eval(*a, **kw)
        rec.wrap(ev, "process", "eval.process", force=True)
        return ev, etype

    rec.replace(trainer_mod, "build_evaluator", evaluator)

    pools = run.work.setdefault("pools", [])
    real_pool = rcnn_mod.multilevel_roi_pool

    def pool(feats, rois, **kw):
        pools.append(([tuple(f.shape[:3]) for f in feats], feats[0].shape[-1],
                      rois.detach().clone(), kw.get("output_size", 7), feats[0].element_size()))
        return real_pool(feats, rois, **kw)

    rec.replace(rcnn_mod, "multilevel_roi_pool", pool)
    solves = run.work.setdefault("gagm_inputs", [])
    real_solve = mgm_mod.ga_gm_fused

    def solve(A, W, U0, ms, n_univ, **kw):
        if len(solves) < 2:
            solves.append((A.clone(), W.clone(), U0.clone(), ms.clone(), n_univ,
                           {k: v for k, v in kw.items() if k != "return_steps"}))
        return real_solve(A, W, U0, ms, n_univ, **kw)

    rec.replace(mgm_mod, "ga_gm_fused", solve)


def window(run, seconds: float) -> None:
    t0 = time.perf_counter()
    passes = 0
    while True:
        _test(run)
        passes += 1
        if time.perf_counter() - t0 >= seconds:
            break
    n = run.state["images_per_pass"]
    run.counts.update(images=passes * n, attempted=passes * n, failed=0, passes=passes,
                      tta_steps=passes * run.state["steps_per_pass"],
                      inference_batches=passes * run.state["steps_per_pass"])


def reference(run, fp8: bool = False, follow: dict | None = None, counter=None,
              alter=None) -> dict:
    """The plain reference over the first pass's steps, following the
    decisions of ``follow`` (the program's run) when it is given; ``alter``
    plants a fault in its GA-GM solutions."""
    from reference import cell

    cell.register(run.traffic, run.data_root)
    split = run.cfg["DATASETS"]["TEST"][0]
    return cell.run_tta(run.cfg, split, run.device, run.weights, steps=_steps(run), fp8=fp8,
                        follow=follow, counter=counter, alter=alter,
                        model_module=run.model_module)


def numbers(got: dict, ref: dict, run, log=None) -> dict:
    steps = [_step_scores(g["det"]["out"], r["det"]["out"])
             for g, r in zip(got["steps"], ref["steps"])]
    if log is not None:
        log(f"losses: got {got['losses']}, reference {ref['losses']}")
        log("widest gaps of the sorted scores: steps' detections "
            f"{[compare.score_gap(*s) for s in steps]!r}, the pass's first batch "
            f"{compare.score_gap(got['detections'], ref['detections'])!r}")
    p0 = {k: run.weights[k] for k in ref["grad"]}
    keep = compare.moving_leaves(ref["grad"], run.cfg["SOLVER"]["WEIGHT_DECAY"], p0)
    return {
        "det_gap": max(compare.score_distance(*s) for s in steps),
        "match_gap": got["match"],
        "finale_gap": got["finale"],
        "loss_gap": compare.loss_gap(got["losses"][:FOLLOW], ref["losses"][:FOLLOW]),
        "grad_gap": compare.worst_leaf(got["grad"], ref["grad"], keep),
        "change_gap": compare.worst_leaf(compare.change(got["params"], p0),
                                         compare.change(ref["params"], p0), keep),
        "score_gap": compare.score_distance(got["detections"], ref["detections"]),
        "mask_gap": compare.mask_gap(got["detections"], ref["detections"]),
    }


def _step_scores(got_det, ref_det):
    """Two steps' detections as ``{image: {"scores": ...}}`` for
    :func:`compare.score_distance`."""
    def per_image(det):
        _, scores, _, valid = det
        return {b: {"scores": scores[b][valid[b]].numpy()} for b in range(scores.shape[0])}

    return per_image(got_det), per_image(ref_det)


def match_gap(solve, choice: dict, device) -> float:
    """GA-GM's annealed rounds (``solve``: the program's kernel B, or
    another solver in its place) on a TTA step's own inputs, where they are
    well-posed: one annealed step at the last temperature from ``solve``'s
    own annealed ``U``, the largest gap of its soft assignments against the
    reference's plain GA-GM's step from the same ``U``.  The rounds as a
    whole are not: from the same ``U0`` the two solvers converged to
    assignments 0.93 apart on a sound run (NVIDIA H100), float32 summation
    order deciding between fixed points at low temperature; nor is the
    exact-LAP finale (:func:`finale_gap` checks what of it is)."""
    from reference.graph.solvers import anneal_taus, ga_gm

    args, kw = choice["args"]
    A, W, U0, ms, nu = (x.to(device) if torch.is_tensor(x) else x for x in args)
    kw = {k: v for k, v in kw.items() if k not in ("lap_iter_cap", "return_steps")}
    Ua, _ = solve(A, W, U0, ms, nu, return_steps=True, lap_iter_cap=0, **kw)
    taus = anneal_taus(kw["sk_tau0"], kw["sk_gamma"], kw["min_tau"])
    one = {**kw, "sk_tau0": taus[-1], "min_tau": taus[-1], "mgm_iter": 1}
    U1, _ = solve(A, W, Ua, ms, nu, return_steps=True, lap_iter_cap=0, **one)
    U1p, _ = ga_gm(A, W, Ua, ms, nu, return_steps=True, hung_iter_cap=0, **one)
    return float((U1 - U1p).abs().max())


def _partial_permutation(U, ms) -> bool:
    """Whether each graph's block of ``U (G*M, U)`` is an assignment: 0/1
    entries, at most one 1 in each row and each column, ``min(ms, U)`` of
    them, none in a row at or past ``ms``."""
    G = ms.shape[0]
    X = U.reshape(G, -1, U.shape[-1])
    if not bool(((X == 0) | (X == 1)).all()):
        return False
    for g in range(G):
        m = int(ms[g])
        if (X[g, m:] != 0).any() or (X[g].sum(0) > 1).any() or (X[g].sum(1) > 1).any():
            return False
        if int(X[g].sum()) != min(m, X.shape[-1]):
            return False
    return True


def finale_gap(solve, choice: dict, device) -> float:
    """GA-GM's exact-LAP finale (``solve``: the program's kernel B, or
    another solver in its place) where it is well-posed, on a TTA step's own
    inputs.  Its many steps are not (a flipped assignment changes every step
    after it), so: 1 when the step's answer, the pseudo-labels it trained
    on, is not an assignment (:func:`_partial_permutation`); else the LAP of
    one finale step from ``solve``'s own annealed ``U``: how far the
    objective of its answer under the reference's power step ``V`` at that
    ``U`` (float64) lies below the optimum of the reference's LAP of ``V``,
    over the optimum, at the worst graph.  In the two-graph case graph 0 is
    pinned to the identity on both sides and left out."""
    from reference.graph.solvers import _project_blocks

    args, kw = choice["args"]
    A, W, U0, ms, nu = (x.to(device) if torch.is_tensor(x) else x for x in args)
    if not _partial_permutation(choice["out"][0], ms.cpu()):
        return 1.0
    kw = {k: v for k, v in kw.items() if k not in ("lap_iter_cap", "return_steps")}
    Ua, _ = solve(A, W, U0, ms, nu, return_steps=True, lap_iter_cap=0, **kw)
    U1, _ = solve(A, W, Ua, ms, nu, return_steps=True, lap_iter_cap=1,
                  **{**kw, "mgm_iter": 0})
    G = ms.shape[0]
    A64, W64, Ua64 = A.double(), W.double(), Ua.double()
    V = ((A64 @ ((Ua64 @ Ua64.T) @ A64)) @ Ua64 * (kw["quad_weight"] * 2.0) + W64 @ Ua64) / G
    V = V.reshape(G, -1, nu)
    best = _project_blocks(V.float(), ms.long(), nu, tau=1.0, sk_iter=0, exact_hungarian=True)
    got = U1.reshape(G, -1, nu).double()
    gap = 0.0
    for g in range(1 if G == 2 else 0, G):
        opt = float((best[g].double() * V[g]).sum())
        gap = max(gap, (opt - float((got[g] * V[g]).sum())) / max(abs(opt), 1e-30))
    return gap


def check_choosers(got: dict, device, alter=None, solve=None) -> None:
    """The choosers of a run by themselves, into ``got``, on every step's
    GA-GM inputs: :func:`match_gap` and :func:`finale_gap`.  ``solve`` is
    the GA-GM under test (the program's kernel B; the reference's plain one,
    with the planted fault ``alter["U"]`` if any, in the control)."""
    if solve is None:
        from reference.ops.gagm import ga_gm_fused as solve
    fault = (alter or {}).get("U")

    def tested(A, W, U0, ms, nu, **kw):
        out = solve(A, W, U0, ms, nu, **kw)
        return fault(out, A, W, U0, ms) if fault else out

    choices = [rec["U"] for rec in got["steps"] if "U" in rec]
    got["match"] = max(match_gap(tested, c, device) for c in choices)
    got["finale"] = max(finale_gap(tested, c, device) for c in choices)


def check(run) -> dict:
    from ttdg_mgm_torch.ops import gagm

    got = run.state["got"]
    free_program(run)
    check_choosers(got, run.device, solve=gagm.ga_gm_fused)
    counter = flop_counter(run) if run.trace else None
    ref = reference(run, follow=got, counter=counter)
    if run.trace:
        _kernel_work(run)
    return numbers(got, ref, run, log=run.log)


def _kernel_work(run) -> None:
    """The window's kernel work from its captured inputs: kernel A's bytes
    per launch, kernel B's power steps on its first two inputs (solved again
    by the reference's plain GA-GM)."""
    from reference.graph.solvers import ga_gm
    from roofline import roi_pool_work

    run.work["pool_work"] = [roi_pool_work(shapes, C, rois, P, elem)
                             for shapes, C, rois, P, elem in run.work.pop("pools", [])]
    steps = []
    for A, W, U0, ms, n_univ, kw in run.work.pop("gagm_inputs", []):
        kw = {k: v for k, v in kw.items() if k != "return_steps"}
        cap = kw.pop("lap_iter_cap", 200)
        _, s = ga_gm(A, W, U0, ms, n_univ, hung_iter_cap=cap, return_steps=True, **kw)
        G = ms.shape[0]
        steps.append({"G": G, "M": A.shape[0] // G, "univ": n_univ, "steps": int(sum(s))})
    run.work["gagm"] = steps
