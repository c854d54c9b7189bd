"""The port's exit test: test-time adaptation raises Dice through the port's
own entry points, as ``tests/test_tta_improves_dice.py`` shows it for the
JAX package.

The same A/B: the committed golden fixture weights (through the weight
bridge), the same domain-shifted target (``scripts/demo_tta_gain.py``,
``DEMO`` settings), ``BaselineTrainer.test`` with ``ttt=False`` and with
``ttt=True`` (one SGD step on the matching loss per batch of 4), on the CPU.
With ``ttt=False`` nothing adapts and the weights are the same, so Dice, E
and S equal the JAX package's.  With ``ttt=True`` both packages' Dice are
printed, not compared: the GA-GM solver's LAP finale does not converge on
this input (``ROADMAP.md`` Queue 3), so float32 round-off lets the two
trajectories part.

Then ``train_net_torch.py --eval-only --device cpu`` in a subprocess on the
miniature dataset and overrides of ``tests/test_cli.py``, and its refusal
of the default bf16 precision.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from ttdg_mgm_tpu.data.catalog import DatasetCatalog as JCatalog
from ttdg_mgm_tpu.data.coco import register_coco_instances as jregister
from ttdg_mgm_tpu.engine.trainer import BaselineTrainer as JTrainer
from ttdg_mgm_tpu.solver.build import build_optimizer as jbuild_optimizer
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.data.coco import register_coco_instances as tregister
from ttdg_mgm_torch.engine.trainer import BaselineTrainer
from ttdg_mgm_torch.solver.build import build_optimizer

from demo_config import DEMO  # noqa: E402
from torch_port_fixture import (cli_args, jax_model_and_params, port_model,  # noqa: E402
                                write_mini_split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
METRICS = ("Dice Coefficient", "Enhanced Alignment Metric", "Structural Similarity Metric")
#: the ttt=False metrics of the two packages, in points
OFF_TOL = 0.02


@pytest.fixture(scope="module")
def shifted_target(tmp_path_factory):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    from demo_tta_gain import make_shifted_target

    root = str(tmp_path_factory.mktemp("torch_tta_gain"))
    jp, img_dir = make_shifted_target(root, DEMO["test_images"], size=DEMO["size"],
                                      seed=DEMO["seed"], blur=DEMO["blur"],
                                      brightness=DEMO["brightness"])
    name = "_torch_tta_gain_target"
    for cat, reg in ((TCatalog, tregister), (JCatalog, jregister)):
        cat.remove(name)
        reg(name, jp, img_dir)
    yield name
    TCatalog.remove(name)
    JCatalog.remove(name)


def _port_trainer(params):
    model = port_model(params)
    size = DEMO["size"]
    return BaselineTrainer(model, build_optimizer(model, lambda _: DEMO["tta_lr"]),
                           min_size=size, max_size=size, test_canvas=size)


def _jax_trainer(model, params):
    import jax
    import jax.numpy as jnp

    size = DEMO["size"]
    return JTrainer(model, jbuild_optimizer(params, lambda _: DEMO["tta_lr"]),
                    jax.tree.map(jnp.asarray, params), canvas=size, min_size=size,
                    max_size=size, test_canvas=size)


def test_torch_tta_improves_dice(shifted_target):
    jmodel, params = jax_model_and_params()
    thr = DEMO["dice_threshold"]
    name = shifted_target

    off = _port_trainer(params).test([name], ttt=False, dice_threshold=thr)[name]
    tr = _port_trainer(params)
    on = tr.test([name], ttt=True, tta_batch=4, dice_threshold=thr)[name]
    j_off = _jax_trainer(jmodel, params).test([name], ttt=False, dice_threshold=thr)[name]
    jtr = _jax_trainer(jmodel, params)
    j_on = jtr.test([name], ttt=True, tta_batch=4, dice_threshold=thr)[name]

    d_off, d_on = off["Dice Coefficient"], on["Dice Coefficient"]
    print(f"\nport: Dice {d_off:.4f} (ttt=False) -> {d_on:.4f} (ttt=True), last TTA loss "
          f"{tr.last_tta_loss:.5f}")
    print(f"JAX:  Dice {j_off['Dice Coefficient']:.4f} (ttt=False) -> "
          f"{j_on['Dice Coefficient']:.4f} (ttt=True), last TTA loss {jtr.last_tta_loss:.5f}")
    print(f"ttt=False E {off[METRICS[1]]:.4f} / {j_off[METRICS[1]]:.4f}, "
          f"S {off[METRICS[2]]:.4f} / {j_off[METRICS[2]]:.4f} (port / JAX)")
    assert all(np.isfinite(v) for r in (off, on) for v in r.values()), (off, on)
    assert tr.last_tta_loss > 0.0, "TTA matching inactive on the target set"
    for m in METRICS:
        assert abs(off[m] - j_off[m]) <= OFF_TOL, (m, off[m], j_off[m])
    assert d_on >= d_off + DEMO["min_gain"], (
        f"TTA did not improve Dice: {d_off:.2f} -> {d_on:.2f} "
        f"(required margin {DEMO['min_gain']})")


@pytest.fixture(scope="module")
def cli_dataset_root(tmp_path_factory):
    return write_mini_split(tmp_path_factory.mktemp("torch_medroot"))


def _run_cli(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, os.path.join(REPO, "train_net_torch.py"), *args],
                          capture_output=True, text=True, timeout=600, env=env, cwd=REPO)


def test_cli_eval_only_cpu(cli_dataset_root, tmp_path):
    out_dir = tmp_path / "out"
    res = _run_cli(cli_args(cli_dataset_root, out_dir))
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads((out_dir / "result_ap.txt").read_text().strip().splitlines()[-1])
    assert rec["weights"] is None
    assert {"Drishti_GS_test", "Drishti_mean"} <= set(rec["results"])
    assert set(rec["results"]["Drishti_GS_test"]) == set(METRICS)
    assert "Total inference time" in res.stderr


def test_cli_refuses_bf16_default(cli_dataset_root, tmp_path):
    """``TPU.PRECISION`` defaults to bfloat16, which ``main`` refuses with a
    message naming the override (the script prints it and exits with code
    2), writing no result."""
    import train_net_torch

    out_dir = tmp_path / "out"
    with pytest.raises(NotImplementedError, match="TPU.PRECISION float32"):
        train_net_torch.main(cli_args(cli_dataset_root, out_dir, precision=False))
    assert not (out_dir / "result_ap.txt").exists()


def test_adaptation_persists_or_resets_across_datasets(cli_dataset_root, tmp_path):
    """The adaptation persists across the datasets of one ``test`` call (the
    second dataset starts from the first's adapted weights, momentum and
    step count), unless ``reset_between_datasets`` restores all three before
    each dataset: then every dataset gives what it gives alone."""
    import torch

    import train_net_torch
    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.config import setup_cfg

    args = train_net_torch.parse_args(cli_args(cli_dataset_root, tmp_path / "out"))
    cfg = setup_cfg(args.config_file, args.opts)
    jp = os.path.join(cli_dataset_root, "Fundus", "Drishti_GS_test.json")
    img_dir = os.path.join(cli_dataset_root, "Fundus", "Drishti_GS", "test", "image")
    names = ("_reset_a", "_reset_b")
    for n in names:
        TCatalog.remove(n)
        tregister(n, jp, img_dir)

    def run(datasets, reset):
        tr = build_trainer(cfg, device="cpu")
        res = tr.test(datasets, ttt=True, tta_batch=2, min_batch_num=1, dice_threshold=0.0,
                      reset_between_datasets=reset)
        return tr, res

    try:
        one, res_one = run(names[:1], False)
        reset, res_reset = run(names, True)
        kept, _ = run(names, False)
    finally:
        for n in names:
            TCatalog.remove(n)
    assert (one.optimizer.count, reset.optimizer.count, kept.optimizer.count) == (1, 1, 2)
    sd_one, sd_reset = one.model.state_dict(), reset.model.state_dict()
    assert all(torch.equal(sd_one[k], sd_reset[k]) for k in sd_one)

    def momentum(tr):
        return [tr.optimizer.sgd.state[p]["momentum_buffer"] for p in tr.optimizer.params]

    assert all(torch.equal(a, b) for a, b in zip(momentum(one), momentum(reset)))
    # the kept state took a second step, which moved the buffers
    assert not all(torch.equal(a, b) for a, b in zip(momentum(one), momentum(kept)))
    assert res_reset[names[0]] == res_reset[names[1]] == res_one[names[0]]
