"""``train_net_torch.py`` data-parallel on the CPU: ``--device cpu
--dist-url file://... TPU.MESH_SHAPE [2]`` starts two gloo ranks
(``torch.multiprocessing.spawn``) that share every batch, at the small size
of tests/test_torch_train_cli.py and tests/test_torch_ateacher_cli.py on
the miniature Drishti-GS split.  Source training (``--num-machines 1
--machine-rank 0`` given), ``--eval-only`` on its final file, and the
mean-teacher trainer without and with ``SEMISUPNET.CROSS_DOMAIN_MATCHING``
run to their end; only the main process writes the checkpoints,
``metrics.json`` and ``result_ap.txt``; each run's ranks, rendezvous and
collectives are bounded by ``TIMEOUT_S`` (given to ``multihost.launch``).
Several machines without ``--dist-url`` raise."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import functools
import json
import os

import numpy as np
import pytest
import torch

import train_net_torch
from torch_port_fixture import cli_args, write_mini_split
from ttdg_mgm_torch.parallel import multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = ["MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
          "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]
TIMEOUT_S = 240.0


@pytest.fixture(autouse=True)
def bounded(monkeypatch):
    """A hung rank fails its test instead of running on."""
    monkeypatch.setattr(multihost, "launch",
                        functools.partial(multihost.launch, timeout_s=TIMEOUT_S))


def _dp(tmp_path, name):
    """The flags of a 2-rank run (put before the config's overrides)."""
    return ["--dist-url", f"file://{tmp_path / name}"]


MESH = ["TPU.MESH_SHAPE", "[2]"]


def _train_args(root, out, config):
    args = cli_args(root, out)
    args = args[args.index("--device"):]
    args[args.index("--config") + 1] = os.path.join(REPO, "configs", config)
    return args + NARROW + ["MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64"]


def test_source_train_then_eval_only(tmp_path):
    root = write_mini_split(tmp_path / "data")
    out = tmp_path / "out"
    args = _train_args(root, out, "seg_res50fpn_source.yaml") + [
        "DATASETS.TRAIN", '["Drishti_GS_test"]', "MODEL.ROI_HEADS.NUM_CLASSES", "2",
        "SOLVER.IMS_PER_BATCH", "2", "SOLVER.MAX_ITER", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
        "TEST.EVAL_PERIOD", "2", "INPUT.MIN_SIZE_TRAIN", "(56, 64)"]
    res = train_net_torch.main(["--num-machines", "1", "--machine-rank", "0",
                                *_dp(tmp_path, "store_train"), *args, *MESH])
    ckdir = out / "checkpoints"
    assert res["iteration"] == 2 and res["checkpoint"] == str(ckdir / "model_0000002.pth")
    assert sorted(os.listdir(ckdir)) == ["last_checkpoint", "model_0000001.pth",
                                         "model_0000002.pth"]
    assert [it for it, _ in res["validation_loss"]] == [2]
    assert np.isfinite(res["validation_loss"][0][1])
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [1]  # one writer: the main process
    assert all(np.isfinite(v) for k, v in lines[0].items() if k.startswith("loss"))
    saved = torch.load(res["checkpoint"], weights_only=False)
    assert saved["iteration"] == 2

    ev = cli_args(root, tmp_path / "eval") + NARROW + ["MODEL.WEIGHTS", res["checkpoint"]]
    results = train_net_torch.main([*_dp(tmp_path, "store_eval"), *ev, *MESH])
    r = results["Drishti_GS_test"]
    assert len(r) == 3 and all(np.isfinite(v) for v in r.values())
    written = (tmp_path / "eval" / "result_ap.txt").read_text().splitlines()
    assert len(written) == 1 and json.loads(written[0])["results"] == results


@pytest.mark.parametrize("cross_domain", [False, True])
def test_mean_teacher_train(tmp_path, cross_domain):
    root = write_mini_split(tmp_path / "data")
    out = tmp_path / "out"
    args = _train_args(root, out, "seg_res50fpn_MT.yaml") + [
        "DATASETS.TRAIN_LABEL", '["Drishti_GS_test"]', "DATASETS.TRAIN_UNLABEL",
        '["Drishti_GS_test"]', "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.MAX_ITER", "3",
        "SEMISUPNET.BURN_UP_STEP", "1", "SEMISUPNET.BBOX_THRESHOLD", "0.0",
        "SOLVER.CHECKPOINT_PERIOD", "2", "SEMISUPNET.CROSS_DOMAIN_MATCHING", str(cross_domain)]
    res = train_net_torch.main([*_dp(tmp_path, "store"), *args, *MESH])
    assert res["iteration"] == 3
    assert sorted(os.listdir(out / "checkpoints")) == ["last_checkpoint", "model_0000002.pth",
                                                      "model_0000003.pth"]
    lines = [json.loads(x) for x in (out / "metrics.json").read_text().splitlines()]
    assert [x["iteration"] for x in lines] == [2]
    assert np.isfinite(lines[-1]["loss_cls_pseudo"])
    assert ("loss_cross_matching" in lines[-1]) == cross_domain


def test_several_machines_need_a_dist_url(tmp_path):
    with pytest.raises(ValueError, match="--dist-url"):
        train_net_torch.main(["--num-machines", "2", *cli_args(tmp_path, tmp_path / "out")])
