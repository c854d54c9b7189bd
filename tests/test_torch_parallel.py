"""Data parallelism of the port (``ttdg_mgm_torch/parallel/``) against the
JAX package's data mesh (CPU): the source and TTA steps, and the world's
invariants.  ``tests/test_torch_parallel_mt.py`` holds the mean-teacher
steps the same way; ``tests/torch_parallel_setup.py`` names the model,
the weights and the batches.

Two gloo ranks (``multihost.launch``: spawned processes, a ``file://``
store under ``tmp_path``, the whole run bounded by ``RANK_TIMEOUT_S``) each
take the step from the same weights on their half of a 4-image batch, with
the explicit reduction of the gradients and the losses.  They are held
against:

* JAX's ``make_source_step`` and ``make_tta_step`` on a 2-device mesh of
  the conftest's virtual CPU devices (``shard_map``; shard ``i``'s key is
  ``fold_in(rng, i)``), the port's ranks fed each shard's JAX uniforms:
  the losses at ``rtol 2e-4, atol 1e-5`` and the parameters after the step
  at ``rtol 5e-3, atol 5e-5`` (``tests/test_parallel.py``'s tolerances),
  and the averaged gradients (JAX's from its momentum trace) within 1e-3
  of each leaf's largest, which a rank's own shard's gradient misses
  (the TTA loss's gradient is 0 in JAX at this size);
* one process that computes both shards' gradients and losses and averages
  them, ``(a + b) / 2`` (``torch_parallel_worker.shard_average``): bit for
  bit, on both ranks.

Also: a process group of one rank gives the no-group step bit for bit, with
the reduction run; a batch the world does not divide raises with JAX's
message; a ``model`` axis above 1 in ``TPU.MESH_SHAPE`` raises; on a
machine with two GPUs (mocked), ``--device cuda`` starts a process per GPU
and ``--device cuda:0`` one process on that GPU.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import os

import pytest
import torch

import torch_parallel_setup as setup
import torch_parallel_worker as worker
import train_net_torch
from ttdg_mgm_torch.build import local_data_ranks
from ttdg_mgm_torch.config import get_cfg
from ttdg_mgm_torch.parallel import mesh as tmesh
from ttdg_mgm_torch.parallel import multihost

KINDS = ("source", "tta")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    return setup.run(tmp_path_factory.mktemp("dp"), KINDS)


def test_ranks_joined_one_world(dp_run):
    assert [r["world"] for r in dp_run["ranks"]] == [(2, 0), (2, 1)]
    for r in dp_run["ranks"]:
        assert r["gathered"] == [{"rank": 0}, {"rank": 1}]


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_equal_the_shard_average_bit_for_bit(dp_run, kind):
    setup.check_shard_average(dp_run, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_the_jax_mesh(dp_run, kind):
    setup.check_jax_mesh(dp_run, kind)
    if kind == "tta":
        assert dp_run["jax"]["tta"]["metrics"]["loss"] > 0, "matching inactive"


def test_indivisible_batch_raises(dp_run):
    for r in dp_run["ranks"]:
        assert "global batch 3 not divisible by data-mesh size 2" in r["indivisible"]


def test_world_of_one_equals_no_group_bit_for_bit(dp_run, tmp_path):
    """A process group of one rank runs the reduction (a sum over one rank,
    divided by 1): the source step's losses and weights equal the no-group
    step's bit for bit."""
    inputs = dp_run["inputs"]
    draws = {k: torch.cat([d[k] for d in inputs["draws"]["source"]]) for k in ("rpn", "roi")}

    def one():
        state = worker.setup(inputs, "source")
        m, _ = worker.run_step(inputs, "source", state, inputs["batches"]["source"], draws)
        return m, state[0].state_dict()

    plain_m, plain_p = one()
    calls = []
    real = tmesh.all_reduce_mean
    multihost.initialize_multihost(f"file://{tmp_path / 'store'}", device="cpu", timeout_s=60)
    try:
        tmesh.all_reduce_mean = lambda ts: calls.append(len(ts)) or real(ts)
        assert tmesh.world_size() == 1 and tmesh.active()
        group_m, group_p = one()
    finally:
        tmesh.all_reduce_mean = real
        multihost.shutdown()
    assert calls and calls[0] > len(plain_m), "the reduction did not run"
    for k, v in plain_m.items():
        assert torch.equal(group_m[k], v), k
    for k, v in plain_p.items():
        assert torch.equal(group_p[k], v), k


@pytest.mark.parametrize("shape", [[1, 2], [2, 4], [1, 1, 1]])
def test_model_axis_raises(shape):
    cfg = get_cfg()
    cfg.TPU.MESH_SHAPE = shape
    with pytest.raises(ValueError, match="TPU.MESH_SHAPE"):
        local_data_ranks(cfg, "cpu")


@pytest.mark.parametrize("shape,want", [([-1], 1), ([2], 2), ([3, 1], 3), ([], 1)])
def test_data_ranks_on_the_cpu(shape, want):
    cfg = get_cfg()
    cfg.TPU.MESH_SHAPE = shape
    assert local_data_ranks(cfg, "cpu") == want


@pytest.fixture
def two_gpus(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)


@pytest.mark.parametrize("device,shape,want", [("cuda", [-1], 2), ("cuda", [1], 1),
                                               ("cuda:0", [-1], 1), ("cuda:1", [1], 1)])
def test_data_ranks_on_two_gpus(two_gpus, device, shape, want):
    cfg = get_cfg()
    cfg.TPU.MESH_SHAPE = shape
    assert local_data_ranks(cfg, device) == want


def test_a_named_gpu_refuses_several_ranks(two_gpus):
    cfg = get_cfg()
    cfg.TPU.MESH_SHAPE = [2]
    with pytest.raises(ValueError, match="TPU.MESH_SHAPE"):
        local_data_ranks(cfg, "cuda:0")


@pytest.mark.parametrize("device,spawned", [("cuda", 2), ("cuda:0", None)])
def test_cli_processes_on_two_gpus(two_gpus, monkeypatch, device, spawned):
    """``train_net_torch.main`` spawns one rank per GPU for ``cuda``, and
    runs a named GPU in its own process (the run itself is stubbed)."""
    seen = {}

    def launch(fn, local, *, args, **kw):
        seen.update(local=local)
        args[1].put(None)  # the main rank's result

    monkeypatch.setattr(multihost, "launch", launch)
    monkeypatch.setattr(train_net_torch, "run", lambda args: seen.update(run=args.device))
    config = os.path.join(REPO, "configs", "seg_res50fpn_source.yaml")
    train_net_torch.main(["--config", config, "--device", device])
    assert seen == ({"local": spawned} if spawned else {"run": device})
