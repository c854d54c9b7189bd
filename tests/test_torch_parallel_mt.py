"""The mean-teacher step data-parallel (``ttdg_mgm_torch/parallel/``),
without and with the cross-domain head, against the JAX package's data
mesh (CPU), as ``tests/test_torch_parallel.py`` holds the source and TTA
steps (``tests/torch_parallel_setup.py`` names the model, the weights, the
batches and why the labelled seed).

Two gloo ranks take ``make_mt_step`` on their halves of the 4 + 4 image
batch (each rank's teacher pseudo-labels its own unlabelled images), fed
each JAX shard's uniforms and completion noise, and average the gradients,
the losses and the head's new class centers.  Against JAX's
``make_mt_step`` on a 2-device mesh: losses at ``rtol 2e-4, atol 1e-5``,
parameters and centers at ``rtol 5e-3, atol 5e-5``, the averaged
gradients within 1e-3 of each leaf's largest; against one process
averaging both shards: bit for bit, on both ranks.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import pytest

import torch_parallel_setup as setup

KINDS = ("mt", "mt_cd")


@pytest.fixture(scope="module")
def dp_run(tmp_path_factory):
    return setup.run(tmp_path_factory.mktemp("dp_mt"), KINDS)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_equal_the_shard_average_bit_for_bit(dp_run, kind):
    setup.check_shard_average(dp_run, kind)


@pytest.mark.parametrize("kind", KINDS)
def test_two_ranks_match_the_jax_mesh(dp_run, kind):
    setup.check_jax_mesh(dp_run, kind)
    m = dp_run["jax"][kind]["metrics"]
    assert m["loss_matching"] > 0 and m["loss_cls_pseudo"] > 0
    if kind == "mt_cd":
        assert all(m[k] > 0 for k in ("loss_node_cls", "loss_cross_matching"))
