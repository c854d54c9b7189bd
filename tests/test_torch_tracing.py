"""The port's tracer (``ttdg_mgm_torch/utils/profiling.py``) on the CPU: off
it records nothing and hands out one shared no-op; on, spans nest per
thread with their parent, key, ``perf_counter`` times, CPU seconds and
inclusive counts; the ``host_syncs`` hook counts every repeat of torch's
synchronising-call warning and prints none; an exception inside a span
still pops it.  End to end: an eval-only TTA pass and a source iteration on
tests/test_cli.py's miniature split give the same losses, weights and Dice,
bit for bit, with the tracer on and off, and leave every span of the
program with its key; the train loader's batches (tests/test_torch_train_loader.py's
split and seeds) are bit for bit the same on and off."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from ttdg_mgm_torch.data import loader as tloader
from ttdg_mgm_torch.data.catalog import DatasetCatalog as TCatalog
from ttdg_mgm_torch.data.coco import register_coco_instances as tregister
from ttdg_mgm_torch.utils import profiling

from test_torch_train_loader import FILES, _register, _write_split  # noqa: E402
from torch_port_fixture import cli_args, write_mini_split  # noqa: E402

#: the message torch's synchronising-call debug mode warns with
TORCH_SYNC = ("called a synchronizing CUDA operation (Triggered internally at "
              "/pytorch/c10/cuda/CUDAFunctions.cpp:158.)")


@pytest.fixture()
def tracer():
    """The tracer on, and off and drained afterwards whatever happens."""
    profiling.drain()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.disable()
        profiling.drain()


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing_and_hands_out_the_shared_noop():
    profiling.drain()
    assert profiling.span("a") is profiling.span("b", key=3) is profiling._NOOP
    with profiling.span("a"):
        profiling.count("host_syncs")
    assert profiling.drain() == []


def test_spans_nest_with_parent_key_and_inclusive_counts(tracer):
    with tracer.span("outer", key=7):
        tracer.count("n", 2)
        with tracer.span("inner", key="img"):
            tracer.count("n")
            tracer.count("m", 5)
        with tracer.span("inner2"):
            pass
    spans = _by_name(tracer.drain())
    outer, inner, inner2 = spans["outer"][0], spans["inner"][0], spans["inner2"][0]
    assert (outer["parent"], inner["parent"], inner2["parent"]) == (None, "outer", "outer")
    assert (outer["key"], inner["key"], inner2["key"]) == (7, "img", None)
    assert outer["counts"] == {"n": 3, "m": 5} and inner["counts"] == {"n": 1, "m": 5}
    assert inner2["counts"] == {}
    assert outer["t0"] <= inner["t0"] <= inner["t1"] <= inner2["t0"] <= outer["t1"]
    assert all(s["thread"] == threading.get_ident() for s in (outer, inner, inner2))


def test_times_are_perf_counter_and_cpu_seconds_tell_work_from_waiting(tracer):
    a = time.perf_counter()
    with tracer.span("sleep"):
        time.sleep(0.05)
    with tracer.span("work"):
        x = 0
        t = time.perf_counter()
        while time.perf_counter() - t < 0.05:
            x += 1
    b = time.perf_counter()
    spans = _by_name(tracer.drain())
    sleep, work = spans["sleep"][0], spans["work"][0]
    assert a <= sleep["t0"] < sleep["t1"] <= work["t0"] < work["t1"] <= b
    assert sleep["t1"] - sleep["t0"] >= 0.05 and work["t1"] - work["t0"] >= 0.05
    assert sleep["cpu_s"] < 0.5 * (sleep["t1"] - sleep["t0"])
    assert work["cpu_s"] > sleep["cpu_s"]


def test_each_thread_nests_on_its_own_stack(tracer):
    """A producer thread's spans, opened while the main thread holds one
    open, have their own parents, and its counts stay on its own spans."""
    started, release = threading.Event(), threading.Event()

    def producer():
        with tracer.span("data.sample", key=1):
            started.set()
            with tracer.span("data.decode"):
                tracer.count("bytes", 10)
            release.wait(5)

    with tracer.span("main"):
        th = threading.Thread(target=producer)
        th.start()
        assert started.wait(5)
        tracer.count("host_syncs")
        release.set()
        th.join(5)
    assert not th.is_alive()
    spans = _by_name(tracer.drain())
    sample, decode, main = spans["data.sample"][0], spans["data.decode"][0], spans["main"][0]
    assert sample["parent"] is None and decode["parent"] == "data.sample"
    assert sample["thread"] == decode["thread"] != main["thread"] == threading.get_ident()
    assert sample["counts"] == {"bytes": 10} and main["counts"] == {"host_syncs": 1}


def test_an_exception_inside_a_span_still_pops_it(tracer):
    with pytest.raises(ValueError):
        with tracer.span("outer"):
            with tracer.span("failing"):
                raise ValueError("boom")
    with tracer.span("after"):
        pass
    spans = _by_name(tracer.drain())
    assert spans["failing"][0]["parent"] == "outer"
    assert spans["after"][0]["parent"] is None
    assert profiling._stack() == []


def test_sync_hook_counts_every_repeat_and_prints_none():
    """Torch's synchronising-call warning, warned five times from one line
    under the default filter (which would show it once): five
    ``host_syncs`` and nothing shown; another warning is shown as before,
    and ``disable`` restores the warning handling."""
    profiling.drain()
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        show, filters = warnings.showwarning, list(warnings.filters)
        profiling.enable()
        try:
            with profiling.span("step"):
                for _ in range(5):
                    warnings.warn(TORCH_SYNC, UserWarning)
                warnings.warn("another warning", UserWarning)
        finally:
            profiling.disable()
        assert warnings.showwarning is show and warnings.filters == filters
        warnings.warn(TORCH_SYNC, UserWarning)
    (step,) = profiling.drain()
    assert step["counts"] == {"host_syncs": 5}
    assert [str(w.message) for w in shown] == ["another warning", TORCH_SYNC]


def test_prefetcher_spans_the_wait_and_the_blocked_producer(tracer):
    """A producer faster than its consumer blocks on the full queue
    (``data.blocked``, in its thread); the consumer's reads are
    ``data.wait``."""
    pf = tloader._Prefetcher(iter(range(4)), depth=1)
    time.sleep(0.2)
    got = list(pf)
    pf.close()
    assert got == [0, 1, 2, 3]
    spans = _by_name(tracer.drain())
    assert len(spans["data.wait"]) == 5
    assert {s["thread"] for s in spans["data.wait"]} == {threading.get_ident()}
    blocked = spans["data.blocked"]
    assert blocked and all(s["thread"] != threading.get_ident() for s in blocked)
    assert max(s["t1"] - s["t0"] for s in blocked) >= 0.1


#: every span of the program that the CPU passes below reach, with the
#: kind of key it carries (``setup.kernels`` needs the card)
KEYED = {"trainer.tta_step": "batch", "trainer.source_step": "iteration",
         "trainer.hooks": "iteration", "eval.inference": "batch", "eval.postprocess": "image",
         "eval.paste_masks": "image", "eval.to_host": "image", "eval.gt_masks": "image",
         "eval.score": "image", "eval.draw": "image", "data.sample": "image"}
UNKEYED = ("step.backbone", "step.proposals", "step.box_inference", "step.node_sampler",
           "step.matching", "step.gagm", "step.roi_heads", "step.universe", "step.backward",
           "step.optimizer", "data.decode", "data.resize", "data.annotations", "data.pack",
           "data.gt_raster", "data.wait", "setup.build_trainer", "setup.init_params")


@pytest.fixture(scope="module")
def mini_split(tmp_path_factory):
    root = write_mini_split(tmp_path_factory.mktemp("tracing_split"))
    name = "_tracing_mini"
    TCatalog.remove(name)
    tregister(name, os.path.join(root, "Fundus", "Drishti_GS_test.json"),
              os.path.join(root, "Fundus", "Drishti_GS", "test", "image"))
    yield root, name
    TCatalog.remove(name)


def _pass(root, name, draw_dir):
    """Build a trainer, train one source iteration, then one TTA pass with
    its evaluation: the losses, the weights and the results."""
    import train_net_torch
    from ttdg_mgm_torch.build import build_trainer
    from ttdg_mgm_torch.config import setup_cfg

    args = train_net_torch.parse_args(cli_args(root, os.path.join(draw_dir, "out")))
    tr = build_trainer(setup_cfg(args.config_file, args.opts), device="cpu")
    losses = []
    tr.train([name], max_iter=1, batch_size=2, seed=0,
             hooks=[lambda it, m: losses.append(float(m["total_loss"]))])
    res = tr.test([name], ttt=True, tta_batch=2, dice_threshold=0.0, draw_dir=draw_dir)
    return losses + [tr.last_tta_loss], tr.model.state_dict(), res


def test_tta_and_source_passes_are_bitwise_equal_on_and_off_and_leave_every_span(
        mini_split, tmp_path):
    root, name = mini_split
    off = _pass(root, name, str(tmp_path / "off"))
    assert profiling.drain() == []
    profiling.enable()
    try:
        on = _pass(root, name, str(tmp_path / "on"))
    finally:
        profiling.disable()
    spans = _by_name(profiling.drain())
    assert off[0] == on[0] and all(np.isfinite(off[0]))
    assert off[1].keys() == on[1].keys()
    assert all(torch.equal(off[1][k], on[1][k]) for k in off[1])
    assert off[2] == on[2]

    images = {0, 1, 2}
    missing = [n for n in list(KEYED) + list(UNKEYED) if n not in spans]
    assert not missing, missing
    for n, kind in KEYED.items():
        keys = {s["key"] for s in spans[n]}
        want = {"batch": {0, 1}, "iteration": {0}, "image": images}[kind]
        assert keys == want, (n, keys)
    assert {s["parent"] for s in spans["eval.paste_masks"]} == {"eval.postprocess"}
    assert {s["parent"] for s in spans["step.gagm"]} == {"step.matching"}
    assert {s["parent"] for s in spans["setup.init_params"]} == {"setup.build_trainer"}
    assert {s["parent"] for s in spans["data.gt_raster"]} == {"data.pack"}
    assert {s["parent"] for s in spans["data.decode"]} == {"data.sample"}
    # a TTA pass is a few hundred spans, not one per box or polygon
    assert sum(map(len, spans.values())) < 300


@pytest.fixture()
def loader_split(tmp_path):
    name = "_tracing_train_loader"
    _register(name, _write_split(str(tmp_path), FILES), str(tmp_path), jax_too=False)
    yield name
    TCatalog.remove(name)


@pytest.mark.parametrize("canvas", [128, "auto"])
def test_train_loader_batches_are_bitwise_equal_on_and_off(loader_split, canvas):
    """tests/test_torch_train_loader.py's ``test_batches_match_jax``
    settings: six batches with and without the tracer."""
    kw = dict(batch_size=2, canvas=canvas, min_size=96, max_size=160, gt_cap=4, mask_res=32,
              seed=3, flip_prob=0.5, min_size_choices=(72, 96, 128))

    def batches():
        ld = tloader.build_train_loader([loader_split], **kw)
        out = [next(ld) for _ in range(6)]
        ld.close()
        ld._thread.join(10)           # its last batch's spans end before the next run
        assert not ld._thread.is_alive()
        return out

    off = batches()
    profiling.enable()
    try:
        on = batches()
    finally:
        profiling.disable()
    spans = _by_name(profiling.drain())
    for a, b in zip(off, on):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(spans["data.pack"]) >= 6 and len(spans["data.sample"]) >= 12
    assert all(s["parent"] == "data.sample" for s in spans["data.resize"])
