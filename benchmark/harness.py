"""The harness: one run of one cell, driven by data.

It reads ``BENCHMARK.json`` at the checkout's root for the cell's
configuration, traffic and metrics, and finds everything that belongs to
them by name under ``benchmark/``:

* ``configs/<config>.json`` (the ``file`` of the configuration): the model's
  configuration tree as it is run (``cfg``) and, optionally, two files of
  its own under ``benchmark/``: ``reference_model``, the plain reference
  model of an architecture ``reference/cell.py`` does not build
  (``build_model(cfg)``, optionally ``init_rules(model)``; see
  :func:`reference.cell.build` and :func:`weights.make_weights`), and
  ``captures``, the work of its kernels in a traced run
  (``instrument(run)`` after the job's set-up, ``work(run)`` after the
  job's check, which fills ``run.work`` for its metric readers);
* ``traffic/<traffic>.json``: the job (``jobs/<job>.py``), the dataset
  splits the generator (``datagen.py``) writes, and the job's configuration
  tree (datasets, solver, test settings), merged over the model's;
* ``limits/<cell>.json``: the limit of each number that decides
  ``correct``;
* ``metrics/<metric>.py``: one reader per metric, end to end or per layer,
  over the run's record (``read(record)``, None when it finds nothing).

A run checks the card, writes the cell's data into ``TMPDIR`` from the
seed, makes the weights on the card from the seed, lets the job build the
program and warm it up (set-up ends there), measures for ``--seconds``
(with ``--trace 1`` under the profiler, with spans around the program's
layers), reads the peak memory, frees the program, and has the job run the
plain reference and compare.  The run's record, which the metric readers
read, holds the cell's merged configuration tree with its ``chips`` under
``config``.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, in a
traced run ``breakdown``, and last ``checks`` (each number compared, with its
limit), which also end standard error.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: modules no run may hold, compared by their top-level name, whole
BANNED = ("jax", "jaxlib", "flax", "ttdg_mgm_tpu")


class RunError(RuntimeError):
    """A run that cannot give a result (no card, a banned import)."""


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def check_imports(when: str) -> None:
    bad = banned_modules()
    if bad:
        raise RunError(f"modules {bad} are loaded {when}; the benchmark runs the port alone")


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def merge(dst: dict, src: dict) -> dict:
    """``src`` merged into a copy of ``dst``, nested dicts key by key."""
    out = dict(dst)
    for k, v in src.items():
        out[k] = merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Spec:
    """A cell as the data files describe it."""

    def __init__(self, workload: str, root: str = ROOT):
        bench = _json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise RunError(f"no workload {workload!r} in BENCHMARK.json")
        self.name = workload
        self.bench = os.path.join(root, "benchmark")
        self.cell = cells[workload]
        conf = next(c for c in bench["configs"] if c["name"] == self.cell["config"])
        self.config = _json(os.path.join(root, conf["file"]))
        #: the configuration's own reference model and captures (paths), or None
        self.reference_model = self._own_file("reference_model")
        self.captures = self._own_file("captures")
        self.traffic = _json(os.path.join(self.bench, "traffic", self.cell["traffic"] + ".json"))
        self.limits = _json(os.path.join(self.bench, "limits", workload + ".json"))
        self.cfg = merge(self.config["cfg"], self.traffic["cfg"])
        self.job = self.traffic["job"]

        def applies(m):
            return "workloads" not in m or workload in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if applies(m)]
        self.per_layer = [m for m in bench["per_layer"] if applies(m)]

    def _own_file(self, key: str) -> str | None:
        """The file the configuration names under ``key``, a path relative
        to the benchmark folder that stays inside it; None without the key."""
        rel = self.config.get(key)
        if rel is None:
            return None
        bench = os.path.normpath(self.bench)
        path = os.path.normpath(os.path.join(bench, rel))
        if os.path.isabs(rel) or not path.startswith(bench + os.sep):
            raise RunError(f"{key} {rel!r} of {self.cell['config']!r} is not under benchmark/")
        return path


def load_module(path: str, name: str):
    """The Python file ``path`` as a fresh module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench: str = HERE):
    """The reader module ``metrics/<name>.py`` of the benchmark folder
    ``bench``."""
    return load_module(os.path.join(bench, "metrics", name + ".py"),
                       "metric_" + name.replace(".", "_"))


def read_metrics(entries: list, record: dict, bench: str = HERE) -> dict:
    out = {}
    for m in entries:
        value = load_reader(m["name"], bench).read(record)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def set_cache_dirs(root: str) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    cache = os.path.join(root, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)


class Run:
    """The state of one run, handed to the job's functions.  ``model_module``
    and ``captures`` are the configuration's own modules (:class:`Spec`), or
    None."""

    def __init__(self, spec: Spec, seed: int, device, trace: bool, data_root: str, log=print):
        import numpy as np

        self.log = log
        self.spec = spec
        self.cfg = spec.cfg
        self.traffic = spec.traffic
        self.seed = seed
        self.device = device
        self.trace = trace
        self.data_root = data_root
        self.data_seed, self.weight_seed = (
            int(x) for x in np.random.SeedSequence(seed).generate_state(2))
        from spans import Recorder

        self.recorder = Recorder(trace)
        self.counts: dict = {}
        self.work: dict = {}
        self.weights = None
        self.model_module = (load_module(spec.reference_model, "bench_reference_model")
                             if spec.reference_model else None)
        self.captures = load_module(spec.captures, "bench_captures") if spec.captures else None

    def make_weights(self) -> None:
        """The benchmark's weights, made on the card from the seed (kept on
        the host for the reference), by the reference model's own init
        rules where it has them."""
        import torch

        from reference.cell import build
        from weights import make_weights

        model, _ = build(self.cfg, self.device, model_module=self.model_module)
        rules = getattr(self.model_module, "init_rules", None)
        sd = make_weights(model, self.weight_seed, rules(model) if rules else None)
        self.weights = {k: v.cpu() for k, v in sd.items()}
        del model, sd
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(spec: Spec, seed: int, seconds: float, trace: bool, device, t_start: float,
            log=print) -> dict:
    """One run of ``spec`` on ``device``; returns the result object.  The
    card's checks and the exit code are :func:`main`'s; a test calls this on
    the CPU with a small configuration."""
    import torch

    from datagen import write_traffic

    job = importlib.import_module("jobs." + spec.job)
    data_root = tempfile.mkdtemp(prefix="bench_data_")
    try:
        run = Run(spec, seed, device, trace, data_root, log)
        write_traffic(data_root, spec.traffic, run.data_seed)
        run.make_weights()
        job.setup(run)
        if trace and run.captures is not None:
            run.captures.instrument(run)
        check_imports("after set-up")
        gc.collect()
        sync(device)
        cuda = device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        setup_s = t0 - t_start
        prof = None
        if trace and cuda:
            from spans import launch_anchor

            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            anchor = launch_anchor(torch)
            t0 = time.perf_counter()
        job.window(run, seconds)
        sync(device)
        t1 = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        run.recorder.close()
        check_imports("after the window")
        log(f"window {t1 - t0:.3f} s, counts {run.counts}, peak {peak} bytes")

        record = {"config": {**spec.cfg, "chips": int(spec.cell["chips"])},
                  "window_s": t1 - t0, "t0": t0, "t1": t1, "setup_s": setup_s,
                  "memory_peak_bytes": peak, "counts": run.counts, "work": run.work,
                  "spans": [s for s in run.recorder.spans if t0 <= s[1] <= t1],
                  "main_thread": threading.get_ident(), "kernels": []}
        if prof is not None:
            from spans import device_intervals

            record["kernels"] = [k for k in device_intervals(prof, anchor)
                                 if k[2] > t0 and k[1] < t1]
            del prof
        checks = job.check(run)         # frees the program, runs the reference
        if trace and run.captures is not None:
            run.captures.work(run)
        check_imports("after the reference")
        limits = spec.limits["limits"]
        numbers = {k: {"value": float(v), "limit": float(limits[k])} for k, v in checks.items()}
        correct = bool(numbers) and all(math.isfinite(n["value"]) and n["value"] <= n["limit"]
                                        for n in numbers.values())
        result = {"correct": correct, "attempted": int(run.counts.get("attempted", 0)),
                  "failed": int(run.counts.get("failed", 0))}
        entries = spec.per_layer if trace else spec.end_to_end
        result["metrics"] = read_metrics(entries, record, spec.bench)
        result["device"] = {"platform": "gpu" if cuda else device.type,
                            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                            "count": int(spec.cell["chips"]), "memory_peak_bytes": int(peak)}
        if trace and record["kernels"]:
            from spans import breakdown, busy_seconds

            result["device"]["busy_s"] = busy_seconds(record["kernels"], t0, t1)
            result["device"]["window_s"] = t1 - t0
            main = [s for s in record["spans"] if s[3] == record["main_thread"]]
            result["breakdown"] = breakdown(record["kernels"], main, t0, t1)
        result["checks"] = numbers
        return result
    finally:
        shutil.rmtree(data_root, ignore_errors=True)


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    set_cache_dirs(ROOT)
    try:
        spec = Spec(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < spec.cell["chips"]:
            raise RunError(f"the cell needs {spec.cell['chips']} CUDA device(s); "
                           f"{torch.cuda.device_count()} available")
        card = card_line()
        print(f"card: {card}", file=sys.stderr, flush=True)
        result = execute(spec, args.seed, args.seconds, bool(args.trace),
                         torch.device("cuda", 0), t_start,
                         log=lambda m: print(m, file=sys.stderr, flush=True))
        result["card"] = card
    except RunError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    checks = result.pop("checks")
    result["checks"] = checks            # the numbers compared come last
    for k, v in checks.items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
