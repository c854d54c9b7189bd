"""The benchmark's parts on the CPU: the metric readers on a recorded trace,
the frozen roofline arithmetic against ``chip_smoke.py``'s, the import
checks, the data writers read back by the port's and the reference's
decoders, and ``BENCHMARK.json`` against the files it names."""

from __future__ import annotations

import ast
import io
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import harness

BENCH = harness.HERE


def _bench() -> dict:
    with open(os.path.join(harness.ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


# -- metric readers ------------------------------------------------------------

def _record(**over) -> dict:
    """A small recorded run: a 10 s window with two TTA passes' spans and
    three device kernels."""
    rec = {"window_s": 10.0, "t0": 100.0, "t1": 110.0, "setup_s": 25.0,
           "memory_peak_bytes": 3 * 2 ** 30, "main_thread": 1,
           "counts": {"images": 32, "passes": 2, "tta_steps": 8, "inference_batches": 8,
                      "attempted": 32, "failed": 0},
           "spans": [("tta.loader_wait", 100.0, 100.5, 1), ("tta.loader_wait", 105.0, 105.5, 1),
                     ("decode", 100.1, 100.13, 2), ("decode", 100.2, 100.25, 2),
                     ("tta.step", 101.0, 101.2, 1), ("tta.step", 102.0, 102.1, 1),
                     ("tta.step", 103.0, 103.3, 1),
                     ("eval.paste", 104.0, 104.4, 1), ("eval.process", 104.4, 104.6, 1)],
           "kernels": [("roi_pool_kernel(Args)", 101.0, 101.001),
                       ("gagm_kernel(Problem)", 101.05, 101.07),
                       ("void cudnn_conv(...)", 101.1, 101.6)],
           "work": {"flops": {"tta_step": {"bfloat16": 989e9, "float32": 67e9},
                              "inference": {"bfloat16": 989e9}},
                    "pool_work": [(3.35e9, 0.0)],
                    "gagm": [{"G": 4, "M": 60, "univ": 32, "steps": 100}]}}
    rec.update(over)
    return rec


READINGS = {
    "tta_images_per_s": 3.2, "peak_mem_gib": 3.0, "setup_s": 25.0,
    "loader_wait_share.tta": 10.0, "decode_ms_per_image.tta": 40.0, "tta_step_ms": 200.0,
    # 8 steps x 2 ms + 8 inference passes x 1 ms over 10 s
    "tta_mfu": 0.24,
    # 1 ms of bytes in a 1 ms launch
    "roi_pool_roofline.tta": 100.0,
    "gagm_roofline.tta": 100.0 * 100 * (16 * (4 * 60 ** 3 + 4 * 3600 * 32) + 2 * 240 ** 2 * 32)
    / 67e12 / 0.02,
    "eval_ms_per_image.tta": 600.0 / 32,
    "device_idle_share.tta": 100.0 * (1 - 0.521 / 10.0),
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_reader_on_recorded_trace(name):
    value = harness.load_reader(name).read(_record())
    assert value == pytest.approx(READINGS[name], rel=1e-9)


@pytest.mark.parametrize("name", ["train_images_per_s.loop", "loader_wait_share.train",
                                  "decode_ms_per_image.train", "source_step_ms", "train_mfu",
                                  "roi_pool_bwd_roofline.train", "device_idle_share.train"])
def test_training_reader_finds_nothing_in_a_tta_record(name):
    assert harness.load_reader(name).read(_record()) is None


def test_readers_declare_bench_units_and_moves():
    b = _bench()
    for m in b["end_to_end"] + b["per_layer"]:
        mod = harness.load_reader(m["name"])
        assert mod.UNIT == m["unit"]
        assert mod.MOVES == m.get("moves")


# -- the frozen roofline arithmetic --------------------------------------------

def test_frozen_roofline_equals_chip_smoke():
    import chip_smoke as cs
    import roofline as rf

    assert rf.bound(640.7e6, 1e9) == cs.bound(640.7e6, 1e9)
    assert rf.gagm_flops(4, 60, 32, 210) == cs.gagm_flops(4, 60, 32, 210)
    # kernel A's float32 TTA box pool at phase 2's shapes and draws: 0.1206 ms
    gen = torch.Generator().manual_seed(1)
    feats = [torch.randn((4, 800 // s, 800 // s, 256), generator=gen) for s in (4, 8, 16, 32)]
    rois = cs.make_rois(torch, gen, 4, 1000, 800)
    shapes = [tuple(f.shape[:3]) for f in feats]
    mine = rf.roi_pool_work(shapes, 256, rois, 7)
    assert mine == cs.roi_pool_work(torch, feats, rois, 7)
    assert round(rf.bound(*mine)[0], 4) == 0.1206
    # kernel C at phase 5's shapes: 640.7 MB
    gen = torch.Generator().manual_seed(2)
    feats = [torch.zeros((8, 800 // s, 800 // s, 256)) for s in (4, 8, 16, 32)]
    rois = cs.make_train_rois(torch, gen, 8, 512, 800)
    shapes = [tuple(f.shape[:3]) for f in feats]
    mine = rf.roi_backward_work(shapes, 256, rois, 7)
    assert mine == cs.roi_backward_work(torch, feats, rois, 7)
    assert 640.7e6 <= mine[0] < 640.8e6
    s = torch.rand(3, 5, 5)
    nr, nc = torch.tensor([5, 4, 3]), torch.tensor([5, 5, 2])
    assert rf.sinkhorn_work(s, nr, nc, 20) == cs.sinkhorn_work(s, nr, nc, 20)


def test_dtype_flops_splits_by_dtype():
    from roofline import DtypeFlops, least_seconds

    a = torch.randn(64, 32)
    b = torch.randn(32, 16)
    with DtypeFlops() as mode:
        a @ b
        a.bfloat16() @ b.bfloat16()
    assert mode.flops == {"float32": 2 * 64 * 32 * 16, "bfloat16": 2 * 64 * 32 * 16}
    assert least_seconds(mode.flops) == pytest.approx(65536 / 67e12 + 65536 / 989e12)


# -- imports ---------------------------------------------------------------------

def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for dirpath, _, files in os.walk(ref):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                         [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
                for n in names:
                    assert n.split(".")[0] not in ("ttdg_mgm_torch",) + harness.BANNED, (f, n)
    code = ("import sys; sys.path.insert(0, %r); import reference.cell, reference.models.rcnn; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & {"ttdg_mgm_torch", *harness.BANNED}


@pytest.mark.parametrize("name,banned", [("jax", True), ("jaxlib.xla", True), ("flax", True),
                                         ("ttdg_mgm_tpu.ops", True), ("ttdg_mgm_torch", False),
                                         ("jaxtyping", False), ("ttdg_mgm_tpu_extra", False)])
def test_import_check_compares_whole_top_level_names(monkeypatch, name, banned):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    if banned:
        with pytest.raises(harness.RunError):
            harness.check_imports("in the test")
    else:
        harness.check_imports("in the test")


def test_run_without_card_prints_no_result(tmp_path):
    """Here there is no card: the command exits non-zero and prints nothing
    on standard output; so it does from a folder without the port."""
    cmd = [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "r50_tta_fundus",
           "--seed", "1", "--seconds", "1", "--trace", "0"]
    r = subprocess.run(cmd, capture_output=True, text=True, cwd=harness.ROOT)
    assert r.returncode != 0 and r.stdout == ""
    import shutil

    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    r = subprocess.run([sys.executable, "benchmark/run.py", *cmd[2:]], capture_output=True,
                       text=True, cwd=tmp_path)
    assert r.returncode != 0 and r.stdout == ""


# -- data writers ----------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["png", "jpeg", "tiff", "tiff_lzw", "tiff_packbits"])
def test_writers_read_back_by_both_decoders(tmp_path, fmt):
    from PIL import Image

    import datagen
    from reference.data.loader import load_image as ref_load
    from ttdg_mgm_torch.data.loader import load_image

    h, w = 75, 101
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    light = 1.0 - 0.55 * (((yy - h / 2) / h) ** 2 + ((xx - w / 2) / w) ** 2)
    img, _ = datagen.polyp_frame(np.random.RandomState(3), (h, w), light, yy, xx)
    name = datagen._save(str(tmp_path / "f"), img, fmt)
    path = str(tmp_path / name)
    got, ref = load_image(path), ref_load(path)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert np.array_equal(got, ref) and np.array_equal(got, pil)
    if fmt != "jpeg":
        assert np.array_equal(got, img)
    else:
        err = np.abs(got.astype(int) - img.astype(int)).mean()
        assert err < 6.0          # quality 75 on a noisy frame


def test_jpeg_is_baseline_420_with_standard_tables():
    import jpeg_encode as je

    data = je.encode_jpeg(np.full((20, 30, 3), 128, np.uint8))
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    sof = data.index(b"\xff\xc0")
    assert data[sof + 10:sof + 13] == bytes([1, 0x22, 0])          # Y sampled 2 x 2
    from PIL import Image

    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG" and im.size == (30, 20) and not im.info.get("progressive")


def test_traffic_seeds_change_content_not_work(tmp_path):
    import datagen

    with open(os.path.join(BENCH, "traffic", "cityscapes_foggy_train_32.json")) as f:
        t = json.load(f)
    t["splits"][0].update(n=2, hw=[64, 128])
    sizes = []
    for seed in (1, 2 ** 31 + 9):
        root = tmp_path / str(seed)
        datagen.write_traffic(str(root), t, seed)
        sizes.append(sorted(p.name for p in root.rglob("*.png")))
    assert sizes[0] == sizes[1] and len(sizes[0]) == 2


# -- BENCHMARK.json ----------------------------------------------------------------

def test_benchmark_json_names_existing_files_and_limits():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    for c in b["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        spec = harness.Spec(w["name"])
        assert spec.limits["limits"], w["name"]
        assert os.path.exists(os.path.join(BENCH, "jobs", spec.job + ".py"))
        assert all(f is None or os.path.isfile(f) for f in (spec.reference_model, spec.captures))
        assert "setup_s" in {m["name"] for m in spec.end_to_end}
        moved = {m["moves"] for m in spec.per_layer}
        assert moved <= {m["name"] for m in spec.end_to_end}
        assert all(e2e[m]["bound"] <= 0.25 for m in e2e)
