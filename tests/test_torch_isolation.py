"""The port stands alone: ``ttdg_mgm_torch``, ``train_net_torch.py`` and
``chip_smoke.py`` import neither JAX nor the JAX package, nor Pillow,
OpenCV or PyYAML (the chip machine has none of the three; the eval-only CLI
on PNG images with RLE ground truth and the mean-teacher training CLI with
its strong augmentation load none of them either, nor do the legacy
dataset loaders on PNG and JPEG trees), and the port's entry points run on
CUDA unless the caller asks for the CPU."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import ast
import os
import subprocess
import sys

import pytest
import torch

from ttdg_mgm_torch import resolve_device
from ttdg_mgm_torch.build import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ttdg_mgm_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ttdg_mgm_tpu")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py"), os.path.join(REPO, "train_net_torch.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_fresh_import_loads_no_jax(tmp_path):
    """Every module of the package and chip_smoke, imported in a fresh
    interpreter, leave no JAX and no JAX-package module in sys.modules."""
    mods = []
    for path in _port_sources():
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
            "print(len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "0 []", res.stdout
    assert len(mods) > 25
    assert "ttdg_mgm_torch.graph.universe" in mods
    assert "train_net_torch" in mods and "ttdg_mgm_torch.engine.trainer" in mods
    assert {"ttdg_mgm_torch.engine.mean_teacher", "ttdg_mgm_torch.models.discriminator",
            "ttdg_mgm_torch.data.enhance"} <= set(mods)
    assert {"ttdg_mgm_torch.graph.gcn", "ttdg_mgm_torch.graph.ot",
            "ttdg_mgm_torch.graph.contrastive", "ttdg_mgm_torch.graph.cross_domain",
            "ttdg_mgm_torch.engine.probe"} <= set(mods)
    assert {"ttdg_mgm_torch.models.vgg", "ttdg_mgm_torch.data.datasets",
            "ttdg_mgm_torch.data.datasets.cityscapes_foggy",
            "ttdg_mgm_torch.data.datasets.pascal_voc",
            "ttdg_mgm_torch.data.datasets.fetus"} <= set(mods)
    assert {"ttdg_mgm_torch.utils.visualize", "ttdg_mgm_torch.utils.draw",
            "ttdg_mgm_torch.utils.profiling", "ttdg_mgm_torch.graph.spectral",
            "ttdg_mgm_torch.graph.hypergraph", "ttdg_mgm_torch.graph.ilp",
            "ttdg_mgm_torch.data.node_sampling"} <= set(mods)


def test_cli_imports_no_pillow_opencv_or_yaml(tmp_path):
    """``train_net_torch.main`` on the CPU over PNG images with RLE ground
    truth (tests/test_cli.py's miniature split, its masks RLE-encoded),
    with ``TEST.DRAW True`` (the visualizer's dumps written), leaves no
    PIL, cv2 or yaml module in sys.modules."""
    from torch_port_fixture import cli_args, write_mini_split

    write_mini_split(tmp_path, rle=True)
    out_dir = tmp_path / "out"
    args = cli_args(str(tmp_path), out_dir) + ["TEST.DRAW", "True"]
    code = ("import os, sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import train_net_torch\n"
            f"res = train_net_torch.main({args!r})\n"
            "assert 'Drishti_mean' in res, res\n"
            f"for kind in ('visual', 'masks'):\n"
            f"    assert len(os.listdir(os.path.join({str(out_dir)!r}, kind))) == 3\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', 'yaml'))\n"
            "print('FOREIGN', len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOREIGN 0 []" in res.stdout, res.stdout[-2000:]


def test_mt_train_cli_imports_no_pillow_opencv_or_yaml(tmp_path):
    """``train_net_torch.main`` training with ``configs/seg_res50fpn_MT.yaml``
    on the CPU at a tiny size (a burn-in step, then MT steps: the two-crop
    loader and its strong augmentation) leaves no PIL, cv2 or yaml module
    in sys.modules."""
    from torch_port_fixture import cli_args, write_mini_split

    write_mini_split(tmp_path)
    args = cli_args(str(tmp_path), tmp_path / "out")
    args = args[args.index("--device"):]
    args[args.index("--config") + 1] = os.path.join(REPO, "configs", "seg_res50fpn_MT.yaml")
    args += ["DATASETS.TRAIN_LABEL", '["Drishti_GS_test"]', "DATASETS.TRAIN_UNLABEL",
             '["Drishti_GS_test"]', "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.MAX_ITER", "2",
             "SEMISUPNET.BURN_UP_STEP", "1", "MODEL.FPN.OUT_CHANNELS", "32",
             "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import train_net_torch\n"
            f"res = train_net_torch.main({args!r})\n"
            "assert res['iteration'] == 2, res\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', 'yaml'))\n"
            "print('FOREIGN', len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOREIGN 0 []" in res.stdout, res.stdout[-2000:]


def test_legacy_loaders_import_no_pillow_opencv_or_yaml(tmp_path):
    """``register_all_legacy`` over foggy-Cityscapes PNG frames and a
    Clipart1k tree of the committed JPEGs, a train batch and a test batch of
    each, a VGG model built from ``MODEL.BACKBONE.NAME build_vgg_backbone``
    and ``FetusDataset`` decoding PNG and JPEG images, in a fresh
    interpreter: no PIL, cv2 or yaml module in sys.modules."""
    from test_torch_legacy_data import write_cityscapes, write_fetus, write_voc

    write_cityscapes(str(tmp_path), "train", 2, hw=(128, 256))
    write_voc(os.path.join(str(tmp_path), "clipart"))
    write_fetus(str(tmp_path / "fetus"))
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "from ttdg_mgm_torch.build import model_kwargs\n"
            "from ttdg_mgm_torch.config import setup_cfg\n"
            "from ttdg_mgm_torch.data.builtin import register_all_legacy\n"
            "from ttdg_mgm_torch.data.datasets import FetusDataset\n"
            "from ttdg_mgm_torch.data.loader import build_test_loader, build_train_loader\n"
            "from ttdg_mgm_torch.models.rcnn import MaskRCNN\n"
            f"register_all_legacy({str(tmp_path)!r})\n"
            "b = next(build_train_loader(['cityscapes_foggy_train'], batch_size=2, canvas=128,"
            " min_size=64, max_size=128, prefetch=0))\n"
            "assert b['gt_valid'].sum() == 16, b['gt_valid']\n"
            "t = list(build_test_loader('Clipart1k_test', batch_size=3, min_size=64,"
            " max_size=96, prefetch=0))\n"
            "assert t[0][0]['image'].shape[0] == 3\n"
            f"cfg = setup_cfg({os.path.join(REPO, 'configs', 'test_segment.yaml')!r},"
            " ['MODEL.BACKBONE.NAME', 'build_vgg_backbone'])\n"
            "MaskRCNN(**model_kwargs(cfg))\n"
            f"ds = FetusDataset({str(tmp_path / 'fetus')!r}, ['hospital_A'],"
            " ['three_vessel_tracheal'])\n"
            "assert {ds[i]['file_name'][-3:] for i in range(len(ds))} == {'png', 'jpg'}\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', 'yaml'))\n"
            "print('FOREIGN', len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOREIGN 0 []" in res.stdout, res.stdout[-2000:]


#: libraries the card does not have: no module of the port may import them
HOST_ONLY = ("PIL", "cv2", "yaml")


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_pillow_opencv_or_yaml(path):
    """No import statement of the port, at any depth (lazy imports inside
    functions included), names Pillow, OpenCV or PyYAML: the port decodes,
    resizes and rasterizes with its own NumPy code and reads YAML with
    ``utils/yaml_lite.py``."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in HOST_ONLY, f"{path}:{node.lineno} imports {name}"


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    """No import statement of the port, at any depth, names JAX or the JAX
    package."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_entry_points_default_to_cuda(monkeypatch):
    """Without a GPU the entry points raise unless the caller passes
    ``device="cpu"``; there is no silent CPU fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no GPU"):
        build_model(resnet_depth=14, resnet_width=16, fpn_channels=16, box_fc_dim=16,
                    mask_conv_dim=16)
    assert resolve_device("cpu") == torch.device("cpu")
    model = build_model(device="cpu", resnet_depth=14, resnet_width=16, fpn_channels=16,
                        box_fc_dim=16, mask_conv_dim=16)
    assert next(model.parameters()).device.type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """The kernel wrappers take CPU tensors (plain version) or CUDA tensors
    (kernel); any other device raises instead of falling back."""
    from ttdg_mgm_torch.ops.gagm import ga_gm_fused
    from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_backward
    from ttdg_mgm_torch.ops.sinkhorn import sinkhorn_batched

    meta = torch.device("meta")
    feats = [torch.empty((1, 8, 8, 4), device=meta)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        multilevel_roi_pool(feats, torch.empty((1, 2, 4), device=meta))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        multilevel_roi_pool_backward(torch.empty((1, 2, 7, 7, 4), device=meta), [(8, 8)],
                                     torch.empty((1, 2, 4), device=meta))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        sinkhorn_batched(torch.empty((2, 6, 6), device=meta), tau=0.1)
    A = torch.empty((8, 8), device=meta)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ga_gm_fused(A, A, torch.empty((8, 4), device=meta),
                    torch.empty((2,), dtype=torch.int32, device=meta), 4)
