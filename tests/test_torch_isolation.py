"""The port stands alone: ``ttdg_mgm_torch``, ``train_net_torch.py`` and
``chip_smoke.py`` import neither JAX nor the JAX package, the eval-only CLI
on PNG images with RLE ground truth imports neither Pillow, OpenCV nor
PyYAML (the chip machine has none of them), and the port's entry points run
on CUDA unless the caller asks for the CPU."""

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


def test_fresh_import_loads_no_jax():
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
                         cwd=os.path.dirname(REPO), env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "0 []", res.stdout
    assert len(mods) > 25
    assert "ttdg_mgm_torch.graph.universe" in mods
    assert "train_net_torch" in mods and "ttdg_mgm_torch.engine.trainer" in mods


def test_cli_imports_no_pillow_opencv_or_yaml(tmp_path):
    """``train_net_torch.main`` on the CPU over PNG images with RLE ground
    truth (tests/test_cli.py's miniature split, its masks RLE-encoded)
    leaves no PIL, cv2 or yaml module in sys.modules."""
    from torch_port_fixture import cli_args, write_mini_split

    write_mini_split(tmp_path, rle=True)
    out_dir = tmp_path / "out"
    code = ("import sys\n"
            f"sys.path.insert(0, {REPO!r})\n"
            "import train_net_torch\n"
            f"res = train_net_torch.main({cli_args(str(tmp_path), out_dir)!r})\n"
            "assert 'Drishti_mean' in res, res\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'cv2', 'yaml'))\n"
            "print('FOREIGN', len(bad), bad[:5])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(REPO), env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "FOREIGN 0 []" in res.stdout, res.stdout[-2000:]


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
