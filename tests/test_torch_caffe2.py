"""Caffe2 ImageNet pickles as ``MODEL.WEIGHTS`` (``R-50.pkl``, the reference's
``detectron2://ImageNetPretrained/MSRA``) in the port, against the JAX
package (CPU).

A synthetic Caffe2 R50 dict (``conv1_w``, ``res_conv1_bn_{s,b}``,
``res{stage}_{block}_{branch}_{w,bn_s,bn_b}`` and an ``fc1000`` head that
is dropped), built as tests/test_converter.py builds one, is pickled to
``tmp_path``:

* the name map (``checkpoint/bridge.py:c2_resnet_to_d2_names``) gives
  JAX's names (``ttdg_mgm_tpu/checkpoint/converter.py``) and running mean
  0 and variance 1 for every norm it loads, so the port's frozen norm scale
  is ``bn_s / sqrt(1 + 1e-5)``, the JAX fold's;
* the port's ``init_params`` on the file and the JAX package's
  ``init_params`` on it give the same R50 trunk: res2-res5 on one image at
  the R50 tolerances of tests/test_torch_models.py (features atol 1e-2,
  rtol 1e-3);
* ``train_net_torch.main --device cpu`` starts from the file (every trunk
  tensor loaded) and trains.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import logging
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train_net_torch
from torch_port_fixture import cli_args, write_mini_split
from ttdg_mgm_tpu import build as jbuild
from ttdg_mgm_tpu import config as jconfig
from ttdg_mgm_tpu.checkpoint.converter import c2_resnet_to_d2_names as j_c2_names
from ttdg_mgm_tpu.models.resnet import ResNet50
from ttdg_mgm_torch import build as tbuild
from ttdg_mgm_torch import config as tconfig
from ttdg_mgm_torch.checkpoint.bridge import c2_resnet_to_d2_names, load_reference_checkpoint
from ttdg_mgm_torch.models.rcnn import MaskRCNN

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: narrow heads over the full R50 trunk (the heads do not read the file)
HEADS = ["MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
         "MODEL.ROI_MASK_HEAD.CONV_DIM", "32"]


def caffe2_r50(seed: int = 1) -> dict:
    """tests/test_converter.py's synthetic Caffe2 R50 dict, with norm
    scales near 1 so the trunk's activations stay finite."""
    rng = np.random.RandomState(seed)

    def bn(n):
        return ((1.0 + 0.1 * rng.randn(n)).astype(np.float32),
                (0.1 * rng.randn(n)).astype(np.float32))

    def conv(o, i, k):
        return (rng.randn(o, i, k, k) / np.sqrt(i * k * k)).astype(np.float32)

    sd = {"conv1_w": conv(64, 3, 7), "fc1000_w": rng.randn(1000, 2048).astype(np.float32)}
    sd["res_conv1_bn_s"], sd["res_conv1_bn_b"] = bn(64)
    in_ch = 64
    for stage, (n, mid, out) in {"2": (3, 64, 256), "3": (4, 128, 512),
                                 "4": (6, 256, 1024), "5": (3, 512, 2048)}.items():
        for i in range(n):
            cin = in_ch if i == 0 else out
            branches = {"branch2a": (mid, cin, 1), "branch2b": (mid, mid, 3),
                        "branch2c": (out, mid, 1)}
            if i == 0:
                branches["branch1"] = (out, cin, 1)
            for br, (o, ci, k) in branches.items():
                sd[f"res{stage}_{i}_{br}_w"] = conv(o, ci, k)
                sd[f"res{stage}_{i}_{br}_bn_s"], sd[f"res{stage}_{i}_{br}_bn_b"] = bn(o)
        in_ch = out
    return sd


@pytest.fixture(scope="module")
def pkl(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("c2") / "R-50.pkl")
    with open(path, "wb") as f:
        pickle.dump(caffe2_r50(), f)
    return path


def test_name_map_matches_jax_and_folds_with_unit_variance(pkl):
    with open(pkl, "rb") as f:
        sd = pickle.load(f)
    got, want = c2_resnet_to_d2_names(sd), j_c2_names(sd)
    stats = {k for k in got if k.endswith(("running_mean", "running_var"))}
    assert set(got) - stats == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert len(stats) == 2 * sum(k.endswith(".norm.weight") for k in want) == 2 * 53
    for k in stats:
        np.testing.assert_array_equal(got[k], 0.0 if k.endswith("mean") else 1.0, err_msg=k)
    assert load_reference_checkpoint(pkl).keys() == got.keys()
    assert not any("fc1000" in k for k in got)


def test_trunk_equals_jax_init_params(pkl):
    opts = ["MODEL.WEIGHTS", pkl, *HEADS]
    jcfg = jconfig.setup_cfg(os.path.join(REPO, "configs", "seg_res50fpn_source.yaml"), opts)
    jparams = jbuild.init_params(jcfg, jbuild.build_model(jcfg))
    tcfg = tconfig.setup_cfg(os.path.join(REPO, "configs", "seg_res50fpn_source.yaml"),
                             opts + ["TPU.PRECISION", "float32", "SOLVER.AMP.ENABLED", "False"])
    pm = tbuild.init_params(tcfg, MaskRCNN(**tbuild.model_kwargs(tcfg)))
    norm = pm.backbone.bottom_up.stem.conv1.norm
    with open(pkl, "rb") as f:
        s = pickle.load(f)["res_conv1_bn_s"]
    np.testing.assert_allclose((norm.weight * (norm.running_var + norm.eps).rsqrt()).numpy(),
                               s / np.sqrt(1.0 + 1e-5), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jparams["backbone"]["stem_conv1_norm"]["scale"]),
                               s / np.sqrt(1.0 + 1e-5), rtol=1e-6)
    x = np.random.RandomState(0).randn(1, 64, 96, 3).astype(np.float32) * 50
    want = ResNet50().apply({"params": jparams["backbone"]}, jnp.asarray(x))
    with torch.no_grad():
        got = pm.backbone.bottom_up(torch.from_numpy(x).permute(0, 3, 1, 2))
    for k in ("res2", "res3", "res4", "res5"):
        w = np.asarray(want[k])
        assert np.abs(w).max() > 0, k
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(), w, atol=1e-2, rtol=1e-3,
                                   err_msg=k)


def test_train_net_starts_from_the_pickle(pkl, tmp_path, caplog):
    root = write_mini_split(tmp_path / "data")
    args = cli_args(root, tmp_path / "out")
    args = args[args.index("--device"):]
    args[args.index("--config") + 1] = os.path.join(REPO, "configs", "seg_res50fpn_source.yaml")
    args += HEADS + ["MODEL.WEIGHTS", pkl, "MODEL.RESNETS.DEPTH", "50",
                     "DATASETS.TRAIN", '["Drishti_GS_test"]', "SOLVER.IMS_PER_BATCH", "2",
                     "SOLVER.MAX_ITER", "1", "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64"]
    with caplog.at_level(logging.INFO, logger="ttdg_mgm_torch"):
        res = train_net_torch.main(args)
    n_trunk = 5 * (1 + 3 * 16 + 4)  # stem, three convs per block, four shortcuts
    assert f"loaded {n_trunk} tensors from {pkl}" in caplog.text
    assert res["iteration"] == 1
    saved = torch.load(res["checkpoint"], weights_only=False)["model"]
    assert all(torch.isfinite(v).all() for v in saved.values() if v.is_floating_point())
