"""The port's detector stages against the JAX package on the CPU: backbone,
FPN and RPN outputs and proposals on the committed fixture weights, the
R50 trunk's layout through the weight bridge, and the flagship
configuration.

Tolerances are those of tests/test_detector_parity.py:152-197 (features
atol 1e-2 rtol 1e-3; RPN logits and deltas atol 1e-3 rtol 1e-3; proposal
boxes atol 1e-2), except where a line below states a tighter one: both
sides here run the same float32 arithmetic from the same weights, so only
the convolution algorithms' summation order differs.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixture import jax_model_and_params, port_model, to_numpy_tree
from ttdg_mgm_tpu.build import build_model as j_build_model
from ttdg_mgm_tpu.config import setup_cfg
from ttdg_mgm_tpu.models import MaskRCNN as JMaskRCNN
from ttdg_mgm_torch.build import FLAGSHIP_KWARGS
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2, load_d2_state_dict
from ttdg_mgm_torch.models.rcnn import MaskRCNN
from ttdg_mgm_torch.synth import synth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _norm(v):
    return tuple(_norm(x) for x in v) if isinstance(v, (tuple, list)) else v


def test_flagship_kwargs_equal_the_jax_build():
    """The port's flagship model is what the JAX package builds for
    configs/test_segment.yaml, field for field."""
    jm = j_build_model(setup_cfg(os.path.join(REPO, "configs", "test_segment.yaml")))
    fields = [f for f in jm.__dataclass_fields__ if f not in ("parent", "name")]
    for f in fields:
        assert f in FLAGSHIP_KWARGS, f"flagship kwargs lack {f}"
        assert _norm(FLAGSHIP_KWARGS[f]) == _norm(getattr(jm, f)), f
    assert set(FLAGSHIP_KWARGS) <= set(fields)
    assert FLAGSHIP_KWARGS["node_cap_per_level"] * 5 == 60
    MaskRCNN(**FLAGSHIP_KWARGS)  # constructs at full width


@pytest.fixture(scope="module")
def fixture_models():
    jm, jp = jax_model_and_params()
    pm = port_model(jp)
    data = synth_batch(128, 2, seed=9)
    return jm, jp, pm, data["image"], data["image_sizes"]


def test_backbone_fpn_rpn_on_fixture(fixture_models):
    jm, jp, pm, imgs, sizes = fixture_models

    def stages(m, im, sz):
        feats = m.extract_features(im)
        (logits, regs, _), props = m._proposals(feats, sz, train=False)
        return feats, logits, regs, props

    jf, jl, jr, (jb, js, jv) = jax.jit(lambda p: jm.apply(
        {"params": p}, jnp.asarray(imgs), jnp.asarray(sizes), method=stages))(jp)
    ti, ts = torch.from_numpy(imgs), torch.from_numpy(sizes)
    with torch.no_grad():
        nchw = pm._features_nchw(ti)
        (tl, tr, _), (tb, tsc, tv) = pm._proposals(nchw, ts)
    for k in jf:
        got = nchw[k].permute(0, 2, 3, 1).numpy()
        # tighter than atol 1e-2: identical f32 weights and inputs
        np.testing.assert_allclose(got, np.asarray(jf[k]), atol=1e-3, rtol=1e-3, err_msg=k)
    for lv in range(5):
        np.testing.assert_allclose(tl[lv].numpy(), np.asarray(jl[lv]), atol=1e-3, rtol=1e-3)
        np.testing.assert_allclose(tr[lv].numpy(), np.asarray(jr[lv]), atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    v = np.asarray(jv)
    assert v.sum() > 50
    np.testing.assert_allclose(tb.numpy()[v], np.asarray(jb)[v], atol=1e-2)
    np.testing.assert_allclose(tsc.numpy()[v], np.asarray(js)[v], atol=1e-3, rtol=1e-3)


def test_forward_inference_on_fixture(fixture_models):
    """Detections before any TTA step: identical valid and classes, boxes
    atol 2e-2, scores 1e-3, mask_probs 2e-3 (test_detector_parity.py:249-252)."""
    jm, jp, pm, imgs, sizes = fixture_models
    j = jm.apply({"params": jp}, jnp.asarray(imgs), jnp.asarray(sizes),
                 method=jm.forward_inference)
    t = pm.forward_inference(torch.from_numpy(imgs), torch.from_numpy(sizes))
    np.testing.assert_array_equal(t["valid"].numpy(), np.asarray(j["valid"]))
    np.testing.assert_array_equal(t["classes"].numpy(), np.asarray(j["classes"]))
    np.testing.assert_allclose(t["boxes"].numpy(), np.asarray(j["boxes"]), atol=2e-2)
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]), atol=1e-3)
    np.testing.assert_allclose(t["mask_probs"].numpy(), np.asarray(j["mask_probs"]), atol=2e-3)


def test_flagship_param_tree_loads_through_the_bridge():
    """The full-width R50-FPN parameter tree of the JAX flagship model (its
    shapes, from ``jax.eval_shape``: 3/4/6/3 bottleneck stages, 256-wide
    FPN, 1024-wide box head) loads strictly into the port's flagship model:
    every name the port owns is present with its shape.  The numerics of
    the same layers are held on the fixture weights above."""
    kw = {**FLAGSHIP_KWARGS, "compute_dtype": "float32"}
    jm = JMaskRCNN(**kw)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 2)))["params"]
    rng = np.random.RandomState(0)
    tree = jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)
    pm = MaskRCNN(**FLAGSHIP_KWARGS)
    sd = flax_params_to_d2(tree, box_head_channels=256)
    skipped = load_d2_state_dict(pm, sd)
    assert not [k for k in skipped if not k.startswith(("D_img.", "multi_matching_sup."))]
    assert len(pm.backbone.bottom_up.res4) == 6
    # the box head's fc1 re-flattened from the JAX NHWC order to d2's NCHW
    w_jax = tree["box_head"]["fc1"]["kernel"].reshape(7, 7, 256, 1024)
    np.testing.assert_array_equal(
        pm.roi_heads.box_head.fc1.weight.detach().numpy().reshape(1024, 256, 7, 7),
        w_jax.transpose(3, 2, 0, 1))


def test_bridge_loader_is_strict(fixture_models):
    """A name the port's modules own that is missing, or an unknown name
    under them, raises; names outside them (d2's ``pixel_mean``, which the
    port keeps out of its state dict) are skipped and returned.  The
    discriminator and the cross-domain head are owned: a tensor of another
    shape under ``D_img`` or ``cross_domain`` raises."""
    _, jp, pm, _, _ = fixture_models
    sd = flax_params_to_d2(to_numpy_tree(jp), box_head_channels=128)
    extra = dict(sd, **{"pixel_mean": np.zeros(3, np.float32)})
    assert load_d2_state_dict(pm, extra) == ["pixel_mean"]
    for name in ("D_img.conv1.weight", "cross_domain.node_cls.weight"):
        with pytest.raises(ValueError, match=name):
            load_d2_state_dict(pm, dict(sd, **{name: np.zeros(1, np.float32)}))
    missing = dict(sd)
    missing.pop("roi_heads.box_head.fc1.weight")
    with pytest.raises(KeyError, match="fc1"):
        load_d2_state_dict(pm, missing)
    with pytest.raises(KeyError, match="unexpected"):
        load_d2_state_dict(pm, dict(sd, **{"backbone.fpn_lateral9.weight": np.zeros(1)}))


def test_synth_batch_matches_the_bench():
    """The port's copy of bench.py:synth_batch gives the same pixels."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("bench", os.path.join(REPO, "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    want = bench.synth_batch(np, 96, 3, seed=4, with_gt=False)
    got = synth_batch(96, 3, seed=4)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["image_sizes"], want["image_sizes"])
