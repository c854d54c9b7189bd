"""The bf16 compute policy (JAX ``compute_dtype="bfloat16"``) in the port:
the plain bf16 versions of kernels A and C against the JAX package's Pallas
pools in interpret mode, the bf16 model against the JAX bf16 model on the
same weights with the bounds of ``tests/test_bf16.py``, float32 parameters
and gradients after bf16 steps, and the configs' mapping onto the policy."""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_fixture import DEMO, jax_model_and_params, port_model, source_batch
from ttdg_mgm_tpu import build as jbuild
from ttdg_mgm_tpu import config as jconfig
from ttdg_mgm_tpu.models import MaskRCNN as JMaskRCNN
from ttdg_mgm_tpu.ops.pallas.roi_pool_pallas import (multilevel_roi_align_windowed,
                                                     multilevel_roi_align_windowed_train)
from ttdg_mgm_torch import build as tbuild
from ttdg_mgm_torch import config as tconfig
from ttdg_mgm_torch.engine.steps import make_source_step, make_tta_step
from ttdg_mgm_torch.models.rcnn import MaskRCNN
from ttdg_mgm_torch.ops.roi_align import (_tap_pairs, multilevel_roi_align_backward,
                                          multilevel_roi_align_backward_bf16,
                                          multilevel_roi_align_bf16)
from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_backward
from ttdg_mgm_torch.solver.build import build_optimizer
from ttdg_mgm_torch.synth import synth_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 64), (32, 32), (16, 16), (8, 8)]


def _bf16_ulp(v):
    a = np.maximum(np.abs(v.astype(np.float32)), 2.0 ** -126)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _levels(seed, B=2, C=16):
    """bf16 levels, as bf16-exact float32 arrays for both packages."""
    rng = np.random.RandomState(seed)
    f32 = [rng.randn(B, h, w, C).astype(np.float32) for h, w in SIZES]
    return [np.asarray(jnp.asarray(f).astype(jnp.bfloat16).astype(jnp.float32)) for f in f32]


def _rois(seed, B=2, K=12):
    """Compact ROIs that each fit the TPU kernel's 32 x 40 window."""
    rng = np.random.RandomState(seed)
    wh = rng.uniform(8, 110, (B, K, 2)).astype(np.float32)
    xy = rng.uniform(0, 140, (B, K, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


@pytest.mark.parametrize("P", [7, 14])
def test_plain_bf16_pool_matches_the_tpu_kernel(P):
    """Kernel A's plain bf16 version (bf16-rounded tap weights, float32
    sums, one rounding) against ``multilevel_roi_align_windowed`` in
    interpret mode on the same bf16 levels and ROIs, at the model's adaptive
    grid: every value within 1 bf16 ulp (the two sum in other orders).  The
    wrapper on CPU tensors is that plain version."""
    feats, rois = _levels(0), _rois(1)
    want = np.asarray(multilevel_roi_align_windowed(
        [jnp.asarray(f).astype(jnp.bfloat16) for f in feats], jnp.asarray(rois),
        output_size=P, sampling_ratio=0, interpret=True).astype(jnp.float32))
    tf = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    got = multilevel_roi_align_bf16(tf, torch.from_numpy(rois), output_size=P)
    assert got.dtype == torch.bfloat16
    g = got.float().numpy()
    assert (np.abs(g - want) <= _bf16_ulp(g)).all()
    torch.testing.assert_close(multilevel_roi_pool(tf, torch.from_numpy(rois), output_size=P),
                               got, rtol=0, atol=0)


def test_plain_bf16_backward_is_more_exact_than_the_tpu_kernel():
    """Kernel C's plain bf16 gradient (each element a float32 sum rounded
    once) and the JAX train pool's bf16 gradient in interpret mode (rounded
    at every overlapping window), both against the float32 gradient of the
    same inputs: the port's largest error is no larger than JAX's (measured
    on this input: port 0.0104, JAX 0.0121), and the port is within 1 bf16
    ulp of the exact sum of its own terms (the same bf16 weights, float64),
    rounded to bf16."""
    feats, rois = _levels(2), _rois(3)
    B, K, P, C = 2, 12, 7, 16
    cot = np.asarray(jnp.asarray(np.random.RandomState(4).randn(B, K, P, P, C).astype(
        np.float32)).astype(jnp.bfloat16).astype(jnp.float32))
    _, vjp = jax.vjp(lambda fs: multilevel_roi_align_windowed_train(
        fs, jnp.asarray(rois), output_size=P, sampling_ratio=0, interpret=True),
        [jnp.asarray(f).astype(jnp.bfloat16) for f in feats])
    g_jax = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(cot).astype(
        jnp.bfloat16))[0]]
    tr, tc = torch.from_numpy(rois), torch.from_numpy(cot)
    g_port = multilevel_roi_align_backward_bf16(tc.to(torch.bfloat16), SIZES, tr)
    assert all(g.dtype == torch.bfloat16 for g in g_port)
    g_f32 = multilevel_roi_align_backward(tc, SIZES, tr)
    err_port = max(float((a.float() - b).abs().max()) for a, b in zip(g_port, g_f32))
    err_jax = max(float(np.abs(a - b.numpy()).max()) for a, b in zip(g_jax, g_f32))
    assert 0 < err_port <= err_jax
    # the exact sum of the port's own terms
    rows, outs, wgt, sizes = _tap_pairs(tr, SIZES, (4, 8, 16, 32), P, 0, 2, B, K)
    exact = torch.zeros((sum(sizes), C), dtype=torch.float64)
    exact.index_add_(0, rows, tc.reshape(-1, C)[outs].double() * wgt.double()[:, None])
    exact = exact.to(torch.float32).to(torch.bfloat16).float().numpy()
    port = torch.cat([g.float().reshape(-1, C) for g in g_port]).numpy()
    assert (np.abs(port - exact) <= _bf16_ulp(exact) + 1e-30).all()
    torch.testing.assert_close(
        multilevel_roi_pool_backward(tc.to(torch.bfloat16), SIZES, tr), g_port, rtol=0, atol=0)


# -- the model ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def bf16_models():
    jm, jp = jax_model_and_params()
    jm16 = JMaskRCNN(**{**DEMO["model_kwargs"], "compute_dtype": "bfloat16"})
    pm32 = port_model(jp)
    pm16 = MaskRCNN(**{**DEMO["model_kwargs"], "compute_dtype": "bfloat16"})
    pm16.load_state_dict(pm32.state_dict())
    return jm16, jp, pm32, pm16


def test_bf16_forward_inference_matches_jax_bf16(bf16_models):
    """``forward_inference`` on the fixture weights: the port's bf16 scores
    within 0.15 of the JAX bf16 model's and of the port's own float32 scores
    (``tests/test_bf16.py``'s bound), finite, ``mask_probs`` float32; the
    features are bf16."""
    jm16, jp, pm32, pm16 = bf16_models
    data = synth_batch(DEMO["size"], 2, seed=9)
    imgs, sizes = data["image"], data["image_sizes"]
    j = jm16.apply({"params": jp}, jnp.asarray(imgs), jnp.asarray(sizes),
                   method=jm16.forward_inference)
    ti, ts = torch.from_numpy(imgs), torch.from_numpy(sizes)
    t16 = pm16.forward_inference(ti, ts)
    t32 = pm32.forward_inference(ti, ts)
    assert t16["mask_probs"].dtype == torch.float32
    assert torch.isfinite(t16["scores"]).all()
    np.testing.assert_allclose(t16["scores"].numpy(), np.asarray(j["scores"]), atol=0.15)
    np.testing.assert_allclose(t16["scores"].numpy(), t32["scores"].numpy(), atol=0.15)
    with torch.no_grad():
        assert all(v.dtype == torch.bfloat16 for v in pm16.extract_features(ti).values())


def test_bf16_steps_keep_float32_parameters(bf16_models):
    """A bf16 source step and a bf16 TTA step: every loss finite and
    float32, the TTA loss > 0, every parameter and gradient float32."""
    _, _, _, pm16 = bf16_models
    model = MaskRCNN(**{**DEMO["model_kwargs"], "compute_dtype": "bfloat16"})
    model.load_state_dict(pm16.state_dict())
    opt = build_optimizer(model, lambda _: 1e-3)
    b = {k: torch.from_numpy(v) for k, v in source_batch(seed=3, n=2).items()}
    metrics = make_source_step(model, opt)(b, torch.Generator().manual_seed(0))
    for k, v in metrics.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert len(grads) > 40 and all(g.dtype == torch.float32 for g in grads)
    loss = make_tta_step(model, opt)({k: torch.from_numpy(v) for k, v in
                                      synth_batch(DEMO["size"], 2, seed=9).items()})
    assert loss.dtype == torch.float32 and torch.isfinite(loss) and float(loss) > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in model.parameters() if p.grad is not None)


# -- the configs -----------------------------------------------------------------------

@pytest.mark.parametrize("config,opts,want", [
    ("test_segment.yaml", [], "bfloat16"),
    ("test_segment.yaml", ["TPU.PRECISION", "float32"], "float32"),
    ("seg_res50fpn_source.yaml", ["TPU.PRECISION", "float32"], "bfloat16"),
    ("seg_res50fpn_source.yaml", ["TPU.PRECISION", "float32", "SOLVER.AMP.ENABLED", "False"],
     "float32")], ids=["default", "float32", "amp_in_file", "amp_off"])
def test_precision_maps_to_compute_dtype_as_jax(config, opts, want):
    """``SOLVER.AMP.ENABLED`` (on in ``seg_res50fpn_source.yaml``) or
    ``TPU.PRECISION bfloat16`` (the default) selects bf16 compute, as
    ``ttdg_mgm_tpu/build.py`` maps them."""
    path = os.path.join(REPO, "configs", config)
    got = tbuild.model_kwargs(tconfig.setup_cfg(path, opts))["compute_dtype"]
    assert got == jbuild.build_model(jconfig.setup_cfg(path, opts)).compute_dtype == want


def test_build_trainer_on_the_unchanged_flagship_config_is_bf16():
    """``build_trainer`` on ``configs/test_segment.yaml`` as shipped builds
    the bf16 flagship on the CPU: bf16 layers, float32 parameters."""
    cfg = tconfig.setup_cfg(os.path.join(REPO, "configs", "test_segment.yaml"),
                            ["MODEL.WEIGHTS", ""])
    trainer = tbuild.build_trainer(cfg, device="cpu")
    model = trainer.model
    assert model.compute_dtype == "bfloat16"
    assert model.backbone.bottom_up.res4[0].conv1.compute_dtype == torch.bfloat16
    assert model.roi_heads.box_predictor.cls_score.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
