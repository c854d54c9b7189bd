"""The slice as a whole: the port's TTA step and inference against the JAX
package on the committed golden fixture (CPU).

Same weights (carried across by ``ttdg_mgm_torch.checkpoint.bridge``), same
4 domain-shifted images.  Compared, each with its tolerance:

* ``loss_ttt``: rtol 1e-4;
* the gradient of every parameter: max abs error per leaf <= 1e-3 * max |g|,
  plus a float32 floor of 1e-6 times the largest gradient of any leaf;
* the parameters after one ``make_tta_step`` (SGD momentum 0.9, weight decay
  1e-4 on every trainable leaf, lr ``DEMO["tta_lr"]``): the gradient bound
  times the learning rate, plus 1e-6 for float32 rounding;
* ``forward_inference`` after the step: identical ``valid`` and
  ``classes``, boxes atol 2e-2, scores atol 1e-3, mask_probs atol 2e-3
  (tests/test_detector_parity.py:249-252).

The GA-GM solve inside the loss is pinned to the JAX solver's own output on
both sides.  On this fixture (4 nodes per graph, 8 universe slots) the
terminal hard-assignment round runs its full 200 steps without converging:
the orbit is chaotic.  The JAX solver itself ends in other assignments when
its inputs move by float32 summation order (about 1e-6 relative here), and
so does the port's solver on the JAX solver's exact inputs.  The solver is
held against the JAX package on its own, on structured problems
(tests/test_torch_gagm.py); the port's real solve still runs here and must
give an active, finite loss.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ttdg_mgm_tpu.graph.mgm as j_mgm
import ttdg_mgm_torch.graph.mgm as t_mgm
from demo_config import DEMO
from torch_port_fixture import jax_model_and_params, port_model, shifted_images, to_numpy_tree
from ttdg_mgm_tpu.graph.solvers import ga_gm as j_ga_gm
from ttdg_mgm_tpu.solver.build import build_optimizer as j_build_optimizer
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2
from ttdg_mgm_torch.engine.steps import make_tta_step
from ttdg_mgm_torch.solver.build import build_optimizer


def _jax_solver_output(model, params, imgs, sizes):
    """The JAX GA-GM solution inside ``loss_ttt`` for these images."""

    def solve(m, im, sz):
        feats = m.extract_features(im)
        _, (pb, _, pv) = m._proposals(feats, sz, train=False)
        boxes, _, classes, valid = m._box_inference(feats, pb, pv, sz)
        nodes, labels, mask = m.graph_generator(m._feature_list(feats),
                                                jax.lax.stop_gradient(boxes), classes, valid)
        mu = m.multi_matching_unsup
        A, W, _, _, U0, ms = mu.build_problem(nodes.astype(jnp.float32), labels, mask,
                                              jax.lax.stop_gradient(m.U))
        return j_ga_gm(A, W, U0, ms, m.univ_size, quad_weight=mu.quad_weight,
                       mgm_iter=mu.mgm_iter, sk_iter=mu.sk_iter, sk_tau0=0.1, sk_gamma=0.5,
                       min_tau=1e-2, tol=1e-3)

    return np.array(jax.jit(lambda p: model.apply({"params": p}, imgs, sizes,
                                                  method=solve))(params))


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    jm, jp = jax_model_and_params()
    imgs, sizes = shifted_images(tmp_path_factory.mktemp("tta_imgs"))
    ji, js = jnp.asarray(imgs), jnp.asarray(sizes)
    ti, ts = torch.from_numpy(imgs), torch.from_numpy(sizes)
    lr = DEMO["tta_lr"]

    # the port's own solve: matching active, finite loss
    pm = port_model(jp)
    real_loss = float(pm.loss_ttt(ti, ts).detach())

    U_fix = _jax_solver_output(jm, jp, ji, js)
    mp = pytest.MonkeyPatch()
    mp.setattr(j_mgm, "ga_gm", lambda *a, **k: jnp.asarray(U_fix))
    mp.setattr(t_mgm, "ga_gm_fused",
               lambda *a, **k: (torch.from_numpy(U_fix), None))
    try:
        loss_fn = jax.jit(jax.value_and_grad(lambda p: jm.apply(
            {"params": p}, ji, js, method=jm.loss_ttt)))
        jl, jg = loss_fn(jp)
        tx = j_build_optimizer(jp, lambda _: lr)
        updates, _ = tx.update(jg, tx.init(jp), jp)
        jp_new = optax.apply_updates(jp, updates)

        pm = port_model(jp)
        opt = build_optimizer(pm, lambda _: lr)
        step = make_tta_step(pm, opt)
        # gradients of the same loss, before the step's update
        pl = pm.loss_ttt(ti, ts)
        pl.backward()
        grads = {n: (p.grad.clone() if p.grad is not None else torch.zeros_like(p))
                 for n, p in pm.named_parameters() if p.requires_grad}
        step_loss = float(step({"image": ti, "image_sizes": ts}))
    finally:
        mp.undo()
    j_out = jm.apply({"params": jp_new}, ji, js, method=jm.forward_inference)
    t_out = pm.forward_inference(ti, ts)
    C = DEMO["model_kwargs"]["fpn_channels"]
    return dict(jl=float(jl), pl=float(pl.detach()), step_loss=step_loss, real_loss=real_loss,
                jg=flax_params_to_d2(to_numpy_tree(jg), box_head_channels=C),
                grads=grads, lr=lr,
                jp_new=flax_params_to_d2(to_numpy_tree(jp_new), box_head_channels=C),
                pm=pm, j_out={k: np.asarray(v) for k, v in j_out.items()},
                t_out={k: v.numpy() for k, v in t_out.items()})


def test_loss_and_matching_active(slice_run):
    r = slice_run
    assert np.isfinite(r["real_loss"]) and r["real_loss"] > 0.0
    assert r["jl"] > 0.0
    np.testing.assert_allclose(r["pl"], r["jl"], rtol=1e-4)
    np.testing.assert_allclose(r["step_loss"], r["jl"], rtol=1e-4)


def test_gradients_every_parameter(slice_run):
    r = slice_run
    assert len(r["grads"]) > 50
    # float32 cancellation floor for leaves whose gradient is nearly zero by
    # symmetry (the affinity's output bias: Sinkhorn ignores a common shift)
    floor = 1e-6 * max(np.abs(g).max() for g in r["jg"].values())
    nonzero = 0
    for name, g in r["grads"].items():
        want = r["jg"][name]
        bound = 1e-3 * np.abs(want).max()
        err = np.abs(g.numpy() - want).max()
        assert err <= bound + floor, f"{name}: max err {err} > {bound} + {floor}"
        nonzero += bool(np.abs(want).max() > 0)
    assert nonzero > 20  # the backbone, FPN, attention and affinity all learn


def test_parameters_after_one_step(slice_run):
    r = slice_run
    params = dict(r["pm"].named_parameters())
    for name, g in r["grads"].items():
        want = r["jp_new"][name]
        tol = r["lr"] * 1e-3 * np.abs(r["jg"][name]).max() + 1e-6
        np.testing.assert_allclose(params[name].detach().numpy(), want, rtol=0, atol=tol,
                                   err_msg=name)


def test_inference_after_step(slice_run):
    j, t = slice_run["j_out"], slice_run["t_out"]
    np.testing.assert_array_equal(t["valid"], j["valid"])
    np.testing.assert_array_equal(t["classes"], j["classes"])
    np.testing.assert_allclose(t["boxes"], j["boxes"], atol=2e-2)
    np.testing.assert_allclose(t["scores"], j["scores"], atol=1e-3)
    np.testing.assert_allclose(t["mask_probs"], j["mask_probs"], atol=2e-3)
    assert j["valid"].sum() > 0
