"""The cross-domain head's modules against the JAX package (CPU), at small
widths (16-24 features, 1-2 classes), inputs from NumPy seeds, JAX weights
carried into the port by ``checkpoint/bridge.py:flax_params_to_d2``.  Each
comparison is at rtol 1e-5 (atol 1e-6 for values near 0, 1e-7 for
Sinkhorn plans of order 1e-2) unless its test states another tolerance:

* ``ops/sinkhorn.py:sinkhorn_masked`` with a column mask, and without one
  (the universe learner's call: the same bits as an all-true column mask);
* ``graph/gcn.py``: ``Feat2Graph``, ``GraphConvolution`` and ``MAGNN``;
* ``graph/ot.py``: ``sinkhorn_distance`` (cost, plan and gradients) on
  inputs where its stop rule fires early, in both packages at the same
  iteration, and on one where it runs all 100 iterations; ``proto_loss``'s
  three outputs and gradients;
* ``graph/contrastive.py:sup_con_loss`` with labels, a mask and neither, in
  both contrast modes;
* ``graph/cross_domain.py:CrossDomainGraphHead``: the three losses, the
  gradients of the inputs and of every parameter (within 1e-4 of each
  leaf's largest value: the gradients run through three Sinkhorns; the
  attentions' key biases and the affinity's output bias, whose exact
  gradient is 0, below 1e-6 of the head's largest), and
  the new centers, with and without completion (the completion noise is
  JAX's own draw), and the refusal of unequal node counts;
* the bridge: all 41 JAX leaves of the head (40 tensors in the port, the
  affinity's first layer joined) with every parameter's count; a
  checkpoint without the head (the reference's) reports its 40 tensors
  missing and leaves them at their initial values.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ttdg_mgm_tpu.graph import contrastive as jcon
from ttdg_mgm_tpu.graph import gcn as jgcn
from ttdg_mgm_tpu.graph import ot as jot
from ttdg_mgm_tpu.graph.cross_domain import CrossDomainGraphHead as JHead
from ttdg_mgm_tpu.ops.sinkhorn import sinkhorn_masked as j_sinkhorn_masked
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2
from ttdg_mgm_torch.graph import contrastive as tcon
from ttdg_mgm_torch.graph import gcn as tgcn
from ttdg_mgm_torch.graph import ot as tot
from ttdg_mgm_torch.graph.cross_domain import CrossDomainGraphHead
from ttdg_mgm_torch.ops.sinkhorn import sinkhorn_masked


RTOL = 1e-5
D, K = 16, 2


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, rtol=RTOL, atol=1e-6, msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _load(module, prefix, jparams):
    """``module`` carrying the JAX parameters of the head (``prefix``
    ``cross_domain.``) through the bridge."""
    sd = flax_params_to_d2({"cross_domain": jax.tree.map(np.asarray, jparams)})
    module.load_state_dict({k[len(prefix):]: _t(v) for k, v in sd.items()
                            if k.startswith(prefix)})
    return module


def _gcn_state(jp, names):
    """A GCN block's JAX parameters as the port's state dict."""
    sd = {}
    for n in names:
        if n == "graph":
            for w in ("wq", "wk"):
                sd[f"graph.{w}.weight"] = _t(np.asarray(jp["graph"][w]["kernel"]).T.copy())
                sd[f"graph.{w}.bias"] = _t(jp["graph"][w]["bias"])
        else:
            sd[f"{n}.weight"] = _t(jp[n]["weight"]["kernel"])
            sd[f"{n}.bias"] = _t(jp[n]["weight"]["bias"])
    return sd


# -- masked Sinkhorn ---------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 9), (2, 6, 5)])
def test_sinkhorn_masked_with_column_mask_matches_jax(shape):
    rs = np.random.RandomState(len(shape))
    s = rs.randn(*shape).astype(np.float32)
    rows = rs.rand(*shape[:-1]) > 0.3
    cols = rs.rand(*shape[:-2], shape[-1]) > 0.3
    got = sinkhorn_masked(_t(s), _t(rows), _t(cols), tau=0.05, max_iter=20)
    want = np.asarray(j_sinkhorn_masked(jnp.asarray(s), jnp.asarray(rows), jnp.asarray(cols),
                                        tau=0.05, max_iter=20))
    _close(got, want, atol=1e-7)
    live = rows[..., :, None] & cols[..., None, :]
    assert (got.numpy()[~live] == 0).all() and (want[~live] == 0).all()
    assert got.numpy()[live].min() > 0


def test_sinkhorn_masked_row_mask_alone_keeps_its_bits():
    """The universe learner's one-mask call: equal to JAX's, and the same
    bits as the call with every column live."""
    rs = np.random.RandomState(3)
    s = rs.randn(12, 8).astype(np.float32)
    rows = rs.rand(12) > 0.25
    got = sinkhorn_masked(_t(s), _t(rows), tau=0.05, max_iter=20)
    assert torch.equal(got, sinkhorn_masked(_t(s), _t(rows), torch.ones(8, dtype=torch.bool),
                                            tau=0.05, max_iter=20))
    _close(got, j_sinkhorn_masked(jnp.asarray(s), jnp.asarray(rows), tau=0.05, max_iter=20),
           atol=1e-7)


# -- GCN ---------------------------------------------------------------------------


def _nodes(seed, M=9, dim=D):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, M, dim).astype(np.float32)
    mask = np.ones((2, M), bool)
    mask[0, -3:] = False
    return x, mask


def test_feat2graph_matches_jax():
    x, mask = _nodes(0)
    jm = jgcn.Feat2Graph(D)
    jp = jm.init(jax.random.PRNGKey(1), x, mask)["params"]
    _, want = jm.apply({"params": jp}, x, mask)
    tm = tgcn.Feat2Graph(D)
    tm.load_state_dict({k[len("graph."):]: v for k, v in _gcn_state({"graph": jp},
                                                                      ["graph"]).items()})
    _, got = tm(_t(x), _t(mask))
    _close(got, want, atol=1e-7)
    # padded rows and columns carry no mass; valid rows sum to 1
    assert (got[0, -3:].abs().sum() == 0) and (got[0, :, -3:].abs().sum() == 0)
    _close(got[1].sum(-1), np.ones(9))


def test_graph_convolution_matches_jax():
    x, _ = _nodes(1)
    adj = np.abs(np.random.RandomState(2).randn(2, 9, 9)).astype(np.float32)
    jm = jgcn.GraphConvolution(24)
    jp = jm.init(jax.random.PRNGKey(2), x, adj)["params"]
    jp = {"weight": {"kernel": jp["weight"]["kernel"],
                     "bias": jnp.asarray(np.random.RandomState(4).randn(24), jnp.float32)}}
    want = jm.apply({"params": jp}, x, adj)
    tm = tgcn.GraphConvolution(D, 24)
    tm.load_state_dict({"weight": _t(jp["weight"]["kernel"]), "bias": _t(jp["weight"]["bias"])})
    _close(tm(_t(x), _t(adj)), want)
    # the port's own init: normal(0.02) weights, zero bias
    w = tgcn.GraphConvolution(256, 256).weight.detach()
    assert abs(float(w.std()) - 0.02) < 1e-3 and abs(float(w.mean())) < 1e-3


def test_magnn_matches_jax():
    x, mask = _nodes(5)
    jm = jgcn.MAGNN(D, 24)
    jp = jm.init(jax.random.PRNGKey(3), x, mask)["params"]
    want = jm.apply({"params": jp}, x, mask)
    tm = tgcn.MAGNN(D, 24)
    tm.load_state_dict(_gcn_state(jp, ["graph", "gc1", "gc2", "gc3"]))
    got = tm(_t(x), _t(mask))
    _close(got, want)
    assert (got[0, -3:] == 0).all()


# -- OT and the prototype loss ------------------------------------------------------


def _stop_iteration(x, y, eps):
    """The first ``max_iter`` at which the port's result is already the
    100-iteration one (the stop rule applied the update of the iteration
    before it)."""
    full = tot.sinkhorn_distance(x, y, eps=eps)[1]
    for k in range(1, 101):
        if torch.equal(tot.sinkhorn_distance(x, y, eps=eps, max_iter=k)[1], full):
            return k


#: (eps, the clouds' spread, the iteration the stop rule fires at; 100: never)
OT_CASES = {"head_eps": (0.01, 1.0, 2), "stops_late": (0.1, 1.0, 86),
            "runs_out": (0.1, 3.0, 100)}


@pytest.mark.parametrize("case", sorted(OT_CASES))
def test_sinkhorn_distance_matches_jax(case):
    """Cost, plan and the cost's gradients on 8 and 11 points in 6
    dimensions.  At the head's ``eps`` 0.01 the stop rule fires at the
    second iteration; at 0.1 it fires at the 86th on clouds of spread 1 and
    never on clouds of spread 3.  Both packages stop at the same iteration
    (checked on JAX by its results after one iteration fewer, after that
    iteration and after 100)."""
    eps, scale, want_stop = OT_CASES[case]
    rs = np.random.RandomState(7)
    x = (rs.randn(1, 8, 6) * scale).astype(np.float32)
    y = (rs.randn(1, 11, 6) * scale + 0.1).astype(np.float32)
    cost, pi = tot.sinkhorn_distance(_t(x), _t(y), eps=eps)
    jcost, jpi = jot.sinkhorn_distance(jnp.asarray(x), jnp.asarray(y), eps=eps)
    _close(cost, jcost)
    _close(pi, jpi, atol=1e-7)
    stop = _stop_iteration(_t(x), _t(y), eps)
    assert stop == want_stop
    if stop < 100:
        for k, same in ((stop - 1, False), (stop, True)):
            jk = jot.sinkhorn_distance(jnp.asarray(x), jnp.asarray(y), eps=eps, max_iter=k)[1]
            assert np.array_equal(np.asarray(jk), np.asarray(jpi)) == same, k
    # the cost's gradient with respect to both clouds
    xt, yt = _t(x).requires_grad_(), _t(y).requires_grad_()
    tot.sinkhorn_distance(xt, yt, eps=eps)[0].sum().backward()
    jgx, jgy = jax.grad(lambda a, b: jot.sinkhorn_distance(a, b, eps=eps)[0].sum(),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    for got, want in ((xt.grad, jgx), (yt.grad, jgy)):
        _close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(want)).max()))


@pytest.mark.parametrize("beta", [0.01, 0.5])
def test_proto_loss_matches_jax(beta):
    rs = np.random.RandomState(2)
    mu = rs.randn(3, 8).astype(np.float32)
    ft = rs.randn(10, 8).astype(np.float32)
    prop = np.asarray([[0.2], [0.5], [0.3]], np.float32)
    want = jot.proto_loss(jnp.asarray(mu), jnp.asarray(ft), jnp.asarray(prop), beta=beta)
    mt, ftt = _t(mu).requires_grad_(), _t(ft).requires_grad_()
    got = tot.proto_loss(mt, ftt, _t(prop), beta=beta)
    for g, w, name in zip(got, want, ("t2p", "p2t", "new_prop")):
        _close(g, w, msg=name)
    assert not got[2].requires_grad
    (got[0] + got[1]).backward()
    jg = jax.grad(lambda a, b: sum(jot.proto_loss(a, b, jnp.asarray(prop), beta=beta)[:2]),
                  argnums=(0, 1))(jnp.asarray(mu), jnp.asarray(ft))
    for g, w in zip((mt.grad, ftt.grad), jg):
        _close(g, w, atol=1e-6)
    state = tot.ProtoLossState(3)
    _close(state.prop, jot.ProtoLossState(3).prop)


@pytest.mark.parametrize("mode", ["one", "all"])
@pytest.mark.parametrize("positives", ["labels", "mask", "neither"])
def test_sup_con_loss_matches_jax(mode, positives):
    rs = np.random.RandomState(4)
    f = rs.randn(6, 2, 8).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    labels = np.asarray([0, 1, 0, 2, 1, 1])
    mask = (rs.rand(6, 6) > 0.5).astype(np.float32)
    kw = {"labels": labels, "mask": mask, "neither": None}
    args = {} if positives == "neither" else {positives: kw[positives]}
    want = jcon.sup_con_loss(jnp.asarray(f), contrast_mode=mode,
                             **{k: jnp.asarray(v) for k, v in args.items()})
    ft = _t(f).requires_grad_()
    got = tcon.sup_con_loss(ft, contrast_mode=mode, **{k: _t(v) for k, v in args.items()})
    _close(got, want)
    got.backward()
    jg = jax.grad(lambda x: jcon.sup_con_loss(x, contrast_mode=mode, **{
        k: jnp.asarray(v) for k, v in args.items()}))(jnp.asarray(f))
    _close(ft.grad, jg, rtol=1e-4, atol=1e-5)


def test_sup_con_loss_refusals():
    f = torch.zeros(2, 2, 4)
    with pytest.raises(ValueError, match="both labels and mask"):
        tcon.sup_con_loss(f, labels=torch.zeros(2), mask=torch.eye(2))
    with pytest.raises(ValueError, match="Unknown mode"):
        tcon.sup_con_loss(f, contrast_mode="two")


# -- the head ---------------------------------------------------------------------


def _head_inputs(seed, M=10, dim=D, classes=K, tgt_missing=None):
    """Source and target node sets with masks and labels (class + 1, 0 for
    none); with ``tgt_missing``, that class is absent from the target."""
    rs = np.random.RandomState(seed)
    src, tgt = (rs.randn(M, dim).astype(np.float32) for _ in range(2))
    src_mask = np.arange(M) < M - 3
    tgt_mask = rs.rand(M) > 0.3
    src_labels = np.where(src_mask, np.arange(M) % classes + 1, 0).astype(np.int32)
    tgt_labels = np.where(tgt_mask, rs.randint(1, classes + 1, M), 0).astype(np.int32)
    if tgt_missing is not None:
        tgt_labels = np.where(tgt_labels == tgt_missing, 0, tgt_labels).astype(np.int32)
        tgt_mask &= tgt_labels > 0
    centers = rs.randn(classes + 1, dim).astype(np.float32)
    return src, src_labels, src_mask, tgt, tgt_labels, tgt_mask, centers


@pytest.fixture(scope="module")
def head_params():
    x = _head_inputs(0)
    return jax.jit(lambda: JHead(K, dim=D).init(jax.random.PRNGKey(0), *x[:6],
                                               completion_rng=jax.random.PRNGKey(0)))()["params"]


def _noise(rng, classes=K, dim=D):
    """The completion noise the JAX head draws from ``rng`` (its two
    ``_complete`` calls), stacked as the port takes it."""
    return np.stack([np.asarray(jax.random.normal(r, (classes, 4, dim)))
                     for r in jax.random.split(rng)])


@pytest.mark.parametrize("complete", [False, True], ids=["plain", "completion"])
def test_head_matches_jax(head_params, complete):
    """Losses, new centers, the gradients of both node sets and of every
    parameter.  With completion the target lacks class 2, so the target's
    completion slots of that class are live."""
    x = _head_inputs(1, tgt_missing=2 if complete else None)
    rng = jax.random.PRNGKey(9)
    kw = {"completion_rng": rng} if complete else {}
    jh = JHead(K, dim=D)

    def jloss(p, s, t):
        losses, centers = jh.apply({"params": p}, s, x[1], x[2], t, x[4], x[5], x[6], **kw)
        return sum(losses.values()), (losses, centers)

    (_, (jl, jc)), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        head_params, jnp.asarray(x[0]), jnp.asarray(x[3]))
    head = _load(CrossDomainGraphHead(K, dim=D), "cross_domain.", head_params)
    s, t = _t(x[0]).requires_grad_(), _t(x[3]).requires_grad_()
    losses, centers = head(s, _t(x[1]), _t(x[2]), t, _t(x[4]), _t(x[5]), _t(x[6]),
                           noise=_t(_noise(rng)) if complete else None)
    assert set(losses) == set(jl) == {"loss_node_cls", "loss_cross_matching", "loss_topology"}
    for k in jl:
        _close(losses[k], jl[k], msg=k)
    _close(centers, jc, atol=1e-6)
    assert not centers.requires_grad
    # the EMA moved the seen classes only (class 2 is seen in the source)
    assert not np.allclose(centers.numpy(), x[6])
    sum(losses.values()).backward()
    for got, want in ((s.grad, jg[1]), (t.grad, jg[2])):
        _close(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(np.asarray(want)).max()))
    gsd = flax_params_to_d2({"cross_domain": jax.tree.map(np.asarray, jg[0])})
    params = dict(head.named_parameters())
    assert len(params) == len(gsd) == 40
    top = max(float(np.abs(v).max()) for v in gsd.values())
    live = 0
    for name, want in gsd.items():
        got = params[name[len("cross_domain."):]].grad
        got = torch.zeros(want.shape) if got is None else got
        scale = float(np.abs(want).max())
        if name.endswith("seed_project.weight"):
            # the seed projection is used only by completion
            assert (scale > 0) == complete, name
        if scale == 0:
            assert not got.any(), name
            continue
        if scale < 1e-6 * top:
            # zero in exact arithmetic: the attentions' key biases (a bias
            # shared by every key shifts each query's logits by a constant,
            # which the softmax drops) and the affinity's output bias (a
            # constant shift of every score, which the Sinkhorn drops); both
            # packages give round-off
            assert name.endswith(("linear_k.bias", "fc_M.2.bias")), name
            assert float(got.abs().max()) < 1e-6 * top, name
            continue
        live += scale > 0
        _close(got, want, rtol=1e-4, atol=1e-4 * scale + 1e-9, msg=name)
    assert live >= 34


def test_head_refuses_unequal_node_counts(head_params):
    x = _head_inputs(2)
    head = _load(CrossDomainGraphHead(K, dim=D), "cross_domain.", head_params)
    with pytest.raises(ValueError, match="10 node rows and the target 12"):
        head(_t(x[0]), _t(x[1]), _t(x[2]), torch.zeros(12, D), torch.ones(12, dtype=torch.int32),
             torch.ones(12, dtype=torch.bool))


def test_head_single_class_and_centers_from_zero():
    """One class, no centers given: they start at zero; class 1 moves, and
    class 0, which collects the padded rows (zero after the attention's
    mask), stays at zero."""
    x = _head_inputs(3, dim=24, classes=1)
    jh = JHead(1, dim=24)
    jp = jax.jit(lambda: jh.init(jax.random.PRNGKey(4), *x[:6],
                                 completion_rng=jax.random.PRNGKey(1)))()["params"]
    jl, jc = jax.jit(lambda p: jh.apply({"params": p}, *x[:6]))(jp)
    head = _load(CrossDomainGraphHead(1, dim=24), "cross_domain.", jp)
    losses, centers = head(*(_t(v) for v in x[:6]))
    for k in jl:
        _close(losses[k], jl[k], msg=k)
    _close(centers, jc, atol=1e-6)
    assert centers.shape == (2, 24) and (centers[1] != 0).all() and not centers[0].any()
    assert head.draw_noise(torch.Generator().manual_seed(0)).shape == (2, 1, 4, 24)


def test_bridge_carries_every_leaf_of_the_head():
    """At the flagship width (256) and 1 class: 41 JAX leaves, 1,316,867
    parameters, all carried into the port's 40 tensors."""
    jh = JHead(1, dim=256)
    x = [np.zeros((4, 256), np.float32), np.ones(4, np.int32), np.ones(4, bool)] * 2
    shapes = jax.eval_shape(lambda: jh.init(jax.random.PRNGKey(0), *x,
                                            completion_rng=jax.random.PRNGKey(0)))["params"]
    leaves = jax.tree.leaves(shapes)
    assert len(leaves) == 41
    assert sum(int(np.prod(s.shape)) for s in leaves) == 1_316_867
    rs = np.random.RandomState(0)
    tree = jax.tree.map(lambda s: rs.randn(*s.shape).astype(np.float32), shapes)
    sd = flax_params_to_d2({"cross_domain": tree})
    head = CrossDomainGraphHead(1, dim=256)
    own = head.state_dict()
    assert sorted(k[len("cross_domain."):] for k in sd) == sorted(own)
    assert len(sd) == 40 and sum(v.size for v in sd.values()) == 1_316_867
    for k, v in sd.items():
        assert tuple(own[k[len("cross_domain."):]].shape) == v.shape, k
    np.testing.assert_array_equal(sd["cross_domain.intra_gcn.gc2.weight"],
                                  tree["intra_gcn"]["gc2"]["weight"]["kernel"])
    np.testing.assert_array_equal(sd["cross_domain.node_cls.weight"],
                                  tree["node_cls"]["kernel"].T)


def test_reference_checkpoint_without_the_head_keeps_its_init():
    """A reference d2 checkpoint has no ``cross_domain.*`` names (the
    reference never wired its ``GModule``): ``merge_state_dict`` loads
    everything else, reports the head's 40 tensors missing, and they keep
    their initial values."""
    from ttdg_mgm_torch.checkpoint.bridge import merge_state_dict
    from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights

    kw = dict(resnet_depth=14, resnet_width=16, fpn_channels=16, box_fc_dim=16,
              mask_conv_dim=16, univ_size=4)
    src = init_weights(MaskRCNN(**kw), torch.Generator().manual_seed(1)).state_dict()
    ref = {k: v.numpy() for k, v in src.items() if not k.startswith("cross_domain.")}
    model = init_weights(MaskRCNN(**kw), torch.Generator().manual_seed(0))
    head = {k: v.clone() for k, v in model.state_dict().items() if k.startswith("cross_domain.")}
    report = merge_state_dict(model, ref)
    assert sorted(report["missing"]) == sorted(head) and len(head) == 40
    assert not report["shape_mismatch"] and len(report["loaded"]) == len(ref)
    sd = model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in head.items())
    assert all(torch.equal(sd[k], src[k]) for k in ref)
