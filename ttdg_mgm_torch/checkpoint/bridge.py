"""Weights across: the JAX package's ``MaskRCNN`` parameter tree to the
port's detectron2-named state dict, and a loader into the port's modules.

:func:`flax_params_to_d2` is this package's own copy of the mapping
``ttdg_mgm_tpu/checkpoint/converter.py:flax_to_d2_state_dict`` (the port
imports nothing of the JAX package).  It takes the parameter tree as nested
dicts of NumPy arrays:

* conv kernels ``(kh, kw, I, O)`` -> ``(O, I, kh, kw)``; dense ``(I, O)`` ->
  ``(O, I)``; transposed-conv kernels are spatially flipped;
* FrozenBatchNorm ``scale``/``bias`` -> d2's four buffers with mean 0 and
  variance ``1 - eps``;
* a VGG trunk's ``backbone/trunk/conv{i}`` and ``conv{i}_norm`` go to
  ``backbone.bottom_up.features.{CONV_IDX[i]}`` and the index after it
  (torchvision ``vgg16_bn``'s numbering, ``models/vgg.py``); the JAX
  exporter reads ``stem_conv1`` unconditionally and raises ``KeyError`` on
  such a tree, so this mapping is the port's own;
* the box head's ``fc1`` kernel is re-flattened from the JAX NHWC order
  ``(P, P, C)`` to d2's NCHW ``(C, P, P)``;
* the affinity's split first layer is re-joined into ``fc_M.0``;
* the universe learner's attention ``multi_matching_sup/Net_U/g_gene`` goes
  to ``multi_matching_sup.Net_U.g_gene.*`` and the hoisted universe ``U`` to
  ``multi_matching_sup.U``;
* the discriminator's convolutions go to ``D_img.{conv1,conv2,classifier}``;
* the cross-domain head ``cross_domain`` keeps its JAX module names
  (``seed_project``, ``intra_gcn.graph.{wq,wk}``, ``intra_gcn.gc1`` .. ``gc3``
  with Kipf's ``weight (in, out)`` and ``bias``, ``intra_attention``,
  ``cross_attention``, ``node_cls``) and its ``matching_affinity`` takes the
  affinity layout above: 41 JAX leaves, 40 tensors.

:func:`load_reference_checkpoint` and :func:`merge_state_dict` read a d2
checkpoint or a Caffe2 ImageNet pickle (``MODEL.WEIGHTS``) into the port's
modules by name, with d2's leniency (``build.py:init_params``).  A reference checkpoint has no
``cross_domain.*`` names (the reference never wired its ``GModule``): the
merge reports them missing and they keep their initial values.

:func:`hypergraph_to_torch` maps a flax ``HyperGraphBlock`` tree
(``graph/hypergraph.py``) into that module's state dict.

:func:`vgg16bn_to_d2` is the counterpart of
``ttdg_mgm_tpu/checkpoint/converter.py:vgg16bn_to_flax``: torchvision
``vgg16_bn`` weights (``features.N.*``) as the port's trunk tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ttdg_mgm_torch.models.vgg import CONV_IDX as VGG_CONV_IDX

BN_EPS = 1e-5
#: the VGG trunk's prefix in the detector's state dict
VGG_PREFIX = "backbone.bottom_up.features."

#: state-dict prefixes of the modules this package owns; names outside them
#: are skipped by :func:`load_d2_state_dict`
OWNED_PREFIXES = ("backbone.", "proposal_generator.", "roi_heads.", "D_img.",
                  "multi_matching_unsup.", "multi_matching_sup.", "cross_domain.")


def _conv(k):
    return np.transpose(np.asarray(k), (3, 2, 0, 1))


def _dense(k):
    return np.transpose(np.asarray(k), (1, 0))


def _deconv(k):
    return np.transpose(np.asarray(k)[::-1, ::-1], (2, 3, 0, 1)).copy()


def _bn(blk, prefix, out):
    scale = np.asarray(blk["scale"])
    out[prefix + ".weight"] = scale
    out[prefix + ".bias"] = np.asarray(blk["bias"])
    out[prefix + ".running_mean"] = np.zeros_like(scale)
    out[prefix + ".running_var"] = np.full_like(scale, 1.0 - BN_EPS)


def _conv_block(blk, prefix, out):
    out[prefix + ".weight"] = _conv(blk["kernel"])
    if "bias" in blk:
        out[prefix + ".bias"] = np.asarray(blk["bias"])


def _dense_block(blk, prefix, out):
    out[prefix + ".weight"] = _dense(blk["kernel"])
    if "bias" in blk:
        out[prefix + ".bias"] = np.asarray(blk["bias"])


def _mha_block(blk, prefix, out):
    for n in ("linear_q", "linear_k", "linear_v", "linear_final"):
        _dense_block(blk[n], f"{prefix}.{n}", out)
    out[prefix + ".layer_norm.weight"] = np.asarray(blk["layer_norm"]["scale"])
    out[prefix + ".layer_norm.bias"] = np.asarray(blk["layer_norm"]["bias"])


def _affinity_block(aff, prefix, out):
    out[prefix + ".project_sr.weight"] = _dense(aff["project_sr"]["kernel"])
    out[prefix + ".project_tg.weight"] = _dense(aff["project_tg"]["kernel"])
    out[prefix + ".fc_M.0.weight"] = np.concatenate(
        [_dense(aff["fc0_x"]["kernel"]), _dense(aff["fc0_y"]["kernel"])], axis=1)
    out[prefix + ".fc_M.0.bias"] = np.asarray(aff["fc0_x"]["bias"])
    _dense_block(aff["fc1"], prefix + ".fc_M.2", out)


def _cross_domain_block(cd, out):
    pre = "cross_domain."
    _dense_block(cd["seed_project"], pre + "seed_project", out)
    gcn = cd["intra_gcn"]
    for n in ("wq", "wk"):
        _dense_block(gcn["graph"][n], f"{pre}intra_gcn.graph.{n}", out)
    for n in ("gc1", "gc2", "gc3"):
        out[f"{pre}intra_gcn.{n}.weight"] = np.asarray(gcn[n]["weight"]["kernel"])
        out[f"{pre}intra_gcn.{n}.bias"] = np.asarray(gcn[n]["weight"]["bias"])
    _mha_block(cd["intra_attention"], pre + "intra_attention", out)
    _mha_block(cd["cross_attention"], pre + "cross_attention", out)
    _dense_block(cd["node_cls"], pre + "node_cls", out)
    _affinity_block(cd["matching_affinity"], pre + "matching_affinity", out)


def flax_params_to_d2(params: dict, *, box_head_channels: int = 256) -> dict:
    """JAX ``MaskRCNN`` params (nested dicts of arrays) -> d2-named float32
    NumPy state dict."""
    p = dict(params)
    sd: dict = {}
    if "backbone" in p and "trunk" in p["backbone"]:
        trunk = p["backbone"]["trunk"]
        for i, idx in enumerate(VGG_CONV_IDX):
            _conv_block(trunk[f"conv{i}"], f"{VGG_PREFIX}{idx}", sd)
            _bn(trunk[f"conv{i}_norm"], f"{VGG_PREFIX}{idx + 1}", sd)
    elif "backbone" in p:
        bb = p["backbone"]
        bu = "backbone.bottom_up."
        _conv_block(bb["stem_conv1"], bu + "stem.conv1", sd)
        _bn(bb["stem_conv1_norm"], bu + "stem.conv1.norm", sd)
        for name, blk in bb.items():
            if not name.startswith("res"):
                continue
            stage, i = name.rsplit("_", 1)
            pre = f"{bu}{stage}.{i}."
            for c in ("conv1", "conv2", "conv3", "shortcut"):
                if c in blk:
                    _conv_block(blk[c], pre + c, sd)
                    _bn(blk[c + "_norm"], pre + c + ".norm", sd)
    if "fpn" in p:
        for i in range(2, 6):
            _conv_block(p["fpn"][f"lateral{i}"], f"backbone.fpn_lateral{i}", sd)
            _conv_block(p["fpn"][f"output{i}"], f"backbone.fpn_output{i}", sd)
    if "rpn_head" in p:
        for n in ("conv", "objectness_logits", "anchor_deltas"):
            _conv_block(p["rpn_head"][n], "proposal_generator.rpn_head." + n, sd)
    if "box_head" in p:
        C = box_head_channels
        w1 = _dense(p["box_head"]["fc1"]["kernel"])  # (fc, P*P*C) NHWC order
        P = int(round((w1.shape[1] // C) ** 0.5))
        w1 = w1.reshape(-1, P, P, C).transpose(0, 3, 1, 2).reshape(w1.shape[0], -1)
        sd["roi_heads.box_head.fc1.weight"] = w1
        sd["roi_heads.box_head.fc1.bias"] = np.asarray(p["box_head"]["fc1"]["bias"])
        for name, blk in p["box_head"].items():
            if name != "fc1":
                _dense_block(blk, f"roi_heads.box_head.{name}", sd)
        _dense_block(p["box_predictor"]["cls_score"], "roi_heads.box_predictor.cls_score", sd)
        _dense_block(p["box_predictor"]["bbox_pred"], "roi_heads.box_predictor.bbox_pred", sd)
    if "mask_head" in p:
        mh = "roi_heads.mask_head."
        for name, blk in p["mask_head"].items():
            if name == "deconv":
                sd[mh + "deconv.weight"] = _deconv(blk["kernel"])
                sd[mh + "deconv.bias"] = np.asarray(blk["bias"])
            else:
                _conv_block(blk, mh + name, sd)
    if "D_img" in p:
        for n in ("conv1", "conv2", "classifier"):
            _conv_block(p["D_img"][n], "D_img." + n, sd)
    if "U" in p:
        sd["multi_matching_sup.U"] = np.asarray(p["U"])
    if "multi_matching_sup" in p:
        _mha_block(p["multi_matching_sup"]["Net_U"]["g_gene"], "multi_matching_sup.Net_U.g_gene",
                   sd)
    if "multi_matching_unsup" in p:
        mu = p["multi_matching_unsup"]
        _mha_block(mu["intra_domain_graph"], "multi_matching_unsup.intra_domain_graph", sd)
        _affinity_block(mu["node_affinity"], "multi_matching_unsup.node_affinity", sd)
    if "cross_domain" in p:
        _cross_domain_block(p["cross_domain"], sd)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


def hypergraph_to_torch(params: dict) -> dict:
    """A flax ``HyperGraphBlock`` parameter tree (nested dicts of arrays:
    ``hgc1/theta/{kernel,bias}``, ``hgc2/...``) as ``graph/hypergraph.py``'s
    state dict of tensors: ``hgc{1,2}.theta.{weight,bias}``, the kernel
    transposed."""
    out = {}
    for n in ("hgc1", "hgc2"):
        _dense_block(params[n]["theta"], f"{n}.theta", out)
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in out.items()}


def vgg16bn_to_d2(sd: dict, prefix: str = "features.") -> dict:
    """torchvision ``vgg16_bn`` weights (``{prefix}{N}.*``: each conv's
    ``weight`` and ``bias``, its BatchNorm's ``weight``, ``bias``,
    ``running_mean`` and ``running_var`` at ``N + 1``, as JAX's defaults 0
    and 1 when absent) -> the detector's VGG trunk tensors
    (``backbone.bottom_up.features.{N}.*``), float32 NumPy.  The statistics
    stay d2 ``FrozenBatchNorm2d`` buffers (eps 1e-5, torchvision's), which
    compute what JAX's folded ``scale`` and ``bias`` compute;
    ``num_batches_tracked`` is dropped."""
    out = {}
    for idx in VGG_CONV_IDX:
        conv, bn = f"{prefix}{idx}.", f"{prefix}{idx + 1}."
        w = np.asarray(sd[bn + "weight"], np.float32)
        tensors = {f"{idx}.weight": sd[conv + "weight"], f"{idx}.bias": sd[conv + "bias"],
                   f"{idx + 1}.weight": w, f"{idx + 1}.bias": sd[bn + "bias"],
                   f"{idx + 1}.running_mean": sd.get(bn + "running_mean", np.zeros_like(w)),
                   f"{idx + 1}.running_var": sd.get(bn + "running_var", np.ones_like(w))}
        out.update({VGG_PREFIX + k: np.asarray(v, np.float32) for k, v in tensors.items()})
    return out


_C2_BRANCH = {"branch2a": "conv1", "branch2b": "conv2", "branch2c": "conv3",
              "branch1": "shortcut"}


def c2_resnet_to_d2_names(sd: dict) -> dict:
    """Caffe2 MSRA ImageNet ResNet names (``R-50.pkl``: ``conv1_w``,
    ``res_conv1_bn_{s,b}``, ``res{stage}_{block}_{branch}_{w,bn_s,bn_b}``)
    as d2 backbone names; other names (``fc1000``) are dropped.  This
    package's own copy of
    ``ttdg_mgm_tpu/checkpoint/converter.py:c2_resnet_to_d2_names``.

    Caffe2's norms are affine with no running statistics.  The JAX
    converter folds them with mean 0 and variance 1, a scale of ``bn_s /
    sqrt(1 + eps)``; so every norm loaded here also gets ``running_mean``
    0 and ``running_var`` 1 (the port's ``FrozenBatchNorm2d`` otherwise
    keeps ``1 - eps``, a scale of ``bn_s`` exactly)."""
    import re

    out = {}

    def norm(base, kind, v):
        out[f"{base}.norm.{'weight' if kind == 'bn_s' else 'bias'}"] = v
        out[base + ".norm.running_mean"] = np.zeros_like(v)
        out[base + ".norm.running_var"] = np.ones_like(v)

    for k, v in sd.items():
        if k == "conv1_w":
            out["backbone.bottom_up.stem.conv1.weight"] = v
        elif k in ("res_conv1_bn_s", "res_conv1_bn_b"):
            norm("backbone.bottom_up.stem.conv1", k[-4:], v)
        else:
            m = re.match(r"res(\d)_(\d+)_(branch\w+)_(w|bn_s|bn_b)$", k)
            conv = _C2_BRANCH.get(m.group(3)) if m else None
            if conv is None:
                continue
            stage, block, _, kind = m.groups()
            base = f"backbone.bottom_up.res{stage}.{block}.{conv}"
            if kind == "w":
                out[base + ".weight"] = v
            else:
                norm(base, kind, v)
    return out


def load_d2_state_dict(model: torch.nn.Module, sd: dict) -> list:
    """Copy a d2-named state dict into ``model``.  Strict on the names the
    model owns: every parameter and buffer under :data:`OWNED_PREFIXES`
    must be present with its shape, and no name under them may be unknown.
    Names outside them are skipped and returned."""
    own = model.state_dict()
    owned = {k for k in own if k.startswith(OWNED_PREFIXES)}
    given = {k for k in sd if k.startswith(OWNED_PREFIXES)}
    missing = sorted(owned - given)
    unexpected = sorted(given - owned)
    if missing or unexpected:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    with torch.no_grad():
        for k in sorted(owned):
            src = torch.tensor(np.asarray(sd[k]), dtype=own[k].dtype)
            if tuple(src.shape) != tuple(own[k].shape):
                raise ValueError(f"{k}: shape {tuple(src.shape)} != {tuple(own[k].shape)}")
            own[k].copy_(src)
    return sorted(set(sd) - given)


def load_reference_checkpoint(path: str, *, prefer: str = "modelTeacher") -> dict:
    """A d2 checkpoint (``.pth``, or a pickled ``.pkl``) -> ``{name: NumPy
    array}``.  A teacher-student checkpoint (``modelTeacher.*`` and
    ``modelStudent.*``) gives the member ``prefer`` with its prefix removed,
    as ``ttdg_mgm_tpu/checkpoint/converter.py:load_reference_checkpoint``
    does; a Caffe2 ImageNet pickle (``conv1_w``) gives its backbone under d2
    names (:func:`c2_resnet_to_d2_names`).  Checkpoints are pickles: load
    only files from a trusted source."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("model", data)
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}
    if "conv1_w" in sd:  # Caffe2 ImageNet pickle (backbone-only init)
        return c2_resnet_to_d2_names(sd)
    if any(k.startswith("modelTeacher.") for k in sd):
        pre = prefer + "."
        sd = {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    return sd


def merge_state_dict(model: torch.nn.Module, sd: dict) -> dict:
    """Copy the entries of ``sd`` whose name and shape match one of the
    model's parameters or buffers under :data:`OWNED_PREFIXES` (d2
    checkpoint semantics: a shape mismatch skips the entry, a name the
    checkpoint lacks keeps its current value).  Returns the names
    ``{"loaded": [...], "shape_mismatch": [...], "missing": [...]}``."""
    own = model.state_dict()
    report = {"loaded": [], "shape_mismatch": [], "missing": []}
    with torch.no_grad():
        for k in sorted(n for n in own if n.startswith(OWNED_PREFIXES)):
            if k not in sd:
                report["missing"].append(k)
            elif tuple(np.shape(sd[k])) != tuple(own[k].shape):
                report["shape_mismatch"].append(k)
            else:
                own[k].copy_(torch.tensor(np.asarray(sd[k]), dtype=own[k].dtype))
                report["loaded"].append(k)
    return report
