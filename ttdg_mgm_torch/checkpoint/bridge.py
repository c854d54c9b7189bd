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
* the box head's ``fc1`` kernel is re-flattened from the JAX NHWC order
  ``(P, P, C)`` to d2's NCHW ``(C, P, P)``;
* the affinity's split first layer is re-joined into ``fc_M.0``;
* the universe learner's attention ``multi_matching_sup/Net_U/g_gene`` goes
  to ``multi_matching_sup.Net_U.g_gene.*`` and the hoisted universe ``U`` to
  ``multi_matching_sup.U``.

:func:`load_reference_checkpoint` and :func:`merge_state_dict` read a d2
checkpoint (``MODEL.WEIGHTS``) into the port's modules by name, with d2's
leniency (``build.py:init_params``).
"""

from __future__ import annotations

import numpy as np
import torch

BN_EPS = 1e-5

#: state-dict prefixes of the modules this package owns; names outside them
#: (the discriminator) are skipped by :func:`load_d2_state_dict`
OWNED_PREFIXES = ("backbone.", "proposal_generator.", "roi_heads.",
                  "multi_matching_unsup.", "multi_matching_sup.")


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


def flax_params_to_d2(params: dict, *, box_head_channels: int = 256) -> dict:
    """JAX ``MaskRCNN`` params (nested dicts of arrays) -> d2-named float32
    NumPy state dict."""
    p = dict(params)
    sd: dict = {}
    if "backbone" in p:
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
    if "U" in p:
        sd["multi_matching_sup.U"] = np.asarray(p["U"])
    if "multi_matching_sup" in p:
        _mha_block(p["multi_matching_sup"]["Net_U"]["g_gene"], "multi_matching_sup.Net_U.g_gene",
                   sd)
    if "multi_matching_unsup" in p:
        mu = p["multi_matching_unsup"]
        _mha_block(mu["intra_domain_graph"], "multi_matching_unsup.intra_domain_graph", sd)
        aff = mu["node_affinity"]
        pre = "multi_matching_unsup.node_affinity"
        sd[pre + ".project_sr.weight"] = _dense(aff["project_sr"]["kernel"])
        sd[pre + ".project_tg.weight"] = _dense(aff["project_tg"]["kernel"])
        sd[pre + ".fc_M.0.weight"] = np.concatenate(
            [_dense(aff["fc0_x"]["kernel"]), _dense(aff["fc0_y"]["kernel"])], axis=1)
        sd[pre + ".fc_M.0.bias"] = np.asarray(aff["fc0_x"]["bias"])
        _dense_block(aff["fc1"], pre + ".fc_M.2", sd)
    return {k: np.asarray(v, np.float32) for k, v in sd.items()}


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
    does.  Checkpoints are pickles: load only files from a trusted source."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
    else:
        data = torch.load(path, map_location="cpu", weights_only=False)
    sd = data.get("model", data)
    sd = {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in sd.items()}
    if "conv1_w" in sd:
        raise NotImplementedError(
            f"{path} is a Caffe2 ImageNet pickle; its name map (c2_resnet_to_d2_names) is not "
            "ported to ttdg_mgm_torch yet (ROADMAP.md, Queue 1: the long tail)")
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
