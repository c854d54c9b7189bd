"""Seeded random weights for a cell's model, made on the device in one draw.

The draw follows the program's init distributions (``models/rcnn.py:
init_weights``, from the JAX package's): lecun-normal kernels truncated at
two standard deviations (here: clamped there), zero biases, the RPN and
box-predictor heads and the affinity layers normal with the small fixed
standard deviations (but the box classifier's 1e-4, not 0.01: the box
head's features reach norms of about 2,500 on these frames, so at 0.01
every score saturates at 1.0, and every one of the 100 detections would
pass ``TEST.DICE_THRES`` and be scored by Dice, E and S, a load set by the
seed's chance; at 1e-4 the logits spread by about 0.25 and the scores lie
near one over the classes, as an untrained detector's do), the graph convolutions normal(0.02), LayerNorm at
identity, the universe ``U`` normal plus ``1 / univ``, the frozen batch
norms at identity with each ResNet block's last norm scaled to 0.1.  One
``torch.randn`` on the card's generator feeds every leaf, in float32, the
dtype the parameters are kept and served in.  The leaves and their shapes
come from the reference's model (``reference/``), built on the device; both
the program and the reference load the result.

A configuration's own reference model (``reference/cell.py``) may bring
rules for its leaves (``init_rules(model)``, in :func:`_plan`'s format):
they are applied over these, for the leaves these leave without a rule
(bare parameters, such as a position embedding) and for those the module
names.  The leaves keep their order and share the one draw.
"""

from __future__ import annotations

import math

import torch
from torch import nn

#: suffixes of the kernels drawn normal with a fixed standard deviation
FIXED_STD = (("rpn_head.conv.weight", 0.01), ("rpn_head.objectness_logits.weight", 0.01),
             ("rpn_head.anchor_deltas.weight", 0.001), ("box_predictor.cls_score.weight", 1e-4),
             ("box_predictor.bbox_pred.weight", 0.001), ("project_sr.weight", 0.01),
             ("project_tg.weight", 0.01), ("fc_M.0.weight", 0.01), ("fc_M.2.weight", 0.01))
#: the truncated normal's standard deviation over that of the untruncated one
TRUNC = 0.87962566103423978


def _plan(model: nn.Module, rules: dict | None = None) -> dict:
    """``{parameter name: ("normal", std, mean, clamp) or ("fill", value)}``,
    with ``rules`` (the same format) over the rules by module type."""
    from reference.graph.gcn import GraphConvolution

    plan = {}
    for mname, mod in model.named_modules():
        pre = mname + "." if mname else ""
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = mod.weight
            name = pre + "weight"
            fixed = next((s for suf, s in FIXED_STD if name.endswith(suf)), None)
            if fixed is not None:
                plan[name] = ("normal", fixed, 0.0, None)
            else:
                fan_in = (w.shape[1] if isinstance(mod, nn.Linear) else
                          w.shape[0] * w.shape[2] * w.shape[3]
                          if isinstance(mod, nn.ConvTranspose2d) else
                          w.shape[1] * w.shape[2] * w.shape[3])
                plan[name] = ("normal", math.sqrt(1.0 / fan_in) / TRUNC, 0.0, 2.0)
            if mod.bias is not None:
                plan[pre + "bias"] = ("fill", 0.0)
        elif isinstance(mod, nn.LayerNorm):
            plan[pre + "weight"] = ("fill", 1.0)
            plan[pre + "bias"] = ("fill", 0.0)
        elif isinstance(mod, GraphConvolution):
            plan[pre + "weight"] = ("normal", 0.02, 0.0, None)
            plan[pre + "bias"] = ("fill", 0.0)
    params = dict(model.named_parameters())
    U = "multi_matching_sup.U"
    plan[U] = ("normal", 1.0, 1.0 / params[U].shape[0], None)
    unknown = sorted(set(rules or ()) - set(params))
    if unknown:
        raise ValueError(f"init rules for leaves the model does not have: {unknown[:5]}")
    plan.update(rules or {})
    missing = [n for n in params if n not in plan]
    if missing:
        raise ValueError(f"no init rule for {missing[:5]}")
    return plan


@torch.no_grad()
def make_weights(model: nn.Module, seed: int, rules: dict | None = None) -> dict:
    """The state dict of ``model`` (on its device) with every parameter drawn
    from ``seed`` in one ``randn`` call, by :func:`_plan` with ``rules``, and
    its buffers as the model built them but for the ResNet blocks' last
    norms (0.1)."""
    params = dict(model.named_parameters())
    plan = _plan(model, rules)
    dev = next(model.parameters()).device
    drawn = [n for n in params if plan[n][0] == "normal"]
    total = sum(params[n].numel() for n in drawn)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=dev, dtype=torch.float32)
    out, off = {}, 0
    for name, p in params.items():
        rule = plan[name]
        if rule[0] == "fill":
            out[name] = torch.full_like(p, rule[1])
            continue
        _, std, mean, clamp = rule
        x = flat[off:off + p.numel()].view(p.shape)
        off += p.numel()
        if clamp is not None:
            x = x.clamp(-clamp, clamp)
        out[name] = x * std + mean
    for name, b in model.state_dict().items():
        if name in params:
            continue
        out[name] = b.clone()
        if name.startswith("backbone.bottom_up.") and name.endswith("conv3.norm.weight"):
            out[name].fill_(0.1)
    return out
