"""Mask R-CNN R50-FPN with the multi-graph-matching losses.

Counterpart of ``ttdg_mgm_tpu/models/rcnn.py:MaskRCNN`` for the eval-only
TTA path and source training: ``extract_features``, ``_proposals``,
``_pool``, ``_box_inference``, ``forward_inference``, ``loss_ttt`` and
``loss_supervised``.  Modules carry detectron2 / reference names
(``backbone.bottom_up``, ``backbone.fpn_*``, ``proposal_generator.rpn_head``,
``roi_heads.*``, ``multi_matching_unsup``, ``multi_matching_sup.U``,
``multi_matching_sup.Net_U``), so the state dict exported from the JAX
package (``checkpoint/bridge.py``) loads by name.

Batch layout as in the JAX package: images ``(B, H, W, 3)`` float RGB 0-255,
``image_sizes (B, 2)`` valid (h, w); features leave ``extract_features`` as
NHWC levels.  Float32 compute only (the bf16 policy is not ported yet).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ttdg_mgm_torch.graph.mgm import MGM3Unsup
from ttdg_mgm_torch.graph.node_sampler import PrototypeComputation
from ttdg_mgm_torch.graph.universe import USup
from ttdg_mgm_torch.models.fpn import FPN
from ttdg_mgm_torch.models.resnet import STAGE_BLOCKS, ResNet
from ttdg_mgm_torch.models.roi_heads import (BoxHead, BoxPredictor, MaskHead, compact_rows,
                                             crop_gt_masks, fast_rcnn_losses,
                                             label_and_sample_proposals, mask_loss,
                                             roi_box_inference)
from ttdg_mgm_torch.models.rpn import RPNHead, generate_proposals, level_anchors, rpn_losses
from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_train

# d2 defaults (Base-RCNN-FPN): caffe-era pixel statistics
PIXEL_MEAN = (103.530, 116.280, 123.675)
PIXEL_STD = (1.0, 1.0, 1.0)


class ProposalGenerator(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.rpn_head = RPNHead(channels)


class ROIHeads(nn.Module):
    def __init__(self, channels: int, num_classes: int, box_fc_dim: int, box_num_fc: int,
                 mask_conv_dim: int, mask_num_conv: int):
        super().__init__()
        self.box_head = BoxHead(channels, 7, box_fc_dim, box_num_fc)
        self.box_predictor = BoxPredictor(box_fc_dim, num_classes)
        self.mask_head = MaskHead(channels, num_classes, mask_conv_dim, mask_num_conv)


class MaskRCNN(nn.Module):
    def __init__(self, *, num_classes: int = 2, univ_size: int = 32, sample_dist: int = 10,
                 node_cap_per_level: int = 20, cls_loss_type: str = "CrossEntropy",
                 pixel_mean: Sequence[float] = PIXEL_MEAN,
                 pixel_std: Sequence[float] = PIXEL_STD, pre_nms_topk_train: int = 2000,
                 pre_nms_topk_test: int = 1000, post_nms_topk: int = 1000,
                 detections_per_image: int = 100, batch_size_per_image: int = 512,
                 mask_fg_cap: int = 128, compute_dtype: str = "float32", sk_iters: int = 20,
                 sk_tau: float = 0.05, hippi_iters: int = 50, gagm_iters: int = 200,
                 lap_polish_iters: int = 200, resnet_depth: int = 50,
                 resnet_width: int = 256, freeze_at: int = 2, mask_on: bool = True,
                 score_thresh_test: float = 0.05, nms_thresh_test: float = 0.5,
                 roi_positive_fraction: float = 0.25,
                 rpn_nms_thresh: float = 0.7, pooler_sampling_ratio: int = 0,
                 fpn_channels: int = 256, box_fc_dim: int = 1024, box_num_fc: int = 2,
                 mask_conv_dim: int = 256, mask_num_conv: int = 4,
                 anchor_sizes: Sequence = ((32,), (64,), (128,), (256,), (512,))):
        super().__init__()
        if compute_dtype != "float32":
            raise NotImplementedError("only compute_dtype='float32' is ported")
        self.num_classes = num_classes
        self.univ_size = univ_size
        self.cls_loss_type = cls_loss_type
        self.pre_nms_topk_train = pre_nms_topk_train
        self.pre_nms_topk_test = pre_nms_topk_test
        self.batch_size_per_image = batch_size_per_image
        self.mask_fg_cap = mask_fg_cap
        self.roi_positive_fraction = roi_positive_fraction
        self.post_nms_topk = post_nms_topk
        self.detections_per_image = detections_per_image
        self.mask_on = mask_on
        self.score_thresh_test = score_thresh_test
        self.nms_thresh_test = nms_thresh_test
        self.rpn_nms_thresh = rpn_nms_thresh
        self.pooler_sampling_ratio = pooler_sampling_ratio
        self.anchor_sizes = tuple(tuple(s) for s in anchor_sizes)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, dtype=torch.float32),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, dtype=torch.float32),
                             persistent=False)
        bottom_up = ResNet(STAGE_BLOCKS[resnet_depth], resnet_width, freeze_at)
        self.backbone = FPN(bottom_up, [resnet_width * 2 ** i for i in range(4)], fpn_channels)
        self.proposal_generator = ProposalGenerator(fpn_channels)
        self.roi_heads = ROIHeads(fpn_channels, num_classes, box_fc_dim, box_num_fc,
                                  mask_conv_dim, mask_num_conv)
        self.multi_matching_sup = USup(num_classes, univ_size, fpn_channels, sk_tau=sk_tau,
                                       sk_iter=sk_iters, hippi_iters=hippi_iters)
        self.multi_matching_unsup = MGM3Unsup(
            num_classes, univ_size, fpn_channels, sk_tau=sk_tau, sk_iter=sk_iters,
            mgm_iter=gagm_iters, lap_polish_iters=lap_polish_iters)
        self.graph_generator = PrototypeComputation(num_classes, sample_dist,
                                                    node_cap_per_level)

    # -- shared feature path -------------------------------------------------

    def _features_nchw(self, images):
        x = (images - self.pixel_mean) / self.pixel_std
        return self.backbone(x.permute(0, 3, 1, 2))

    def extract_features(self, images):
        """images ``(B, H, W, 3)`` -> ``{"p2": (B, H/4, W/4, C), ..., "p6"}``."""
        return _to_nhwc(self._features_nchw(images))

    def _proposals(self, feats_nchw, image_sizes, *, train: bool = False):
        levels = [feats_nchw[f"p{i}"] for i in range(2, 7)]
        logits, regs = self.proposal_generator.rpn_head(levels)
        anchors = level_anchors([(f.shape[2], f.shape[3]) for f in levels],
                                sizes=self.anchor_sizes, device=image_sizes.device)
        props = generate_proposals(
            logits, regs, anchors, image_sizes,
            pre_nms_topk=self.pre_nms_topk_train if train else self.pre_nms_topk_test,
            post_nms_topk=self.post_nms_topk, nms_thresh=self.rpn_nms_thresh)
        return (logits, regs, anchors), props

    def _pool(self, feats, boxes, output_size: int, *, pack: bool = False):
        """Multi-level ROIAlign ``(B, K, 4) -> (B, K, P, P, C)`` (CUDA kernels
        on CUDA tensors): forward-only, or with ``pack`` the differentiable
        training pool (feature gradients through the backward kernel)."""
        levels = [feats[f"p{i}"] for i in range(2, 6)]
        if pack:
            return multilevel_roi_pool_train(levels, boxes, output_size=output_size,
                                             sampling_ratio=self.pooler_sampling_ratio)
        with torch.no_grad():
            return multilevel_roi_pool(levels, boxes, output_size=output_size,
                                       sampling_ratio=self.pooler_sampling_ratio)

    def _box_inference(self, feats, prop_boxes, prop_valid, image_sizes):
        B, K = prop_boxes.shape[:2]
        pooled = self._pool(feats, prop_boxes, 7)
        x = self.roi_heads.box_head(pooled.reshape(B * K, *pooled.shape[2:]))
        scores, deltas = self.roi_heads.box_predictor(x)
        return roi_box_inference(
            scores.reshape(B, K, -1), deltas.reshape(B, K, -1), prop_boxes, prop_valid,
            image_sizes, num_classes=self.num_classes, score_thresh=self.score_thresh_test,
            nms_thresh=self.nms_thresh_test, topk=self.detections_per_image)

    # -- branches ------------------------------------------------------------

    @torch.no_grad()
    def forward_inference(self, images, image_sizes):
        """Detections and per-detection mask probabilities: dict of boxes
        ``(B, D, 4)``, scores, classes, valid and mask_probs ``(B, D, 28, 28)``."""
        nchw = self._features_nchw(images)
        feats = _to_nhwc(nchw)
        _, (pboxes, _, pvalid) = self._proposals(nchw, image_sizes)
        boxes, scores, classes, valid = self._box_inference(feats, pboxes, pvalid, image_sizes)
        B, D = scores.shape
        if not self.mask_on:
            mask_probs = torch.zeros((B, D, 28, 28), device=boxes.device)
        else:
            pooled = self._pool(feats, boxes, 14)
            logits = self.roi_heads.mask_head(pooled.reshape(B * D, *pooled.shape[2:]))
            cls_idx = classes.clamp(0, self.num_classes - 1).reshape(B * D)
            sel = logits[torch.arange(B * D, device=logits.device), cls_idx]
            mask_probs = torch.sigmoid(sel).reshape(B, D, *sel.shape[1:])
        return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid,
                "mask_probs": mask_probs}

    def loss_ttt(self, images, image_sizes):
        """TTA loss: box inference (no gradient) -> graph nodes from the
        predicted boxes -> unsupervised MGM loss against the frozen universe."""
        nchw = self._features_nchw(images)
        feats = _to_nhwc(nchw)
        with torch.no_grad():
            _, (pboxes, _, pvalid) = self._proposals(nchw, image_sizes)
            boxes, _, classes, valid = self._box_inference(feats, pboxes, pvalid, image_sizes)
        nodes, labels, node_mask = self.graph_generator(
            [feats[f"p{i}"] for i in range(2, 7)], boxes, classes, valid)
        return self.multi_matching_unsup(nodes.float(), labels, node_mask,
                                         self.multi_matching_sup.U.detach())

    def loss_supervised(self, images, image_sizes, gt_boxes, gt_classes, gt_masks, gt_valid, *,
                        generator: torch.Generator | None = None, uniforms: dict | None = None):
        """Supervised source losses (reference ``supervised_source`` branch):
        RPN, box and mask losses, and the universe-matching loss on nodes
        from the GT boxes.  Returns a dict of scalar losses.

        GT is padded: boxes ``(B, G, 4)``, classes ``(B, G)`` 0-based, masks
        ``(B, G, R, R)`` on an ``R x R`` canvas over the padded image, valid
        ``(B, G)``.  The sampling uniforms are ``uniforms["rpn"] (B, N)``, one
        per anchor, and ``uniforms["roi"] (B, K + G)``, one per proposal and
        GT box; when not given they are drawn from ``generator``."""
        nchw = self._features_nchw(images)
        feats = _to_nhwc(nchw)
        (logits, regs, anchors), (pboxes, _, pvalid) = self._proposals(nchw, image_sizes,
                                                                       train=True)
        B = images.shape[0]
        if uniforms is None:
            dev = images.device
            n_anchors = sum(a.shape[0] for a in anchors)
            n_rois = pboxes.shape[1] + gt_boxes.shape[1]
            uniforms = {"rpn": torch.rand((B, n_anchors), generator=generator, device=dev),
                        "roi": torch.rand((B, n_rois), generator=generator, device=dev)}
        losses = rpn_losses(logits, regs, anchors, gt_boxes, gt_valid, uniforms["rpn"])

        S = self.batch_size_per_image
        sb, sc, sm, sfg, sv = label_and_sample_proposals(
            pboxes, pvalid, gt_boxes, gt_classes, gt_valid, uniforms["roi"],
            num_classes=self.num_classes, batch_size_per_image=S,
            positive_fraction=self.roi_positive_fraction)
        pooled = self._pool(feats, sb, 7, pack=True)
        x = self.roi_heads.box_head(pooled.reshape(B * S, *pooled.shape[2:]))
        scores, deltas = self.roi_heads.box_predictor(x)
        matched = torch.gather(gt_boxes, 1, sm[..., None].expand(B, S, 4))
        det = fast_rcnn_losses(scores.reshape(B, S, -1), deltas.reshape(B, S, -1), sb, matched,
                               sc, sfg, sv, num_classes=self.num_classes,
                               cls_loss_type=self.cls_loss_type)
        losses["loss_cls"] = det["loss_cls"].mean()
        losses["loss_box_reg"] = det["loss_box_reg"].mean()

        if self.mask_on:
            cap = self.mask_fg_cap
            (fg_boxes, fg_cls, fg_matched), n_fg = compact_rows(
                sfg, cap, (sb, 0.0), (sc, 0), (sm, 0))
            fg_mask = torch.arange(cap, device=sfg.device) < n_fg[:, None]
            pooled_m = self._pool(feats, fg_boxes, 14, pack=True)
            mlogits = self.roi_heads.mask_head(pooled_m.reshape(B * cap, *pooled_m.shape[2:]))
            mlogits = mlogits.reshape(B, cap, *mlogits.shape[1:])
            # GT masks live on a (R, R) canvas of the padded image: per-axis
            # scales (the canvas may be rectangular)
            mres = gt_masks.shape[-1]
            sy = mres / images.shape[1]
            sx = mres / images.shape[2]
            scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32, device=sb.device)
            m28 = crop_gt_masks(gt_masks, fg_matched, fg_boxes * scale)
            per_img = mask_loss(mlogits, fg_cls, m28, fg_mask)
            w = n_fg.to(torch.float32).clamp(min=1.0)
            losses["loss_mask"] = (per_img * w).sum() / w.sum()

        nodes, labels, node_mask = self.graph_generator(
            [feats[f"p{i}"] for i in range(2, 7)], gt_boxes, gt_classes.to(torch.int32), gt_valid)
        losses["loss_matching"] = self.multi_matching_sup(nodes.float(), labels, node_mask)
        return losses


def _to_nhwc(feats):
    return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in feats.items()}


@torch.no_grad()
def init_weights(model: MaskRCNN, generator: torch.Generator) -> MaskRCNN:
    """Random weights drawn from the JAX package's init distributions, from
    ``generator``: lecun-normal kernels (truncated at 2 std) and zero biases
    (flax defaults), FrozenBN identity with the residual branch's last norm
    at 0.1, RPN convs normal(0.01) with deltas normal(0.001), box predictor
    normal(0.01)/normal(0.001), affinity normal(0.01), ``U`` normal + 1/univ."""

    def lecun(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w.copy_(torch.nn.init.trunc_normal_(torch.empty_like(w, device="cpu"), 0.0, std,
                                            -2.0 * std, 2.0 * std, generator=generator))

    def normal(w, std):
        w.copy_(torch.randn(w.shape, generator=generator) * std)

    special = {}
    rh = model.proposal_generator.rpn_head
    special[id(rh.conv.weight)] = 0.01
    special[id(rh.objectness_logits.weight)] = 0.01
    special[id(rh.anchor_deltas.weight)] = 0.001
    bp = model.roi_heads.box_predictor
    special[id(bp.cls_score.weight)] = 0.01
    special[id(bp.bbox_pred.weight)] = 0.001
    aff = model.multi_matching_unsup.node_affinity
    for m in (aff.project_sr, aff.project_tg, aff.fc_M[0], aff.fc_M[2]):
        special[id(m.weight)] = 0.01
    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            w = mod.weight
            if id(w) in special:
                normal(w, special[id(w)])
            elif isinstance(mod, nn.Linear):
                lecun(w, w.shape[1])
            elif isinstance(mod, nn.ConvTranspose2d):
                lecun(w, w.shape[0] * w.shape[2] * w.shape[3])
            else:
                lecun(w, w.shape[1] * w.shape[2] * w.shape[3])
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, mod in model.backbone.bottom_up.named_modules():
        if name.endswith("conv3.norm"):
            mod.weight.fill_(0.1)
    U = model.multi_matching_sup.U
    U.copy_(torch.randn(U.shape, generator=generator) + 1.0 / U.shape[0])
    return model
