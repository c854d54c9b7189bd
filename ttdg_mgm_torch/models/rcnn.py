"""Mask R-CNN with an FPN on a ResNet or VGG-16-BN trunk, or ViTDet's simple
feature pyramid on a plain ViT (``backbone_name``), with the
multi-graph-matching losses.

Counterpart of ``ttdg_mgm_tpu/models/rcnn.py:MaskRCNN`` for the eval-only
TTA path, source training and the mean-teacher step with its cross-domain
head: ``extract_features``, ``_proposals``, ``_pool``, ``_box_inference``,
``forward_inference``, ``proposals_weak``, ``loss_ttt``,
``loss_supervised``, ``loss_cross_domain``, ``_dis_feature`` and
``loss_domain``.  Modules carry detectron2 / reference names
(``backbone.bottom_up``, ``backbone.fpn_*``, ``proposal_generator.rpn_head``,
``roi_heads.*``, ``D_img``, ``multi_matching_unsup``,
``multi_matching_sup.U``, ``multi_matching_sup.Net_U``) and the JAX names
of the cross-domain head (``cross_domain.*``), so the state dict exported
from the JAX package (``checkpoint/bridge.py``) loads by name.

Batch layout as in the JAX package: images ``(B, H, W, 3)`` float RGB 0-255,
``image_sizes (B, 2)`` valid (h, w); features leave ``extract_features`` as
NHWC levels.

``compute_dtype="bfloat16"`` is the JAX package's bf16 compute policy, with
its casts site by site (``ttdg_mgm_tpu/models/rcnn.py``): parameters stay
float32; the backbone, FPN, RPN head, box head, box predictor and mask head
compute in bfloat16 (``models/layers.py``), so the features, the pools
(kernels A and C on bfloat16 levels) and the heads' activations are
bfloat16; the consumers that need precision upcast their own small outputs
(RPN logits and deltas, box scores and deltas, mask logits, the
discriminator's logits) and the graph nodes enter the matching modules
and the cross-domain head as float32; the GT-mask crop stays float32.  The
VGG trunk computes in float32 on the bf16-rounded input, as the JAX model's
does (``models/vgg.py``).

``backbone_name="vit"`` is ViTDet's Mask R-CNN (detectron2's
``mask_rcnn_vitdet_b_100ep.py``): the trunk of ``models/vit.py`` under
``fpn.py:SimpleFeaturePyramid`` (``vit``: the trunk's fields and
``square_pad``), with ``rpn_num_convs`` 2, a box head of ``box_num_conv``
normed convolutions before its ``box_num_fc`` dense layers and a mask head
normed by ``mask_norm`` (``"LN"``).  Its input is padded or cut to the
``square_pad`` square (detectron2's ``square_pad``; the loaders' canvas is
that square, so only zero padding is cut).  The norm rule of the optimizer
(``solver/build.py:trainable_mask``) freezes the channel LayerNorms the
pyramid's and heads' convolutions carry as ``norm``, as it freezes the
ResNet's frozen norms; the ViT's ``norm1``, ``norm2`` and the pyramid's
``simfp_2.1`` train.

Spans (``utils/profiling.py``) on every path through the model:
``step.backbone`` (trunk and FPN), ``step.proposals`` (RPN head, decode,
top-k and NMS; the RPN losses), ``step.box_inference`` (the box head and
its NMS), ``step.roi_heads`` (the supervised box and mask heads and their
losses; the mask head at inference), ``step.node_sampler`` (graph nodes),
``step.matching`` (the TTA matching loss, ``graph/mgm.py``) and
``step.universe`` (the source matching loss against the universe).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ttdg_mgm_torch.graph.cross_domain import CrossDomainGraphHead
from ttdg_mgm_torch.graph.gcn import GraphConvolution
from ttdg_mgm_torch.graph.mgm import MGM3Unsup
from ttdg_mgm_torch.graph.node_sampler import PrototypeComputation
from ttdg_mgm_torch.graph.universe import USup
from ttdg_mgm_torch.models.discriminator import FCDiscriminatorImg, grad_reverse
from ttdg_mgm_torch.models.fpn import FPN, SimpleFeaturePyramid
from ttdg_mgm_torch.models.layers import set_compute_dtype
from ttdg_mgm_torch.models.resnet import STAGE_BLOCKS, ResNet
from ttdg_mgm_torch.models.roi_heads import (BoxHead, BoxPredictor, MaskHead, compact_rows,
                                             crop_gt_masks, fast_rcnn_losses,
                                             label_and_sample_proposals, mask_loss,
                                             roi_box_inference)
from ttdg_mgm_torch.models.rpn import RPNHead, generate_proposals, level_anchors, rpn_losses
from ttdg_mgm_torch.models.vgg import STAGE_CHANNELS as VGG_STAGE_CHANNELS
from ttdg_mgm_torch.models.vgg import VGG16FPNBackbone
from ttdg_mgm_torch.models.vit import ViT, init_vit_
from ttdg_mgm_torch.ops.roi_pool import multilevel_roi_pool, multilevel_roi_pool_train
from ttdg_mgm_torch.utils.profiling import span

#: compute dtypes of the JAX ``MaskRCNN.compute_dtype`` field (None: the
#: layers' own float32)
COMPUTE_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# d2 defaults (Base-RCNN-FPN): caffe-era pixel statistics
PIXEL_MEAN = (103.530, 116.280, 123.675)
PIXEL_STD = (1.0, 1.0, 1.0)

#: the discriminator's hidden width by ``dis_type`` (JAX ``rcnn.py:163-167``):
#: the raw backbone stages' R50 widths, whatever the trunk (flax infers only
#: the input width); an FPN level takes ``fpn_channels``
DIS_CHANNELS = {"res2": 256, "res3": 512, "res4": 1024, "res5": 2048}


def _bce_with_logits_mean(logits, target_value: float):
    """JAX ``_bce_with_logits_mean``: the mean BCE of logits clipped to
    [-30, 30] against a constant target."""
    x = logits.clamp(-30, 30)
    return (x.clamp(min=0) - x * target_value + torch.log1p(torch.exp(-x.abs()))).mean()


class ProposalGenerator(nn.Module):
    def __init__(self, channels: int, num_convs: int = 1):
        super().__init__()
        self.rpn_head = RPNHead(channels, num_convs=num_convs)


class ROIHeads(nn.Module):
    """The box head and predictor, and the mask head when ``mask_on`` (the
    JAX model of ``mask_on=False`` never calls its mask head, so it has no
    such parameters)."""

    def __init__(self, channels: int, num_classes: int, box_fc_dim: int, box_num_fc: int,
                 mask_conv_dim: int, mask_num_conv: int, mask_on: bool = True,
                 box_num_conv: int = 0, box_conv_dim: int = 256, box_norm: str = "",
                 mask_norm: str = ""):
        super().__init__()
        self.box_head = BoxHead(channels, 7, box_fc_dim, box_num_fc, box_num_conv, box_conv_dim,
                                box_norm)
        self.box_predictor = BoxPredictor(
            box_fc_dim if box_num_fc else (box_conv_dim if box_num_conv else channels) * 49,
            num_classes)
        self.mask_head = (MaskHead(channels, num_classes, mask_conv_dim, mask_num_conv,
                                   mask_norm) if mask_on else None)


class MaskRCNN(nn.Module):
    def __init__(self, *, num_classes: int = 2, univ_size: int = 32, sample_dist: int = 10,
                 node_cap_per_level: int = 20, dis_type: str = "p2",
                 cls_loss_type: str = "CrossEntropy",
                 pixel_mean: Sequence[float] = PIXEL_MEAN,
                 pixel_std: Sequence[float] = PIXEL_STD, pre_nms_topk_train: int = 2000,
                 pre_nms_topk_test: int = 1000, post_nms_topk: int = 1000,
                 detections_per_image: int = 100, batch_size_per_image: int = 512,
                 mask_fg_cap: int = 128, compute_dtype: str = "float32",
                 backbone_name: str = "resnet50", sk_iters: int = 20,
                 sk_tau: float = 0.05, hippi_iters: int = 50, gagm_iters: int = 200,
                 lap_polish_iters: int = 200, resnet_depth: int = 50,
                 resnet_width: int = 256, freeze_at: int = 2, mask_on: bool = True,
                 score_thresh_test: float = 0.05, nms_thresh_test: float = 0.5,
                 roi_positive_fraction: float = 0.25,
                 rpn_nms_thresh: float = 0.7, pooler_sampling_ratio: int = 0,
                 fpn_channels: int = 256, box_fc_dim: int = 1024, box_num_fc: int = 2,
                 mask_conv_dim: int = 256, mask_num_conv: int = 4,
                 anchor_sizes: Sequence = ((32,), (64,), (128,), (256,), (512,)),
                 vit: dict | None = None, fpn_norm: str = "", rpn_num_convs: int = 1,
                 box_num_conv: int = 0, box_conv_dim: int = 256, box_norm: str = "",
                 mask_norm: str = ""):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, got "
                             f"{compute_dtype!r}")
        if backbone_name not in ("resnet50", "vgg16", "vit"):
            raise ValueError(f"backbone_name must be 'resnet50', 'vgg16' or 'vit', got "
                             f"{backbone_name!r}")
        if fpn_norm and backbone_name != "vit":
            raise ValueError(f"fpn_norm {fpn_norm!r}: the FPN of a ResNet or VGG trunk has no norm")
        self.compute_dtype = compute_dtype
        self.num_classes = num_classes
        self.univ_size = univ_size
        self.dis_type = dis_type
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
        self.square_pad = 0
        stage_channels = None
        if backbone_name == "vit":
            vit = dict(vit or {})
            self.square_pad = vit.pop("square_pad", 1024)
            self.backbone = SimpleFeaturePyramid(ViT(img_size=self.square_pad, **vit),
                                                 fpn_channels, fpn_norm)
        else:
            if backbone_name == "vgg16":
                bottom_up, stage_channels = VGG16FPNBackbone(), VGG_STAGE_CHANNELS
            else:
                bottom_up = ResNet(STAGE_BLOCKS[resnet_depth], resnet_width, freeze_at)
                stage_channels = tuple(resnet_width * 2 ** i for i in range(4))
            self.backbone = FPN(bottom_up, stage_channels, fpn_channels)
        self.proposal_generator = ProposalGenerator(fpn_channels, rpn_num_convs)
        self.roi_heads = ROIHeads(fpn_channels, num_classes, box_fc_dim, box_num_fc,
                                  mask_conv_dim, mask_num_conv, mask_on, box_num_conv,
                                  box_conv_dim, box_norm, mask_norm)
        self.multi_matching_sup = USup(num_classes, univ_size, fpn_channels, sk_tau=sk_tau,
                                       sk_iter=sk_iters, hippi_iters=hippi_iters)
        self.multi_matching_unsup = MGM3Unsup(
            num_classes, univ_size, fpn_channels, sk_tau=sk_tau, sk_iter=sk_iters,
            mgm_iter=gagm_iters, lap_polish_iters=lap_polish_iters)
        self.graph_generator = PrototypeComputation(num_classes, sample_dist,
                                                    node_cap_per_level)
        if dis_type in ("res2", "res3", "res4", "res5") and stage_channels is not None:
            dis_in = stage_channels[int(dis_type[3:]) - 2]
        elif dis_type in ("p2", "p3", "p4", "p5", "p6"):
            dis_in = fpn_channels
        else:
            raise ValueError(f"dis_type must be res2..res5 (not with a ViT) or p2..p6, got "
                             f"{dis_type!r}")
        self.D_img = FCDiscriminatorImg(dis_in, DIS_CHANNELS.get(dis_type, fpn_channels))
        # graph node dim == FPN width; registered last, so its parameters
        # follow every other module's
        self.cross_domain = CrossDomainGraphHead(num_classes, dim=fpn_channels)
        # flax dtype= on exactly these modules (JAX rcnn.py setup); the graph
        # modules stay float32
        for mod in (self.backbone, self.proposal_generator, self.roi_heads, self.D_img):
            set_compute_dtype(mod, COMPUTE_DTYPES[compute_dtype])
        if backbone_name == "vgg16":
            # JAX builds the VGG trunk without a dtype: it computes in float32
            set_compute_dtype(bottom_up, None)

    # -- shared feature path -------------------------------------------------

    def _normalize(self, images):
        """NHWC images -> NCHW input in the compute dtype (JAX ``_normalize``:
        normalised in float32, then cast); a ViT's canvas first padded with
        zeros or cut to its ``square_pad`` square."""
        if self.square_pad:
            images = _square(images, self.square_pad)
        x = (images - self.pixel_mean) / self.pixel_std
        dt = COMPUTE_DTYPES[self.compute_dtype]
        if dt is not None:
            x = x.to(dt)
        return x.permute(0, 3, 1, 2)

    def _features_nchw(self, images):
        """The FPN levels, NCHW, in the compute dtype."""
        with span("step.backbone"):
            return self.backbone(self._normalize(images))

    def extract_features(self, images):
        """images ``(B, H, W, 3)`` -> ``{"p2": (B, H/4, W/4, C), ..., "p6"}``."""
        return _to_nhwc(self._features_nchw(images))

    def _proposals(self, feats_nchw, image_sizes, *, train: bool = False):
        with span("step.proposals"):
            levels = [feats_nchw[f"p{i}"] for i in range(2, 7)]
            logits, regs = self.proposal_generator.rpn_head(levels)
            # box decode and scoring in float32 (JAX rcnn.py:221-222)
            logits = [t.float() for t in logits]
            regs = [t.float() for t in regs]
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
        with span("step.box_inference"):
            B, K = prop_boxes.shape[:2]
            pooled = self._pool(feats, prop_boxes, 7)
            x = self.roi_heads.box_head(pooled.reshape(B * K, *pooled.shape[2:]))
            scores, deltas = (t.float() for t in self.roi_heads.box_predictor(x))
            return roi_box_inference(
                scores.reshape(B, K, -1), deltas.reshape(B, K, -1), prop_boxes, prop_valid,
                image_sizes, num_classes=self.num_classes, score_thresh=self.score_thresh_test,
                nms_thresh=self.nms_thresh_test, topk=self.detections_per_image)

    # -- branches ------------------------------------------------------------

    def _detect(self, images, image_sizes):
        """Features and box detections ``(boxes, scores, classes, valid)``."""
        nchw = self._features_nchw(images)
        feats = _to_nhwc(nchw)
        _, (pboxes, _, pvalid) = self._proposals(nchw, image_sizes)
        return feats, self._box_inference(feats, pboxes, pvalid, image_sizes)

    @torch.no_grad()
    def forward_inference(self, images, image_sizes):
        """Detections and per-detection mask probabilities: dict of boxes
        ``(B, D, 4)``, scores, classes, valid and mask_probs ``(B, D, 28, 28)``."""
        feats, (boxes, scores, classes, valid) = self._detect(images, image_sizes)
        B, D = scores.shape
        if not self.mask_on:
            mask_probs = torch.zeros((B, D, 28, 28), device=boxes.device)
        else:
            with span("step.roi_heads"):
                pooled = self._pool(feats, boxes, 14)
                logits = self.roi_heads.mask_head(
                    pooled.reshape(B * D, *pooled.shape[2:])).float()
                cls_idx = classes.clamp(0, self.num_classes - 1).reshape(B * D)
                sel = logits[torch.arange(B * D, device=logits.device), cls_idx]
                mask_probs = torch.sigmoid(sel).reshape(B, D, *sel.shape[1:])
        return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid,
                "mask_probs": mask_probs}

    @torch.no_grad()
    def proposals_weak(self, images, image_sizes):
        """Box detections without masks (the teacher's pseudo-labels, JAX
        ``proposals_weak``): dict of boxes ``(B, D, 4)``, scores, classes
        and valid."""
        _, (boxes, scores, classes, valid) = self._detect(images, image_sizes)
        return {"boxes": boxes, "scores": scores, "classes": classes, "valid": valid}

    def loss_ttt(self, images, image_sizes):
        """TTA loss: box inference (no gradient) -> graph nodes from the
        predicted boxes -> unsupervised MGM loss against the frozen universe."""
        nchw = self._features_nchw(images)
        feats = _to_nhwc(nchw)
        with torch.no_grad():
            _, (pboxes, _, pvalid) = self._proposals(nchw, image_sizes)
            boxes, _, classes, valid = self._box_inference(feats, pboxes, pvalid, image_sizes)
        with span("step.node_sampler"):
            nodes, labels, node_mask = self.graph_generator(
                [feats[f"p{i}"] for i in range(2, 7)], boxes, classes, valid)
        with span("step.matching"):
            return self.multi_matching_unsup(nodes.float(), labels, node_mask,
                                             self.multi_matching_sup.U.detach())

    def loss_supervised(self, images, image_sizes, gt_boxes, gt_classes, gt_masks, gt_valid, *,
                        generator: torch.Generator | None = None, uniforms: dict | None = None,
                        source: bool = True, with_mask: bool = True):
        """Supervised losses (reference ``supervised_source`` and
        ``supervised_target`` branches): RPN, box and mask losses, and with
        ``source`` the universe-matching loss on nodes from the GT boxes.
        ``with_mask=False`` skips the mask head and its pool.  Returns a dict
        of scalar losses.

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
        with span("step.proposals"):
            losses = rpn_losses(logits, regs, anchors, gt_boxes, gt_valid, uniforms["rpn"])
        with span("step.roi_heads"):
            S = self.batch_size_per_image
            sb, sc, sm, sfg, sv = label_and_sample_proposals(
                pboxes, pvalid, gt_boxes, gt_classes, gt_valid, uniforms["roi"],
                num_classes=self.num_classes, batch_size_per_image=S,
                positive_fraction=self.roi_positive_fraction)
            pooled = self._pool(feats, sb, 7, pack=True)
            x = self.roi_heads.box_head(pooled.reshape(B * S, *pooled.shape[2:]))
            scores, deltas = (t.float() for t in self.roi_heads.box_predictor(x))
            matched = torch.gather(gt_boxes, 1, sm[..., None].expand(B, S, 4))
            det = fast_rcnn_losses(scores.reshape(B, S, -1), deltas.reshape(B, S, -1), sb,
                                   matched, sc, sfg, sv, num_classes=self.num_classes,
                                   cls_loss_type=self.cls_loss_type)
            losses["loss_cls"] = det["loss_cls"].mean()
            losses["loss_box_reg"] = det["loss_box_reg"].mean()

            if with_mask and self.mask_on:
                cap = self.mask_fg_cap
                (fg_boxes, fg_cls, fg_matched), n_fg = compact_rows(
                    sfg, cap, (sb, 0.0), (sc, 0), (sm, 0))
                fg_mask = torch.arange(cap, device=sfg.device) < n_fg[:, None]
                pooled_m = self._pool(feats, fg_boxes, 14, pack=True)
                mlogits = self.roi_heads.mask_head(
                    pooled_m.reshape(B * cap, *pooled_m.shape[2:])).float()
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

        if source:
            with span("step.node_sampler"):
                nodes, labels, node_mask = self.graph_generator(
                    [feats[f"p{i}"] for i in range(2, 7)], gt_boxes,
                    gt_classes.to(torch.int32), gt_valid)
            with span("step.universe"):
                losses["loss_matching"] = self.multi_matching_sup(nodes.float(), labels,
                                                                  node_mask)
        return losses

    def loss_cross_domain(self, images_s, image_sizes_s, boxes_s, classes_s, valid_s,
                          images_t, image_sizes_t, boxes_t, classes_t, valid_t, centers,
                          noise=None):
        """The cross-domain graph-matching losses of the mean-teacher step
        (JAX ``loss_cross_domain``): the features of both strong views
        (a backbone pass of their own), graph nodes from the source's GT
        boxes and the target's pseudo-boxes, each domain's per-image node
        sets flattened into one, in float32 through :attr:`cross_domain`
        with the EMA ``centers`` and the completion ``noise``.  Returns
        ``(losses, new_centers)``."""
        def nodes(images, boxes, classes, valid):
            feats = self.extract_features(images)
            n, lab, m = self.graph_generator([feats[f"p{i}"] for i in range(2, 7)], boxes,
                                             classes.to(torch.int32), valid)
            return n.reshape(-1, n.shape[-1]).float(), lab.reshape(-1), m.reshape(-1)

        return self.cross_domain(*nodes(images_s, boxes_s, classes_s, valid_s),
                                 *nodes(images_t, boxes_t, classes_t, valid_t), centers,
                                 noise=noise)

    def _dis_feature(self, images):
        """The ``dis_type`` feature map, NCHW in the compute dtype: an FPN
        level (``p2`` .. ``p6``) or a backbone stage (``res2`` .. ``res5``)."""
        if self.dis_type.startswith("res"):
            return self.backbone.bottom_up(self._normalize(images))[self.dis_type]
        return self._features_nchw(images)[self.dis_type]

    def loss_domain(self, images_source, images_target):
        """The domain losses (reference ``domain`` branch): the patch
        discriminator on the gradient-reversed ``dis_type`` feature of each
        domain, BCE against 0 (source) and 1 (target) on float32 logits."""
        out_s = self.D_img(grad_reverse(self._dis_feature(images_source)))
        out_t = self.D_img(grad_reverse(self._dis_feature(images_target)))
        return {"loss_D_img_s": _bce_with_logits_mean(out_s.float(), 0.0),
                "loss_D_img_t": _bce_with_logits_mean(out_t.float(), 1.0)}


def _square(images, side: int):
    """``(B, H, W, 3)`` padded with zeros, or cut, to ``(B, side, side, 3)``."""
    H, W = images.shape[1:3]
    images = images[:, :side, :side]
    if H < side or W < side:
        images = torch.nn.functional.pad(images, (0, 0, 0, max(side - W, 0), 0, max(side - H, 0)))
    return images


def _to_nhwc(feats):
    return {k: v.permute(0, 2, 3, 1).contiguous() for k, v in feats.items()}


@torch.no_grad()
def init_weights(model: MaskRCNN, generator: torch.Generator) -> MaskRCNN:
    """Random weights drawn from the JAX package's init distributions, from
    ``generator``: lecun-normal kernels (truncated at 2 std) and zero biases
    (flax defaults; the VGG trunk's convs too), FrozenBN identity with the
    ResNet residual branch's last norm at 0.1, RPN convs normal(0.01) with deltas normal(0.001), box predictor
    normal(0.01)/normal(0.001), affinity normal(0.01), ``U`` normal + 1/univ,
    then the discriminator (lecun-normal) and last the cross-domain head, so
    the draws before each are those of a model without it."""

    def lecun(w, fan_in):
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        w.copy_(torch.nn.init.trunc_normal_(torch.empty_like(w, device="cpu"), 0.0, std,
                                            -2.0 * std, 2.0 * std, generator=generator))

    def normal(w, std):
        w.copy_(torch.randn(w.shape, generator=generator) * std)

    special = {}
    rh = model.proposal_generator.rpn_head
    for conv in (rh.conv if isinstance(rh.conv, nn.Sequential) else [rh.conv]):
        special[id(conv.weight)] = 0.01
    special[id(rh.objectness_logits.weight)] = 0.01
    special[id(rh.anchor_deltas.weight)] = 0.001
    bp = model.roi_heads.box_predictor
    special[id(bp.cls_score.weight)] = 0.01
    special[id(bp.bbox_pred.weight)] = 0.001
    aff = model.multi_matching_unsup.node_affinity
    for m in (aff.project_sr, aff.project_tg, aff.fc_M[0], aff.fc_M[2]):
        special[id(m.weight)] = 0.01
    late = set(map(id, model.D_img.modules())) | set(map(id, model.cross_domain.modules()))
    for mod in model.modules():
        if id(mod) in late:
            continue
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
    if isinstance(model.backbone, SimpleFeaturePyramid):
        init_vit_(model.backbone.net, generator)
    else:
        for name, mod in model.backbone.bottom_up.named_modules():
            if name.endswith("conv3.norm"):
                mod.weight.fill_(0.1)
    U = model.multi_matching_sup.U
    U.copy_(torch.randn(U.shape, generator=generator) + 1.0 / U.shape[0])
    for conv in (model.D_img.conv1, model.D_img.conv2, model.D_img.classifier):
        lecun(conv.weight, conv.weight.shape[1] * conv.weight.shape[2] * conv.weight.shape[3])
        conv.bias.zero_()
    # last the cross-domain head: dense kernels lecun-normal, the graph
    # convolutions' weights normal(0.02), the affinity's normal(0.01)
    aff = model.cross_domain.matching_affinity
    affinity = {id(m.weight) for m in (aff.project_sr, aff.project_tg, aff.fc_M[0], aff.fc_M[2])}
    for mod in model.cross_domain.modules():
        if isinstance(mod, nn.Linear):
            if id(mod.weight) in affinity:
                normal(mod.weight, 0.01)
            else:
                lecun(mod.weight, mod.weight.shape[1])
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, GraphConvolution):
            normal(mod.weight, 0.02)
            mod.bias.zero_()
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    return model
