"""The flagship configurations and model construction.

``FLAGSHIP_KWARGS`` is the R50-FPN Mask R-CNN that the JAX package builds
for ``configs/test_segment.yaml`` (``ttdg_mgm_tpu/build.py:build_model``):
full widths, 1000 proposals, 100 detections, a 32-slot universe and 12
nodes per FPN level (``MODEL.GRAPH.MAX_NODES`` 64 // 5), so 60 nodes per
graph, and the source-training fields at their ``ttdg_mgm_tpu/config.py``
defaults (2000 pre-NMS proposals, 512 sampled ROIs per image at 25 %
foreground, 128 mask ROIs, cross-entropy, 50 HiPPI iterations).  Source
training (``configs/seg_res50fpn_source.yaml``) trains this model, with 2
classes; ``SOURCE_SOLVER`` holds that file's solver settings
(``IMS_PER_BATCH`` 8, ``BASE_LR`` 0.0025, over ``config.py``'s defaults,
which ``solver/build.py`` keeps as its own: momentum 0.9, weight decay
1e-4).
Fields of the JAX model which only the discriminator, the VGG backbone or
the bf16 compute policy read are not ported yet; ``OUT_OF_SLICE`` names
them.
"""

from __future__ import annotations

import torch

from ttdg_mgm_torch import resolve_device
from ttdg_mgm_torch.models.rcnn import MaskRCNN, init_weights

FLAGSHIP_KWARGS = dict(
    num_classes=2, univ_size=32, sample_dist=10, node_cap_per_level=12,
    pixel_mean=(103.53, 116.28, 123.675), pixel_std=(1.0, 1.0, 1.0),
    pre_nms_topk_test=1000, post_nms_topk=1000, detections_per_image=100,
    sk_iters=20, sk_tau=0.05, gagm_iters=200, lap_polish_iters=200,
    resnet_depth=50, resnet_width=256, freeze_at=2, mask_on=True,
    score_thresh_test=0.05, nms_thresh_test=0.5, rpn_nms_thresh=0.7,
    pooler_sampling_ratio=0, fpn_channels=256, box_fc_dim=1024, box_num_fc=2,
    mask_conv_dim=256, mask_num_conv=4,
    anchor_sizes=((32,), (64,), (128,), (256,), (512,)),
    cls_loss_type="CrossEntropy", pre_nms_topk_train=2000, batch_size_per_image=512,
    roi_positive_fraction=0.25, mask_fg_cap=128, hippi_iters=50,
)

#: ``configs/seg_res50fpn_source.yaml`` SOLVER, and the GT-mask canvas of
#: the JAX trainer (``engine/trainer.py:196``)
SOURCE_SOLVER = dict(ims_per_batch=8, base_lr=0.0025, mask_res=256)

#: JAX ``MaskRCNN`` fields outside this package's slice: the discriminator's
#: feature level, the VGG backbone switch and the bf16 compute policy
OUT_OF_SLICE = ("dis_type", "backbone_name", "compute_dtype")


def build_model(*, device=None, seed: int = 0, **overrides) -> MaskRCNN:
    """The flagship model (``overrides`` replace fields) with random weights
    drawn from the JAX package's init distributions, on ``device`` (CUDA
    unless the caller names another)."""
    dev = resolve_device(device)
    model = MaskRCNN(**{**FLAGSHIP_KWARGS, **overrides})
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(dev)
