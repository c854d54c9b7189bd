"""Shared set-up of the port's whole-slice tests: the committed golden
fixture weights in both frameworks, the shifted-target test images, and the
labelled source batch with the JAX package's sampling uniforms.

The JAX model is ``MaskRCNN(**DEMO["model_kwargs"])`` with the fixture
weights (tests/demo_config.py); the port model gets the same weights through
``ttdg_mgm_torch.checkpoint.bridge``.  Images are 4 domain-shifted disc
images from scripts/demo_tta_gain.py:make_shifted_target at DEMO settings.
"""

from __future__ import annotations

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from demo_config import DEMO, load_fixture_weights
from ttdg_mgm_tpu.models import MaskRCNN as JMaskRCNN
from ttdg_mgm_torch.build import OUT_OF_SLICE
from ttdg_mgm_torch.checkpoint.bridge import flax_params_to_d2, load_d2_state_dict
from ttdg_mgm_torch.models.rcnn import MaskRCNN

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(HERE, "fixtures", "tta_demo_weights.msgpack")


def port_kwargs(kwargs: dict) -> dict:
    return {k: v for k, v in kwargs.items() if k not in OUT_OF_SLICE}


@functools.lru_cache(maxsize=1)
def jax_model_and_params():
    """The JAX model and the fixture's parameters (computed once per
    process).  The parameter tree's layout comes from ``jax.eval_shape`` of
    ``model.init``: every value is the fixture's, so a traced init (20 s on
    the CPU) would give the same tree."""
    model = JMaskRCNN(**DEMO["model_kwargs"])
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                            jnp.asarray([[64.0, 64.0]]))["params"]
    return model, load_fixture_weights(shapes, FIXTURE)


def to_numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def port_model(params) -> MaskRCNN:
    """Port model on the CPU carrying the JAX ``params``."""
    kw = port_kwargs(DEMO["model_kwargs"])
    model = MaskRCNN(**kw)
    sd = flax_params_to_d2(to_numpy_tree(params),
                           box_head_channels=kw["fpn_channels"])
    load_d2_state_dict(model, sd)
    return model


def shifted_images(tmpdir, n: int = 4):
    """``(n, S, S, 3)`` float32 RGB images and ``(n, 2)`` sizes."""
    from PIL import Image

    sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
    from demo_tta_gain import make_shifted_target

    _, img_dir = make_shifted_target(str(tmpdir), n, size=DEMO["size"], seed=DEMO["seed"],
                                     blur=DEMO["blur"], brightness=DEMO["brightness"])
    imgs = np.stack([np.asarray(Image.open(os.path.join(img_dir, f"t{i}.png")).convert("RGB"),
                                np.float32) for i in range(n)])
    sizes = np.full((n, 2), float(DEMO["size"]), np.float32)
    return imgs, sizes


def source_batch(seed: int, n: int = 4, mask_res: int = 64) -> dict:
    """A labelled disc batch at the fixture's size (``ttdg_mgm_torch.synth``,
    the same pixels as ``bench.py:synth_batch``), GT padded to 32 slots."""
    from ttdg_mgm_torch.synth import synth_batch

    return synth_batch(DEMO["size"], n, seed=seed, with_gt=True, mask_res=mask_res)


def jax_uniforms(rng, B: int, n_anchors: int, n_rois: int) -> dict:
    """The uniforms ``MaskRCNN.loss_supervised`` draws from ``rng`` in the
    JAX package (``models/rcnn.py:376-381``, ``rpn.py:183``,
    ``roi_heads.py:126``), as NumPy arrays for the port's ``uniforms``."""
    rng_rpn, rng_roi = jax.random.split(rng)
    return {"rpn": np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n_anchors,)))(
                jax.random.split(rng_rpn, B))),
            "roi": np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n_rois,)))(
                jax.random.split(rng_roi, B)))}


def cli_args(dataset_root, out_dir, precision: bool = True) -> list:
    """``train_net_torch.py``'s arguments for tests/test_cli.py's eval-only
    TTA run on its miniature Drishti-GS split, with its overrides, on the
    CPU, in float32 unless ``precision`` is False."""
    args = ["--eval-only", "--device", "cpu",
            "--config", os.path.join(os.path.dirname(HERE), "configs", "test_segment.yaml"),
            "--datasets-root", str(dataset_root),
            "DATASETS.TEST", '["Drishti_GS_test"]', "MODEL.WEIGHTS", "",
            "OUTPUT_DIR", str(out_dir),
            "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "64",
            "MODEL.RPN.PRE_NMS_TOPK_TEST", "64", "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
            "TEST.DETECTIONS_PER_IMAGE", "8", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
            "MODEL.GRAPH.UNIV_SIZE", "8", "MODEL.GRAPH.MAX_NODES", "20",
            "TEST.BATCH", "2", "TEST.MIN_BATCH_NUM", "1", "TEST.DICE_THRES", "0.0",
            "MODEL.GRAPH.GAGM_ITERS", "8", "MODEL.GRAPH.HIPPI_ITERS", "5",
            "MODEL.GRAPH.SK_ITERS", "5", "MODEL.RESNETS.DEPTH", "14"]
    return args + (["TPU.PRECISION", "float32"] if precision else [])


def write_mini_split(root, rle: bool = False) -> str:
    """tests/test_cli.py's miniature Drishti-GS test split under ``root``:
    three 64x64 disc images (PNG written by Pillow) and their discs as
    ground truth, as polygons or, with ``rle``, RLE.  Returns ``root``."""
    import json

    from PIL import Image

    from ttdg_mgm_torch.utils.rle import rle_encode

    img_dir = os.path.join(str(root), "Fundus", "Drishti_GS", "test", "image")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    yy, xx = np.mgrid[:64, :64]
    for i in range(3):
        cx, cy, r = 28 + 4 * i, 30, 11
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
        arr = np.full((64, 64, 3), 35, np.uint8)
        arr[disc] = [210, 170, 150]
        Image.fromarray(arr).save(os.path.join(img_dir, f"f{i}.png"))
        images.append({"id": i, "file_name": f"f{i}.png", "height": 64, "width": 64})
        theta = np.linspace(0, 2 * np.pi, 13)[:-1]
        poly = np.stack([cx + r * np.cos(theta), cy + r * np.sin(theta)], -1)
        annotations.append({"id": i + 1, "image_id": i, "category_id": 1,
                            "bbox": [cx - r, cy - r, 2 * r, 2 * r], "iscrowd": 0,
                            "area": float(np.pi * r * r),
                            "segmentation": (rle_encode(disc.astype(np.uint8)) if rle
                                             else [poly.reshape(-1).tolist()])})
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": 1, "name": "disc"}, {"id": 2, "name": "cup"}]}
    with open(os.path.join(str(root), "Fundus", "Drishti_GS_test.json"), "w") as f:
        json.dump(coco, f)
    return str(root)
