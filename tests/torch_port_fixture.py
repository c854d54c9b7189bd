"""Shared set-up of the port's whole-slice tests: the committed golden
fixture weights in both frameworks, the shifted-target test images, and the
labelled source batch with the JAX package's sampling uniforms.

The JAX model is ``MaskRCNN(**DEMO["model_kwargs"])`` with the fixture
weights (tests/demo_config.py); the port model gets the same weights through
``ttdg_mgm_torch.checkpoint.bridge``.  Images are 4 domain-shifted disc
images from scripts/demo_tta_gain.py:make_shifted_target at DEMO settings.
"""

from __future__ import annotations

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


def jax_model_and_params():
    model = JMaskRCNN(**DEMO["model_kwargs"])
    init = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                      jnp.asarray([[64.0, 64.0]]))["params"]
    return model, load_fixture_weights(init, FIXTURE)


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
