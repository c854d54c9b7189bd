"""The strong augmentation without Pillow (CPU): each operation of
``ttdg_mgm_torch/data/enhance.py`` equals Pillow's, bit for bit, and
``data/transforms.py:build_strong_augmentation`` equals the JAX package's
(which runs Pillow) over a run of images for the same seed.

The images: odd and even sizes, down to one row or column; random RGB,
gray (R = G = B, where the hue and saturation are 0 and the luma is the
value), saturated (channels at 0 or 255 only, where the blend's
extrapolation clips) and smooth gradients.  The blend factors lie below 0,
in [0, 1] and above 1; the blur's sigma spans [0.1, 2] (the strong
augmentation's range) and a few values beyond.  Every RGB triple is
covered by the HSV round trip and the luma in ``test_every_colour``.
"""

import torch_test_threads  # noqa: F401  (one intra-op thread per test process)

import numpy as np
import pytest
from PIL import Image, ImageEnhance, ImageFilter

from ttdg_mgm_tpu.data import transforms as jtransforms
from ttdg_mgm_torch.data import enhance
from ttdg_mgm_torch.data import transforms as ttransforms

SIZES = [(1, 7), (6, 1), (5, 9), (16, 16), (33, 48), (64, 31)]
FACTORS = [-0.8, -0.05, 0.0, 0.25, 0.6, 0.999, 1.0, 1.0000001, 1.4, 3.0]
SIGMAS = [0.1, 0.25, 0.5, 0.77, 1.0, 1.3, 1.65, 2.0, 2.6, 4.0]


def _image(kind: str, h: int, w: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed)
    if kind == "random":
        return rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    if kind == "gray":
        return np.repeat(rng.randint(0, 256, (h, w, 1)), 3, -1).astype(np.uint8)
    if kind == "saturated":
        return (rng.randint(0, 2, (h, w, 3)) * 255).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 127 // max(h + w - 2, 1)], -1).astype(np.uint8)


KINDS = ["random", "gray", "saturated", "gradient"]


def _pil(img):
    return Image.fromarray(img)


def test_every_colour():
    """``convert("L")``, ``convert("HSV")`` and HSV back to RGB on all 2^24
    triples (as one 4096 x 4096 image)."""
    c = np.arange(1 << 24, dtype=np.uint32)
    img = np.stack([(c >> 16) & 255, (c >> 8) & 255, c & 255], -1).astype(np.uint8)
    img = img.reshape(4096, 4096, 3)
    np.testing.assert_array_equal(enhance.to_gray(img), np.asarray(_pil(img).convert("L")))
    np.testing.assert_array_equal(enhance.rgb_to_hsv(img), np.asarray(_pil(img).convert("HSV")))
    np.testing.assert_array_equal(enhance.hsv_to_rgb(img),
                                  np.asarray(Image.fromarray(img, "HSV").convert("RGB")))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", SIZES, ids=str)
def test_enhancers_and_blend_match_pillow(kind, hw):
    img = _image(kind, *hw, seed=hw[0] * 100 + hw[1])
    other = _image("random", *hw, seed=7)
    for f in FACTORS:
        for name, cls, fn in (("brightness", ImageEnhance.Brightness, enhance.brightness),
                              ("contrast", ImageEnhance.Contrast, enhance.contrast),
                              ("color", ImageEnhance.Color, enhance.color)):
            np.testing.assert_array_equal(fn(img, f), np.asarray(cls(_pil(img)).enhance(f)),
                                          err_msg=f"{name} {f}")
        np.testing.assert_array_equal(enhance.blend(other, img, f),
                                      np.asarray(Image.blend(_pil(other), _pil(img), f)),
                                      err_msg=f"blend {f}")
    np.testing.assert_array_equal(enhance.gray_to_rgb(enhance.to_gray(img)),
                                  np.asarray(_pil(img).convert("L").convert("RGB")))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hw", SIZES, ids=str)
def test_gaussian_blur_matches_pillow(kind, hw):
    img = _image(kind, *hw, seed=hw[0] + 7 * hw[1])
    for sigma in SIGMAS:
        want = np.asarray(_pil(img).filter(ImageFilter.GaussianBlur(radius=sigma)))
        np.testing.assert_array_equal(enhance.gaussian_blur(img, sigma), want,
                                      err_msg=f"sigma {sigma}")


@pytest.mark.parametrize("seed", [0, 5, 123])
def test_strong_augmentation_matches_jax(seed):
    """24 images through one augmentation of each package: the same draws
    in the same order give the same images; the input is left as it was."""
    jax_aug = jtransforms.build_strong_augmentation(seed)
    port_aug = ttransforms.build_strong_augmentation(seed)
    rng = np.random.RandomState(seed + 1)
    changed = 0
    for i in range(24):
        h, w = rng.randint(20, 70), rng.randint(20, 70)
        img = _image(KINDS[i % 4], h, w, seed=1000 * seed + i)
        keep = img.copy()
        got = port_aug(img)
        np.testing.assert_array_equal(img, keep)
        want = jax_aug(img)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want, err_msg=f"image {i}")
        changed += not np.array_equal(got, img)
    assert changed >= 20
