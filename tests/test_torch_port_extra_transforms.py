"""The port's image augmentations (``data/extra_transforms.py``, torch)
against the JAX package's (numpy + cv2), on the CPU, with the same seeds:

- ``photometric_distortion`` over seeds that together fire every branch
  (brightness, contrast before and after the colour change, saturation,
  hue, channel swap; asserted), within 1e-3 levels; its HSV conversions
  against ``cv2.cvtColor`` within 1e-3 (H in degrees);
- ``random_scale`` exactly, in all three modes and with one scale;
- ``rescale_keep_ratio``, ``resize_multiview`` (both ``keep_ratio``
  settings, 2D boxes clipped) and ``random_resize``, upscaling and
  downscaling: output sizes exact, scale factors, matrices and boxes within
  1e-6, images within 1e-3 levels;
- ``pad_waymo_view`` exactly.
"""

import cv2
import numpy as np
import pytest
import torch

from deepinteraction_tpu.data import extra_transforms as J
from deepinteraction_tpu_torch.data import extra_transforms as T

torch.set_num_threads(1)

LEVELS = 1e-3  # images, in 0-255 levels
EXACT6 = 1e-6  # scale factors, matrices, boxes


def _images(v=2, h=30, w=44, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (v, h, w, 3)).astype(np.float32)
    img[:, :4, :4] = 97.0  # grey pixels: saturation 0
    img[:, 4:8, :4] = (255.0, 0.0, 0.0)  # pure hues
    img[:, 8:12, :4] = (0.0, 0.0, 255.0)
    return img


def _branches(seed, brightness_delta=32.0, contrast_range=(0.5, 1.5), saturation_range=(0.5, 1.5), hue_delta=18.0):
    """The branches ``photometric_distortion`` takes for ``seed``, replaying
    its draws."""
    rng = np.random.default_rng(seed)
    fired = set()
    if rng.integers(2):
        rng.uniform(-brightness_delta, brightness_delta)
        fired.add("brightness")
    contrast_first = bool(rng.integers(2))
    if rng.integers(2):
        rng.uniform(*contrast_range)
        fired.add("contrast first" if contrast_first else "contrast last")
    if rng.integers(2):
        fired.add("saturation")
    rng.uniform(*saturation_range)
    if rng.integers(2):
        fired.add("hue")
    rng.uniform(-hue_delta, hue_delta)
    if rng.integers(2):
        fired.add("swap")
    return fired


SEEDS = range(12)


def test_seeds_fire_every_branch():
    fired = set().union(*(_branches(s) for s in SEEDS))
    assert fired == {"brightness", "contrast first", "contrast last", "saturation", "hue", "swap"}, fired


@pytest.mark.parametrize("seed", SEEDS)
def test_photometric_distortion_matches_jax(seed):
    img = _images()
    want = J.photometric_distortion(img, np.random.default_rng(seed))
    got = T.photometric_distortion(torch.from_numpy(img), np.random.default_rng(seed))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LEVELS)


def test_hsv_conversions_match_cv2():
    img = _images()[0]
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    np.testing.assert_allclose(T._rgb_to_hsv(torch.from_numpy(img)).numpy(), hsv, rtol=0, atol=LEVELS)
    hsv[..., 1] *= 1.3  # saturation past 1, as a saturation draw can give
    hsv[..., 0] = (hsv[..., 0] + 11.5) % 360.0
    np.testing.assert_allclose(T._hsv_to_rgb(torch.from_numpy(hsv)).numpy(), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB),
                               rtol=0, atol=LEVELS)


@pytest.mark.parametrize("scales,mode,ratio", [
    ([(1000, 600)], "range", (0.5, 1.5)),
    ([(640, 360), (1280, 720)], "range", None),
    ([(640, 360), (800, 450), (1280, 720)], "value", None),
    ([(1280, 886)], "range", None),
])
def test_random_scale_exact(scales, mode, ratio):
    for seed in range(12):
        want = J.random_scale(scales, np.random.default_rng(seed), mode, ratio)
        got = T.random_scale(scales, np.random.default_rng(seed), mode, ratio)
        assert got == want


def _close_images(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=LEVELS)


@pytest.mark.parametrize("scale", [(30, 20), (97, 61), (160, 90)])  # down, up, up
def test_rescale_keep_ratio_matches_jax(scale):
    img = _images()[0]
    want, ws, hs = J.rescale_keep_ratio(img, scale)
    got, gws, ghs = T.rescale_keep_ratio(torch.from_numpy(img), scale)
    _close_images([got], [want])
    assert abs(gws - ws) <= EXACT6 and abs(ghs - hs) <= EXACT6


@pytest.mark.parametrize("keep_ratio,scale", [(True, (30, 20)), (True, (133, 70)), (False, (50, 17)),
                                              (False, (101, 77))])
def test_resize_multiview_matches_jax(keep_ratio, scale):
    imgs = _images(v=3)
    rng = np.random.default_rng(5)
    l2i = rng.normal(size=(3, 4, 4)).astype(np.float32)
    boxes = rng.uniform(-10, 60, (7, 4)).astype(np.float32)
    want = J.resize_multiview(list(imgs), l2i, scale, keep_ratio, boxes.copy())
    got = T.resize_multiview([torch.from_numpy(i) for i in imgs], l2i, scale, keep_ratio, boxes.copy())
    _close_images(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=EXACT6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("ratio_range", [(0.5, 0.7), (1.3, 2.1)])
def test_random_resize_matches_jax(ratio_range):
    imgs = _images(v=2, h=23, w=37)
    l2i = np.random.default_rng(2).normal(size=(2, 4, 4)).astype(np.float32)
    for seed in range(3):
        want = J.random_resize(list(imgs), l2i, np.random.default_rng(seed), ratio_range)
        got = T.random_resize([torch.from_numpy(i) for i in imgs], l2i, np.random.default_rng(seed), ratio_range)
        _close_images(got[0], want[0])
        assert got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=EXACT6 * np.abs(want[1]).max())


@pytest.mark.parametrize("rows", [886, 1280, 1300])
def test_pad_waymo_view_exact(rows):
    img = np.random.default_rng(1).uniform(0, 255, (rows, 5, 3)).astype(np.float32)
    want = J.pad_waymo_view(img)
    got = T.pad_waymo_view(torch.from_numpy(img))
    assert tuple(got.shape) == want.shape and np.array_equal(got.numpy(), want)
