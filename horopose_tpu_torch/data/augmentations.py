"""Training-time image augmentations (host side, numpy and PIL).

Port of `horopose_tpu/data/augmentations.py`. The JAX functions draw from
the global `random` and `np.random`; these draw from the generators passed
in (`rng: random.Random`, `np_rng: np.random.RandomState`), in the same
order, so `random.Random(s)` and `RandomState(s)` give the very draws that
`random.seed(s)` and `np.random.seed(s)` give the JAX function.
"""

from __future__ import annotations

import math
import random
from typing import Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance

from horopose_tpu_torch.data.roboutils import get_K_crop_resize_np


def occlusion_aug(bbox, img_shape, rng: random.Random, min_area=0.0,
                  max_area=0.3, max_try_times=5) -> Tuple[int, int, int, int]:
    """Sample a random occluder rectangle inside bbox; returns
    (ymin, h, xmin, w), zeros when no placement found."""
    xmin, ymin, xmax, ymax = bbox[0], bbox[1], bbox[2], bbox[3]
    imght, imgwidth = img_shape
    counter = 0
    while True:
        if counter > max_try_times:
            return 0, 0, 0, 0
        counter += 1
        synth_area = (rng.random() * (max_area - min_area) + min_area) * \
            (xmax - xmin) * (ymax - ymin)
        ratio = rng.random() * 1.5 + 0.5
        synth_h = math.sqrt(max(synth_area * ratio, 0.0))
        synth_w = math.sqrt(max(synth_area / ratio, 0.0))
        synth_xmin = rng.random() * ((xmax - xmin) - synth_w - 1) + xmin
        synth_ymin = rng.random() * ((ymax - ymin) - synth_h - 1) + ymin
        if synth_xmin >= 0 and synth_ymin >= 0 and \
                synth_xmin + synth_w < imgwidth and \
                synth_ymin + synth_h < imght:
            return (int(synth_ymin), int(synth_h), int(synth_xmin),
                    int(synth_w))


def apply_occlusion(rgb: np.ndarray, bbox, p: float, rng: random.Random,
                    np_rng: np.random.RandomState) -> np.ndarray:
    """With probability p, paint a random-noise rectangle inside bbox."""
    if rng.random() >= p:
        return rgb
    h, w = rgb.shape[:2]
    ymin, hh, xmin, ww = occlusion_aug(bbox, np.array([h, w]), rng)
    if hh > 0 and ww > 0:
        rgb = rgb.copy()
        rgb[ymin:ymin + hh, xmin:xmin + ww] = \
            (np_rng.rand(hh, ww, 3) * 255).astype(rgb.dtype)
    return rgb


def apply_color_jitter(rgb: np.ndarray, rng: random.Random,
                       p: float = 0.4) -> np.ndarray:
    """Per-channel random gain."""
    if rng.random() >= p:
        return rgb
    color_factor = 2 * rng.random()
    c_high, c_low = 1 + color_factor, 1 - color_factor
    out = rgb.astype(np.float32).copy()
    for c in range(3):
        out[:, :, c] = np.clip(out[:, :, c] * rng.uniform(c_low, c_high),
                               0, 255)
    return out.astype(np.uint8)


_PILLOW_AUGS = [
    (ImageEnhance.Sharpness, 0.3, (0.0, 50.0)),
    (ImageEnhance.Contrast, 0.3, (0.7, 1.8)),
    (ImageEnhance.Brightness, 0.3, (0.7, 1.8)),
    (ImageEnhance.Color, 0.3, (0.0, 4.0)),
]


def apply_pillow_augs(rgb: np.ndarray, rng: random.Random) -> np.ndarray:
    """Sharpness, contrast, brightness and color, each with p=0.3."""
    im = Image.fromarray(rgb)
    for fn, p, interval in _PILLOW_AUGS:
        if rng.random() <= p:
            im = fn(im).enhance(factor=rng.uniform(*interval))
    return np.asarray(im)


def crop_resize_to_aspect(rgb: np.ndarray, K: np.ndarray,
                          keypoints_3d: np.ndarray,
                          resize: Tuple[int, int] = (256, 256)):
    """Resize a (square) image to `resize`, update K, and recompute the 2D
    keypoints by projecting the 3D keypoints through the new K.

    Returns (rgb', K', keypoints_2d')."""
    h, w = rgb.shape[:2]
    h_out, w_out = min(resize), max(resize)
    if (h, w) != (h_out, w_out):
        # the box spans the full image; the resize is the only change
        K = get_K_crop_resize_np(K, (0.0, 0.0, float(w), float(h)),
                                 (h, w), (h_out, w_out))
        im = Image.fromarray(rgb).resize((w_out, h_out), Image.BILINEAR)
        rgb = np.asarray(im)
    kp_h = (K @ keypoints_3d.T).T
    keypoints_2d = kp_h[:, :2] / kp_h[:, 2:3]
    return rgb, K, keypoints_2d


def flip_image_and_annotations(rgb: np.ndarray, keypoints_2d: np.ndarray,
                               K: np.ndarray,
                               flip_pairs: Optional[list] = None):
    """Horizontal flip with left/right keypoint swap and K mirroring."""
    rgb = np.ascontiguousarray(rgb[:, ::-1])
    w = rgb.shape[1]
    kp = keypoints_2d.copy()
    kp[:, 0] = w - kp[:, 0] - 1
    if flip_pairs is not None:
        for a, b in flip_pairs:
            kp[[a, b]] = kp[[b, a]]
    K = K.copy()
    K[0, 0] = -K[0, 0]
    K[0, 2] = w - 1 - K[0, 2]
    return rgb, kp, K
