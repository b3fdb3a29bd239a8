"""Bounding-box, crop and intrinsics bookkeeping (numpy, host side).

Copy of `horopose_tpu/data/roboutils.py`, with one change: the training
jitter of `get_bbox(strict=False)` draws from the `random.Random` the
caller passes instead of the global `random` module, so a dataset can seed
it per sample. `random.Random(s)` gives the draws `random.seed(s)` gives.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np


def get_bbox(bbox, w, h, strict: bool = True,
             rng: Optional[random.Random] = None) -> np.ndarray:
    """Inflate a keypoint-derived xyxy bbox by 30% per side, enforce a
    minimum size of 150x120, clamp to the image. With strict=False it adds
    a random margin jitter (training crops), drawn from `rng`."""
    wmin, hmin, wmax, hmax = bbox
    wmin, hmin, wmax, hmax = max(0, wmin), max(0, hmin), min(w, wmax), min(h, hmax)
    wnew = wmax - wmin
    hnew = hmax - hmin
    wmin = int(max(0, wmin - 0.3 * wnew))
    wmax = int(min(w, wmax + 0.3 * wnew))
    hmin = int(max(0, hmin - 0.3 * hnew))
    hmax = int(min(h, hmax + 0.3 * hnew))
    wnew = wmax - wmin
    hnew = hmax - hmin

    if not strict:
        if rng is None:
            raise ValueError("get_bbox(strict=False) draws its jitter from "
                             "rng, a random.Random")
        randomw = (rng.random() - 0.2) / 2
        randomh = (rng.random() - 0.2) / 2
        dwnew = randomw * wnew
        wmax += dwnew / 2
        wmin -= dwnew / 2
        dhnew = randomh * hnew
        hmax += dhnew / 2
        hmin -= dhnew / 2
        wmin = int(max(0, wmin))
        wmax = int(min(w, wmax))
        hmin = int(max(0, hmin))
        hmax = int(min(h, hmax))
        wnew = wmax - wmin
        hnew = hmax - hmin

    if wnew < 150:
        wmax += 75
        wmin -= 75
    if hnew < 120:
        hmax += 60
        hmin -= 60
    wmin, hmin, wmax, hmax = max(0, wmin), max(0, hmin), min(w, wmax), min(h, hmax)
    wmin, hmin, wmax, hmax = min(w, wmin), min(h, hmin), max(0, wmax), max(0, hmax)
    return np.array([wmin, hmin, wmax, hmax])


def get_bbox_raw(bbox) -> np.ndarray:
    """Like get_bbox but unclamped (used for truncation handling)."""
    wmin, hmin, wmax, hmax = bbox
    wnew = wmax - wmin
    hnew = hmax - hmin
    wmin = int(wmin - 0.3 * wnew)
    wmax = int(wmax + 0.3 * wnew)
    hmin = int(hmin - 0.3 * hnew)
    hmax = int(hmax + 0.3 * hnew)
    wnew = wmax - wmin
    hnew = hmax - hmin
    if wnew < 150:
        wmax += 75
        wmin -= 75
    if hnew < 120:
        hmax += 60
        hmin -= 60
    return np.array([wmin, hmin, wmax, hmax])


def get_extended_bbox(bbox, dwmin, dhmin, dwmax, dhmax, bounded=True,
                      image_size=None) -> np.ndarray:
    """Grow an xyxy bbox by the given margins; with bounded, clamp it to
    image_size (w, h)."""
    wmin, hmin, wmax, hmax = bbox
    ext = np.array([wmin - dwmin, hmin - dhmin, wmax + dwmax, hmax + dhmax])
    if bounded:
        if image_size is None:
            raise ValueError("a bounded extended bbox needs image_size")
        ext = np.array([max(0, ext[0]), max(0, ext[1]),
                        min(image_size[0], ext[2]), min(image_size[1], ext[3])])
    return ext


def resize_image(image: np.ndarray, bbox, keypoints_2d: np.ndarray,
                 K: np.ndarray):
    """Square-pad crop around bbox, shifting K and 2D keypoints.

    Returns (square_image, keypoints_2d', K'): the crop is pasted centered
    into a black square of side max(bbox_w, bbox_h); the principal point
    shifts by (wmin - x_offset)."""
    wmin, hmin, wmax, hmax = [int(v) for v in bbox]
    square_size = int(max(wmax - wmin, hmax - hmin))
    square_image = np.zeros((square_size, square_size, 3), np.uint8)
    x_offset = int((square_size - (wmax - wmin)) // 2)
    y_offset = int((square_size - (hmax - hmin)) // 2)
    square_image[y_offset:y_offset + (hmax - hmin),
                 x_offset:x_offset + (wmax - wmin)] = image[hmin:hmax, wmin:wmax]
    kp = keypoints_2d.copy()
    kp[:, 0] += x_offset - wmin
    kp[:, 1] += y_offset - hmin
    K = K.copy()
    K[0, 2] -= (wmin - x_offset)
    K[1, 2] -= (hmin - y_offset)
    return square_image, kp, K


def bbox_transform(bbox, K_original_inv, K_new, resize_hw) -> np.ndarray:
    """Reproject an xyxy bbox through K_orig^-1 then K_new and clamp."""
    wmin, hmin, wmax, hmax = bbox
    corners = np.array([[wmin, hmin, 1.0], [wmax, hmin, 1.0],
                        [wmax, hmax, 1.0], [wmin, hmax, 1.0]])
    rays = K_original_inv @ corners.T
    new_corners = (K_new @ rays).T
    return np.array([
        np.clip(new_corners[0, 0], 0, resize_hw[0]),
        np.clip(new_corners[0, 1], 0, resize_hw[1]),
        np.clip(new_corners[1, 0], 0, resize_hw[0]),
        np.clip(new_corners[2, 1], 0, resize_hw[1]),
    ])


def get_K_crop_resize_np(K: np.ndarray, box, orig_size, crop_resize):
    """Update K for a crop (box xyxy) followed by a resize to crop_resize."""
    K = K.astype(np.float64)
    x1, y1, x2, y2 = [float(v) for v in box]
    final_width, final_height = max(crop_resize), min(crop_resize)
    crop_width = x2 - x1
    crop_height = y2 - y1
    crop_cj = (x1 + x2) / 2
    crop_ci = (y1 + y2) / 2
    cx = K[0, 2] + (crop_width - 1) / 2 - crop_cj
    cy = K[1, 2] + (crop_height - 1) / 2 - crop_ci
    orig_cx_diff = cx - (crop_width - 1) / 2
    orig_cy_diff = cy - (crop_height - 1) / 2
    scale_x = final_width / crop_width
    scale_y = final_height / crop_height
    out = K.copy()
    out[0, 0] = scale_x * K[0, 0]
    out[1, 1] = scale_y * K[1, 1]
    out[0, 2] = (final_width - 1) / 2 + scale_x * orig_cx_diff
    out[1, 2] = (final_height - 1) / 2 + scale_y * orig_cy_diff
    return out
