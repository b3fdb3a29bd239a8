"""Bounding-box and crop-intrinsics bookkeeping (numpy, host side).

Copies of `get_bbox` (its strict branch) and `get_K_crop_resize_np` from
`horopose_tpu/data/roboutils.py`.
"""

from __future__ import annotations

import numpy as np


def get_bbox(bbox, w, h) -> np.ndarray:
    """Inflate an xyxy bbox by 30% per side, enforce a minimum size of
    150x120, clamp to the image."""
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
    if wnew < 150:
        wmax += 75
        wmin -= 75
    if hnew < 120:
        hmax += 60
        hmin -= 60
    wmin, hmin, wmax, hmax = max(0, wmin), max(0, hmin), min(w, wmax), min(h, hmax)
    wmin, hmin, wmax, hmax = min(w, wmin), min(h, hmin), max(0, wmax), max(0, hmax)
    return np.array([wmin, hmin, wmax, hmax])


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
