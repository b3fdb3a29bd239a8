"""Debugging images.

Port of `horopose_tpu/core/vis.py::save_silhouette_comparison`, the
sim2real stage's view of a rendered silhouette against the teacher's
mask. The plots of the test harness and the shaded render are not ported
yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image


def save_silhouette_comparison(rendered: np.ndarray, target: np.ndarray,
                               save_path: str):
    """Write the rendered mask in the red channel and the teacher's in the
    blue one, (h, w) each in [0, 1], as an image file."""
    h, w = rendered.shape
    stack = np.zeros((h, w, 3), np.uint8)
    stack[..., 0] = np.clip(rendered * 255, 0, 255).astype(np.uint8)
    stack[..., 2] = np.clip(target * 255, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    Image.fromarray(stack).save(save_path)
