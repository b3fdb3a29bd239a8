"""Fused square-pad crop + bilinear resize, in plain PyTorch on the frames'
device.

Twin of `horopose_tpu/native/dream_ops.cpp::crop_resize_bilinear`: the crop
of each bbox is centred in a black square of side max(bbox_w, bbox_h) and
resized to S x S with align_corners=False bilinear weights. Each output
pixel maps straight into the source frame; a tap outside the crop window
reads the black padding (zero). The result rounds by +0.5 and truncates.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _axis(lo: torch.Tensor, hi: torch.Tensor, size: int, square: torch.Tensor,
          S: int) -> Tuple[torch.Tensor, ...]:
    """Source taps and weights along one axis, per frame: (B, S) each.

    lo/hi: crop window [lo, hi) per frame; size: the frame's extent."""
    off = torch.div(square - (hi - lo), 2, rounding_mode="floor")
    scale = square.float() / float(S)
    o = torch.arange(S, dtype=torch.float32, device=lo.device)
    s = (o[None] + 0.5) * scale[:, None] - 0.5          # square-space coord
    f = s - off[:, None].float() + lo[:, None].float()  # source-space coord
    i0 = torch.floor(f)
    w1 = f - i0
    w0 = 1.0 - w1
    i0 = i0.long()
    taps, weights = [], []
    for i, w in ((i0, w0), (i0 + 1, w1)):
        inside = (i >= lo[:, None]) & (i < hi[:, None]) & (i >= 0) & (i < size)
        taps.append(i.clamp(0, size - 1))
        weights.append(torch.where(inside, w, torch.zeros_like(w)))
    return taps[0], taps[1], weights[0], weights[1]


def crop_resize_bilinear(images: torch.Tensor, bboxes: torch.Tensor,
                         size: int) -> torch.Tensor:
    """images (B, H, W, 3) uint8; bboxes (B, 4) integer xyxy
    [wmin, hmin, wmax, hmax] in source pixels -> (B, size, size, 3) uint8."""
    if images.dim() != 4 or images.shape[-1] != 3 or \
            images.dtype != torch.uint8:
        raise ValueError("images must be (B, H, W, 3) uint8")
    B, H, W, _ = images.shape
    bb = bboxes.to(device=images.device, dtype=torch.long)
    wmin, hmin, wmax, hmax = bb.unbind(-1)
    square = torch.maximum(wmax - wmin, hmax - hmin)
    if bool((square <= 0).any()):
        raise ValueError("every bbox needs a positive width or height")
    y0, y1, wy0, wy1 = _axis(hmin, hmax, H, square, size)
    x0, x1, wx0, wx1 = _axis(wmin, wmax, W, square, size)
    b = torch.arange(B, device=images.device)[:, None, None]
    acc = torch.zeros(B, size, size, 3, dtype=torch.float32,
                      device=images.device)
    # tap order and weight products as in the C++ loop: (dy, dx) row-major
    for yy, wy in ((y0, wy0), (y1, wy1)):
        for xx, wx in ((x0, wx0), (x1, wx1)):
            wgt = wy[:, :, None] * wx[:, None, :]
            acc += wgt[..., None] * images[b, yy[:, :, None], xx[:, None, :]]
    return (acc + 0.5).clamp_(0.0, 255.0).to(torch.uint8)
