"""3x3 stride-1 SAME convolution without bias, NHWC.

Port of `horopose_tpu/ops/conv_pallas.py`. `pack_weights` and
`conv3x3_s2d_plain` follow the JAX `pack_weights` and `conv3x3_s2d_pallas`
step by step: pad, space-to-depth, four (4C, 4F) weight slabs, four
accumulated float32 matrix products, unpack. `conv3x3_s2d_plain` is the
plain PyTorch version of the CUDA kernel in `ops/conv3x3_cuda.py`, which
computes the convolution directly. The JAX `block_b` argument, a TPU grid
tile, has no counterpart here.

As in the JAX package, no model calls this convolution: its one path is
the `tools/bench_conv.py` entry point, which holds the kernel against
cuDNN at the HRNet branch-0 shape.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from horopose_tpu_torch.ops.conv3x3_cuda import conv3x3_nhwc


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, F) -> (16*C, 4*F) packed GEMM matrix.

    Row index (ry, rx, py, px, c), with dy = 2*ry + py and dx = 2*rx + px
    indexing the 4x4 input window of a 2x2 output quad; column (p, q, f).
    Zeros where (dy - p, dx - q) falls outside the 3x3 window."""
    C, Fo = w.shape[2], w.shape[3]
    wp = w.new_zeros(4, 4, C, 2, 2, Fo)
    for p in (0, 1):
        for q in (0, 1):
            wp[p:p + 3, q:q + 3, :, p, q, :] = w
    wp = wp.reshape(2, 2, 2, 2, C, 2, 2, Fo)     # ry,py,rx,px,c,p,q,f
    wp = wp.permute(0, 2, 1, 3, 4, 5, 6, 7)      # ry,rx,py,px,c,p,q,f
    return wp.reshape(16 * C, 4 * Fo)


def conv3x3_s2d_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C), H and W even; w (3, 3, C, F) HWIO -> (B, H, W, F)
    in x's dtype, accumulated in float32."""
    B, H, W, C = x.shape
    Fo = w.shape[3]
    if H % 2 or W % 2:
        raise ValueError(f"conv3x3 wants even H and W, got {H}x{W}")
    hp, wp = H // 2, W // 2
    # pad and space-to-depth: xs[b, i, j, (py, px, c)] = xpad[b, 2i+py, 2j+px, c]
    xpad = F.pad(x, (0, 0, 1, 1, 1, 1))
    xs = xpad.reshape(B, hp + 1, 2, wp + 1, 2, C).permute(0, 1, 3, 2, 4, 5)
    xs = xs.reshape(B, hp + 1, wp + 1, 4 * C).float()
    # rows of pack_weights are (ry, rx, py, px, c): a reshape splits them
    # into the four (4C, 4F) slabs of the quads
    wmat = pack_weights(w.to(x.dtype)).float().reshape(4, 4 * C, 4 * Fo)
    acc = x.new_zeros(B * hp * wp, 4 * Fo, dtype=torch.float32)
    for idx, (ry, rx) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        quad = xs[:, ry:ry + hp, rx:rx + wp, :].reshape(B * hp * wp, 4 * C)
        acc = acc + quad @ wmat[idx]
    # unpack: yp[b, i, j, (p, q, f)] -> y[b, 2i+p, 2j+q, f]
    y = acc.to(x.dtype).reshape(B, hp, wp, 2, 2, Fo).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(B, H, W, Fo)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            use_kernel: Optional[bool] = None) -> torch.Tensor:
    """3x3 stride-1 SAME conv, no bias: x (B, H, W, C) float32 or bfloat16,
    H and W even; w (3, 3, C, F) -> (B, H, W, F) in x's dtype.

    use_kernel: None takes the CUDA kernel for a CUDA tensor (it launches or
    raises) and the plain version for a CPU tensor; False takes the plain
    version."""
    if use_kernel is False:
        return conv3x3_s2d_plain(x, w)
    return conv3x3_nhwc(x, w)
