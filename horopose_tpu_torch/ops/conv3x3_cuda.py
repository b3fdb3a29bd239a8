"""Wrapper of the hand-written CUDA 3x3 convolution (`csrc/conv3x3.cu`).

`conv3x3_nhwc` replaces the Pallas kernel
`horopose_tpu/ops/conv_pallas.py::_kernel`: a 3x3 stride-1 SAME convolution
without bias, x (B, H, W, C) NHWC and w (3, 3, C, F) HWIO -> (B, H, W, F),
float32 or bfloat16 with float32 accumulation. It computes the convolution
directly; the Pallas kernel's space-to-depth packing served the TPU's
128-lane MXU. Both dtypes walk the same tiles of TILE_ROWS x TILE_COLS
output pixels of one image and TILE_F output channels (`tile_origin`) on a
persistent grid of `plan_blocks` blocks, each staging its next steps' inputs
with cp.async while it computes. bfloat16 runs an implicit GEMM on the
tensor cores (mma.sync), one block an SM; at the HRNet branch-0 shape
(128, 64, 64, 32) -> 32 it is bound by 67.1 MB of input and output, 0.020
ms at 3.35 TB/s. float32 runs FFMA register tiles (2 rows x 8 pixels x 8
output channels a thread), two blocks an SM, bound by the 67 TFLOP/s of
the float32 units, 0.144 ms at that shape.

A CPU tensor takes the plain version (`ops.conv3x3.conv3x3_s2d_plain`).
A CUDA tensor always takes the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from horopose_tpu_torch import cuda_build

SOURCE = "conv3x3"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, is_bf16, B, H, W, C, F, blocks, y, stream, device
_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _I]
# both kernels' tile (csrc/conv3x3.cu: kRows, kCols, kN and kFRows,
# kFCols, kFN)
TILE_ROWS, TILE_COLS, TILE_F = 8, 64, 32
# persistent blocks an SM: a bfloat16 block takes 222 KB of shared memory,
# a float32 one 99 KB and 128 threads of 255 registers
BLOCKS_PER_SM = 1
F32_BLOCKS_PER_SM = 2


def conv_tiles(B: int, H: int, W: int, Fo: int) -> int:
    """Output tiles of either kernel."""
    return (-(-Fo // TILE_F) * B * -(-H // TILE_ROWS)
            * -(-W // TILE_COLS))


def tile_origin(t: int, B: int, H: int, W: int) -> Tuple[int, int, int, int]:
    """(output chunk, image, first row, first column) of tile t: output
    chunk major, then image, row tile, column tile, as the kernel's
    `step_tile` orders them."""
    tiles_h, tiles_w = -(-H // TILE_ROWS), -(-W // TILE_COLS)
    per_f = B * tiles_h * tiles_w
    r = t % per_f
    rt = r % (tiles_h * tiles_w)
    return (t // per_f, r // (tiles_h * tiles_w), (rt // tiles_w) * TILE_ROWS,
            (rt % tiles_w) * TILE_COLS)


def plan_blocks(n_tiles: int, sm_count: int,
                per_sm: int = BLOCKS_PER_SM) -> int:
    """Persistent blocks, `per_sm` an SM at most (BLOCKS_PER_SM for
    bfloat16, F32_BLOCKS_PER_SM for float32); block i takes tiles i,
    i + blocks, i + 2 * blocks, ..."""
    return max(1, min(n_tiles, per_sm * sm_count))


def _function():
    fn = cuda_build.load(SOURCE).conv3x3_nhwc
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def conv3x3_nhwc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, C) float32 or bfloat16, H and W even; w (3, 3, C, F),
    cast to x's dtype as the Pallas version casts its packed weights ->
    y (B, H, W, F) in x's dtype."""
    if x.device.type == "cpu":
        from horopose_tpu_torch.ops.conv3x3 import conv3x3_s2d_plain
        return conv3x3_s2d_plain(x, w)
    name = "conv3x3_nhwc"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name} wants NHWC (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} wants a contiguous NHWC tensor")
    B, H, W, C = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"{name}: w must be (3, 3, {C}, F), got "
                         f"{tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"{name}: w on {w.device}, x on {x.device}")
    if H % 2 or W % 2:
        raise ValueError(f"{name} wants even H and W, got {H}x{W}")
    Fo = w.shape[3]
    bf16 = x.dtype == torch.bfloat16
    if max(H, W, C, Fo) >= 2 ** 31 or conv_tiles(B, H, W, Fo) >= 2 ** 31:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)} -> "
                         f"{Fo} channels")
    w = w.to(x.dtype).contiguous()
    y = torch.empty(B, H, W, Fo, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    blocks = plan_blocks(conv_tiles(B, H, W, Fo),
                         cuda_build.sm_count(x.device.index),
                         BLOCKS_PER_SM if bf16 else F32_BLOCKS_PER_SM)
    err = _function()(
        x.data_ptr(), w.data_ptr(), int(bf16), B, H, W, C, Fo, blocks,
        y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        x.device.index)
    conv3x3_nhwc.launches += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return y


# kernel launches since the last reset; read by chip_smoke.py
conv3x3_nhwc.launches = 0
