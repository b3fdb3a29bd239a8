"""Wrapper of the hand-written CUDA 3x3 convolution (`csrc/conv3x3.cu`).

`conv3x3_nhwc` replaces the Pallas kernel
`horopose_tpu/ops/conv_pallas.py::_kernel`: a 3x3 stride-1 SAME convolution
without bias, x (B, H, W, C) NHWC and w (3, 3, C, F) HWIO -> (B, H, W, F),
float32 or bfloat16 with float32 accumulation. It computes the convolution
directly (8x16 output pixels and 32 output channels a block, input patch
and weights staged in shared memory); the Pallas kernel's space-to-depth
packing served the TPU's 128-lane MXU. At the HRNet branch-0 shape
(128, 64, 64, 32) -> 32 in bf16 it is bound by 67.1 MB of input and output,
0.020 ms at 3.35 TB/s.

A CPU tensor takes the plain version (`ops.conv3x3.conv3x3_s2d_plain`).
A CUDA tensor always takes the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from horopose_tpu_torch import cuda_build

SOURCE = "conv3x3"
_P, _I = ctypes.c_void_p, ctypes.c_int
# x, w, is_bf16, B, H, W, C, F, y, stream, device
_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _I]
# the grid puts the image on blockIdx.z
_MAX_BATCH = 65535


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
    if B > _MAX_BATCH or max(H, W, C, Fo) >= 2 ** 31:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)} -> "
                         f"{Fo} channels")
    w = w.to(x.dtype).contiguous()
    y = torch.empty(B, H, W, Fo, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    err = _function()(
        x.data_ptr(), w.data_ptr(), int(x.dtype == torch.bfloat16), B, H, W,
        C, Fo, y.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream,
        x.device.index)
    conv3x3_nhwc.launches += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return y


# kernel launches since the last reset; read by chip_smoke.py
conv3x3_nhwc.launches = 0
