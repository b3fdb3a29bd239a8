"""Wrapper of the hand-written CUDA soft-argmax forward (`csrc/soft_argmax.cu`).

Replaces the Pallas kernel `horopose_tpu/ops/integral_pallas.py::_fwd_kernel`.
Per (b, k) cell of a (D, H, W) logit volume it computes, in float32, the
softmax expectations E = (E_w, E_h, E_d) and uvd = E / dim - 0.5 in one
read of the logits; the normalised tensor is never written. It is bound by
that read: BK * D*H*W * sizeof(x) bytes (3.7 MB per image in bf16 at the
serving shape, about 0.14 ms at b=128 at 3.35 TB/s). Design: one block of
256 threads per cell, an online (max, sum, 3 weighted sums) per thread,
then a block reduction with the same rescaling.

A CPU tensor takes the plain version (`ops.integral.soft_argmax_3d_fwd_plain`).
A CUDA tensor always takes the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from horopose_tpu_torch import cuda_build

SOURCE = "soft_argmax"


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.soft_argmax_3d_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int]
        fn.restype = ctypes.c_int
    return lib


def soft_argmax_3d_fwd(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BK, D, H, W) float32 or bfloat16 logits -> (uvd, E), both (BK, 3)
    float32, ordered (w, h, d). uvd is in [-0.5, 0.5]; E in index units."""
    if x.device.type == "cpu":
        from horopose_tpu_torch.ops.integral import soft_argmax_3d_fwd_plain
        return soft_argmax_3d_fwd_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"soft_argmax_3d_fwd: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"soft_argmax_3d_fwd wants (BK, D, H, W), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"soft_argmax_3d_fwd takes float32 or bfloat16, not "
                        f"{x.dtype}")
    if not x.is_contiguous():
        raise ValueError("soft_argmax_3d_fwd wants a contiguous tensor")
    BK, D, H, W = x.shape
    if min(D, H, W) < 1 or D * H * W >= 2 ** 31 or BK >= 2 ** 31:
        raise ValueError(f"soft_argmax_3d_fwd: unsupported shape "
                         f"{tuple(x.shape)}")
    uvd = torch.empty(BK, 3, dtype=torch.float32, device=x.device)
    ex = torch.empty(BK, 3, dtype=torch.float32, device=x.device)
    if BK == 0:
        return uvd, ex
    lib = _library()
    err = lib.soft_argmax_3d_fwd(
        x.data_ptr(), int(x.dtype == torch.bfloat16), BK, D, H, W,
        uvd.data_ptr(), ex.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream, x.device.index)
    soft_argmax_3d_fwd.launches += 1
    if err != 0:
        raise RuntimeError(f"soft_argmax_3d_fwd launch failed: CUDA error "
                           f"{err}")
    return uvd, ex


# kernel launches since the last reset; read by chip_smoke.py
soft_argmax_3d_fwd.launches = 0
