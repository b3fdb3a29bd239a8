"""Wrappers of the hand-written CUDA soft-argmax kernels (`csrc/soft_argmax.cu`).

`soft_argmax_3d_fwd` replaces the Pallas kernel
`horopose_tpu/ops/integral_pallas.py::_fwd_kernel`. Per (b, k) cell of a
(D, H, W) logit volume it computes, in float32, the softmax expectations
E = (E_w, E_h, E_d), uvd = E / dim - 0.5 and the cell's (max, sum of
exp(x - max)) in one read of the logits; the normalised tensor is never
written. It is bound by that read: BK * D*H*W * sizeof(x) bytes (3.7 MB per
image in bf16 at the serving shape, about 0.14 ms at b=128 at 3.35 TB/s).
Design: each cell's D*H rows are split over several blocks
(`plan_splits`), which read 16-byte vectors along W-rows and keep an online
(max, sum, 3 weighted sums) per thread; a second kernel merges each cell's
splits. A base pointer off 16 bytes, or a row that is not a whole number of
16-byte vectors, takes the same kernels with scalar loads
(`vector_loads`).

`soft_argmax_3d_bwd` replaces `_bwd_kernel`: the closed-form gradient
dx = exp(x - m) / s * sum_axis g_axis / dim_axis * (idx_axis - E_axis), in
the logits' dtype. With the forward's (m, s) it is one elementwise pass,
bound by one read of x and one write of dx (0.140 ms in bf16 at the
training shape, 64 x 7 cells of 64^3, at 3.35 TB/s). Design: the forward's
grid (`plan_splits`) and walk along W-rows in 16-byte vectors, with the
column term of g_w computed once a column and the row term of g_h and g_d
once a row, so a logit costs an exp and a few float32 operations, and
`vector_loads` of x and of dx choose 16-byte or scalar access.

A CPU tensor takes the plain version (`ops.integral.soft_argmax_3d_*_plain`).
A CUDA tensor always takes the kernel or raises. The two wrappers are the
CUDA implementations of the operators `horopose::soft_argmax_3d_fwd` and
`horopose::soft_argmax_3d_bwd` that `ops/integral.py` registers, through
which the model, its gradient and an exported program reach them.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from horopose_tpu_torch import cuda_build

SOURCE = "soft_argmax"
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    # x, is_bf16, vec, bk, D, H, W, splits, rows_per_split, partial, uvd,
    # ex, stats, stream, device
    "soft_argmax_3d_fwd": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P, _I],
    # x, is_bf16, vec, bk, D, H, W, splits, rows_per_split, ex, stats, g,
    # dx, stream, device
    "soft_argmax_3d_bwd": [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                           _P, _P, _I],
}
# both kernels put the split on blockIdx.y
_MAX_SPLITS = 65535
# both kernels split cells until the grid has this many blocks an SM
BLOCKS_PER_SM = 4


def plan_splits(bk: int, rows: int, sm_count: int) -> Tuple[int, int]:
    """(splits, rows_per_split) for `bk` cells of `rows` W-rows each: about
    BLOCKS_PER_SM blocks an SM in all, at least one row a split. Split i
    takes rows [i * rows_per_split, min((i + 1) * rows_per_split, rows)),
    and no split is empty."""
    want = -(-BLOCKS_PER_SM * sm_count // bk)
    per = max(1, rows // want, -(-rows // _MAX_SPLITS))
    return -(-rows // per), per


def vector_loads(data_ptr: int, W: int, element_size: int) -> bool:
    """Whether a kernel may read (or write) 16-byte vectors at data_ptr:
    the base is 16-byte aligned and a row of W logits is a whole number of
    vectors."""
    return data_ptr % 16 == 0 and (W * element_size) % 16 == 0


def _function(name: str):
    fn = getattr(cuda_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check_logits(name: str, x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if x.dim() != 4:
        raise ValueError(f"{name} wants (BK, D, H, W), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} takes float32 or bfloat16, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} wants a contiguous tensor")
    BK, D, H, W = x.shape
    if min(D, H, W) < 1 or D * H * W >= 2 ** 31 - 2 ** 16 or BK >= 2 ** 31:
        raise ValueError(f"{name}: unsupported shape {tuple(x.shape)}")


def _check_rows(name: str, what: str, t: torch.Tensor, x: torch.Tensor,
                width: int) -> None:
    if (t.shape != (x.shape[0], width) or t.dtype != torch.float32
            or t.device != x.device or not t.is_contiguous()):
        raise ValueError(f"{name}: {what} must be a contiguous float32 "
                         f"({x.shape[0]}, {width}) tensor on {x.device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def soft_argmax_3d_fwd(x: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (BK, D, H, W) float32 or bfloat16 logits -> (uvd, E, stats), all
    float32: uvd and E (BK, 3) ordered (w, h, d), uvd in [-0.5, 0.5] and E
    in index units; stats (BK, 2) each cell's (m, s), its max and
    sum of exp(x - m), kept for the backward."""
    if x.device.type == "cpu":
        from horopose_tpu_torch.ops.integral import soft_argmax_3d_fwd_plain
        return soft_argmax_3d_fwd_plain(x)
    _check_logits("soft_argmax_3d_fwd", x)
    BK, D, H, W = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    uvd = torch.empty(BK, 3, **f32)
    ex = torch.empty(BK, 3, **f32)
    stats = torch.empty(BK, 2, **f32)
    if BK == 0:
        return uvd, ex, stats
    splits, per = plan_splits(BK, D * H, cuda_build.sm_count(x.device.index))
    partial = torch.empty(BK, splits, 5, **f32)
    vec = vector_loads(x.data_ptr(), W, x.element_size())
    err = _function("soft_argmax_3d_fwd")(
        x.data_ptr(), int(x.dtype == torch.bfloat16), int(vec), BK, D, H, W,
        splits, per, partial.data_ptr(), uvd.data_ptr(), ex.data_ptr(),
        stats.data_ptr(), _stream(x), x.device.index)
    soft_argmax_3d_fwd.launches += 1
    if err != 0:
        raise RuntimeError(f"soft_argmax_3d_fwd launch failed: CUDA error "
                           f"{err}")
    return uvd, ex, stats


def soft_argmax_3d_bwd(x: torch.Tensor, ex: torch.Tensor,
                       stats: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Gradient of the forward's uvd with respect to the logits.

    x (BK, D, H, W) float32 or bfloat16 logits; ex (BK, 3) and stats
    (BK, 2) from `soft_argmax_3d_fwd(x)`; g (BK, 3) float32, dL/duvd.
    Returns dx (BK, D, H, W) in x's dtype."""
    if x.device.type == "cpu":
        from horopose_tpu_torch.ops.integral import soft_argmax_3d_bwd_plain
        return soft_argmax_3d_bwd_plain(x, ex, stats, g)
    name = "soft_argmax_3d_bwd"
    _check_logits(name, x)
    _check_rows(name, "E", ex, x, 3)
    _check_rows(name, "stats", stats, x, 2)
    _check_rows(name, "g", g, x, 3)
    BK, D, H, W = x.shape
    dx = torch.empty_like(x)
    if BK == 0:
        return dx
    splits, per = plan_splits(BK, D * H, cuda_build.sm_count(x.device.index))
    vec = (vector_loads(x.data_ptr(), W, x.element_size())
           and vector_loads(dx.data_ptr(), W, dx.element_size()))
    err = _function(name)(
        x.data_ptr(), int(x.dtype == torch.bfloat16), int(vec), BK, D, H, W,
        splits, per, ex.data_ptr(), stats.data_ptr(), g.data_ptr(),
        dx.data_ptr(), _stream(x), x.device.index)
    soft_argmax_3d_bwd.launches += 1
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    return dx


# kernel launches since the last reset; read by chip_smoke.py
soft_argmax_3d_fwd.launches = 0
soft_argmax_3d_bwd.launches = 0
