"""Soft-argmax ("integral") heatmap decoding, softmax normalisation.

Port of `horopose_tpu/ops/integral.py` and of the `jax.custom_vjp` in
`horopose_tpu/ops/integral_pallas.py`. `soft_argmax_3d_fwd_plain` and
`soft_argmax_3d_bwd_plain` are the plain PyTorch versions of the CUDA
kernels in `ops/integral_cuda.py`: an f32 softmax with three marginal sums
and dot products, and the closed-form gradient. `SoftArgmax3d` ties the two
kernels into autograd. The CPU tests hold the plain versions against the
JAX package, and the card holds the kernels against them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from horopose_tpu_torch.ops.integral_cuda import (soft_argmax_3d_bwd,
                                                  soft_argmax_3d_fwd)
from horopose_tpu_torch.ops.transforms import invert_K, uvd_to_xyz


def _index_grids(D: int, H: int, W: int, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.arange(W, **f32), torch.arange(H, **f32),
            torch.arange(D, **f32))


def soft_argmax_3d_fwd_plain(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """x (BK, D, H, W) logits -> (uvd, E, stats), all float32: uvd and E
    (BK, 3) ordered (w, h, d), E the softmax expectation of each index and
    uvd = E / dim - 0.5; stats (BK, 2) each cell's m = max x and
    s = sum exp(x - m)."""
    BK, D, H, W = x.shape
    with torch.autocast(x.device.type, enabled=False):
        flat = x.reshape(BK, D * H * W).float()
        m = flat.amax(dim=-1)
        e = torch.exp(flat - m[:, None])
        s = e.sum(dim=-1)
        p = (e / s[:, None]).reshape(BK, D, H, W)
        idx_w, idx_h, idx_d = _index_grids(D, H, W, x.device)
        e_w = p.sum(dim=(1, 2)) @ idx_w
        e_h = p.sum(dim=(1, 3)) @ idx_h
        e_d = p.sum(dim=(2, 3)) @ idx_d
    uvd = torch.stack([e_w / float(W) - 0.5, e_h / float(H) - 0.5,
                       e_d / float(D) - 0.5], dim=-1)
    return (uvd, torch.stack([e_w, e_h, e_d], dim=-1),
            torch.stack([m, s], dim=-1))


def soft_argmax_3d_bwd_plain(x: torch.Tensor, ex: torch.Tensor,
                             stats: torch.Tensor, g: torch.Tensor
                             ) -> torch.Tensor:
    """Closed-form gradient of `soft_argmax_3d_fwd_plain`'s uvd with
    respect to x: p = exp(x - m) / s, dx = p * sum_axis g_axis / dim_axis *
    (idx_axis - E_axis), in float32 arithmetic, returned in x's dtype.
    ex (BK, 3) and stats (BK, 2) come from the forward; g (BK, 3) is
    dL/duvd."""
    BK, D, H, W = x.shape
    idx_w, idx_h, idx_d = _index_grids(D, H, W, x.device)
    m, s = stats[:, 0, None, None, None], stats[:, 1, None, None, None]
    p = torch.exp(x.float() - m) * (1.0 / s)
    g = g.float()

    def dev(idx, axis, dim):          # g_axis / dim * (idx - E_axis)
        return (g[:, axis, None] / float(dim)) * (idx[None] - ex[:, axis, None])

    dx = (dev(idx_w, 0, W)[:, None, None, :] + dev(idx_h, 1, H)[:, None, :, None]
          + dev(idx_d, 2, D)[:, :, None, None])
    return (p * dx).to(x.dtype)


class SoftArgmax3d(torch.autograd.Function):
    """uvd (BK, 3) float32 of x (BK, D, H, W) logits, differentiable in x.

    Forward and backward go through `ops/integral_cuda.py`: the CUDA kernels
    for a CUDA tensor, their plain versions for a CPU one. The forward saves
    x, E and the cells' (m, s); the backward returns dx in x's dtype, as the
    Pallas backward returns the logits' dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        uvd, ex, stats = soft_argmax_3d_fwd(x)
        ctx.save_for_backward(x, ex, stats)
        return uvd

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        x, ex, stats = ctx.saved_tensors
        return soft_argmax_3d_bwd(x, ex, stats, g.contiguous().float())


def soft_argmax_3d(logits: torch.Tensor, depth_dim: int, height_dim: int,
                   width_dim: int) -> torch.Tensor:
    """Plain 3-D soft-argmax: logits reshapeable to (B, K, D, H, W), with K
    inferred -> uvd (B, K, 3) in [-0.5, 0.5]."""
    B = logits.shape[0]
    x = logits.reshape(B, -1, depth_dim, height_dim, width_dim)
    uvd, _, _ = soft_argmax_3d_fwd_plain(x.reshape(-1, *x.shape[2:]))
    return uvd.reshape(B, -1, 3)


def integral_uvd(out: torch.Tensor, *, num_joints: int, depth_dim: int,
                 height_dim: int, width_dim: int,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Head logits reshapeable to (B, num_joints, D, H, W) -> uvd
    (B, num_joints, 3) in [-0.5, 0.5]. use_kernel: None decodes through
    `SoftArgmax3d`, the CUDA kernels (forward and backward) for a CUDA
    tensor and their plain versions for a CPU one; False asks for the
    plain forward under torch autograd (tests and chip_smoke.py compare
    with it)."""
    B = out.shape[0]
    x = out.reshape(B * num_joints, depth_dim, height_dim, width_dim)
    if use_kernel is False:
        uvd, _, _ = soft_argmax_3d_fwd_plain(x)
    else:
        uvd = SoftArgmax3d.apply(x.contiguous())
    return uvd.reshape(B, num_joints, 3)


def heatmap_integral_pose(out: torch.Tensor, *, num_joints: int,
                          depth_dim: int, height_dim: int, width_dim: int,
                          image_size: float, bbox_3d_shape, K: torch.Tensor,
                          root_trans: torch.Tensor, rootid: int = 0,
                          fixroot: bool = False,
                          use_kernel: Optional[bool] = None):
    """Decode head logits to (uvd (B, K, 3) in [-0.5, 0.5], xyz (B, K, 3)
    metres).

    out: raw head logits, any layout reshapeable to
    (B, num_joints, depth_dim, height_dim, width_dim); use_kernel as in
    `integral_uvd`.
    """
    depth_factor = float(bbox_3d_shape[2]) * 1e-3
    uvd = integral_uvd(out, num_joints=num_joints, depth_dim=depth_dim,
                       height_dim=height_dim, width_dim=width_dim,
                       use_kernel=use_kernel)
    if fixroot:  # out-of-place uvd[:, rootid, 2] = 0
        root_d = torch.zeros(num_joints, 3, dtype=torch.bool,
                             device=uvd.device)
        root_d[rootid, 2] = True
        uvd = uvd.masked_fill(root_d, 0.0)
    K_inv = invert_K(K.float())
    return uvd, uvd_to_xyz(uvd, image_size, K_inv, root_trans, depth_factor)


def heatmap_integral_joint(out: torch.Tensor, *, dof: int,
                           joint_bounds: torch.Tensor) -> torch.Tensor:
    """1-D soft-argmax over per-joint angle heatmaps scaled to joint bounds.

    out: (B, dof, R) or reshapeable; joint_bounds (dof, 2) -> (B, dof).
    """
    B = out.shape[0]
    flat = out.reshape(B, dof, -1).float()
    res = flat.shape[-1]
    probs = torch.softmax(flat, dim=-1)
    coord = probs @ torch.arange(res, dtype=torch.float32,
                                 device=out.device) / float(res)
    lo = joint_bounds[:, 0][None]
    hi = joint_bounds[:, 1][None]
    return coord * (hi - lo) + lo
