"""Soft-argmax ("integral") heatmap decoding, softmax normalisation.

Port of `horopose_tpu/ops/integral.py`. `soft_argmax_3d_fwd_plain` is the
plain PyTorch version of the CUDA kernel in `ops/integral_cuda.py`: an f32
softmax, three marginal sums and three dot products. The CPU tests hold it
against the JAX package, and the card holds the kernel against it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from horopose_tpu_torch.ops.integral_cuda import soft_argmax_3d_fwd
from horopose_tpu_torch.ops.transforms import invert_K, uvd_to_xyz


def soft_argmax_3d_fwd_plain(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BK, D, H, W) logits -> (uvd, E), both (BK, 3) float32, ordered
    (w, h, d): E is the softmax expectation of each index and
    uvd = E / dim - 0.5."""
    BK, D, H, W = x.shape
    p = torch.softmax(x.reshape(BK, D * H * W).float(), dim=-1)
    p = p.reshape(BK, D, H, W)
    f32 = dict(dtype=torch.float32, device=x.device)
    e_w = p.sum(dim=(1, 2)) @ torch.arange(W, **f32)
    e_h = p.sum(dim=(1, 3)) @ torch.arange(H, **f32)
    e_d = p.sum(dim=(2, 3)) @ torch.arange(D, **f32)
    uvd = torch.stack([e_w / float(W) - 0.5, e_h / float(H) - 0.5,
                       e_d / float(D) - 0.5], dim=-1)
    return uvd, torch.stack([e_w, e_h, e_d], dim=-1)


def soft_argmax_3d(logits: torch.Tensor, depth_dim: int, height_dim: int,
                   width_dim: int) -> torch.Tensor:
    """Plain 3-D soft-argmax: logits reshapeable to (B, K, D, H, W), with K
    inferred -> uvd (B, K, 3) in [-0.5, 0.5]."""
    B = logits.shape[0]
    x = logits.reshape(B, -1, depth_dim, height_dim, width_dim)
    uvd, _ = soft_argmax_3d_fwd_plain(x.reshape(-1, *x.shape[2:]))
    return uvd.reshape(B, -1, 3)


def heatmap_integral_pose(out: torch.Tensor, *, num_joints: int,
                          depth_dim: int, height_dim: int, width_dim: int,
                          image_size: float, bbox_3d_shape, K: torch.Tensor,
                          root_trans: torch.Tensor, rootid: int = 0,
                          fixroot: bool = False,
                          use_kernel: Optional[bool] = None):
    """Decode head logits to (uvd (B, K, 3) in [-0.5, 0.5], xyz (B, K, 3)
    metres).

    out: raw head logits, any layout reshapeable to
    (B, num_joints, depth_dim, height_dim, width_dim). use_kernel: None
    takes the CUDA kernel for a CUDA tensor and the plain version for a CPU
    one; False asks for the plain version (tests and chip_smoke.py).
    """
    B = out.shape[0]
    depth_factor = float(bbox_3d_shape[2]) * 1e-3
    x = out.reshape(B * num_joints, depth_dim, height_dim, width_dim)
    if use_kernel is False:
        uvd, _ = soft_argmax_3d_fwd_plain(x)
    else:
        uvd, _ = soft_argmax_3d_fwd(x.contiguous())
    uvd = uvd.reshape(B, num_joints, 3)
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
