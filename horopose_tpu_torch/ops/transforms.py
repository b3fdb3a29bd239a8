"""Camera-space transforms: uvd <-> xyz, intrinsics, projection.

Port of the serving-path subset of `horopose_tpu/ops/transforms.py`.
Batched over leading dims.
"""

from __future__ import annotations

import torch


def make_K(fx, fy, cx, cy, dtype=torch.float32, device=None) -> torch.Tensor:
    """Build intrinsic matrices (..., 3, 3) from focal/center components."""
    fx, fy, cx, cy = (torch.as_tensor(v, dtype=dtype, device=device)
                      for v in (fx, fy, cx, cy))
    batch = torch.broadcast_shapes(fx.shape, fy.shape, cx.shape, cy.shape)
    fx, fy, cx, cy = (v.expand(batch) for v in (fx, fy, cx, cy))
    z = torch.zeros(batch, dtype=dtype, device=fx.device)
    o = torch.ones(batch, dtype=dtype, device=fx.device)
    rows = [torch.stack([fx, z, cx], -1),
            torch.stack([z, fy, cy], -1),
            torch.stack([z, z, o], -1)]
    return torch.stack(rows, dim=-2)


def invert_K(K: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of pinhole K (no skew), shape-preserving."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    return make_K(1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy, dtype=K.dtype,
                  device=K.device)


def project_points(K: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Perspective projection: K (..., 3, 3) x points (..., N, 3) -> (..., N, 2)."""
    proj = torch.einsum("...ij,...nj->...ni", K, points)
    z = proj[..., 2:3]
    z = torch.where(z.abs() < 1e-9, torch.full_like(z, 1e-9), z)  # degenerate depth
    return proj[..., :2] / z


def uvd_to_xyz(uvd: torch.Tensor, image_size: float, K_inv: torch.Tensor,
               root_trans: torch.Tensor, depth_factor: float) -> torch.Tensor:
    """Soft-argmax output -> metric camera-frame 3D points.

    uvd (..., N, 3) in [-0.5, 0.5]; K_inv (..., 3, 3); root_trans (..., 3).
    uv is remapped to crop pixels, d to metres via depth_factor, absolute
    z = d + root_z, and xyz = K^-1 [u v 1]^T * z.
    """
    uv_pix = (uvd[..., :2] + 0.5) * image_size
    dz = uvd[..., 2] * depth_factor
    uv_homo = torch.cat([uv_pix, torch.ones_like(uv_pix[..., :1])], dim=-1)
    rays = torch.einsum("...ij,...nj->...ni", K_inv, uv_homo)
    abs_z = dz + root_trans[..., 2:3]
    return rays * abs_z[..., None]


def uvz_to_xyz_singlepoint(uv: torch.Tensor, z: torch.Tensor,
                           K: torch.Tensor) -> torch.Tensor:
    """Root translation from (uv pixel coords, metric depth, K).

    uv (..., 2), z (..., 1), K (..., 3, 3) -> xyz (..., 3).
    """
    uvz = torch.cat([uv * z, z], dim=-1)
    return torch.einsum("...ij,...j->...i", invert_K(K), uvz)


def k_value_from_bbox(bboxes: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor,
                      real_area: float = 1000.0 * 1000.0) -> torch.Tensor:
    """Root-depth prior k = sqrt(fx*fy*real_area / bbox_area), where the
    area is the square of the bbox's longer side. bboxes (..., 4) xyxy."""
    side = torch.maximum((bboxes[..., 2] - bboxes[..., 0]).abs(),
                         (bboxes[..., 3] - bboxes[..., 1]).abs())
    return torch.sqrt(fx * fy * real_area / (side * side))
