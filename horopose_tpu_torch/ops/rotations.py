"""Rotation representation conversions, batched over leading dims.

Port of the serving and training subset of `horopose_tpu/ops/rotations.py`.
"""

from __future__ import annotations

import torch


def quat_to_rotmat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) in (w, x, y, z) order -> rotation matrix (..., 3, 3)."""
    q = quat / (torch.linalg.norm(quat, dim=-1, keepdim=True) + 1e-9)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    rows = [
        torch.stack([w2 + x2 - y2 - z2, 2 * xy - 2 * wz, 2 * wy + 2 * xz], -1),
        torch.stack([2 * wz + 2 * xy, w2 - x2 + y2 - z2, 2 * yz - 2 * wx], -1),
        torch.stack([2 * xz - 2 * wy, 2 * wx + 2 * yz, w2 - x2 - y2 + z2], -1),
    ]
    return torch.stack(rows, dim=-2)


def rot6d_to_rotmat(r6: torch.Tensor) -> torch.Tensor:
    """Zhou et al. 6D representation (..., 6) -> rotation matrix (..., 3, 3).

    The 6 numbers are the first two ROWS of the matrix; Gram-Schmidt gives
    row x = normalize(r6[:3]), row z = normalize(x cross r6[3:]),
    row y = z cross x.
    """
    x_raw = r6[..., 0:3]
    y_raw = r6[..., 3:6]
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    z = torch.linalg.cross(x, y_raw, dim=-1)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True)
    y = torch.linalg.cross(z, x, dim=-1)
    return torch.stack([x, y, z], dim=-2)


def rotmat_to_rot6d(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> 6D representation: first two rows."""
    return matrix[..., :2, :].reshape(*matrix.shape[:-2], 6)


def geodesic_distance(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """Angle (radians, in [0, pi]) between rotation matrices, batched."""
    m = m1 @ m2.transpose(-1, -2)
    cos = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2] - 1.0) / 2.0
    return torch.arccos(torch.clamp(cos, -1.0, 1.0))


def euler_from_rotmat(matrix: torch.Tensor) -> torch.Tensor:
    """XYZ euler angles (..., 3) from rotation matrices, with the
    reference's gimbal-lock branch (sy < 1e-6: x from the second row,
    z = 0)."""
    r = matrix
    sy = torch.sqrt(r[..., 0, 0] ** 2 + r[..., 1, 0] ** 2)
    singular = (sy < 1e-6).to(r.dtype)
    x = torch.atan2(r[..., 2, 1], r[..., 2, 2])
    y = torch.atan2(-r[..., 2, 0], sy)
    z = torch.atan2(r[..., 1, 0], r[..., 0, 0])
    xs = torch.atan2(-r[..., 1, 2], r[..., 1, 1])
    return torch.stack([x * (1 - singular) + xs * singular, y,
                        z * (1 - singular)], dim=-1)


def make_T(rotmat: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    """Assemble homogeneous transforms (..., 4, 4) from R (..., 3, 3), t (..., 3)."""
    batch = torch.broadcast_shapes(rotmat.shape[:-2], trans.shape[:-1])
    rotmat = rotmat.expand(*batch, 3, 3)
    trans = trans.expand(*batch, 3)
    top = torch.cat([rotmat, trans[..., :, None]], dim=-1)
    bottom = torch.zeros(*batch, 1, 4, dtype=top.dtype, device=top.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def invert_T(T: torch.Tensor) -> torch.Tensor:
    """Invert rigid transforms (..., 4, 4) analytically."""
    R_inv = T[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", R_inv, T[..., :3, 3])
    return make_T(R_inv, t_inv)


def rot_to_rotmat(rot: torch.Tensor) -> torch.Tensor:
    """Dispatch on trailing dim: 6 -> rot6d, 4 -> quat."""
    d = rot.shape[-1]
    if d == 6:
        return rot6d_to_rotmat(rot)
    if d == 4:
        return quat_to_rotmat(rot)
    if d == 9:
        raise NotImplementedError(
            "rot9d is not ported yet (ROADMAP queue 1 item 5: "
            "the non-flagship FullNet flags)")
    raise ValueError(f"unsupported rotation dim {d}")


def rotmat_to_rot(matrix: torch.Tensor, dim: int) -> torch.Tensor:
    if dim == 6:
        return rotmat_to_rot6d(matrix)
    if dim == 9:
        return matrix.reshape(*matrix.shape[:-2], 9)
    if dim == 4:
        raise NotImplementedError(
            "quaternion-from-matrix is not ported yet (ROADMAP queue 1 "
            "item 5: the non-flagship FullNet flags)")
    raise ValueError(f"unsupported rotation dim {dim}")
