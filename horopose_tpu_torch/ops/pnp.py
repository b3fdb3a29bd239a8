"""Batched differentiable Perspective-n-Point.

Port of `horopose_tpu/ops/pnp.py`. For each of B samples, (N, 2) pixel
keypoints, (N, 3) model points and the intrinsics K give the pose
(R, t) that minimises the reprojection error:

  1. inits, in K-normalised image coordinates and centred 3-D points: the
     DLT (the null vector of the 2N x 12 design matrix by SVD, decomposed
     against K = I, orthogonalised, the cheirality sign fixed), the planar
     homography (IPPE-style, for near-coplanar sets where the DLT is rank
     deficient), and the mirrored-planar pose of each of those two (the
     second basin of the planar two-fold ambiguity);
  2. Levenberg-Marquardt with adaptive damping, 40 fixed iterations, each
     step accepted or rejected per sample with `torch.where` (no host
     read inside the loop). The DLT and planar candidates refine as one
     stacked batch of 2B, then the two mirrored ones as another: 80
     dependent iterations, not 160. The lowest final residual of the four
     wins;
  3. gradients by the implicit function theorem at the optimum
     (`PnPTheta.backward`): with F = J^T r the gradient of the objective,
     the pullback of g is -(dF/dx)^T H^-T g, one batched 6x6 solve.

The refine's Jacobian is analytic (`_residuals_and_jacobian`); the
backward's come from `torch.func.jacfwd` / `jacrev` under `torch.func.vmap`.
Float32 throughout, as the JAX solver. Used for the pseudo-ground-truth
rotation of the real sets (`core/engine.py::prepare_gt`) and by
`models/deeplab.py::CtRNetInference`.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, jacrev, vjp, vmap

from horopose_tpu_torch.ops.rotations import (axis_angle_to_rotmat,
                                              rotmat_to_axis_angle)

_REFINE_ITERS = 40
_LM_LAMBDA0 = 1e-3


def _det3(m: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by the triple product (no LU)."""
    return (torch.linalg.cross(m[..., 0, :], m[..., 1, :], dim=-1)
            * m[..., 2, :]).sum(-1)


def _orthogonalize(R_raw: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (det +1) to each (..., 3, 3) matrix, by SVD."""
    u, _, vt = torch.linalg.svd(R_raw)
    det = _det3(u @ vt)
    vt = torch.cat([vt[..., :2, :], vt[..., 2:, :] * det[..., None, None]],
                   dim=-2)
    return u @ vt


def _null_vector(rows_u: torch.Tensor, rows_v: torch.Tensor) -> torch.Tensor:
    """The right singular vector of the smallest singular value of the
    design matrix [rows_u; rows_v] (B, 2N, M) -> (B, M)."""
    A = torch.cat([rows_u, rows_v], dim=1)
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return vt[:, -1]


def _front_or_flipped(R: torch.Tensor, R_flip: torch.Tensor, t: torch.Tensor,
                      Xc: torch.Tensor):
    """Cheirality: keep (R, t) when the points lie in front of the camera
    on average, else (R_flip, -t)."""
    z = torch.einsum("bj,bnj->bn", R[:, 2], Xc) + t[:, None, 2]
    flip = z.mean(-1) < 0
    return (torch.where(flip[:, None, None], R_flip, R),
            torch.where(flip[:, None], -t, t))


def _dlt_init(uvn: torch.Tensor, Xc: torch.Tensor):
    """Direct linear transform in normalised coordinates: (B, N, 2)
    normalised image points, (B, N, 3) centred 3-D points -> (R, t), N >= 6.
    Every entry of the design matrix is O(1) (Hartley-style conditioning):
    raw pixels fail in float32."""
    X = torch.cat([Xc, torch.ones_like(Xc[..., :1])], dim=-1)
    u, v = uvn[..., 0:1], uvn[..., 1:2]
    zeros = torch.zeros_like(X)
    M = _null_vector(torch.cat([X, zeros, -u * X], dim=-1),
                     torch.cat([zeros, X, -v * X], dim=-1)).reshape(-1, 3, 4)
    R_raw = M[..., :3]                                  # = s R, K = I
    scale = torch.clamp(torch.linalg.vector_norm(R_raw, dim=-1).mean(-1),
                        min=1e-9)
    sign = torch.where(_det3(R_raw) >= 0, 1.0, -1.0)   # no sign(0) = 0
    R0 = _orthogonalize(R_raw * sign[:, None, None])
    t0 = M[..., 3] * sign[:, None] / scale[:, None]
    return _front_or_flipped(R0, _orthogonalize(-R0), t0, Xc)


def _planar_init(uvn: torch.Tensor, Xc: torch.Tensor, V: torch.Tensor):
    """Homography init for near-coplanar sets, where the DLT is rank
    deficient. V (B, 3, 3): eigenvectors of the points' scatter, ascending;
    the first is the plane normal, the other two its basis. R comes from
    the homography's first two columns, cheirality-disambiguated."""
    normal, basis = V[..., 0], V[..., 1:]
    P2 = Xc @ basis                                      # (B, N, 2) in-plane
    P2h = torch.cat([P2, torch.ones_like(P2[..., :1])], dim=-1)
    u, v = uvn[..., 0:1], uvn[..., 1:2]
    zeros = torch.zeros_like(P2h)
    H = _null_vector(torch.cat([P2h, zeros, -u * P2h], dim=-1),
                     torch.cat([zeros, P2h, -v * P2h], dim=-1)).reshape(-1, 3, 3)
    s = 0.5 * (torch.linalg.vector_norm(H[..., 0], dim=-1)
               + torch.linalg.vector_norm(H[..., 1], dim=-1))
    H = H / torch.clamp(s, min=1e-12)[:, None, None]
    r1, r2, t_pl = H[..., 0], H[..., 1], H[..., 2]
    R_pl = _orthogonalize(torch.stack(
        [r1, r2, torch.linalg.cross(r1, r2, dim=-1)], dim=-1))
    # plane coordinates -> world: Xc = basis @ p, so
    # R_full @ [basis normal] = R_pl
    M3t = torch.cat([basis, normal[..., None]], dim=-1).transpose(-1, -2)
    return _front_or_flipped(R_pl @ M3t, _orthogonalize(-R_pl) @ M3t, t_pl,
                             Xc)


def _residuals(theta, pts2d, pts3d, K):
    """Raw-pixel reprojection residuals of one sample, flattened (2N,),
    for the implicit backward. For a skew-free K its optimum is the
    normalised objective's (u_pred - u_obs = fx (xn_pred - xn_obs))."""
    R = axis_angle_to_rotmat(theta[:3])
    cam = pts3d @ R.T + theta[3:]
    proj = cam @ K.T
    uv = proj[:, :2] / torch.clamp(proj[:, 2:3], min=1e-9)
    return (uv - pts2d).reshape(-1)


def _camera_points(R, t, Xc):
    """(R X (B, N, 3), cam = R X + t, z guarded away from 0 (B, N, 1), and
    where it was guarded)."""
    RX = Xc @ R.transpose(1, 2)
    cam = RX + t[:, None]
    z = cam[..., 2:3]
    tiny = z.abs() < 1e-9
    z = torch.where(tiny, torch.where(z < 0, -1e-9, 1e-9).to(z.dtype), z)
    return RX, cam, z, tiny


def _residuals_n(theta, uvn, Xc, f):
    """Pixel-unit residuals from normalised quantities, (B, 2N): theta (B,
    6) = [axis-angle, t] of the centred points Xc (B, N, 3), uvn (B, N, 2)
    normalised image points, f (B, 2) = (|fx|, |fy|). Every intermediate
    is O(1)."""
    _, cam, z, _ = _camera_points(axis_angle_to_rotmat(theta[:, :3]),
                                  theta[:, 3:], Xc)
    return ((cam[..., :2] / z - uvn) * f[:, None]).flatten(1)


def _skew(v):
    """[v]x (..., 3, 3) of v (..., 3): [v]x w = v x w."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack([torch.stack([zero, -z, y], -1),
                        torch.stack([z, zero, -x], -1),
                        torch.stack([-y, x, zero], -1)], -2)


def _residuals_and_jacobian(theta, uvn, Xc, f):
    """(r (B, 2N), J = dr / dtheta (B, 2N, 6)), analytically. The rotation
    part is the exact derivative of Rodrigues' formula (Gallego & Yezzi):
    d(R X)/d aa_i = (aa_i (aa x R X) + (aa x (I - R) e_i) x R X) / |aa|^2,
    and e_i x X where `axis_angle_to_rotmat` takes its first-order branch
    (|aa|^2 <= 1e-6), as autodiff of that map gives."""
    aa = theta[:, :3]
    R = axis_angle_to_rotmat(aa)
    RX, cam, z, tiny = _camera_points(R, theta[:, 3:], Xc)
    xn = cam[..., :2] / z
    r = ((xn - uvn) * f[:, None]).flatten(1)
    theta2 = (aa * aa).sum(-1)[:, None, None, None]
    # columns (I - R) e_i as rows i, crossed with aa: (B, 3 [i], 3)
    c = torch.linalg.cross(aa[:, None, :].expand(-1, 3, -1),
                           (torch.eye(3, device=aa.device) - R)
                           .transpose(1, 2), dim=-1)
    a_x_RX = torch.linalg.cross(aa[:, None, :].expand_as(RX), RX, dim=-1)
    full = (a_x_RX[..., :, None] * aa[:, None, None, :]
            - _skew(RX) @ c[:, None].transpose(-1, -2)) / theta2
    drot = torch.where(theta2 > 1e-6, full, -_skew(Xc))    # (B, N, 3, 3)
    dcam = torch.cat([drot, torch.eye(3, device=aa.device)
                      .expand_as(drot)], dim=-1)             # (B, N, 3, 6)
    # d xn / d cam, the guarded z a constant
    dz = torch.where(tiny, 0.0, -1.0 / z)
    inv_z = 1.0 / z
    zero = torch.zeros_like(inv_z)
    D = torch.stack([torch.cat([inv_z, zero, dz * xn[..., 0:1]], -1),
                     torch.cat([zero, inv_z, dz * xn[..., 1:2]], -1)], -2)
    J = (D @ dcam) * f[:, None, :, None]                     # (B, N, 2, 6)
    return r, J.flatten(1, 2)


def _refine(theta0, uvn, Xc, f, iters: int = _REFINE_ITERS):
    """Levenberg-Marquardt with adaptive damping: a step is accepted where
    it lowers the squared residual (the damping shrinks x0.3), else
    rejected (x10). A fixed tiny damping stalls or diverges from imperfect
    inits. A non-finite init falls back to the identity pose at z = 1.
    Returns (theta (B, 6), best squared residual (B,))."""
    fallback = torch.zeros_like(theta0)
    fallback[:, 5] = 1.0
    theta = torch.where(torch.isfinite(theta0).all(-1, keepdim=True), theta0,
                        fallback)
    best = (_residuals_n(theta, uvn, Xc, f) ** 2).sum(-1)
    best = torch.where(torch.isfinite(best), best, torch.inf)
    lam = torch.full_like(best, _LM_LAMBDA0)
    for _ in range(iters):
        r, J = _residuals_and_jacobian(theta, uvn, Xc, f)
        JtJ = J.transpose(1, 2) @ J
        H = JtJ + lam[:, None, None] * torch.diag_embed(
            torch.clamp(torch.diagonal(JtJ, dim1=1, dim2=2), min=1e-12))
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        # solve_ex: no error check, so no host read; a singular H gives
        # non-finite entries, which become a zero step
        step = torch.linalg.solve_ex(H, g)[0]
        step = torch.where(torch.isfinite(step), step, 0.0)
        theta_new = theta - step
        new = (_residuals_n(theta_new, uvn, Xc, f) ** 2).sum(-1)
        ok = torch.isfinite(new) & (new < best)
        theta = torch.where(ok[:, None], theta_new, theta)
        lam = torch.where(ok, torch.clamp(lam * 0.3, min=1e-10),
                          torch.clamp(lam * 10.0, max=1e8))
        best = torch.where(ok, new, best)
    return theta, best


def _mirror_planar_candidate(theta: torch.Tensor, normal: torch.Tensor):
    """The other basin of the planar two-fold ambiguity: rotate the pose so
    its plane normal maps onto the normal's reflection about the ray to
    the centroid (IPPE's solution pair). theta (B, 6), normal (B, 3)."""
    R = axis_angle_to_rotmat(theta[:, :3])
    t = theta[:, 3:]
    v = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True),
                        min=1e-9)
    n_c = (R @ normal[..., None])[..., 0]
    n2 = 2.0 * (v * n_c).sum(-1, keepdim=True) * v - n_c
    axis = torch.linalg.cross(n_c, n2, dim=-1)
    s = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    c = torch.clamp((n_c * n2).sum(-1, keepdim=True), -1.0, 1.0)
    aa = torch.where(s > 1e-9,
                     axis / torch.clamp(s, min=1e-9) * torch.atan2(s, c), 0.0)
    R2 = axis_angle_to_rotmat(aa) @ R
    return torch.cat([rotmat_to_axis_angle(R2), t], dim=-1)


def _pose_vector(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([rotmat_to_axis_angle(R), t], dim=-1)


def solve_pnp(pts2d: torch.Tensor, pts3d: torch.Tensor,
              K: torch.Tensor) -> torch.Tensor:
    """(B, N, 2), (B, N, 3), (B, 3, 3) float32 -> theta (B, 6) =
    [axis-angle, t], no gradient. The normalised-coordinate DLT, the
    planar homography and both mirrored-planar inits, each refined by LM;
    the lowest final residual wins (the planar branches cover coplanar and
    near-coplanar sets, both basins of their ambiguity)."""
    B = pts2d.shape[0]
    f = torch.stack([K[:, 0, 0].abs(), K[:, 1, 1].abs()], dim=-1)
    Kinv = torch.linalg.inv_ex(K)[0]
    uvh = torch.cat([pts2d, torch.ones_like(pts2d[..., :1])], dim=-1) \
        @ Kinv.transpose(1, 2)
    uvn = uvh[..., :2] / uvh[..., 2:3]
    c3 = pts3d.mean(1)
    Xc = pts3d - c3[:, None]
    V = torch.linalg.eigh(Xc.transpose(1, 2) @ Xc)[1]
    normal = V[..., 0]

    R0, t0 = _dlt_init(uvn, Xc)
    R1, t1 = _planar_init(uvn, Xc, V)
    twice = (lambda x: torch.cat([x, x]))
    uvn2, Xc2, f2 = twice(uvn), twice(Xc), twice(f)
    th01, res01 = _refine(torch.cat([_pose_vector(R0, t0),
                                     _pose_vector(R1, t1)]), uvn2, Xc2, f2)
    th0, th1 = th01[:B], th01[B:]
    # the planar solution's mirror, and the DLT solution's (with noisy thin
    # sets the DLT basin can be the wrong one of the pair)
    th23, res23 = _refine(torch.cat([
        _mirror_planar_candidate(th1, normal),
        _mirror_planar_candidate(th0, normal)]), uvn2, Xc2, f2)
    cands = torch.stack([th0, th1, th23[:B], th23[B:]], dim=1)   # (B, 4, 6)
    ress = torch.stack([res01[:B], res01[B:], res23[:B], res23[B:]], dim=1)
    ress = torch.where(torch.isfinite(ress), ress, torch.inf)
    theta_c = torch.gather(cands, 1, ress.argmin(1)[:, None, None]
                           .expand(B, 1, 6))[:, 0]
    # un-centre the translation: R (X - c3) + t_c = R X + (t_c - R c3)
    R = axis_angle_to_rotmat(theta_c[:, :3])
    t = theta_c[:, 3:] - (R @ c3[..., None])[..., 0]
    return torch.cat([theta_c[:, :3], t], dim=-1)


def _grad_obj(theta, pts2d, pts3d, K):
    """J^T r of one sample: the gradient of half the squared raw-pixel
    residual."""
    J = jacrev(_residuals)(theta, pts2d, pts3d, K)
    return J.T @ _residuals(theta, pts2d, pts3d, K)


def _implicit_pullback(theta, pts2d, pts3d, K, g):
    H = jacfwd(_grad_obj)(theta, pts2d, pts3d, K)
    H = H + 1e-8 * torch.eye(6, dtype=theta.dtype, device=theta.device)
    u = torch.linalg.solve_ex(H.T, g)[0]                  # H^-T g
    _, pull = vjp(lambda p2, p3, k: _grad_obj(theta, p2, p3, k),
                  pts2d, pts3d, K)
    return pull(-u)


class PnPTheta(torch.autograd.Function):
    """theta (B, 6) = [axis-angle, t] from (pts2d, pts3d, K); the backward
    is the implicit function theorem at the optimum."""

    @staticmethod
    def forward(ctx, pts2d, pts3d, K):
        theta = solve_pnp(pts2d, pts3d, K)
        ctx.save_for_backward(theta, pts2d, pts3d, K)
        return theta

    @staticmethod
    def backward(ctx, g):
        theta, pts2d, pts3d, K = ctx.saved_tensors
        return vmap(_implicit_pullback)(theta, pts2d, pts3d, K, g)


def pnp_theta(pts2d: torch.Tensor, pts3d: torch.Tensor,
              K: torch.Tensor) -> torch.Tensor:
    """Batched differentiable PnP: (B, N, 2), (B, N, 3), (B, 3, 3) ->
    theta (B, 6) = [axis-angle, t]."""
    return PnPTheta.apply(pts2d, pts3d, K)


def pnp(pts2d: torch.Tensor, pts3d: torch.Tensor, K: torch.Tensor):
    """Batched differentiable PnP: pts2d (B, N, 2), pts3d (B, N, 3), K
    (B, 3, 3) or (3, 3) -> (R (B, 3, 3), t (B, 3)), in float32."""
    if K.dim() == 2:
        K = K.expand(pts2d.shape[0], 3, 3)
    theta = pnp_theta(pts2d.float(), pts3d.float(), K.float())
    return axis_angle_to_rotmat(theta[:, :3]), theta[:, 3:]


def batch_project(theta: torch.Tensor, pts3d: torch.Tensor,
                  K: torch.Tensor) -> torch.Tensor:
    """Project (B, N, 3) points with theta = [axis-angle, t] through K ->
    (B, N, 2) pixels."""
    R = axis_angle_to_rotmat(theta[:, :3])
    cam = torch.einsum("bij,bnj->bni", R, pts3d) + theta[:, None, 3:]
    proj = torch.einsum("bij,bnj->bni", K, cam)
    return proj[..., :2] / proj[..., 2:3]
