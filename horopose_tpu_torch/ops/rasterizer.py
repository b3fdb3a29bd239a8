"""Differentiable soft silhouette rasterizer.

Port of `horopose_tpu/ops/rasterizer.py`, the renderer of the sim2real mask
loss. For every (pixel, face) pair: the signed squared 2-D distance d of
the pixel to the projected triangle (negative inside), the face's coverage
D = sigmoid(-d / sigma), and the silhouette alpha = 1 - prod_f (1 - D_f),
summed in log space: log(1 - D) = -softplus(-d / sigma). Faces with a
vertex behind the camera are masked. Differentiable to the vertices.

Two modes, both plain PyTorch:
  - dense (`rasterize_silhouette`): every pixel against every face, in
    chunks of pixels;
  - tiled (`rasterize_silhouette_tiled`): each 16x16 tile against the
    `faces_per_tile` faces whose screen bbox (plus a halo past which a
    face's coverage is below 1e-16) lies nearest, with the share of tiles
    that had more overlapping faces than that (`overflow`).
Each chunk runs under `torch.utils.checkpoint`, so autograd keeps a
chunk's output and recomputes its (B, chunk, faces) distances in the
backward, never all chunks' at once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

# elements of one chunk's (B, pixels, faces) tensors in the tiled mode
_TILE_CHUNK_ELEMENTS = 1 << 25


def resolve_faces_per_tile(value, n_faces) -> int:
    """The `raster_faces_per_tile` config knob -> a tile budget. "auto" or
    None: 256 for coarse meshes (<= 2048 faces), 384 for finely tessellated
    ones, and 0 (the dense renderer) when that budget is not below the
    face count. An integer wins; 0 forces dense."""
    if value in (None, "auto"):
        budget = 256 if int(n_faces) <= 2048 else 384
        return 0 if budget >= int(n_faces) else budget
    return int(value)


def _signed_dist_sq(px, py, v):
    """Signed squared distance of pixels to triangles, negative inside.
    px, py (..., P, 1) pixel coordinates; v (..., 1, F, 3, 2) the
    triangles -> (..., P, F). Each edge's terms are written out in x and y
    (no size-2 dims), and p - a is shared by the edge function and the
    segment distance of the edge from a."""
    # per-face terms, each contiguous (..., 1, F): vertex a of edge e and
    # the edge vector ab, edges 01, 12, 20
    ax = [v[..., e, 0].contiguous() for e in range(3)]
    ay = [v[..., e, 1].contiguous() for e in range(3)]
    abx = [ax[(e + 1) % 3] - ax[e] for e in range(3)]
    aby = [ay[(e + 1) % 3] - ay[e] for e in range(3)]
    len2 = [abx[e] * abx[e] + aby[e] * aby[e] for e in range(3)]
    # the triangle's orientation; a zero-area one contains no pixel
    area = aby[0] * abx[2] - abx[0] * aby[2]
    s = torch.sign(area)
    inside, d2 = None, None
    for e in range(3):
        apx, apy = px - ax[e], py - ay[e]               # (..., P, F)
        ok = (abx[e] * apy - aby[e] * apx) * s >= 0
        inside = ok if inside is None else inside & ok
        t = torch.clamp((apx * abx[e] + apy * aby[e])
                        / torch.clamp(len2[e], min=1e-12), 0.0, 1.0)
        dx = apx - t * abx[e]
        dy = apy - t * aby[e]
        de = dx * dx + dy * dy
        d2 = de if d2 is None else torch.minimum(d2, de)
    # a triangle seen edge-on leaves all three edge functions ~0 along its
    # whole line, and f32 rounding can call far pixels inside: no interior
    # pixel is farther from the boundary than the longest edge
    emax2 = torch.maximum(torch.maximum(len2[0], len2[1]), len2[2])
    inside = inside & (area.abs() > 1e-9) & (d2 <= emax2)
    return torch.where(inside, -d2, d2)


def _coverage(tri, valid, pix, inv_sigma: float):
    """alpha of pixels pix (..., P, 2) against triangles tri (..., F, 3, 2)
    with mask valid (..., F) -> (..., P)."""
    sd2 = _signed_dist_sq(pix[..., :, 0:1], pix[..., :, 1:2],
                          tri[..., None, :, :, :])
    log_one_minus = -F.softplus(-sd2 * inv_sigma)
    log_one_minus = torch.where(valid[..., None, :], log_one_minus, 0.0)
    return 1.0 - torch.exp(log_one_minus.sum(-1))


def _chunked(fn, *args):
    """fn(*args), under activation checkpointing when autograd records."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _project(verts, faces, K):
    """Per-face screen triangles (B, F, 3, 2) and the in-front mask (B, F)."""
    if K.dim() == 2:
        K = K.expand(verts.shape[0], 3, 3)
    proj = torch.einsum("bij,bvj->bvi", K, verts)
    z = proj[..., 2]
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    uv = proj[..., :2] / safe_z[..., None]
    return uv[:, faces], (z[:, faces] > 1e-4).all(-1)


def _pixel_centres(h: int, w: int, device) -> torch.Tensor:
    """(h * w, 2) xy pixel centres, row-major."""
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1).reshape(-1, 2)


def rasterize_silhouette(verts: torch.Tensor, faces: torch.Tensor,
                         K: torch.Tensor, image_hw, sigma: float = 1.0,
                         pixel_chunk: int = 2048) -> torch.Tensor:
    """Dense soft silhouette. verts (B, V, 3) camera-frame vertices; faces
    (F, 3) int; K (B, 3, 3) or (3, 3); image_hw (H, W); sigma in pixel^2.
    Returns alpha (B, H, W) in [0, 1]."""
    H, W = image_hw
    faces = torch.as_tensor(faces, dtype=torch.int64, device=verts.device)
    tri_uv, valid = _project(verts, faces, K)
    pixels = _pixel_centres(H, W, verts.device)
    inv_sigma = 1.0 / sigma
    alpha = [_chunked(_coverage, tri_uv[:, None], valid[:, None],
                      pixels[None, c0:c0 + pixel_chunk], inv_sigma)[:, 0]
             for c0 in range(0, H * W, pixel_chunk)]
    return torch.cat(alpha, dim=1).reshape(-1, H, W)


def rasterize_silhouette_tiled(verts: torch.Tensor, faces: torch.Tensor,
                               K: torch.Tensor, image_hw, sigma: float = 1.0,
                               tile: int = 16, faces_per_tile: int = 192,
                               return_overflow: bool = False):
    """Tile-culled soft silhouette, the dense renderer's math on each
    `tile` x `tile` block against at most `faces_per_tile` faces: those
    whose screen bbox plus a halo of sqrt(37 sigma) + 1 pixels overlaps
    the tile (beyond it a face adds softplus(-37) < 1e-16 to the log-space
    sum), nearest bbox centre first. With return_overflow, also the share
    of tiles whose overlapping faces exceeded the budget (0: exact) as a
    device scalar."""
    H, W = image_hw
    B = verts.shape[0]
    faces = torch.as_tensor(faces, dtype=torch.int64, device=verts.device)
    Kf = min(faces_per_tile, faces.shape[0])
    tri_uv, valid = _project(verts, faces, K)
    th, tw = -(-H // tile), -(-W // tile)
    halo = math.sqrt(37.0 * sigma) + 1.0

    with torch.no_grad():
        box = tri_uv.detach()
        fmin = box.amin(2) - halo                        # (B, F, 2) xy
        fmax = box.amax(2) + halo
        torig = _pixel_centres(th, tw, verts.device) * tile - tile * 0.5
        lo, hi = torig[None, :, None], torig[None, :, None] + tile
        overlap = ((fmin[:, None] <= hi) & (fmax[:, None] >= lo)).all(-1) \
            & valid[:, None, :]                          # (B, T, F)
        d2c = ((0.5 * (fmin + fmax))[:, None]
               - (torig + tile * 0.5)[None, :, None]).pow(2).sum(-1)
        score = torch.where(overlap, -d2c, -torch.inf)
        idx = torch.topk(score, Kf, dim=2).indices      # (B, T, Kf)
        sel_valid = torch.gather(overlap, 2, idx)
        overflow = (overlap.sum(2) > Kf).float().mean()

    tri_sel = tri_uv[torch.arange(B, device=verts.device)[:, None, None],
                     idx]                                # (B, T, Kf, 3, 2)
    tp = tile * tile
    local = _pixel_centres(tile, tile, verts.device)
    pix_tiles = torig[:, None, :] + local[None]          # (T, tp, 2)
    T = pix_tiles.shape[0]
    step = max(1, _TILE_CHUNK_ELEMENTS // (B * tp * Kf))
    inv_sigma = 1.0 / sigma
    alpha = torch.cat([_chunked(_coverage, tri_sel[:, t0:t0 + step],
                                sel_valid[:, t0:t0 + step],
                                pix_tiles[None, t0:t0 + step], inv_sigma)
                       for t0 in range(0, T, step)], dim=1)    # (B, T, tp)
    img = alpha.reshape(B, th, tw, tile, tile).permute(0, 1, 3, 2, 4)
    out = img.reshape(B, th * tile, tw * tile)[:, :H, :W]
    return (out, overflow) if return_overflow else out


def render_robot_silhouette(robot, robot_mesh, cfg: torch.Tensor,
                            rot: torch.Tensor, trans: torch.Tensor,
                            K: torch.Tensor, image_hw, root: int = 0,
                            sigma: float = 1.0, detach_joints: bool = True,
                            faces_per_tile: int = 0,
                            return_overflow: bool = False):
    """Batched robot silhouette: (rot, trans) place keypoint-link `root` in
    the camera, FK poses the link meshes, and the joints are detached from
    the mask's gradient (unless detach_joints=False), so the mask loss
    drives only the root pose. faces_per_tile > 0 takes the tiled
    renderer; the dense one's overflow is 0."""
    from horopose_tpu_torch.ops.rotations import (invert_T, make_T,
                                                  rot_to_rotmat)
    link_poses = robot.plan.link_poses(cfg)             # (B, L, 4, 4)
    if detach_joints:
        link_poses = link_poses.detach()
    base2cam = make_T(rot_to_rotmat(rot), trans)         # (B, 4, 4)
    if root != 0:
        base2cam = base2cam @ invert_T(
            link_poses[:, robot._kp_link_idx[root]])
    world = torch.einsum("bij,bljk->blik", base2cam, link_poses)
    v_local, faces, vert_link = robot_mesh.tensors(cfg.device)
    posed = world[:, vert_link]                          # (B, V, 4, 4)
    v_cam = torch.einsum("bvij,vj->bvi", posed[..., :3, :3], v_local) \
        + posed[..., :3, 3]
    if faces_per_tile and faces_per_tile > 0:
        out = rasterize_silhouette_tiled(v_cam, faces, K, image_hw,
                                         sigma=sigma,
                                         faces_per_tile=faces_per_tile,
                                         return_overflow=True)
        return out if return_overflow else out[0]
    alpha = rasterize_silhouette(v_cam, faces, K, image_hw, sigma=sigma)
    return (alpha, alpha.new_zeros(())) if return_overflow else alpha
