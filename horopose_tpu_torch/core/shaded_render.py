"""Shaded (Lambertian) robot rendering for visualization.

Port of `horopose_tpu/core/shaded_render.py`, host-side numpy as there: a
z-buffer rasterizer with flat shading, textured where the mesh carries OBJ
UVs and map_Kd images. Visualization only (the differentiable silhouette is
`ops/rasterizer.py`); it draws the synthetic DREAM frames of
`tools/synth_dream.py` and the overlay of `core/vis.py::render_mesh`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_LINK_PALETTE = np.array([
    [230, 230, 230], [200, 120, 60], [120, 160, 220], [160, 220, 120],
    [220, 160, 200], [220, 220, 120], [120, 220, 220], [180, 180, 240],
    [240, 180, 140], [140, 240, 180], [200, 200, 160], [160, 200, 200],
    [240, 140, 180], [180, 140, 240], [210, 170, 130], [130, 210, 170],
    [170, 130, 210], [190, 190, 190], [150, 150, 220], [220, 150, 150],
], np.float32) / 255.0


def render_shaded(verts_cam: np.ndarray, faces: np.ndarray,
                  K: np.ndarray, image_hw: Tuple[int, int],
                  face_colors: Optional[np.ndarray] = None,
                  light_dir=(0.3, -0.5, -0.8), ambient: float = 0.35,
                  face_uv: Optional[np.ndarray] = None,
                  face_tex: Optional[np.ndarray] = None,
                  textures=()) -> Tuple[np.ndarray, np.ndarray]:
    """Flat-shaded z-buffer render, optionally textured.

    verts_cam (V, 3) camera-frame; faces (F, 3); K (3, 3).
    face_uv (F, 3, 2) OBJ uv per corner, face_tex (F,) index into
    `textures` (-1 = flat color), textures: float RGB arrays in [0, 1].
    Textured faces sample map_Kd with perspective-correct barycentric UVs
    modulated by the Lambertian term.
    Returns (rgb (H, W, 3) uint8, depth (H, W) float with inf background).
    """
    H, W = image_hw
    rgb = np.zeros((H, W, 3), np.float32)
    zbuf = np.full((H, W), np.inf, np.float32)
    light = np.asarray(light_dir, np.float32)
    light = light / np.linalg.norm(light)

    proj = (K @ verts_cam.T).T
    z = proj[:, 2]
    uv = proj[:, :2] / np.maximum(z[:, None], 1e-6)

    tri_uv = uv[faces]                     # (F, 3, 2)
    tri_z = z[faces]                       # (F, 3)
    tri_v = verts_cam[faces]               # (F, 3, 3)
    normals = np.cross(tri_v[:, 1] - tri_v[:, 0], tri_v[:, 2] - tri_v[:, 0])
    nlen = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals / np.maximum(nlen, 1e-12)
    shade = ambient + (1 - ambient) * np.abs(normals @ light)

    if face_colors is None:
        face_colors = np.full((len(faces), 3), 0.8, np.float32)

    # painter-free: per-face barycentric fill with z test
    order = np.argsort(tri_z.mean(axis=1))[::-1]  # far-to-near helps locality
    for fi in order:
        if np.any(tri_z[fi] <= 1e-4):
            continue
        p = tri_uv[fi]
        xmin = max(int(np.floor(p[:, 0].min())), 0)
        xmax = min(int(np.ceil(p[:, 0].max())) + 1, W)
        ymin = max(int(np.floor(p[:, 1].min())), 0)
        ymax = min(int(np.ceil(p[:, 1].max())) + 1, H)
        if xmin >= xmax or ymin >= ymax:
            continue
        xs = np.arange(xmin, xmax) + 0.5
        ys = np.arange(ymin, ymax) + 0.5
        gx, gy = np.meshgrid(xs, ys)
        d = (p[1, 0] - p[0, 0]) * (p[2, 1] - p[0, 1]) - \
            (p[2, 0] - p[0, 0]) * (p[1, 1] - p[0, 1])
        if abs(d) < 1e-9:
            continue
        w1 = ((gx - p[0, 0]) * (p[2, 1] - p[0, 1]) -
              (p[2, 0] - p[0, 0]) * (gy - p[0, 1])) / d
        w2 = ((p[1, 0] - p[0, 0]) * (gy - p[0, 1]) -
              (gx - p[0, 0]) * (p[1, 1] - p[0, 1])) / d
        w0 = 1.0 - w1 - w2
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        if not inside.any():
            continue
        # perspective-correct-ish depth via barycentric on 1/z
        invz = w0 / tri_z[fi, 0] + w1 / tri_z[fi, 1] + w2 / tri_z[fi, 2]
        depth = 1.0 / np.maximum(invz, 1e-9)
        tile_z = zbuf[ymin:ymax, xmin:xmax]
        upd = inside & (depth < tile_z)
        tile_z[upd] = depth[upd]
        ti = int(face_tex[fi]) if face_tex is not None else -1
        if ti >= 0 and ti < len(textures) and face_uv is not None:
            # perspective-correct uv: interpolate uv/z, divide by 1/z
            uvz = face_uv[fi] / tri_z[fi][:, None]        # (3, 2)
            u = (w0 * uvz[0, 0] + w1 * uvz[1, 0] + w2 * uvz[2, 0]) * depth
            v = (w0 * uvz[0, 1] + w1 * uvz[1, 1] + w2 * uvz[2, 1]) * depth
            tex = textures[ti]
            th, tw = tex.shape[:2]
            # OBJ v runs bottom-up; wrap coordinates
            px = np.clip((np.mod(u, 1.0) * tw).astype(np.int32), 0, tw - 1)
            py = np.clip(((1.0 - np.mod(v, 1.0)) * th).astype(np.int32),
                         0, th - 1)
            color = tex[py[upd], px[upd]]
            rgb[ymin:ymax, xmin:xmax][upd] = color * shade[fi]
        else:
            rgb[ymin:ymax, xmin:xmax][upd] = face_colors[fi] * shade[fi]

    return (np.clip(rgb * 255, 0, 255)).astype(np.uint8), zbuf


def render_robot_shaded(robot, robot_mesh, cfg, rot, trans, K, image_hw,
                        root: int = 0,
                        original_image: Optional[np.ndarray] = None,
                        blend: float = 0.7):
    """Shaded render of one posed robot, optionally blended over the
    original image.

    robot: the port's `Robot`; robot_mesh: `kinematics.meshes.RobotMesh`
    over its FK plan's links; cfg (DoF,), rot (6,) or (4,), trans (3,): one
    sample, numpy arrays or tensors, (rot, trans) placing keypoint-link
    `root` in the camera. Returns (rendered (H, W, 3) uint8, blended or
    None)."""
    from horopose_tpu_torch.ops.rotations import (invert_T, make_T,
                                                  rot_to_rotmat)

    def one(x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=robot.device)[None]

    with torch.no_grad():
        link_poses = robot.plan.link_poses(one(cfg))
        base2cam = make_T(rot_to_rotmat(one(rot)), one(trans))
        if root != 0:
            base2cam = base2cam @ invert_T(
                link_poses[:, robot._kp_link_idx[root]])
        world = (base2cam[:, None] @ link_poses)[0].cpu().numpy()
    vl = robot_mesh.vert_link
    R = world[vl, :3, :3]
    t = world[vl, :3, 3]
    v_cam = np.einsum("vij,vj->vi", R, robot_mesh.verts) + t

    face_link = robot_mesh.vert_link[robot_mesh.faces[:, 0]]
    colors = _LINK_PALETTE[face_link % len(_LINK_PALETTE)]
    if robot_mesh.face_kd is not None:
        # material diffuse (MTL Kd / URDF <material> rgba) where declared,
        # link palette elsewhere
        kd = np.asarray(robot_mesh.face_kd, np.float32)
        has = ~np.isnan(kd).any(axis=1)
        colors = np.where(has[:, None], np.nan_to_num(kd), colors)
    rendered, _ = render_shaded(v_cam, robot_mesh.faces, np.asarray(K),
                                image_hw, face_colors=colors,
                                face_uv=robot_mesh.face_uv,
                                face_tex=robot_mesh.face_tex,
                                textures=robot_mesh.textures)
    blended = None
    if original_image is not None:
        bg = np.asarray(original_image, np.float32)
        mask = rendered.any(axis=-1, keepdims=True)
        blended = np.where(mask,
                           (1 - blend) * bg + blend * rendered,
                           bg).astype(np.uint8)
    return rendered, blended
