"""Triangle meshes for the silhouette render: OBJ loading and URDF
primitive meshing.

Port of the geometry of `horopose_tpu/kinematics/meshes.py`: a
dependency-free OBJ reader (vertices and fan-triangulated faces), box,
cylinder and sphere meshes so the built-in URDF descriptions render
without mesh files, and `RobotMesh`, every link's vertices concatenated
with static face indices and a vertex -> link map, so posing the whole
robot is one gather and one batched transform
(`ops/rasterizer.py::render_robot_silhouette`).

The appearance (OBJ materials, UVs, textures) serves only the shaded
render, which is not ported yet (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from horopose_tpu_torch.kinematics.urdf import Geometry, URDFModel


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader -> (verts (V, 3) float32, faces (F, 3) int32);
    polygons are fan-triangulated."""
    verts: List[List[float]] = []
    faces: List[List[int]] = []
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("f "):
                vi = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for i in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[i], vi[i + 1]])
    return (np.asarray(verts, np.float32),
            np.asarray(faces, np.int32).reshape(-1, 3))


def box_mesh(size) -> Tuple[np.ndarray, np.ndarray]:
    sx, sy, sz = [s / 2 for s in size]
    v = np.array([[x, y, z] for x in (-sx, sx) for y in (-sy, sy)
                  for z in (-sz, sz)], np.float32)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return v, f


def cylinder_mesh(radius: float, length: float,
                  n: int = 16) -> Tuple[np.ndarray, np.ndarray]:
    """Cylinder along +z, centred at the origin (the URDF convention)."""
    ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
    circle = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    bot = np.concatenate([circle, np.full((n, 1), -length / 2)], axis=1)
    top = np.concatenate([circle, np.full((n, 1), length / 2)], axis=1)
    centers = np.array([[0, 0, -length / 2], [0, 0, length / 2]], np.float32)
    v = np.concatenate([bot, top, centers]).astype(np.float32)
    faces = []
    cb, ct = 2 * n, 2 * n + 1
    for i in range(n):
        j = (i + 1) % n
        faces += [[i, j, n + i], [j, n + j, n + i]]          # side
        faces += [[cb, j, i], [ct, n + i, n + j]]            # caps
    return v, np.asarray(faces, np.int32)


def sphere_mesh(radius: float, n: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    us = np.linspace(0, np.pi, n)
    vs = np.linspace(0, 2 * np.pi, n, endpoint=False)
    verts = [[radius * np.sin(u) * np.cos(v_), radius * np.sin(u) * np.sin(v_),
              radius * np.cos(u)] for u in us for v_ in vs]
    faces = []
    for i in range(n - 1):
        for j in range(n):
            a = i * n + j
            b = i * n + (j + 1) % n
            c = (i + 1) * n + j
            d = (i + 1) * n + (j + 1) % n
            faces += [[a, b, c], [b, d, c]]
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def geometry_mesh(g: Geometry) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(verts, faces) of one URDF geometry element in its LINK frame, or
    None for a mesh file that is missing or not OBJ."""
    if g.mesh_path is not None:
        if (not os.path.exists(g.mesh_path)
                or os.path.splitext(g.mesh_path)[1].lower() != ".obj"):
            return None
        v, f = load_obj(g.mesh_path)
        v = v * np.asarray(g.mesh_scale, np.float32)
    elif g.box_size is not None:
        v, f = box_mesh(g.box_size)
    elif g.cylinder is not None:
        v, f = cylinder_mesh(*g.cylinder)
    elif g.sphere_radius is not None:
        v, f = sphere_mesh(g.sphere_radius)
    else:
        return None
    R = g.origin[:3, :3].astype(np.float32)
    t = g.origin[:3, 3].astype(np.float32)
    return v @ R.T + t, f


@dataclass
class RobotMesh:
    """Whole-robot mesh, all link geometries concatenated.

    verts (V, 3) in each vertex's LINK frame; faces (F, 3) into verts;
    vert_link (V,) index into the FK plan's link names. Provenance for
    `check_mesh_fidelity`: geometries from mesh files and from URDF
    primitives, and the declared mesh files that could not be loaded."""
    verts: np.ndarray
    faces: np.ndarray
    vert_link: np.ndarray
    n_file_geoms: int = 0
    n_primitive_geoms: int = 0
    missing_meshes: Tuple[str, ...] = ()
    unsupported_meshes: Tuple[str, ...] = ()
    _on_device: Dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def num_faces(self) -> int:
        return len(self.faces)

    def tensors(self, device) -> Tuple[torch.Tensor, ...]:
        """(verts float32, faces int64, vert_link int64) on `device`,
        copied once per device."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = (
                torch.as_tensor(self.verts, device=device),
                torch.as_tensor(self.faces, dtype=torch.int64, device=device),
                torch.as_tensor(self.vert_link, dtype=torch.int64,
                                device=device))
        return self._on_device[device]


def build_robot_mesh(model: URDFModel, link_index: Dict[str, int],
                     which: str = "visual",
                     with_appearance: bool = False) -> RobotMesh:
    """The mesh of every link in `link_index` ({link name: FK plan index})
    from its visual (or collision) geometries."""
    if with_appearance:
        raise NotImplementedError(
            "with_appearance: the materials and textures serve the shaded "
            "render, not ported yet (ROADMAP queue 1 item 8)")
    all_v, all_f, all_l = [], [], []
    offset = 0
    n_file = n_prim = 0
    missing: List[str] = []
    unsupported: List[str] = []
    for name, link in model.links.items():
        if name not in link_index:
            continue
        for g in (link.visuals if which == "visual" else link.collisions):
            if g.mesh_path is not None:
                if not os.path.exists(g.mesh_path):
                    missing.append(g.mesh_path)
                elif os.path.splitext(g.mesh_path)[1].lower() != ".obj":
                    unsupported.append(g.mesh_path)
            vf = geometry_mesh(g)
            if vf is None:
                continue
            if g.mesh_path is not None:
                n_file += 1
            else:
                n_prim += 1
            v, f = vf
            all_v.append(v)
            all_f.append(f + offset)
            all_l.append(np.full(len(v), link_index[name], np.int32))
            offset += len(v)
    if not all_v:
        raise ValueError("robot has no renderable geometry")
    return RobotMesh(verts=np.concatenate(all_v), faces=np.concatenate(all_f),
                     vert_link=np.concatenate(all_l), n_file_geoms=n_file,
                     n_primitive_geoms=n_prim, missing_meshes=tuple(missing),
                     unsupported_meshes=tuple(unsupported))


def check_mesh_fidelity(robot_mesh: RobotMesh, context: str = "render"):
    """Raise when the URDF's declared link meshes could not be loaded:
    primitives in their place would corrupt the silhouette. A
    primitive-only URDF (the built-in descriptions) renders with a
    warning."""
    problems = []
    if robot_mesh.missing_meshes:
        problems.append("missing mesh files: " +
                        ", ".join(robot_mesh.missing_meshes))
    if robot_mesh.unsupported_meshes:
        problems.append("unsupported (non-OBJ) mesh files: " +
                        ", ".join(robot_mesh.unsupported_meshes) +
                        " — convert to .obj")
    if problems:
        raise RuntimeError(
            f"[{context}] URDF declares link meshes that cannot be "
            f"rasterized: {'; '.join(problems)}")
    if robot_mesh.n_file_geoms == 0:
        print(f"[{context}] WARNING: rendering URDF primitive geometry "
              f"({robot_mesh.n_primitive_geoms} shapes) — for mesh-accurate "
              "silhouettes drop the official robot description (with .obj "
              "meshes) under data/deps/")
