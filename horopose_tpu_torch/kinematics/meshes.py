"""Triangle meshes for rendering: OBJ loading and URDF primitive meshing.

Port of `horopose_tpu/kinematics/meshes.py`: a dependency-free OBJ reader
(vertices, fan-triangulated faces, and with `load_obj_textured` the UVs
and MTL materials), box, cylinder and sphere meshes so the built-in URDF
descriptions render without mesh files, and `RobotMesh`, every link's
vertices concatenated with static face indices and a vertex -> link map,
so posing the whole robot is one gather and one batched transform
(`ops/rasterizer.py::render_robot_silhouette`). Built with
`with_appearance=True` it also carries per-face UVs, diffuse colours (MTL
Kd, else the URDF <material> colour) and decoded map_Kd textures, which
the shaded render (`core/shaded_render.py`) draws.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from horopose_tpu_torch.kinematics.urdf import Geometry, URDFModel


def _load_mtl(path: str) -> Dict[str, Dict]:
    """Tiny MTL reader: {material name: {"kd": (3,) f32|None,
    "map_kd": abs path|None}}."""
    mats: Dict[str, Dict] = {}
    cur = None
    try:
        with open(path, "r", errors="ignore") as f:
            for line in f:
                tok = line.split()
                if not tok:
                    continue
                if tok[0] == "newmtl" and len(tok) > 1:
                    cur = {"kd": None, "map_kd": None}
                    mats[tok[1]] = cur
                elif cur is not None and tok[0] == "Kd" and len(tok) >= 4:
                    cur["kd"] = np.asarray([float(v) for v in tok[1:4]],
                                           np.float32)
                elif cur is not None and tok[0] == "map_Kd" and len(tok) > 1:
                    cur["map_kd"] = os.path.join(os.path.dirname(path),
                                                 tok[-1])
    except OSError:
        pass
    return mats


def load_obj_textured(path: str):
    """OBJ reader with UV and material support (the shaded render).

    Returns (verts (V,3) f32, faces (F,3) i32, face_uv (F,3,2) f32 or
    None, face_mat (F,) i32 into materials, materials list of
    {"kd", "map_kd"}). Faces without vt indices get uv (0,0) and
    face_mat -1.
    """
    verts: List[List[float]] = []
    uvs: List[List[float]] = []
    faces: List[List[int]] = []
    face_uv_idx: List[List[int]] = []
    face_mat: List[int] = []
    materials: List[Dict] = []
    mat_index: Dict[str, int] = {}
    cur_mat = -1
    base = os.path.dirname(path)
    with open(path, "r", errors="ignore") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("mtllib "):
                for name, m in _load_mtl(
                        os.path.join(base, line.split(None, 1)[1].strip())
                ).items():
                    if name not in mat_index:
                        mat_index[name] = len(materials)
                        materials.append(m)
            elif line.startswith("usemtl "):
                cur_mat = mat_index.get(line.split(None, 1)[1].strip(), -1)
            elif line.startswith("f "):
                toks = line.split()[1:]
                vi, ti = [], []
                for tok in toks:
                    comp = tok.split("/")
                    vi.append(int(comp[0]) - 1)
                    ti.append(int(comp[1]) - 1
                              if len(comp) > 1 and comp[1] else -1)
                for i in range(1, len(vi) - 1):  # fan-triangulate
                    faces.append([vi[0], vi[i], vi[i + 1]])
                    face_uv_idx.append([ti[0], ti[i], ti[i + 1]])
                    face_mat.append(cur_mat)
    verts_np = np.asarray(verts, np.float32)
    faces_np = np.asarray(faces, np.int32).reshape(-1, 3)
    face_uv = None
    if uvs and any(t >= 0 for tri in face_uv_idx for t in tri):
        uv_np = np.concatenate([np.asarray(uvs, np.float32),
                                np.zeros((1, 2), np.float32)])  # -1 -> (0,0)
        face_uv = uv_np[np.asarray(face_uv_idx, np.int32)]
    return (verts_np, faces_np, face_uv,
            np.asarray(face_mat, np.int32).reshape(-1), materials)


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader -> (verts (V,3) f32, faces (F,3) i32)."""
    v, f, _, _, _ = load_obj_textured(path)
    return v, f


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


def _load_texture(path: str) -> Optional[np.ndarray]:
    try:
        from PIL import Image
        return np.asarray(Image.open(path).convert("RGB"),
                          np.float32) / 255.0
    except OSError:
        return None


def geometry_mesh(g: Geometry, with_appearance: bool = False):
    """Mesh for one URDF geometry element, in the LINK frame.

    Returns (verts, faces) — or, with_appearance=True,
    (verts, faces, face_uv|None, face_kd (F,3) NaN=unset,
    face_texpath (F,) list of str|None) carrying OBJ material / URDF
    <material> color data for the textured visualizer."""
    face_uv = None
    face_kd = None
    face_texpath: List[Optional[str]] = []
    if g.mesh_path is not None:
        if not os.path.exists(g.mesh_path):
            return None
        ext = os.path.splitext(g.mesh_path)[1].lower()
        if ext != ".obj":
            return None  # stl/dae need richer loaders; fall back to nothing
        v, f, face_uv, face_mat, materials = load_obj_textured(g.mesh_path)
        v = v * np.asarray(g.mesh_scale, np.float32)
        if with_appearance:
            face_kd = np.full((len(f), 3), np.nan, np.float32)
            for fi, mi in enumerate(face_mat):
                kd = materials[mi]["kd"] if mi >= 0 else None
                if kd is not None:
                    face_kd[fi] = kd
                face_texpath.append(materials[mi]["map_kd"]
                                    if mi >= 0 else None)
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
    v = v @ R.T + t
    if not with_appearance:
        return v, f
    if face_kd is None:
        face_kd = np.full((len(f), 3), np.nan, np.float32)
    if g.rgba is not None:  # URDF <visual><material><color rgba> fallback
        nanrows = np.isnan(face_kd).any(axis=1)
        face_kd[nanrows] = np.asarray(g.rgba[:3], np.float32)
    if not face_texpath:
        face_texpath = [None] * len(f)
    return v, f, face_uv, face_kd, face_texpath


@dataclass
class RobotMesh:
    """Whole-robot mesh, all link geometries concatenated.

    verts (V, 3) in each vertex's LINK frame; faces (F, 3) into verts;
    vert_link (V,) index into the FK plan's link names. Provenance for
    `check_mesh_fidelity`: geometries from mesh files and from URDF
    primitives, and the declared mesh files that could not be loaded.
    Appearance (None without `with_appearance`): face_uv (F, 3, 2),
    face_kd (F, 3) with NaN where unset, face_tex (F,) into `textures`
    (-1: untextured), textures the decoded RGB images in [0, 1]."""
    verts: np.ndarray
    faces: np.ndarray
    vert_link: np.ndarray
    n_file_geoms: int = 0
    n_primitive_geoms: int = 0
    missing_meshes: Tuple[str, ...] = ()
    unsupported_meshes: Tuple[str, ...] = ()
    face_uv: Optional[np.ndarray] = None
    face_kd: Optional[np.ndarray] = None
    face_tex: Optional[np.ndarray] = None
    textures: Tuple[np.ndarray, ...] = ()
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
    from its visual (or collision) geometries, with their materials and
    textures when `with_appearance`."""
    all_v, all_f, all_l = [], [], []
    all_uv, all_kd, all_tex = [], [], []
    textures: List[np.ndarray] = []
    tex_index: Dict[str, int] = {}
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
            vf = geometry_mesh(g, with_appearance=with_appearance)
            if vf is None:
                continue
            if g.mesh_path is not None:
                n_file += 1
            else:
                n_prim += 1
            if with_appearance:
                v, f, uv, kd, texpaths = vf
                all_uv.append(uv if uv is not None
                              else np.zeros((len(f), 3, 2), np.float32))
                all_kd.append(kd)
                tex_ids = np.full(len(f), -1, np.int32)
                for fi, tp in enumerate(texpaths):
                    if tp is None:
                        continue
                    if tp not in tex_index:
                        img = _load_texture(tp)
                        tex_index[tp] = -1 if img is None else len(textures)
                        if img is not None:
                            textures.append(img)
                    tex_ids[fi] = tex_index[tp]
                all_tex.append(tex_ids)
            else:
                v, f = vf
            all_v.append(v)
            all_f.append(f + offset)
            all_l.append(np.full(len(v), link_index[name], np.int32))
            offset += len(v)
    if not all_v:
        raise ValueError("robot has no renderable geometry")
    appearance = {}
    if with_appearance:
        appearance = dict(face_uv=np.concatenate(all_uv),
                          face_kd=np.concatenate(all_kd),
                          face_tex=np.concatenate(all_tex),
                          textures=tuple(textures))
    return RobotMesh(verts=np.concatenate(all_v), faces=np.concatenate(all_f),
                     vert_link=np.concatenate(all_l), n_file_geoms=n_file,
                     n_primitive_geoms=n_prim, missing_meshes=tuple(missing),
                     unsupported_meshes=tuple(unsupported), **appearance)


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
