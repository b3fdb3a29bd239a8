"""Minimal URDF parser (pure Python, stdlib XML, runs once per robot).

A copy of `horopose_tpu/kinematics/urdf.py`: the kinematic tree (links,
joints, origins, axes, types, limits, mimics) and the visual/collision
geometry references. Parsing gives a static description; `fk.py` compiles
it once into a plan of batched 4x4 products.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple
from xml.etree import ElementTree

import numpy as np


def _rpy_to_matrix(rpy) -> np.ndarray:
    """URDF rpy (fixed-axis XYZ) -> 3x3 rotation: R = Rz(y) @ Ry(p) @ Rx(r)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ], dtype=np.float64)


def _parse_origin(node) -> np.ndarray:
    """<origin xyz rpy> -> homogeneous 4x4 (identity if absent)."""
    T = np.eye(4, dtype=np.float64)
    if node is None:
        return T
    origin = node.find("origin")
    if origin is None:
        return T
    xyz = [float(v) for v in origin.get("xyz", "0 0 0").split()]
    rpy = [float(v) for v in origin.get("rpy", "0 0 0").split()]
    T[:3, :3] = _rpy_to_matrix(rpy)
    T[:3, 3] = xyz
    return T


@dataclass
class Geometry:
    """One visual/collision geometry element attached to a link."""
    origin: np.ndarray                 # 4x4 offset in the link frame
    mesh_path: Optional[str] = None    # resolved absolute path, if a mesh
    mesh_scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    box_size: Optional[Tuple[float, float, float]] = None
    cylinder: Optional[Tuple[float, float]] = None  # (radius, length)
    sphere_radius: Optional[float] = None
    rgba: Optional[Tuple[float, float, float, float]] = None  # <material>


@dataclass
class Link:
    name: str
    visuals: List[Geometry] = field(default_factory=list)
    collisions: List[Geometry] = field(default_factory=list)


@dataclass
class Joint:
    name: str
    jtype: str                      # revolute/continuous/prismatic/fixed/floating/planar
    parent: str
    child: str
    origin: np.ndarray              # 4x4 static transform parent->joint frame
    axis: np.ndarray                # (3,) unit axis in joint frame
    limit_lower: float = 0.0
    limit_upper: float = 0.0
    mimic_joint: Optional[str] = None
    mimic_multiplier: float = 1.0
    mimic_offset: float = 0.0

    @property
    def is_actuated(self) -> bool:
        return self.jtype in ("revolute", "continuous", "prismatic") \
            and self.mimic_joint is None


@dataclass
class URDFModel:
    name: str
    links: Dict[str, Link]
    joints: Dict[str, Joint]
    root_link: str
    base_dir: str = ""

    @property
    def actuated_joint_names(self) -> List[str]:
        return [j.name for j in self.joints.values() if j.is_actuated]

    def children_of(self, link_name: str) -> List[Joint]:
        return [j for j in self.joints.values() if j.parent == link_name]

    def topological_joints(self) -> List[Joint]:
        """Joints ordered so every parent link is produced before its children."""
        out: List[Joint] = []
        stack = [self.root_link]
        while stack:
            link = stack.pop(0)
            for j in self.children_of(link):
                out.append(j)
                stack.append(j.child)
        return out


def _resolve_mesh_path(filename: str, base_dir: str) -> str:
    """Resolve package:// and relative mesh URIs against the URDF location."""
    if filename.startswith("package://"):
        rel = filename[len("package://"):]
        # package root heuristic: strip the package name if the remainder
        # exists relative to base_dir, else keep full relative path.
        parts = rel.split("/", 1)
        if len(parts) == 2 and os.path.exists(os.path.join(base_dir, parts[1])):
            return os.path.join(base_dir, parts[1])
        return os.path.join(base_dir, rel)
    if os.path.isabs(filename):
        return filename
    return os.path.join(base_dir, filename)


def _parse_geometry(node, base_dir: str) -> Optional[Geometry]:
    geom_node = node.find("geometry")
    if geom_node is None:
        return None
    g = Geometry(origin=_parse_origin(node))
    mat = node.find("material")
    if mat is not None:
        color = mat.find("color")
        if color is not None and color.get("rgba"):
            vals = tuple(float(v) for v in color.get("rgba").split())
            if len(vals) == 4:
                g.rgba = vals
    mesh = geom_node.find("mesh")
    if mesh is not None:
        g.mesh_path = _resolve_mesh_path(mesh.get("filename", ""), base_dir)
        scale = mesh.get("scale")
        if scale:
            g.mesh_scale = tuple(float(v) for v in scale.split())
        return g
    box = geom_node.find("box")
    if box is not None:
        g.box_size = tuple(float(v) for v in box.get("size", "1 1 1").split())
        return g
    cyl = geom_node.find("cylinder")
    if cyl is not None:
        g.cylinder = (float(cyl.get("radius", 1.0)), float(cyl.get("length", 1.0)))
        return g
    sph = geom_node.find("sphere")
    if sph is not None:
        g.sphere_radius = float(sph.get("radius", 1.0))
        return g
    return None


def parse_urdf(path_or_string: str, base_dir: Optional[str] = None) -> URDFModel:
    """Parse a URDF file (or an XML string) into a URDFModel."""
    if os.path.exists(path_or_string):
        tree = ElementTree.parse(path_or_string)
        root = tree.getroot()
        base_dir = base_dir or os.path.dirname(os.path.abspath(path_or_string))
    else:
        root = ElementTree.fromstring(path_or_string)
        base_dir = base_dir or ""
    assert root.tag == "robot", f"not a URDF: root tag {root.tag}"

    links: Dict[str, Link] = {}
    for lnode in root.findall("link"):
        link = Link(name=lnode.get("name"))
        for vnode in lnode.findall("visual"):
            g = _parse_geometry(vnode, base_dir)
            if g is not None:
                link.visuals.append(g)
        for cnode in lnode.findall("collision"):
            g = _parse_geometry(cnode, base_dir)
            if g is not None:
                link.collisions.append(g)
        links[link.name] = link

    joints: Dict[str, Joint] = {}
    for jnode in root.findall("joint"):
        axis_node = jnode.find("axis")
        axis = np.array([1.0, 0.0, 0.0]) if axis_node is None else \
            np.array([float(v) for v in axis_node.get("xyz", "1 0 0").split()])
        norm = np.linalg.norm(axis)
        if norm > 0:
            axis = axis / norm
        limit_node = jnode.find("limit")
        lo = float(limit_node.get("lower", 0.0)) if limit_node is not None else 0.0
        hi = float(limit_node.get("upper", 0.0)) if limit_node is not None else 0.0
        mimic_node = jnode.find("mimic")
        joint = Joint(
            name=jnode.get("name"),
            jtype=jnode.get("type", "fixed"),
            parent=jnode.find("parent").get("link"),
            child=jnode.find("child").get("link"),
            origin=_parse_origin(jnode),
            axis=axis,
            limit_lower=lo,
            limit_upper=hi,
            mimic_joint=mimic_node.get("joint") if mimic_node is not None else None,
            mimic_multiplier=float(mimic_node.get("multiplier", 1.0))
            if mimic_node is not None else 1.0,
            mimic_offset=float(mimic_node.get("offset", 0.0))
            if mimic_node is not None else 0.0,
        )
        joints[joint.name] = joint

    children = {j.child for j in joints.values()}
    roots = [name for name in links if name not in children]
    assert len(roots) >= 1, "URDF has no root link"
    return URDFModel(name=root.get("name", "robot"), links=links,
                     joints=joints, root_link=roots[0], base_dir=base_dir)
