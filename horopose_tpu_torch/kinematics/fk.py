"""Batched forward kinematics from a static plan.

The URDF is compiled once into topologically sorted joint arrays, held as
tensors on the plan's device. Executing FK is then a fixed chain of batched
4x4 products, one per joint.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from horopose_tpu_torch.kinematics.urdf import URDFModel

_FIXED, _REVOLUTE, _PRISMATIC = 0, 1, 2


class KinematicPlan:
    """Static FK plan for one robot.

    link_names: FK returns poses in this order; entry 0 is the root link
    (identity pose). dof: number of actuated DoF.
    """

    def __init__(self, model: URDFModel,
                 actuated_joint_names: Optional[Sequence[str]] = None,
                 device="cuda"):
        self.device = torch.device(device)
        joints = model.topological_joints()
        if actuated_joint_names is None:
            actuated_joint_names = [j.name for j in joints if j.is_actuated]
        self.actuated_joint_names = list(actuated_joint_names)
        self.dof = len(self.actuated_joint_names)
        qidx = {name: i for i, name in enumerate(self.actuated_joint_names)}

        self.link_names: List[str] = [model.root_link]
        link_index = {model.root_link: 0}

        origins, axes, types = [], [], []
        parent_idx, sel_rows, offsets = [], [], []
        for j in joints:
            link_index[j.child] = len(self.link_names)
            self.link_names.append(j.child)
            origins.append(j.origin)
            axes.append(j.axis)
            parent_idx.append(link_index[j.parent])
            row = np.zeros(self.dof, dtype=np.float64)
            off = 0.0
            if j.jtype in ("revolute", "continuous", "prismatic"):
                types.append(_PRISMATIC if j.jtype == "prismatic"
                             else _REVOLUTE)
                if j.mimic_joint is not None:
                    src = model.joints[j.mimic_joint]
                    if src.name in qidx:
                        row[qidx[src.name]] = j.mimic_multiplier
                        off = j.mimic_offset
                elif j.name in qidx:
                    row[qidx[j.name]] = 1.0
                # actuated-but-unlisted joints stay at q=0 (row of zeros)
            else:
                types.append(_FIXED)
            sel_rows.append(row)
            offsets.append(off)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)

        self.n_joints = len(joints)
        self._origins = dev(np.stack(origins))                   # (J, 4, 4)
        self._axes = dev(np.stack(axes))                         # (J, 3)
        types = np.asarray(types, np.int32)
        self._is_rev = dev(types == _REVOLUTE)                   # (J,)
        self._is_prs = dev(types == _PRISMATIC)                  # (J,)
        self._parent = [int(p) for p in parent_idx]
        self._sel = dev(np.stack(sel_rows))                      # (J, DoF)
        self._offset = dev(offsets)                              # (J,)

    def _motions(self, q: torch.Tensor) -> torch.Tensor:
        """Per-joint motion transforms. q (B, J) -> (B, J, 4, 4)."""
        B, J = q.shape
        ax, ay, az = self._axes[:, 0], self._axes[:, 1], self._axes[:, 2]
        c = torch.cos(q)
        s = torch.sin(q)
        one_c = 1.0 - c
        # Rodrigues for a unit axis, broadcast over the batch
        r = torch.stack([
            torch.stack([c + ax * ax * one_c, ax * ay * one_c - az * s,
                         ay * s + ax * az * one_c], -1),
            torch.stack([az * s + ax * ay * one_c, c + ay * ay * one_c,
                         -ax * s + ay * az * one_c], -1),
            torch.stack([-ay * s + ax * az * one_c, ax * s + ay * az * one_c,
                         c + az * az * one_c], -1),
        ], dim=-2)                                               # (B, J, 3, 3)
        is_rev = self._is_rev[None, :, None, None]
        eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
        rot = r * is_rev + eye3 * (1.0 - is_rev)
        trans = (self._axes[None] * q[..., None]) * self._is_prs[None, :, None]
        top = torch.cat([rot, trans[..., None]], dim=-1)         # (B, J, 3, 4)
        bottom = torch.zeros(B, J, 1, 4, dtype=q.dtype, device=q.device)
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    def link_poses(self, cfg: torch.Tensor) -> torch.Tensor:
        """FK. cfg (..., DoF) -> link poses (..., L, 4, 4) in link_names order."""
        batch_shape = cfg.shape[:-1]
        cfg2 = cfg.reshape(-1, self.dof).float()
        B = cfg2.shape[0]
        q = cfg2 @ self._sel.T + self._offset[None]              # (B, J)
        motions = self._motions(q)                               # (B, J, 4, 4)
        # local transform parent->child: origin_j @ motion_j
        local = torch.einsum("jab,Bjbc->Bjac", self._origins, motions)
        poses = [torch.eye(4, dtype=torch.float32,
                           device=cfg.device).expand(B, 4, 4)]
        for jidx in range(self.n_joints):
            poses.append(poses[self._parent[jidx]] @ local[:, jidx])
        out = torch.stack(poses, dim=1)                          # (B, L, 4, 4)
        return out.reshape(*batch_shape, len(self.link_names), 4, 4)
