"""Write DREAM-format datasets (jpg + per-image json + camera json).

Port of `horopose_tpu/tools/synth_dream.py` for its random-noise images
(`render_images=False`). The on-disk schema is what `data/dream.py`
reads: `objects[0]` carries `quaternion_xyzw` / `location` / `keypoints` /
`bounding_box`, `sim_state.joints` the DoF values, and
`_camera_settings.json` the intrinsics. A random base pose is encoded as
quaternion_xyzw exactly the way the reader decodes it, and the 3D
keypoints come from the port's FK of the built-in robot description, so
FK(gt_joints) placed at TCO reproduces the annotations. The draws from the
seed are the JAX writer's, so both write the same jpgs and the same
annotations up to float32 FK rounding.

The rendered images (`render_images=True`) need the shaded renderer
(`core/shaded_render.py`), which is not ported yet.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from horopose_tpu_torch import constants as C


def _axis_angle(axis, theta):
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _rotmat_to_quat_xyzw(M):
    """Standard rotation-matrix -> quaternion, xyzw order: the exact
    inverse of the reader's decode chain (_quat_xyzw_to_rotmat)."""
    w = np.sqrt(max(1.0 + M[0, 0] + M[1, 1] + M[2, 2], 0.0)) / 2.0
    if w > 1e-6:
        x = (M[2, 1] - M[1, 2]) / (4 * w)
        y = (M[0, 2] - M[2, 0]) / (4 * w)
        z = (M[1, 0] - M[0, 1]) / (4 * w)
    else:  # w ~ 0: pick the dominant diagonal term
        i = int(np.argmax([M[0, 0], M[1, 1], M[2, 2]]))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1.0 + M[i, i] - M[j, j] - M[k, k], 1e-12)) * 2
        v = np.zeros(3)
        v[i] = s / 4
        v[j] = (M[j, i] + M[i, j]) / s
        v[k] = (M[k, i] + M[i, k]) / s
        w = (M[k, j] - M[j, k]) / s
        x, y, z = v
    return np.array([x, y, z, w])


# canonical "upright robot seen from the front" base->camera rotation:
# camera y (image down) = -base z (robot up), camera z = base y
_R_UPRIGHT = np.array([[1.0, 0, 0], [0, 0, -1.0], [0, 1.0, 0]])


def make_synthetic_dream_dataset(base_dir, robot_type="panda", n_images=6,
                                 seed=0, image_hw=(480, 640),
                                 synthetic=True, split="test_dr",
                                 render_images=False,
                                 view_mode="random",
                                 view_jitter_deg=25.0) -> Path:
    """Write n_images DREAM-format samples under
    base_dir/{synthetic,real}/<robot>_synth_<split> (or <robot>-3cam_<split>)
    and return that directory. Its name matters to the reader: 'synthetic'
    selects the 0.01 translation scale, the robot name the keypoints.

    view_mode "random": a uniformly random base orientation; "upright":
    the robot upright, a random azimuth, the camera tilt jittered by at
    most view_jitter_deg."""
    if render_images:
        raise NotImplementedError(
            "render_images=True needs the shaded renderer "
            "(core/shaded_render.py), not ported yet (ROADMAP queue 1 "
            "item 8)")
    from horopose_tpu_torch.data.dream import (R_NORMAL_UE,
                                               _quat_xyzw_to_rotmat)
    from horopose_tpu_torch.kinematics.robot import Robot

    rng = np.random.RandomState(seed)
    base = Path(base_dir)
    name = f"{robot_type}_synth_{split}" if synthetic else \
        f"{robot_type}-3cam_{split}"
    root = base / ("synthetic" if synthetic else "real") / name
    root.mkdir(parents=True, exist_ok=True)
    h, w = image_hw
    fx = fy = 320.0
    cx, cy = w / 2, h / 2
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    scale = 0.01 if synthetic else 1.0

    (root / "_camera_settings.json").write_text(json.dumps({
        "camera_settings": [{
            "name": "camera",
            "intrinsic_settings": {"fx": fx, "fy": fy, "cx": cx, "cy": cy},
        }]
    }))

    robot = Robot(robot_type, device="cpu")
    bounds = C.JOINT_BOUNDS[robot_type]
    kp_names = C.KEYPOINT_NAMES[robot_type]
    joint_names = C.JOINT_NAMES[robot_type]

    for i in range(n_images):
        # base pose: the decode path defines the rotation; keep the robot
        # in front of the camera
        if view_mode == "upright":
            az = rng.uniform(0, 2 * np.pi)
            Rz = _axis_angle(np.array([0.0, 0, 1]), az)
            theta = np.deg2rad(rng.uniform(0, view_jitter_deg))
            axis = rng.randn(3)
            R = _axis_angle(axis, theta) @ _R_UPRIGHT @ Rz
            q = _rotmat_to_quat_xyzw(R @ R_NORMAL_UE.T)
            # round-trip through the reader's decode so annotations are
            # exact even if q normalization nudges the matrix
            R = _quat_xyzw_to_rotmat(q) @ R_NORMAL_UE
        else:
            q = rng.randn(4)
            q /= np.linalg.norm(q)
            R = _quat_xyzw_to_rotmat(q) @ R_NORMAL_UE

        cfg = rng.uniform(bounds[:, 0] * 0.5, bounds[:, 1] * 0.5)
        kp_base = robot.get_keypoints_only_fk(
            torch.as_tensor(cfg, dtype=torch.float32)[None]
        )[0].double().numpy()

        if view_mode == "upright":
            # frame the robot: its keypoint centroid lands near the optical
            # axis (otherwise an upright arm extends out of the image top)
            target = np.array([rng.uniform(-0.15, 0.15),
                               rng.uniform(-0.1, 0.1),
                               rng.uniform(1.5, 2.4)])
            trans = target - R @ kp_base.mean(axis=0)
        else:
            trans = np.array([rng.uniform(-0.2, 0.2),
                              rng.uniform(-0.2, 0.2),
                              rng.uniform(1.2, 2.2)])
        kp_cam = (R @ kp_base.T).T + trans
        proj = (K @ kp_cam.T).T
        kp2d = proj[:, :2] / proj[:, 2:3]

        margin = 10
        bb_min = kp2d.min(axis=0) - margin
        bb_max = kp2d.max(axis=0) + margin
        img = rng.randint(0, 255, (h, w, 3), dtype=np.uint8)

        ann = {
            "objects": [{
                "class": robot_type,
                "quaternion_xyzw": q.tolist(),
                "location": (trans / scale).tolist(),
                "bounding_box": {"min": bb_min.tolist(),
                                 "max": bb_max.tolist()},
                "keypoints": [
                    {"name": kp_names[k],
                     "location": (kp_cam[k] / scale).tolist(),
                     "projected_location": kp2d[k].tolist()}
                    for k in range(len(kp_names))
                ],
            }],
            "sim_state": {
                "joints": [{"name": f"{robot_type}/{jn}",
                            "position": float(cfg[j])}
                           for j, jn in enumerate(joint_names)],
            },
        }
        Image.fromarray(img).save(root / f"{i:06d}.jpg", quality=85)
        (root / f"{i:06d}.json").write_text(json.dumps(ann))
    return root
