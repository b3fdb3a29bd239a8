"""The one traffic generator: it reads a mix's parameters
(`benchmark/traffic/<traffic>.json`) and makes its inputs from the seed.

Two kinds of input, named by the mix's `mode`:
- `serve`: requests of `batch` full uint8 frames (H x W x 3) with the
  camera's intrinsics and one robot bbox a frame, its width and height
  drawn uniformly from `bbox_w` and `bbox_h` px and placed uniformly in
  the frame (copied from `chip_smoke.py::synthetic_requests`);
- `train`: DREAM-layout stage-2 batches (copied from the program's
  `data/synthetic.py`): joints uniform within `joint_jitter` rad of the
  dataset's mean, a uniform base rotation, the base `base_xy_m` from the
  optical axis and `base_depth_m` deep, keypoints from the benchmark's own
  FK (`reference/robot.py`, float64), projected into the frame and into
  two square crops around them (side: the keypoints' box plus
  `crop_margin_px`), with their intrinsics, bboxes and visibility. A row
  that puts a keypoint nearer the camera than `min_keypoint_depth_m` is
  drawn again: a camera sees no robot behind it.
The pixels are uniform noise drawn on the device. Every stream has its own
generator, seeded from (seed, stream), so the same seed gives the same
inputs on every run.
"""

from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np
import torch

from benchmark.reference.robot import RobotFK

STREAMS = ("pixels", "geometry", "weights", "dropout", "order")


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one stream of a run's draws."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, STREAMS.index(stream)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def rng(seed: int, stream: str) -> np.random.Generator:
    return np.random.default_rng(stream_seed(seed, stream))


def torch_generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed,
                                                                  stream))


def order(traffic: Mapping, seed: int, n: int) -> List[int]:
    """The pool entries the window sends, in turn: each pass over the pool
    in an order drawn from the seed."""
    r = rng(seed, "order")
    pool = int(traffic["pool"])
    out: List[int] = []
    while len(out) < n:
        out += [int(i) for i in r.permutation(pool)]
    return out[:n]


# --------------------------------------------------------------------- serve


def serve_requests(traffic: Mapping, seed: int, device) -> List[dict]:
    """`pool` requests: frames (B, H, W, 3) uint8 and K (B, 3, 3), bboxes
    (B, 4) float32, numpy on the host."""
    B, pool = int(traffic["batch"]), int(traffic["pool"])
    H, W = traffic["frame_hw"]
    g = torch_generator(seed, "pixels", device)
    r = rng(seed, "geometry")
    K = np.asarray(traffic["K"], np.float32)
    out = []
    for _ in range(pool):
        frames = torch.randint(0, 256, (B, H, W, 3), dtype=torch.uint8,
                               generator=g, device=device).cpu().numpy()
        w = r.uniform(*traffic["bbox_w"], B)
        h = r.uniform(*traffic["bbox_h"], B)
        x0, y0 = r.uniform(0, W - w), r.uniform(0, H - h)
        out.append(dict(
            frames=frames, K=np.tile(K[None], (B, 1, 1)),
            bboxes=np.stack([x0, y0, x0 + w, y0 + h], -1).astype(np.float32)))
    return out


# --------------------------------------------------------------------- train


def _rotations(r: np.random.Generator, n: int) -> np.ndarray:
    q, rr = np.linalg.qr(r.standard_normal((n, 3, 3)))
    q = q * np.sign(np.diagonal(rr, axis1=-2, axis2=-1))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q


def _project(K: np.ndarray, p: np.ndarray) -> np.ndarray:
    x = p @ np.swapaxes(K, -1, -2)
    return x[..., :2] / x[..., 2:3]


def _box(kp2d: np.ndarray) -> np.ndarray:
    return np.concatenate([kp2d.min(axis=1), kp2d.max(axis=1)], -1)


def _inside(kp2d: np.ndarray, w: float, h: float) -> np.ndarray:
    return ((kp2d[..., 0] >= 0) & (kp2d[..., 0] < w) & (kp2d[..., 1] >= 0)
            & (kp2d[..., 1] < h)).astype(np.float32)


def _crop(kp3d, K, center, side, size: int, extend) -> Dict[str, np.ndarray]:
    B = kp3d.shape[0]
    scale = size / side
    K_crop = np.tile(K[None], (B, 1, 1))
    K_crop[:, 0, 2] -= center[:, 0] - side / 2
    K_crop[:, 1, 2] -= center[:, 1] - side / 2
    K_crop[:, :2] *= scale[:, None, None]
    kp2d = _project(K_crop, kp3d)
    box = _box(kp2d)
    wh = box[:, 2:] - box[:, :2]
    margin = np.concatenate([wh * np.asarray(extend)] * 2, -1) * \
        [-1, -1, 1, 1]
    return dict(K=K_crop, keypoints_3d=kp3d, keypoints_2d=kp2d,
                valid_mask_crop=_inside(kp2d, size, size),
                bbox_strict_bounded=np.clip(box, 0, size),
                bbox_gt2d_extended=np.clip(box + margin, 0, size))


def _poses(traffic: Mapping, robot: RobotFK, r: np.random.Generator, B: int):
    """B rows of (joints, R, t, camera keypoints); rows that put a
    keypoint nearer than `min_keypoint_depth_m` are drawn again, B at a
    time, until B rows are kept."""
    kept = []
    while sum(len(k[0]) for k in kept) < B:
        q = robot.mean_joints[None] + r.uniform(
            -traffic["joint_jitter"], traffic["joint_jitter"], (B, robot.dof))
        R = _rotations(r, B)
        t = np.stack([r.uniform(-traffic["base_xy_m"], traffic["base_xy_m"],
                                B),
                      r.uniform(-traffic["base_xy_m"], traffic["base_xy_m"],
                                B),
                      r.uniform(*traffic["base_depth_m"], B)], -1)
        kp = robot.keypoints_base(torch.as_tensor(q)).numpy()
        kp = kp @ np.swapaxes(R, -1, -2) + t[:, None]
        ok = kp[..., 2].min(axis=1) >= traffic["min_keypoint_depth_m"]
        kept.append((q[ok], R[ok], t[ok], kp[ok]))
    return [np.concatenate(x)[:B] for x in zip(*kept)]


def train_batches(traffic: Mapping, robot_name: str, image_size: int,
                  seed: int, device) -> List[dict]:
    """`pool` DREAM-layout batches of `batch` rows on `device`: float32
    tensors and uint8 (B, S, S, 3) crops, nested as the program's step
    takes them (`root` and `other` crops)."""
    robot = RobotFK(robot_name, dtype=torch.float64)
    B, pool, S = int(traffic["batch"]), int(traffic["pool"]), int(image_size)
    W, H = traffic["frame_wh"]
    K = np.asarray(traffic["K"], np.float64)
    g = torch_generator(seed, "pixels", device)
    r = rng(seed, "geometry")
    out = []
    for _ in range(pool):
        q, R, t, kp3d = _poses(traffic, robot, r, B)
        TCO = np.tile(np.eye(4)[None], (B, 1, 1))
        TCO[:, :3, :3], TCO[:, :3, 3] = R, t
        kp2d = _project(np.tile(K[None], (B, 1, 1)), kp3d)
        box = _box(kp2d)
        center = (box[:, :2] + box[:, 2:]) / 2
        side = (box[:, 2:] - box[:, :2]).max(axis=1) + \
            traffic["crop_margin_px"]
        batch = dict(
            TCO=TCO, K_original=np.tile(K[None], (B, 1, 1)), jointpose=q,
            keypoints_2d_original=kp2d, keypoints_3d_original=kp3d,
            valid_mask=_inside(kp2d, W, H),
            bbox_strict_bounded_original=np.clip(box, 0, [W, H, W, H]),
            root=_crop(kp3d, K, center, side, S, traffic["extend_ratio"]),
            other=_crop(kp3d, K, center, side, S, traffic["extend_ratio"]))
        out.append(_to_device(batch, device))
        for crop in ("root", "other"):
            out[-1][crop]["images"] = torch.randint(
                0, 256, (B, S, S, 3), dtype=torch.uint8, generator=g,
                device=device)
    return out


def _to_device(tree: Mapping, device) -> dict:
    return {k: _to_device(v, device) if isinstance(v, Mapping)
            else torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in tree.items()}
