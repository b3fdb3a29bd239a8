"""Serving in plain PyTorch: full frames in, the seven outputs out.

Per frame: the robot bbox grown by 30% a side (at least 150 x 120,
clamped to the frame), its square-padded crop resized bilinearly to S x S
(align_corners=False, taps outside the crop read black, rounded to
uint8), the crop's intrinsics, the k prior from the strict bbox and the
frame's intrinsics, the FullNet forward in eval mode, the FK keypoints
placed by the predicted rotation and translation of the reference
keypoint, and their projection into the frame.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.fullnet import FullNet, project, rot6d_to_rotmat
from benchmark.reference.robot import RobotFK

OUTPUT_KEYS = ("joints", "rotation", "translation", "root_depth",
               "keypoints_3d", "keypoints_3d_integral", "keypoints_2d")


def strict_bbox(box, w: int, h: int) -> np.ndarray:
    """A detection xyxy grown by 30% a side, at least 150 x 120 px,
    clamped to the w x h frame, in whole pixels."""
    wmin, hmin = max(0, box[0]), max(0, box[1])
    wmax, hmax = min(w, box[2]), min(h, box[3])
    bw, bh = wmax - wmin, hmax - hmin
    wmin, wmax = int(max(0, wmin - 0.3 * bw)), int(min(w, wmax + 0.3 * bw))
    hmin, hmax = int(max(0, hmin - 0.3 * bh)), int(min(h, hmax + 0.3 * bh))
    if wmax - wmin < 150:
        wmin, wmax = wmin - 75, wmax + 75
    if hmax - hmin < 120:
        hmin, hmax = hmin - 60, hmax + 60
    wmin, hmin, wmax, hmax = max(0, wmin), max(0, hmin), min(w, wmax), \
        min(h, hmax)
    return np.array([min(w, wmin), min(h, hmin), max(0, wmax), max(0, hmax)])


def crop_K(K: np.ndarray, box: np.ndarray, S: int) -> np.ndarray:
    """Intrinsics of the box's square crop (side max(w, h), the box
    centred) resized to S x S."""
    wmin, hmin, wmax, hmax = (int(v) for v in box)
    sq = max(wmax - wmin, hmax - hmin)
    x0 = wmin - (sq - (wmax - wmin)) // 2
    y0 = hmin - (sq - (hmax - hmin)) // 2
    s = S / sq
    out = K.astype(np.float64).copy()
    out[0, 0], out[1, 1] = s * K[0, 0], s * K[1, 1]
    out[0, 2] = (S - 1) / 2 + s * (K[0, 2] - x0 - sq / 2)
    out[1, 2] = (S - 1) / 2 + s * (K[1, 2] - y0 - sq / 2)
    return out


def _taps(lo, hi, square, size: int, S: int):
    """Per frame (B, S): both bilinear taps along one axis of the crop
    window [lo, hi), centred in a square of side `square`, and their
    weights, zero for a tap outside the window or the frame."""
    lo, hi, square = lo[:, None], hi[:, None], square[:, None]
    off = torch.div(square - (hi - lo), 2, rounding_mode="floor")
    o = torch.arange(S, dtype=torch.float32, device=lo.device)[None]
    f = (o + 0.5) * (square.float() / float(S)) - 0.5 - off.float() + \
        lo.float()
    i0 = torch.floor(f)
    w1 = f - i0
    out = []
    for i, w in ((i0.long(), 1.0 - w1), (i0.long() + 1, w1)):
        inside = (i >= lo) & (i < hi) & (i >= 0) & (i < size)
        out.append((i.clamp(0, size - 1), torch.where(inside, w, 0.0)))
    return out


def crop_resize(frames: torch.Tensor, boxes: torch.Tensor, S: int
                ) -> torch.Tensor:
    """frames (B, H, W, 3) uint8, boxes (B, 4) whole-pixel xyxy ->
    (B, S, S, 3) uint8 square-padded bilinear crops."""
    B, H, W, _ = frames.shape
    wmin, hmin, wmax, hmax = boxes.long().unbind(-1)
    square = torch.maximum(wmax - wmin, hmax - hmin)
    b = torch.arange(B, device=frames.device)[:, None, None]
    acc = torch.zeros(B, S, S, 3, dtype=torch.float32, device=frames.device)
    for y, wy in _taps(hmin, hmax, square, H, S):
        for x, wx in _taps(wmin, wmax, square, W, S):
            acc += (wy[:, :, None] * wx[:, None, :])[..., None] * \
                frames[b, y[:, :, None], x[:, None, :]]
    return (acc + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def prepare(frames: np.ndarray, K: np.ndarray, bboxes: np.ndarray, S: int,
            device) -> Dict[str, torch.Tensor]:
    """The network's inputs for a block of frames: crops (B, 3, S, S) in
    [0, 1], K_crop (B, 3, 3), k (B,), and the frames' own K."""
    B, H, W = frames.shape[:3]
    boxes = np.stack([strict_bbox(bboxes[i], W, H) for i in range(B)])
    K_crop = np.stack([crop_K(K[i], boxes[i], S) for i in range(B)])
    side = np.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    f32 = dict(dtype=torch.float32, device=device)
    K_t = torch.as_tensor(np.asarray(K, np.float32), **f32)
    side_t = torch.as_tensor(side, **f32)
    k = torch.sqrt(K_t[:, 0, 0].abs() * K_t[:, 1, 1].abs() * 1e6
                   / (side_t * side_t))
    crops = crop_resize(torch.as_tensor(frames, device=device),
                        torch.as_tensor(boxes, device=device), S)
    return dict(x=crops.permute(0, 3, 1, 2).float() / 255.0,
                K_crop=torch.as_tensor(K_crop.astype(np.float32), **f32),
                k=k, K=K_t)


@torch.no_grad()
def serve(model: FullNet, robot: RobotFK, frames: np.ndarray, K: np.ndarray,
          bboxes: np.ndarray, block: int = 32) -> Dict[str, np.ndarray]:
    """The seven outputs of every frame, `block` frames at a time."""
    model.eval()
    device = next(model.parameters()).device
    outs = []
    for i in range(0, frames.shape[0], block):
        inp = prepare(frames[i:i + block], K[i:i + block],
                      bboxes[i:i + block], model.image_size, device)
        o = model(inp["x"], inp["x"], inp["k"], inp["K_crop"])
        R = rot6d_to_rotmat(o["rot"])
        kp3d = robot.keypoints_camera(o["pose"], R, o["trans"], model.ref)
        outs.append(dict(joints=o["pose"], rotation=R, translation=o["trans"],
                         root_depth=o["depth"], keypoints_3d=kp3d,
                         keypoints_3d_integral=o["xyz_int"],
                         keypoints_2d=project(inp["K"], kp3d)))
    return {k: torch.cat([o[k] for o in outs]).cpu().numpy()
            for k in OUTPUT_KEYS}
