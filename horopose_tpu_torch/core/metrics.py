"""Evaluation metrics: ADD, PCK, AUCs, per-keypoint and per-joint errors.

Port of `horopose_tpu/core/metrics.py`, numpy on the host as there:
  ADD AUC: thresholds arange(0, 0.1, 1e-5), trapezoid, / 0.1
  PCK AUC: thresholds arange(0, 20, 0.01), trapezoid, / 20
  fixed thresholds ADD {1..100} mm, PCK {2.5..20} px
  Panda leaves the finger joint out of the per-image joint-error mean.
The 2-D error keeps the reference's fixed 640x480 frame mask whatever the
frame's size. The threshold sweeps use searchsorted on sorted distances.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

ADD_THRESHOLDS_MM = [1, 5, 10, 20, 40, 60, 80, 100]
PCK_THRESHOLDS_PX = [2.5, 5.0, 7.5, 10.0, 12.5, 15.0, 17.5, 20.0]


def _project(K: np.ndarray, pts: np.ndarray) -> np.ndarray:
    proj = np.einsum("bij,bnj->bni", K, pts)
    return proj[..., :2] / proj[..., 2:3]


def compute_metrics_batch(*, robot, gt_keypoints3d, gt_keypoints2d,
                          K_original, gt_joint,
                          pred_keypoints3d: np.ndarray,
                          pred_joint: Optional[np.ndarray],
                          reference_keypoint_id: int) -> Dict:
    """Metrics for one batch, all inputs numpy. pred_keypoints3d is either
    the FK-lifted or the integral prediction (the caller runs both);
    pred_joint None skips the joint errors (zeros).

    Returns a dict of arrays and lists: per-image and per-keypoint 3-D and
    2-D errors, per-joint and per-image joint errors, the root depth
    error, and the root-relative depth and 3-D errors."""
    batch_size, keypoints_num = gt_keypoints3d.shape[:2]
    dof = robot.dof

    pred_keypoints2d = _project(K_original, pred_keypoints3d)

    # 3D ADD
    error3d_batch = np.linalg.norm(pred_keypoints3d - gt_keypoints3d, axis=2)
    error3d = error3d_batch.mean(axis=1)                     # per image

    # 2D PCK with the frame validity mask
    error2d_batch = np.linalg.norm(pred_keypoints2d - gt_keypoints2d, axis=2)
    valid = ((gt_keypoints2d[:, :, 0] <= 640.0) &
             (gt_keypoints2d[:, :, 0] >= 0) &
             (gt_keypoints2d[:, :, 1] <= 480.0) &
             (gt_keypoints2d[:, :, 1] >= 0))
    error2d_all = error2d_batch * valid
    error2d = error2d_all.sum(axis=1) / np.maximum(valid.sum(axis=1), 1)

    dis3d = list(error3d_batch.mean(axis=0))                 # per keypoint
    dis2d = error2d_all.sum(axis=0) / np.maximum(valid.sum(axis=0), 1)

    if pred_joint is not None:
        error_joint = np.abs(gt_joint - pred_joint)
        l1_jointerror = list(error_joint.mean(axis=0))
        if robot.robot_type == "panda":
            mean_jointerror = list(error_joint[:, :-1].mean(axis=1))
        else:
            mean_jointerror = list(error_joint.mean(axis=1))
    else:
        l1_jointerror = [0.0] * dof
        mean_jointerror = [0.0] * batch_size

    rid = reference_keypoint_id
    error_depth = np.abs(pred_keypoints3d[:, rid, 2] -
                         gt_keypoints3d[:, rid, 2])

    pred_rel = pred_keypoints3d[:, :, 2] - pred_keypoints3d[:, rid:rid + 1, 2]
    gt_rel = gt_keypoints3d[:, :, 2] - gt_keypoints3d[:, rid:rid + 1, 2]
    batch_error_relative = np.abs(pred_rel - gt_rel).mean(axis=1)

    pred_r = pred_keypoints3d.copy()
    pred_r[:, :, 2] = pred_rel
    gt_r = gt_keypoints3d.copy()
    gt_r[:, :, 2] = gt_rel
    error3d_relative = np.linalg.norm(pred_r - gt_r, axis=2).mean(axis=1)

    return dict(
        image_dis3d_avg=list(error3d),
        image_dis2d_avg=list(error2d),
        batch_dis3d_avg=dis3d,
        batch_dis2d_avg=list(dis2d),
        batch_l1jointerror_avg=l1_jointerror,
        image_l1jointerror_avg=mean_jointerror,
        root_depth_error=error_depth,
        batch_error_relative=batch_error_relative,
        error3d_relative=error3d_relative,
    )


def _auc(dis: np.ndarray, limit: float, step: float) -> float:
    """Trapezoid of P(dis <= t) over t in arange(0, limit, step), / limit
    (numpy's trapezoid rule with a scalar spacing, written out)."""
    thresholds = np.arange(0.0, limit, step)
    s = np.sort(np.asarray(dis))
    counts = np.searchsorted(s, thresholds, side="right") / max(len(s), 1)
    return float((step * (counts[1:] + counts[:-1]) / 2.0).sum() / limit)


def summary_add_pck(alldis: Dict) -> Dict:
    """ADD (m) and 2-D (px) mean, median and AUC, and the fraction of
    images under each fixed threshold."""
    dis3d = np.asarray(alldis["dis3d"])
    dis2d = np.asarray(alldis["dis2d"])
    summary = {
        "ADD/mean": float(np.mean(dis3d)),
        "ADD/median": float(np.median(dis3d)),
        "ADD/AUC": _auc(dis3d, 0.1, 0.00001),
        "ADD_2D/mean": float(np.mean(dis2d)),
        "ADD_2D/median": float(np.median(dis2d)),
        "PCK/AUC": _auc(dis2d, 20.0, 0.01),
    }
    for th_mm in ADD_THRESHOLDS_MM:
        summary[f"ADD_{th_mm}_mm"] = float(np.mean(dis3d <= th_mm * 1e-3))
    for th_p in PCK_THRESHOLDS_PX:
        summary[f"PCK_{th_p}_pixel"] = float(np.mean(dis2d <= th_p))
    return summary
