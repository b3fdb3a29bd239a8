"""Visualization: 2D keypoint overlays, 3D skeletons, ADD curves, the
shaded mesh overlay and the sim2real silhouette view.

Port of `horopose_tpu/core/vis.py`: the test harness's grid of the best
and worst cases (`vis_joints_3d`), a single 3D view, the ADD curve with its
distance histograms (`draw_add_curve`), `render_mesh` (the shaded render
of `core/shaded_render.py` blended over a frame) and
`save_silhouette_comparison`. The plots use matplotlib with the Agg
backend; where matplotlib is missing each plot is a no-op with a warning,
so a headless run never fails on a plot.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
from PIL import Image


def _plt():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        return plt
    except Exception as e:
        print(f"[vis] matplotlib unavailable: {e}")
        return None


# skeleton edges = consecutive keypoints (the DREAM keypoint chains)
def _edges(num_keypoints: int):
    return [(i, i + 1) for i in range(num_keypoints - 1)]


# the reference's limb palette: per-limb colors for the prediction
# skeleton, uniform light red for GT
_PRED_LIMB_COLORS = [(140, 140, 255), (150, 235, 120), (165, 175, 215),
                     (135, 153, 124), (140, 140, 255), (150, 235, 120),
                     (165, 175, 215)]
_GT_LIMB_COLOR = (255, 70, 70)
_DARKBLUE = (70, 80, 150)
_LIGHTBLUE = (140, 140, 255)


def overlay_keypoints_2d(ax, image: np.ndarray, kp2d: np.ndarray,
                         color="lime", gt_kp2d: Optional[np.ndarray] = None):
    ax.imshow(image.astype(np.uint8))
    ax.scatter(kp2d[:, 0], kp2d[:, 1], c=color, s=12)
    for a, b in _edges(len(kp2d)):
        ax.plot(kp2d[[a, b], 0], kp2d[[a, b], 1], c=color, lw=1)
    if gt_kp2d is not None:
        ax.scatter(gt_kp2d[:, 0], gt_kp2d[:, 1], c="red", s=12, marker="x")
    ax.axis("off")


def skeleton_3d(ax, kp3d: np.ndarray, color="tab:blue", label=None):
    ax.scatter(kp3d[:, 0], kp3d[:, 1], kp3d[:, 2], c=color, s=14,
               label=label)
    for a, b in _edges(len(kp3d)):
        ax.plot(kp3d[[a, b], 0], kp3d[[a, b], 1], kp3d[[a, b], 2], c=color)


def _skeleton_3d_ref(ax, kp3d: np.ndarray, limb_colors, point_rgb,
                     lw: float = 3.5, point_s: float = 25):
    """One skeleton in the reference's 3D convention: plotted as (x, z, y)
    with the vertical axis inverted by the fixed z-limits, per-limb
    colors, thick round-capped lines."""
    ax.scatter(kp3d[:, 0], kp3d[:, 2], kp3d[:, 1], s=point_s,
               c=[np.array(point_rgb) / 255.0])
    for i, (a, b) in enumerate(_edges(len(kp3d))):
        c = np.array(limb_colors[i % len(limb_colors)]) / 255.0
        ax.plot(kp3d[[a, b], 0], kp3d[[a, b], 2], kp3d[[a, b], 1],
                lw=lw, ls="-", c=c, solid_capstyle="round")


def _set_ref_bounds(ax):
    """Fixed world-box of the reference grid: x in [-0.5, 0.5], depth in
    [0.5, 2.0], vertical inverted."""
    ax.set_xlim(-0.5, 0.5)
    ax.set_ylim(0.5, 2.0)
    ax.set_zlim(0.4, -0.5)


def vis_joints_3d(images: np.ndarray, pred_kp3d: np.ndarray,
                  gt_kp3d: np.ndarray, pred_kp2d: np.ndarray,
                  gt_kp2d: np.ndarray, save_path: str,
                  n_samples: int = 4, views=(-70, -40, 0, 20, 50),
                  errors=None):
    """The reference's 8-column grid, one row per sample:
    [image + 2D overlays | prediction-only @-70 | gt-only @-70 |
    prediction+gt at azim -70/-40/0/20/50], elev=12 throughout, fixed world
    box, per-limb prediction palette vs light-red GT, per-sample
    'error/ADD: ...m' title on the image column."""
    plt = _plt()
    if plt is None:
        return
    n = min(n_samples, len(images))
    cols = 3 + len(views)
    fig = plt.figure(figsize=(3 * cols, round(3 * n * 0.85)))
    for i in range(n):
        ax = fig.add_subplot(n, cols, i * cols + 1)
        overlay_keypoints_2d(ax, images[i], pred_kp2d[i], gt_kp2d=gt_kp2d[i])
        title = f"sample {i}: pred(circle) vs gt(x)"
        if errors is not None:
            title = f"error/ADD: {errors[i]:0.5f}m, " \
                    "(prediction: blue, gt: red)"
        ax.set_title(title, fontsize=8)

        # prediction-only and gt-only columns
        ax3 = fig.add_subplot(n, cols, i * cols + 2, projection="3d")
        _skeleton_3d_ref(ax3, pred_kp3d[i], _PRED_LIMB_COLORS, _DARKBLUE)
        _set_ref_bounds(ax3)
        ax3.view_init(elev=12, azim=-70)
        if i == 0:
            ax3.set_title("prediction", fontsize=8)
        ax3 = fig.add_subplot(n, cols, i * cols + 3, projection="3d")
        _skeleton_3d_ref(ax3, gt_kp3d[i], [_GT_LIMB_COLOR], _DARKBLUE)
        _set_ref_bounds(ax3)
        ax3.view_init(elev=12, azim=-70)
        if i == 0:
            ax3.set_title("gt", fontsize=8)

        # rotating prediction+gt columns
        for v, azim in enumerate(views):
            ax3 = fig.add_subplot(n, cols, i * cols + 4 + v,
                                  projection="3d")
            _skeleton_3d_ref(ax3, pred_kp3d[i], _PRED_LIMB_COLORS,
                             _LIGHTBLUE, lw=3.5, point_s=25)
            _skeleton_3d_ref(ax3, gt_kp3d[i], [_GT_LIMB_COLOR], _DARKBLUE,
                             lw=2.0, point_s=10)
            _set_ref_bounds(ax3)
            ax3.view_init(elev=12, azim=azim)
            if i == 0:
                ax3.set_title("prediction + gt", fontsize=8)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_path, dpi=80)
    plt.close(fig)


def vis_3dkp_single_view(pred_kp3d: np.ndarray, gt_kp3d: np.ndarray,
                         save_path: str, azim: float = 45.0):
    """Single 3D comparison view."""
    plt = _plt()
    if plt is None:
        return
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    skeleton_3d(ax, pred_kp3d, color="tab:blue", label="pred")
    skeleton_3d(ax, gt_kp3d, color="tab:red", label="gt")
    ax.view_init(elev=15, azim=azim)
    ax.legend()
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=100)
    plt.close(fig)


def draw_add_curve(alldis: dict, result_path: str, test_ds_name: str,
                   auc: float):
    """ADD threshold-sweep curve + distance histograms, written as
    add_distribution_curve_<set name>.jpg under result_path."""
    plt = _plt()
    if plt is None:
        return
    dis3d = np.asarray(alldis["dis3d"])
    thresholds = np.arange(0.0, 0.1, 1e-5)
    s = np.sort(dis3d)
    counts = np.searchsorted(s, thresholds, side="right") / max(len(s), 1)
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    ax = axes[0, 0]
    ax.plot(thresholds, counts)
    ax.set_xlim(0, 0.1)
    ax.set_ylim(0, 1)
    ax.grid(True)
    ax.set_xlabel("ADD threshold (m)")
    ax.set_ylabel("fraction under threshold")
    ax.axvline(float(np.mean(dis3d)), color="red", ls="--", label="mean")
    ax.axvline(float(np.median(dis3d)), color="green", ls="--",
               label="median")
    ax.set_title(f"ADD curve (AUC={auc * 100:.2f})")
    ax.legend()
    for ax, lim in ((axes[0, 1], None), (axes[1, 0], 0.5), (axes[1, 1], 0.1)):
        ax.hist(dis3d, bins=60, range=(0, lim) if lim else None)
        if lim:
            ax.set_xlim(0, lim)
        ax.set_title(f"3D distance distribution"
                     f"{f' 0-{lim}m' if lim else ''}")
    name = os.path.basename(str(test_ds_name))
    os.makedirs(result_path, exist_ok=True)
    fig.tight_layout()
    fig.savefig(os.path.join(result_path,
                             f"add_distribution_curve_{name}.jpg"))
    plt.close(fig)


def render_mesh(image: np.ndarray, robot, robot_mesh, cfg, rot, trans, K,
                blend: float = 0.7, root: int = 0) -> np.ndarray:
    """The shaded robot mesh (`core/shaded_render.py`) blended over the
    frame: OBJ map_Kd textures, MTL Kd or URDF material colours where the
    mesh was built with_appearance=True, the link palette elsewhere.

    (rot, trans) place keypoint-link `root` in the camera: pass the
    config's reference_keypoint_id when rendering model predictions."""
    from horopose_tpu_torch.core.shaded_render import render_robot_shaded
    _, blended = render_robot_shaded(robot, robot_mesh, cfg, rot, trans, K,
                                     image.shape[:2], root=root,
                                     original_image=image, blend=blend)
    return blended


def save_silhouette_comparison(rendered: np.ndarray, target: np.ndarray,
                               save_path: str):
    """Write the rendered mask in the red channel and the teacher's in the
    blue one, (h, w) each in [0, 1], as an image file."""
    h, w = rendered.shape
    stack = np.zeros((h, w, 3), np.uint8)
    stack[..., 0] = np.clip(rendered * 255, 0, 255).astype(np.uint8)
    stack[..., 2] = np.clip(target * 255, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    Image.fromarray(stack).save(save_path)
