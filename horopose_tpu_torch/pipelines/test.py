"""Evaluation harness.

Port of `horopose_tpu/pipelines/test.py`: rebuild the model from a saved
experiment's config.yaml, load its checkpoint, run the full metric battery
over a DREAM test set, and append `result/summary.txt` with the JAX
package's fields, in its order, plus `add_distribution.json` (the ADD
curve's numbers).

Timing: `measure_forward_fps` times three forwards at the test batch size
with CUDA events, the median of `iters` after one warm-up: "root" (the
rootnet backbone, pooling and depth_layer), "other" (the reg backbone,
deconvs, final_layer and the soft-argmax kernel) and "all" (the full
forward and the FK lift). The JAX package splits the branches by XLA's
dead-code elimination; here each branch is its own FullNet method. On a
CPU device the host clock times them. The eval loop's wall time
(the batch's copy, the forward, the predictions' copy back and the host
metrics) is reported on its own line.

The checkpoint is the port's or one the JAX package wrote (flax msgpack,
`core/checkpoint.py`); a real set's rotation ground truth is PnP of its
annotated 2D keypoints against FK (`make_pnp_fn`). The ADD curve
(`add_distribution_curve_<set>.jpg`) is drawn always, and with
`visualization` the best and worst cases (`vis_best_cases.jpg`,
`vis_worst_cases.jpg`), both through `core/vis.py` (a no-op where
matplotlib is missing). `cfg.profile_dir` wraps the eval loop in
`core/profiling.trace`, which writes a Chrome trace there.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict

import numpy as np
import torch

from horopose_tpu_torch.config import make_cfg
from horopose_tpu_torch.core.checkpoint import (is_jax_payload,
                                                load_checkpoint_file,
                                                model_state_dict)
from horopose_tpu_torch.core.engine import build_full_eval_step
from horopose_tpu_torch.core.loggers import AverageMeter
from horopose_tpu_torch.core.profiling import trace
from horopose_tpu_torch.core.vis import draw_add_curve, vis_joints_3d
from horopose_tpu_torch.core.metrics import (ADD_THRESHOLDS_MM,
                                             PCK_THRESHOLDS_PX,
                                             compute_metrics_batch,
                                             summary_add_pck)
from horopose_tpu_torch.data.dream import DreamDataset
from horopose_tpu_torch.data.samplers import DataLoader, collate, pad_batch
from horopose_tpu_torch.ops.rotations import euler_from_rotmat, rot_to_rotmat
from horopose_tpu_torch.ops.transforms import project_points
from horopose_tpu_torch.parallel.prefetch import to_device
from horopose_tpu_torch.pipelines.common import (FullNetConfig,
                                                 dataset_crop_hw, make_pnp_fn,
                                                 make_robot, set_seed)
from horopose_tpu_torch.pipelines.train_full import (host_numpy,
                                                     seeded_fullnet)


def make_test_cfg(exp_path: str, dataset_path: str):
    """Rebuild the config from the experiment's saved config.yaml."""
    cfg = make_cfg(os.path.join(exp_path, "config.yaml"))
    cfg.test_ds_names = dataset_path
    cfg.exp_path = exp_path
    return cfg


def visualize_extremes(eval_step, ds, dis3d, image_ids, result_path: str,
                       device, n: int = 4, batch_size: int = 8):
    """The `n` best and worst samples by ADD, replayed through the eval
    step by their dataset indices and drawn by `core/vis.py::
    vis_joints_3d` as vis_best_cases.jpg and vis_worst_cases.jpg."""
    order = np.argsort(np.asarray(dis3d))
    for tag, ids in (("best", order[:n]), ("worst", order[-n:])):
        batch = collate([ds[int(image_ids[i])] for i in ids])
        batch, n_valid = pad_batch(batch, batch_size)
        preds, gts, _ = eval_step(to_device(batch, device))
        kp3_pred = host_numpy(preds["xyz_fk"])[:n_valid]
        K = batch["other"]["K"][:n_valid].float()
        vis_joints_3d(
            batch["other"]["images"].numpy()[:n_valid], kp3_pred,
            host_numpy(gts["gt_keypoints3d"])[:n_valid],
            project_points(K, torch.from_numpy(kp3_pred)).numpy(),
            batch["other"]["keypoints_2d"].numpy()[:n_valid],
            os.path.join(result_path, f"vis_{tag}_cases.jpg"),
            n_samples=n_valid, errors=[float(dis3d[i]) for i in ids])


def _median_seconds(fn: Callable[[], object], device: torch.device,
                    iters: int) -> float:
    """Median wall time of fn() over `iters` calls after one warm-up: CUDA
    events on a CUDA device, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def measure_forward_fps(model, robot, cfg: FullNetConfig, batch_size: int,
                        device, iters: int = 10) -> Dict[str, float]:
    """Per-image forward latencies in seconds: {"all", "root", "other"}
    (see the module docstring), on constant inputs of `batch_size` rows as
    in the JAX harness."""
    device = torch.device(device)
    size = int(cfg.image_size)
    root = int(cfg.rootnet_image_size or size)
    x_reg = torch.zeros(batch_size, 3, size, size, device=device)
    x_root = torch.zeros(batch_size, 3, root, root, device=device)
    k = torch.full((batch_size,), 1500.0, device=device)
    K = torch.tensor([[320.0, 0, size / 2], [0, 320.0, size / 2],
                      [0, 0, 1]], device=device).expand(batch_size, 3, 3)
    ref = int(cfg.reference_keypoint_id)
    model.eval()

    def run_all():
        out = model(x_reg, x_root, k, K)
        return robot.get_keypoints_root(out["pose"], out["rot"],
                                        out["trans"], root=ref)

    variants = {"all": run_all,
                "root": lambda: model.root_depth(x_root, k),
                "other": lambda: model.keypoint_uvd(x_reg)}
    with torch.no_grad():
        return {name: _median_seconds(fn, device, iters) / batch_size
                for name, fn in variants.items()}


def _load_weights(model, ckpt_path: str) -> int:
    """Load the checkpoint's model weights; returns its epoch (-1 when it
    records none)."""
    payload = load_checkpoint_file(ckpt_path)
    model.load_state_dict(model_state_dict(payload, model))
    if is_jax_payload(payload):
        print(f"[test] loaded the JAX package's checkpoint {ckpt_path}")
    elif "optimizer" not in payload:
        print(f"[test] loaded weights-only checkpoint {ckpt_path}")
    return int(payload.get("epoch", -1))


def test_network(cfg, ckpt_name: str = "curr_best_auc(add)_model.pk",
                 batch_size: int = 128, max_batches: int = None,
                 visualization: bool = False, device="cuda",
                 dtype: torch.dtype = torch.float32) -> Dict:
    """Evaluate the experiment's checkpoint on cfg.test_ds_names; writes
    result/summary.txt and add_distribution.json under cfg.exp_path and
    returns the ADD/PCK summary."""
    set_seed()
    device = torch.device(device)
    fcfg = FullNetConfig.from_cfg(cfg)
    robot = make_robot(fcfg, device=device)
    result_path = os.path.join(cfg.exp_path, "result")
    os.makedirs(result_path, exist_ok=True)

    model = seeded_fullnet(fcfg, dtype)
    # --ckpt is a name under <exp_path>/ckpt or a path
    ckpt_path = ckpt_name if os.path.exists(ckpt_name) else \
        os.path.join(cfg.exp_path, "ckpt", ckpt_name)
    ckpt_epoch = -1
    if os.path.exists(ckpt_path):
        ckpt_epoch = _load_weights(model, ckpt_path)
    else:
        print(f"[test] WARNING: checkpoint {ckpt_path} not found, "
              "evaluating random init")
    model.to(device).eval()

    rootnet_hw, other_hw = dataset_crop_hw(cfg)
    ds = DreamDataset(cfg.test_ds_names, color_jitter=False,
                      rgb_augmentation=False, occlusion_augmentation=False,
                      rootnet_resize_hw=rootnet_hw, other_resize_hw=other_hw,
                      extend_ratio=cfg.extend_ratio)
    loader = DataLoader(ds, batch_size=batch_size, num_workers=8,
                        drop_last=False, pin_memory=device.type == "cuda")
    # the test harness keys the pseudo-ground truth on the dataset under
    # evaluation, not on the train set
    eval_step = build_full_eval_step(fcfg, model, robot,
                                     pnp_fn=make_pnp_fn(cfg.test_ds_names))

    alldis = defaultdict(list)
    alldis_rel = defaultdict(list)
    metric_l1joint = [AverageMeter() for _ in range(robot.dof)]
    time_loop = AverageMeter()  # wall time incl. transfers + host metrics
    ref = int(cfg.reference_keypoint_id)

    profile = contextlib.nullcontext()
    if cfg.get("profile_dir"):
        profile = trace(str(cfg.profile_dir))
        print(f"[test] writing a torch.profiler trace to {cfg.profile_dir}")
    with profile:
        for bi, batch in enumerate(loader):
            if max_batches and bi >= max_batches:
                break
            batch, n_valid = pad_batch(batch, batch_size)
            t0 = time.perf_counter()
            dev = to_device(batch, device, non_blocking=True)
            preds, gts, _ = eval_step(dev)
            # padded rows leave before the metric battery, so batch means
            # (the per-joint meters) see only real samples
            preds = {k: host_numpy(v)[:n_valid] for k, v in preds.items()}
            gts = {k: host_numpy(v)[:n_valid] for k, v in gts.items()}
            K_orig = batch["K_original"].numpy()[:n_valid]
            kp2d_orig = batch["keypoints_2d_original"].numpy()[:n_valid]
            m_fk = compute_metrics_batch(
                robot=robot, gt_keypoints3d=gts["gt_keypoints3d"],
                gt_keypoints2d=kp2d_orig, K_original=K_orig,
                gt_joint=gts["gt_pose_before_mask"],
                pred_keypoints3d=preds["xyz_fk"], pred_joint=preds["pose"],
                reference_keypoint_id=ref)
            # rotation error: the reference's euler L1
            ep = euler_from_rotmat(rot_to_rotmat(
                torch.from_numpy(preds["rot"])))
            eg = euler_from_rotmat(rot_to_rotmat(
                torch.from_numpy(gts["gt_root_rot"])))
            rotang = (ep - eg).abs().mean(dim=1).numpy()

            # KeypointNet 2d distance: integral keypoints reprojected onto
            # the reg crop against the crop's gt 2D keypoints, masked mean
            kp2_int = project_points(
                batch["other"]["K"][:n_valid].float(),
                torch.from_numpy(preds["xyz_int"])).numpy()
            vm_crop = batch["other"]["valid_mask_crop"].numpy()[:n_valid]
            gt_kp2 = batch["other"]["keypoints_2d"].numpy()[:n_valid]
            d2 = np.linalg.norm(kp2_int - gt_kp2, axis=2) * vm_crop
            alldis["mean_kp2d_distance"].append(
                float(d2.sum() / max((vm_crop != 0).sum(), 1)))
            alldis["id"].extend(batch["image_id"].numpy()[:n_valid].tolist())
            alldis["dis3d"].extend(m_fk["image_dis3d_avg"])
            alldis["dis2d"].extend(m_fk["image_dis2d_avg"])
            alldis["jointerror"].extend(m_fk["image_l1jointerror_avg"])
            alldis["deptherror"].extend(
                np.asarray(m_fk["root_depth_error"]).tolist())
            alldis["deptherror_relative"].extend(
                np.asarray(m_fk["batch_error_relative"]).tolist())
            alldis["mean_rot_angle"].extend(rotang.tolist())
            alldis_rel["dis3d"].extend(
                np.asarray(m_fk["error3d_relative"]).tolist())
            alldis_rel["dis2d"].extend(m_fk["image_dis2d_avg"])
            for i in range(robot.dof):
                metric_l1joint[i].add(m_fk["batch_l1jointerror_avg"][i])
            if bi > 0:  # the first batch also pays the warm-up
                time_loop.add((time.perf_counter() - t0) / batch_size,
                              n=batch_size)
    loader.close()

    summary = summary_add_pck(alldis)
    summary_rel = summary_add_pck(alldis_rel)
    mean_joint_error = float(np.mean(alldis["jointerror"]) / np.pi * 180.0)
    mean_depth_error = float(np.mean(alldis["deptherror"]))
    mean_rot_error = float(np.mean(alldis["mean_rot_angle"]) / np.pi * 180.0)
    rel_depth_error = float(np.mean(alldis["deptherror_relative"]))
    mean_kp2d_error = float(np.mean(alldis["mean_kp2d_distance"]))
    times = measure_forward_fps(model, robot, fcfg, batch_size, device)
    time_forward = times["all"]
    fps = 1.0 / time_forward if time_forward > 0 else 0.0

    lines = [
        "Model metrics summary",
        f"Dataset for testing: {cfg.test_ds_names}",
        f"This model was saved from epoch:{ckpt_epoch}",
        f"Joint_l1_error/mean (degree): {mean_joint_error}",
        f"Depth_l1_error/mean (m): {mean_depth_error}",
        f"Rotation_l1_error/mean (degree): {mean_rot_error}",
        f"Relative_l1_error/mean (m): {rel_depth_error}",
        f"KeypointNet_2d_distance/mean (pixel): {mean_kp2d_error}",
        f"Relative_ADD/AUC: {summary_rel['ADD/AUC']}",
        f"ADD/AUC: {summary['ADD/AUC']}",
        f"ADD/mean (m): {summary['ADD/mean']}",
        f"ADD/median (m): {summary['ADD/median']}",
        f"PCK/AUC: {summary['PCK/AUC']}",
        f"ADD_2D/mean (pixel): {summary['ADD_2D/mean']}",
        f"ADD_2D/median (pixel): {summary['ADD_2D/median']}",
    ]
    for th in ADD_THRESHOLDS_MM:
        lines.append(f"ADD<{th}mm: {summary[f'ADD_{th}_mm']}")
    for th in PCK_THRESHOLDS_PX:
        lines.append(f"ADD_2d<{th}pixel: {summary[f'PCK_{th}_pixel']}")
    for i in range(robot.dof):
        lines.append(f"Joint_l1_error/joint_{i + 1} (degree): "
                     f"{metric_l1joint[i].mean / np.pi * 180.0}")
    lines += [
        "Runtimes:",
        f"Runtime of rootnet: {times['root']}",
        f"Runtime of regression+integral: {times['other']}",
        f"Runtime of all: {time_forward}",
        f"time_image.mean-time_other.mean: {time_forward - times['other']}",
        f"Runtime of eval loop per image (incl. device->host transfer + "
        f"host metrics): {time_loop.mean}",
        # the JAX harness reports FPS_parallel as FPS: both branches run in
        # one program there; here they run in turn on one stream
        f"FPS_parallel: {int(fps)}",
        f"FPS: {int(fps)}",
        "",
    ]
    with open(os.path.join(result_path, "summary.txt"), "a") as f:
        f.write("\n".join(lines) + "\n")
    # the ADD curve's raw data, then its plot
    with open(os.path.join(result_path, "add_distribution.json"), "w") as f:
        json.dump(dict(dis3d=list(map(float, alldis["dis3d"])),
                       auc=summary["ADD/AUC"]), f)
    draw_add_curve(alldis, result_path, cfg.test_ds_names,
                   auc=summary["ADD/AUC"])
    if visualization:
        visualize_extremes(eval_step, ds, alldis["dis3d"], alldis["id"],
                           result_path, device)
    print("\n".join(lines))
    return summary
