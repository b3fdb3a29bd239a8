"""Learning demo: train the flagship pipeline on rendered synthetic frames
and watch the held-out ADD AUC, then replay the test harness.

Port of `scripts/demo_learn.py`. The script writes a DREAM-format train
set and a held-out test set whose frames are shaded renders of the robot
at the annotated pose (`tools/synth_dream.py`, `render_images=True`), so
the pixels carry the pose; trains stage 2 through
`pipelines.train_full.train_full` from the YAML it writes; prints the
per-epoch progression from `log/scalars.jsonl` (the training loss, each
test set's held-out ADD AUC, and the validation's 2-D, 3-D and depth
errors); and replays `pipelines.test.test_network` on the best-ADD-AUC
checkpoint, printing its `summary.txt`. The keeper saves that checkpoint
only when the AUC rises above 0; if it never did, the script says so.

    python -m horopose_tpu_torch.scripts.demo_learn --workdir <dir> \
        [--n-train 512 --n-test 64 --epochs 30 --batch-size 32]

It trains on the card; `--device cpu` asks for the CPU. The sets are
written in this process, once for a given size (`data/.generated.json`
records it); the experiment goes under `<workdir>/experiments/`.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict

CONFIG_TEMPLATE = """\
exp_name : "{exp_name}"
urdf_robot_name : "{robot}"
train_ds_names : "dream/synthetic/{robot}_synth_train_dr"
image_size : 256.0
backbone_name : "{backbone}"
rootnet_backbone_name : "{rootnet_backbone}"
lr : {lr}
weight_decay : 0.
use_schedule : {use_schedule}
schedule_type : "exponential"
n_epochs_warmup : 0
start_decay : {start_decay}
end_decay : {end_decay}
final_decay : 0.01
exponent : 0.95
batch_size : {batch_size}
epoch_size : {epoch_size}
n_epochs : {epochs}
n_dataloader_workers : 4
clip_gradient : 5.0
n_iter : 4
pose_loss_func : "mse"
rot_loss_func : "mse"
trans_loss_func : "l2norm"
depth_loss_func : "l1"
uv_loss_func : "l2norm"
kp2d_loss_func : "l2norm"
kp3d_loss_func : "l2norm"
kp2d_int_loss_func : "l2norm"
kp3d_int_loss_func : "l2norm"
align_3d_loss_func : "l2norm"
pose_loss_weight : 1.0
rot_loss_weight : 1.0
trans_loss_weight : 1.0
depth_loss_weight : 10.0
uv_loss_weight : 1.0
kp2d_loss_weight : 10.0
kp3d_loss_weight : 10.0
kp2d_int_loss_weight : 10.0
kp3d_int_loss_weight : 10.0
align_3d_loss_weight : 0.0
joint_individual_weights : None
use_joint_valid_mask : False
fix_root : True
bbox_3d_shape :
  - 1300
  - 1300
  - 1300
reference_keypoint_id : 3
use_rootnet : True
rootnet_depth_loss_weight : 1.0
use_rootnet_xy_branch : False
pretrained_rootnet : None
use_origin_bbox : False
use_extended_bbox : True
use_rootnet_with_reg_int_shared_backbone : True
resume_run : False
resume_experiment_name : "none"
"""

# the validation errors printed beside the AUC (tag prefixes of
# pipelines/train_full.py::validate_full, each followed by "_<set>")
ERROR_TAGS = {"err2d": "Val/error2d_loss", "err3d": "Val/error3d_loss",
              "depth": "Val/depth_loss"}
BEST_CKPT = "curr_best_auc(add)_model.pk"


def generate(workdir: str, robot: str, n_train: int, n_test: int, hw,
             view_mode: str):
    """The rendered train and test sets under <workdir>/data/dream, unless
    a set of this size is there already."""
    from horopose_tpu_torch.tools.synth_dream import \
        make_synthetic_dream_dataset
    base = os.path.join(workdir, "data", "dream")
    done = os.path.join(workdir, "data", ".generated.json")
    want = {"robot": robot, "n_train": n_train, "n_test": n_test,
            "hw": list(hw), "view_mode": view_mode}
    if os.path.exists(done):
        with open(done) as f:
            if json.load(f) == want:
                print(f"[demo] datasets already generated under {base}")
                return
    print(f"[demo] rendering {n_train} train + {n_test} test images ...",
          flush=True)
    make_synthetic_dream_dataset(base, robot, n_images=n_train, seed=1000,
                                 image_hw=hw, split="train_dr",
                                 render_images=True, view_mode=view_mode)
    make_synthetic_dream_dataset(base, robot, n_images=n_test, seed=2000,
                                 image_hw=hw, split="test_dr",
                                 render_images=True, view_mode=view_mode)
    with open(done, "w") as f:
        json.dump(want, f)
    print("[demo] datasets ready", flush=True)


def _scalars(exp_dir: str):
    path = os.path.join(exp_dir, "log", "scalars.jsonl")
    if not os.path.exists(path):
        return
    with open(path) as f:
        for line in f:
            yield json.loads(line)


def auc_progression(exp_dir: str) -> Dict[int, Dict[str, float]]:
    """{epoch: {test set tag: held-out ADD AUC}} from the experiment's
    scalars.jsonl."""
    rows: Dict[int, Dict[str, float]] = {}
    for r in _scalars(exp_dir):
        if r["tag"].startswith("Val/AUC_ADD_"):
            rows.setdefault(int(r["step"]), {})[
                r["tag"].split("Val/AUC_ADD_")[1]] = r["value"]
    return rows


def progression(exp_dir: str) -> Dict[int, Dict[str, float]]:
    """auc_progression with each epoch's mean training loss ("loss") and
    the validation errors of ERROR_TAGS ("err2d_dr", ...)."""
    rows = auc_progression(exp_dir)
    for r in _scalars(exp_dir):
        epoch, tag = int(r["step"]), r["tag"]
        if tag == "Train/loss_epoch":
            rows.setdefault(epoch, {})["loss"] = r["value"]
        for name, prefix in ERROR_TAGS.items():
            if tag.startswith(prefix + "_"):
                rows.setdefault(epoch, {})[
                    f"{name}{tag[len(prefix):]}"] = r["value"]
    return rows


def format_row(epoch: int, row: Dict[str, float]) -> str:
    loss = row.get("loss", math.nan)
    rest = "  ".join(f"{k}={v:.4f}" for k, v in sorted(row.items())
                     if k != "loss")
    return f"  epoch {epoch:3d}: loss={loss:.4f}  {rest}"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", default="horopose_demo")
    p.add_argument("--robot", default="panda")
    p.add_argument("--n-train", type=int, default=512)
    p.add_argument("--n-test", type=int, default=64)
    p.add_argument("--image-hw", type=int, nargs=2, default=(480, 640))
    p.add_argument("--view-mode", default="upright",
                   choices=("upright", "random"),
                   help="the sets' viewpoints (tools/synth_dream.py)")
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--backbone", default="resnet50")
    p.add_argument("--rootnet-backbone", default="hrnet32")
    p.add_argument("--exp-name", default="demo_learn")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default: cuda)")
    p.add_argument("--skip-eval", action="store_true")
    args = p.parse_args(argv)

    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    generate(workdir, args.robot, args.n_train, args.n_test,
             tuple(args.image_hw), args.view_mode)

    from horopose_tpu_torch.config import make_cfg
    from horopose_tpu_torch.pipelines.train_full import train_full

    cfg_path = os.path.join(workdir, f"{args.exp_name}.yaml")
    with open(cfg_path, "w") as f:
        f.write(CONFIG_TEMPLATE.format(
            exp_name=args.exp_name, robot=args.robot,
            backbone=args.backbone, rootnet_backbone=args.rootnet_backbone,
            lr=args.lr, batch_size=args.batch_size,
            epoch_size=args.n_train, epochs=args.epochs,
            use_schedule=args.epochs > 20,
            start_decay=max(args.epochs // 2, 1), end_decay=args.epochs))
    cfg = make_cfg(cfg_path)
    # the sets this run wrote, whatever HOROPOSE_DATA_DIR says
    data = os.path.join(workdir, "data", "dream", "synthetic")
    cfg.train_ds_names = os.path.join(data, f"{args.robot}_synth_train_dr")
    print(f"[demo] training {args.epochs} epochs x "
          f"{args.n_train // args.batch_size} steps @b{args.batch_size} on "
          f"{args.device}", flush=True)
    exp_root = os.path.join(workdir, "experiments")
    train_full(cfg, device=args.device, exp_root=exp_root)

    exp_dir = os.path.join(exp_root, args.exp_name)
    rows = progression(exp_dir)
    print("\n[demo] progression (epoch: mean training loss, held-out ADD "
          "AUC by test set, validation 2-D / 3-D keypoint and depth "
          "errors):")
    for epoch in sorted(rows):
        print(format_row(epoch, rows[epoch]))

    if args.skip_eval:
        return
    ckpt = os.path.join(exp_dir, "ckpt", BEST_CKPT)
    if not os.path.exists(ckpt):
        print("[demo] no best checkpoint was saved (AUC never improved) — "
              "skipping the eval-harness replay")
        return
    from horopose_tpu_torch.pipelines.test import make_test_cfg, test_network
    tcfg = make_test_cfg(exp_dir, os.path.join(
        data, f"{args.robot}_synth_test_dr"))
    test_network(tcfg, ckpt_name=ckpt,
                 batch_size=min(args.batch_size, args.n_test),
                 device=args.device)
    summary = os.path.join(exp_dir, "result", "summary.txt")
    if os.path.exists(summary):
        print("\n[demo] result/summary.txt:")
        with open(summary) as f:
            print(f.read())


if __name__ == "__main__":
    main()
