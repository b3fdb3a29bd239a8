"""Config system: the defaults and the YAML overlay of the JAX package.

Port of `horopose_tpu/config.py`: `make_default_cfg` gives the same keys
and values, and `make_cfg` overlays a config file with the same per-key
coercions. The port does not depend on PyYAML: `load_yaml` reads the
subset of YAML 1.1 that `configs/` uses, with PyYAML's rules for it:

- one `key : value` per line at the top level, `#` comments;
- quoted strings; plain scalars resolved as PyYAML's resolver does:
  `true`/`True`/`yes`/`on`... booleans, `~`/`null`/empty as None, decimal
  ints, floats only with a dot (`0.`, `1.0e-4`, `.5`), so `1e-4` stays the
  string "1e-4" (make_cfg applies float() to `lr`) and `None` stays the
  string "None" (make_cfg maps it to None for the keys that take a path);
- flow lists `[0.2, 0.13]` and block lists (`key :` then `- 1300` lines).

Anything else (nested mappings, anchors, multi-line strings, octal or
sexagesimal numbers) is outside the subset and raises or stays a string.
`remat` recomputes each backbone unit in the backward, as in the JAX
package (`models/common.py::remat_call`). `mesh_shape` must cover every
rank of a data-parallel run (`parallel/mesh.py::train_mesh`; the port
runs one process per card) and divide the test harness's batch;
`compute_dtype` picks the training dtype of `python -m
horopose_tpu_torch.scripts.train`.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional


class AttrDict(dict):
    """dict with attribute access."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


LOCAL_DATA_DIR = Path(os.environ.get("HOROPOSE_DATA_DIR", "data"))
DEPS_DIR = LOCAL_DATA_DIR / "deps"

# the user's robot descriptions (Robot falls back to its built-in ones
# when a file is absent)
PANDA_DESCRIPTION_PATH = str(DEPS_DIR / "panda-description/panda.urdf")
KUKA_DESCRIPTION_PATH = str(
    DEPS_DIR / "kuka-description/iiwa_description/urdf/iiwa7.urdf")
BAXTER_DESCRIPTION_PATH = str(
    DEPS_DIR / "baxter-description/baxter_description/urdf/baxter.urdf")

URDF_PATHS = {
    "panda": PANDA_DESCRIPTION_PATH,
    "kuka": KUKA_DESCRIPTION_PATH,
    "baxter": BAXTER_DESCRIPTION_PATH,
}


def resolve_urdf_path(robot_type: str) -> Optional[str]:
    """The user's URDF of `robot_type` under DEPS_DIR when the file
    exists, else None (the built-in description)."""
    p = URDF_PATHS.get(robot_type)
    return p if p and os.path.exists(p) else None


# PyYAML 1.1's implicit resolvers for the scalars of the subset
_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                       |\.[0-9_]+(?:[eE][-+][0-9]+)?
                       |[-+]?\.(?:inf|Inf|INF)
                       |\.(?:nan|NaN|NAN))$""", re.X)


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one at the start or after a space,
    outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str) -> Any:
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "\"'":
        return s[1:-1]
    if s in _NULL:
        return None
    if s.lower() in _BOOL and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOL[s.lower()]
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s):
        t = s.replace("_", "").lower()
        return float(t.replace(".inf", "inf").replace(".nan", "nan"))
    return s


def _value(text: str) -> Any:
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]"):
            raise ValueError(f"unterminated flow list: {s!r}")
        inner = s[1:-1].strip()
        return [_scalar(p) for p in inner.split(",")] if inner else []
    return _scalar(s)


def load_yaml(text: str) -> Dict[str, Any]:
    """A top-level mapping in the YAML subset described above."""
    out: Dict[str, Any] = {}
    pending: List = None            # the block list of the last empty key
    last_key = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line[0] in " \t-":
            item = line.strip()
            if last_key is None or not item.startswith("-") or (
                    out[last_key] is not None and pending is None):
                raise ValueError(f"line {lineno}: {raw!r} is outside the "
                                 f"YAML subset of configs/")
            if pending is None:
                pending = out[last_key] = []
            pending.append(_value(item[1:]))
            continue
        key, sep, value = line.partition(":")
        if not sep:
            raise ValueError(f"line {lineno}: no `key : value` in {raw!r}")
        last_key = key.strip()
        out[last_key] = _value(value)
        pending = None
    return out


def make_default_cfg() -> AttrDict:
    """The JAX package's defaults, key for key."""
    cfg = AttrDict()
    cfg.exp_name = "default"
    cfg.config_path = "default"

    # training
    cfg.no_cuda = False
    cfg.device_id = 0
    cfg.batch_size = 64
    cfg.epoch_size = 104950
    cfg.n_epochs = 700
    cfg.n_dataloader_workers = int(os.environ.get("N_CPUS", 10)) - 2
    cfg.clip_gradient = 10.0

    # data
    cfg.urdf_robot_name = "panda"
    cfg.train_ds_names = os.path.abspath(
        str(LOCAL_DATA_DIR / "dream/real/panda_synth_train_dr"))
    cfg.image_size = 256.0

    # augmentation
    cfg.jitter = True
    cfg.other_aug = True
    cfg.occlusion = True
    cfg.occlu_p = 0.5
    cfg.padding = False
    cfg.fix_truncation = False
    cfg.truncation_padding = [120, 120, 120, 120]
    cfg.rootnet_flip = False

    # pipeline selection
    cfg.use_rootnet = False
    cfg.use_rootnet_with_reg_int_shared_backbone = False
    cfg.use_sim2real = False
    cfg.use_sim2real_real = False
    cfg.pretrained_rootnet = None
    cfg.pretrained_weight_on_synth = None
    cfg.backbone_pretrained = None
    cfg.rootnet_backbone_pretrained = None
    cfg.use_view = False
    cfg.known_joint = False

    # optimizer / schedule
    cfg.lr = 1e-4
    cfg.weight_decay = 0.0
    cfg.use_schedule = False
    cfg.schedule_type = ""
    cfg.n_epochs_warmup = 0
    cfg.start_decay = 100
    cfg.end_decay = 200
    cfg.final_decay = 0.01
    cfg.exponent = 1.0
    cfg.step_decay = 0.1
    cfg.step = 5

    # model
    cfg.backbone_name = "resnet50"
    cfg.rootnet_backbone_name = "hrnet32"
    cfg.rootnet_image_size = None       # None: follow image_size
    cfg.other_image_size = None
    cfg.n_iter = 4
    cfg.p_dropout = 0.5
    cfg.use_rpmg = False
    cfg.reg_joint_map = False
    cfg.joint_conv_dim = []
    cfg.rotation_dim = 6
    cfg.direct_reg_rot = False
    cfg.rot_iterative_matmul = False
    cfg.fix_root = True
    cfg.reg_from_bb_out = False
    cfg.depth_from_bb_out = False
    cfg.bbox_3d_shape = [1300, 1300, 1300]
    cfg.reference_keypoint_id = 3
    cfg.resample = False
    cfg.use_origin_bbox = False
    cfg.use_extended_bbox = True
    cfg.extend_ratio = [0.2, 0.13]
    cfg.use_offset = False
    cfg.use_rootnet_xy_branch = False
    cfg.add_fc = False
    cfg.multi_kp = False
    cfg.kps_need_depth = None

    # losses
    cfg.pose_loss_func = "mse"
    cfg.rot_loss_func = "mse"
    cfg.trans_loss_func = "l2norm"
    cfg.uv_loss_func = "l2norm"
    cfg.depth_loss_func = "l1"
    cfg.kp3d_loss_func = "l2norm"
    cfg.kp2d_loss_func = "l2norm"
    cfg.kp3d_int_loss_func = "l2norm"
    cfg.kp2d_int_loss_func = "l2norm"
    cfg.align_3d_loss_func = "l2norm"
    cfg.pose_loss_weight = 0.0
    cfg.rot_loss_weight = 0.0
    cfg.trans_loss_weight = 0.0
    cfg.uv_loss_weight = 0.0
    cfg.depth_loss_weight = 0.0
    cfg.kp2d_loss_weight = 0.0
    cfg.kp3d_loss_weight = 0.0
    cfg.kp2d_int_loss_weight = 0.0
    cfg.kp3d_int_loss_weight = 0.0
    cfg.align_3d_loss_weight = 0.0
    cfg.joint_individual_weights = None
    cfg.use_joint_valid_mask = False
    cfg.fix_mask = False
    cfg.rootnet_depth_loss_weight = 1.0
    cfg.xy_loss_func = "l1"
    cfg.allow_random_teacher = False
    cfg.allow_random_init = False
    cfg.mask_loss_func = "mse_mean"
    cfg.mask_loss_weight = 0.0
    cfg.scale_loss_weight = 0.0
    cfg.iou_loss_weight = 0.0

    # resume
    cfg.resume_run = False
    cfg.resume_experiment_name = "resume_name"

    # the JAX package's extensions, each honoured by the port
    cfg.mesh_shape = None
    cfg.compute_dtype = "float32"
    cfg.remat = False     # backbone units recomputed in the backward
    cfg.debug_nans = False
    cfg.profile_dir = None
    cfg.decode_cache = False
    cfg.decode_cache_dir = ""
    cfg.prefetch_batches = 2
    cfg.raster_faces_per_tile = "auto"
    return cfg


def make_cfg(config_path: str) -> AttrDict:
    """Overlay a YAML file on the defaults with the per-key coercions of
    the JAX `make_cfg`; unknown keys are dropped."""
    cfg = make_default_cfg()
    cfg.config_path = str(config_path)
    with open(config_path, encoding="utf-8") as f:
        overrides = load_yaml(f.read())
    for k, v in overrides.items():
        if k not in cfg:
            continue
        if k == "n_dataloader_workers":
            cfg[k] = min(cfg[k], v)
        elif k == "train_ds_names":
            cfg[k] = os.path.abspath(str(LOCAL_DATA_DIR / v))
            if "move" in str(v):
                cfg[k] = v
        elif k in ("lr", "exponent") or k.endswith("loss_weight"):
            cfg[k] = float(v)
        elif k in ("joint_individual_weights", "pretrained_rootnet",
                   "pretrained_weight_on_synth", "backbone_pretrained",
                   "rootnet_backbone_pretrained"):
            cfg[k] = None if v == "None" else v
        elif k == "extend_ratio":
            cfg[k] = list(v)
        else:
            cfg[k] = v
    return cfg
