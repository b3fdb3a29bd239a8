"""End-to-end inference: full frames in, robot state and pose out.

Port of `horopose_tpu/predictor.py`. Per frame: a bbox (the full frame when
none is given), the fused square-pad crop and bilinear resize on the card,
the k-value depth prior, the FullNet forward (its soft-argmax in the CUDA
kernel on a CUDA device), the FK lift, and the projection back into the
original frame.

Usage:
    pred = Predictor(FullNetConfig(), state_dict, device="cuda")
    pred = Predictor.from_experiment("experiments/<exp>")   # any checkpoint
    out = pred(images_uint8, K, bboxes=det_bboxes)   # (B, H, W, 3), (B, 3, 3)
    out["joints"], out["rotation"], out["translation"],
    out["keypoints_3d"], out["keypoints_2d"]
"""

from __future__ import annotations

import os
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from horopose_tpu_torch.data import roboutils as RU
from horopose_tpu_torch.data.crop import crop_resize_bilinear
from horopose_tpu_torch.ops.rotations import rot_to_rotmat
from horopose_tpu_torch.ops.transforms import (k_value_from_bbox,
                                               project_points)
from horopose_tpu_torch.pipelines.common import (FullNetConfig, build_fullnet,
                                                 crop_sizes, make_robot)
from horopose_tpu_torch.tools.export import ServingModule


class Predictor:
    def __init__(self, config: FullNetConfig,
                 state_dict: Mapping[str, torch.Tensor], device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.cfg = config
        self.device = torch.device(device)
        self.robot = make_robot(config, device=self.device)
        self.model = build_fullnet(config, dtype=dtype)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        # the forward the export tool exports, from the same pieces
        self.serving = ServingModule(self.model, self.robot,
                                     config.reference_keypoint_id)
        # the two crops share the bbox and differ only in resolution
        self.root_size, self.size = crop_sizes(config)

    @classmethod
    def from_experiment(cls, exp_path: str,
                        ckpt_name: str = "curr_best_auc(add)_model.pk",
                        device="cuda", dtype: torch.dtype = torch.float32
                        ) -> "Predictor":
        """The model of an experiment directory, the port's, the JAX
        package's or the reference's: its `config.yaml` and its checkpoint
        `ckpt/<ckpt_name>` (random weights from GLOBAL_SEED, with a
        warning, when that file is missing)."""
        from horopose_tpu_torch.config import make_cfg
        from horopose_tpu_torch.core.checkpoint import (load_checkpoint_file,
                                                        model_state_dict)
        from horopose_tpu_torch.pipelines.train_full import seeded_fullnet
        cfg = FullNetConfig.from_cfg(
            make_cfg(os.path.join(exp_path, "config.yaml")))
        model = seeded_fullnet(cfg)
        ckpt_path = os.path.join(exp_path, "ckpt", ckpt_name)
        if os.path.exists(ckpt_path):
            state_dict = model_state_dict(load_checkpoint_file(ckpt_path),
                                          model)
        else:
            print(f"[predictor] WARNING: {ckpt_path} missing, random init")
            state_dict = model.state_dict()
        return cls(cfg, state_dict, device=device, dtype=dtype)

    def preprocess(self, images: np.ndarray, K: np.ndarray,
                   bboxes: Optional[np.ndarray] = None
                   ) -> Tuple[torch.Tensor, ...]:
        """Crop and resize each frame on the device and adjust intrinsics.

        Returns (crops, crops_root) (B, S, S, 3) uint8 and K_crops (B, 3, 3),
        k_values (B,) float32, all on the device."""
        B, H, W = images.shape[:3]
        if bboxes is None:
            bboxes = np.tile(np.asarray([0, 0, W, H], np.float32)[None],
                             (B, 1))
        bboxes_strict = np.zeros((B, 4), np.int64)
        K_crops = np.empty((B, 3, 3), np.float32)
        for i in range(B):
            bbox = RU.get_bbox(bboxes[i], W, H)
            bboxes_strict[i] = bbox
            wmin, hmin, wmax, hmax = [int(v) for v in bbox]
            sq = int(max(wmax - wmin, hmax - hmin))
            K_sq = K[i].astype(np.float64).copy()
            K_sq[0, 2] -= (wmin - int((sq - (wmax - wmin)) // 2))
            K_sq[1, 2] -= (hmin - int((sq - (hmax - hmin)) // 2))
            K_crops[i] = RU.get_K_crop_resize_np(
                K_sq, (0.0, 0.0, float(sq), float(sq)), (sq, sq),
                (self.size, self.size))
        frames = torch.as_tensor(np.ascontiguousarray(images, np.uint8),
                                 device=self.device)
        boxes = torch.as_tensor(bboxes_strict, device=self.device)
        crops = crop_resize_bilinear(frames, boxes, self.size)
        crops_root = crops if self.root_size == self.size else \
            crop_resize_bilinear(frames, boxes, self.root_size)
        # k prior: the strict ORIGINAL-frame bbox with the ORIGINAL
        # intrinsics, as training pairs them (the crop K would scale k by
        # size/sq and bias the root depth)
        K_orig = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        k_values = k_value_from_bbox(boxes.float(), K_orig[:, 0, 0].abs(),
                                     K_orig[:, 1, 1].abs())
        return (crops, crops_root,
                torch.as_tensor(K_crops, device=self.device), k_values)

    @torch.inference_mode()
    def forward(self, crops: torch.Tensor, crops_root: torch.Tensor,
                k_values: torch.Tensor, K_crops: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """FullNet forward and FK lift on preprocessed device tensors
        (`tools/export.py::ServingModule.outputs`)."""
        return self.serving.outputs(crops, crops_root, k_values, K_crops)

    def __call__(self, images: np.ndarray, K: np.ndarray,
                 bboxes: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """images (B, H, W, 3) uint8 full frames; K (B, 3, 3); bboxes
        (B, 4) xyxy robot boxes (the full frame when omitted)."""
        crops, crops_root, K_crops, k_values = self.preprocess(
            images, K, bboxes)
        B = crops.shape[0]
        if B == 0:
            # no detections: run one dummy row and trim, so the outputs
            # keep their shapes without a batch-0 path through the model
            out = self.forward(
                crops.new_zeros(1, *crops.shape[1:]),
                crops_root.new_zeros(1, *crops_root.shape[1:]),
                k_values.new_ones(1),
                torch.eye(3, device=self.device)[None])
            out = {k: v[:0] for k, v in out.items()}
        else:
            out = self.forward(crops, crops_root, k_values, K_crops)
        with torch.inference_mode():
            K_orig = torch.as_tensor(np.asarray(K, np.float32),
                                     device=self.device)
            kp2d = project_points(K_orig, out["xyz_fk"])
            rotation = rot_to_rotmat(out["rot"])
        return {k: v.cpu().numpy() for k, v in dict(
            joints=out["pose"], rotation=rotation,
            translation=out["trans"], root_depth=out["depth"],
            keypoints_3d=out["xyz_fk"],
            keypoints_3d_integral=out["xyz_int"],
            keypoints_2d=kp2d).items()}
