"""DREAM-format dataset reader.

Port of `horopose_tpu/data/dream.py`. Each sample is a jpg + a per-image
json (objects[0] with quaternion_xyzw / location / keypoints /
bounding_box; sim_state.joints) plus a per-directory
_camera_settings.json. The reader builds the ground truth as the JAX one
does:
  - TCO with the UE coordinate fix R_NORMAL_UE and the 0.01 translation
    scale on synthetic sets,
  - three bbox variants (loose crop bbox / strict bounded / gt2d
    extended),
  - two crops per sample ("root" for DepthNet, "other" for the keypoint
    and regression branch), each with adjusted K, reprojected keypoints,
    and crop-validity masks,
  - the color-jitter / occlusion / Pillow augmentation stack.

Host side only: the frame is decoded with PIL (the JAX package's native
libjpeg decode is byte-identical to it) and the square crops are cut by
`data/crop.py::crop_resize_bilinear` on a CPU tensor of the one frame
(the twin of the JAX package's native C++ crop). Samples are dicts of
numpy arrays; `data.samplers.collate` stacks them into CPU tensors.

Random draws: `get(idx, rng, np_rng)` takes its generators;
`dataset[(seed, epoch, idx)]` seeds them from the three numbers
(`sample_generators`), so a sample's augmentations depend on which sample
and epoch it is, not on which worker process loads it. `dataset[idx]` is
`dataset[(DEFAULT_SEED, 0, idx)]`.
"""

from __future__ import annotations

import json
import os
import random
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
from PIL import Image

from horopose_tpu_torch import constants as C
from horopose_tpu_torch.data import roboutils as RU
from horopose_tpu_torch.data.augmentations import (apply_color_jitter,
                                                   apply_occlusion,
                                                   apply_pillow_augs,
                                                   crop_resize_to_aspect,
                                                   flip_image_and_annotations)
from horopose_tpu_torch.data.crop import crop_resize_bilinear

# ids with corrupt annotations in the public kuka train set
KUKA_SYNT_TRAIN_DR_INCORRECT_IDS = {83114, 28630}
# the loaders' default worker seed
DEFAULT_SEED = 808

R_NORMAL_UE = np.array([
    [0, -1, 0],
    [0, 0, -1],
    [1, 0, 0],
], dtype=np.float64)


def _quat_xyzw_to_rotmat(q: np.ndarray) -> np.ndarray:
    """The reference's quaternion decode: the xyzw data is unpacked
    positionally as (w, x, y, z)."""
    q = q / np.linalg.norm(q)
    w, x, y, z = q
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return np.array([
        [w2 - x2 - y2 + z2, -2 * yz + 2 * wx, 2 * wy + 2 * xz],
        [2 * wx + 2 * yz, -(w2 - x2 + y2 - z2), 2 * xy - 2 * wz],
        [-2 * xz + 2 * wy, 2 * wz + 2 * xy, -(w2 + x2 - y2 - z2)],
    ])


def build_frame_index(base_dir: Path) -> List[Dict]:
    """Sorted (rgb_path, scene_id, view_id) index."""
    base_dir = Path(base_dir)
    infos = []
    for im_path in sorted(base_dir.glob("*.jpg")):
        view_id = int(im_path.with_suffix("").with_suffix("").name)
        if view_id == 0 and "panda_synth_test_photo" in str(base_dir):
            continue
        if "kuka_synth_train_dr" in str(base_dir) and \
                view_id in KUKA_SYNT_TRAIN_DR_INCORRECT_IDS:
            continue
        infos.append(dict(rgb_path=str(im_path), scene_id=view_id,
                          view_id=view_id))
    return infos


def sample_generators(seed: int, epoch: int, idx: int
                      ) -> Tuple[random.Random, np.random.RandomState]:
    """The (random.Random, RandomState) pair of sample `idx` in `epoch`
    of a loader seeded with `seed`."""
    a, b = np.random.SeedSequence([seed, epoch, idx]).generate_state(2)
    return random.Random(int(a)), np.random.RandomState(int(b))


def decode_rgb(path) -> np.ndarray:
    """A jpg decoded to (H, W, 3) uint8 RGB."""
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


class DreamDataset:
    def __init__(self, base_dir,
                 rootnet_resize_hw=(256, 256),
                 other_resize_hw=(256, 256),
                 strict_crop=True,
                 color_jitter=True,
                 rgb_augmentation=True,
                 occlusion_augmentation=True,
                 occlu_p=0.5,
                 extend_ratio=(0.2, 0.13),
                 flip=False,
                 process_truncation=False,
                 truncation_padding=(120, 120, 120, 120),
                 padding=False,
                 padding_pixel=30,
                 return_original_image=False,
                 decode_cache_dir=None):
        self.base_dir = Path(base_dir)
        self.ds_name = os.path.basename(str(base_dir))
        self.rootnet_resize_hw = tuple(rootnet_resize_hw)
        self.other_resize_hw = tuple(other_resize_hw)
        self.strict_crop = strict_crop
        self.color_jitter = color_jitter
        self.rgb_augmentation = rgb_augmentation
        self.occlusion_augmentation = occlusion_augmentation
        self.occlu_p = occlu_p
        self.extend_ratio = list(extend_ratio)
        self.flip = flip
        self.process_truncation = process_truncation
        self.truncation_padding = list(truncation_padding)
        self.padding = padding
        self.padding_pixel = padding_pixel
        self.return_original_image = return_original_image

        self.frame_index = build_frame_index(self.base_dir)
        # decoded-jpg memmap cache (data/cache.py): epoch 1 fills it, later
        # epochs skip the decode. None = off (the default).
        self.decode_cache = None
        if decode_cache_dir:
            from horopose_tpu_torch.data.cache import (DecodedImageCache,
                                                       dataset_fingerprint)
            try:
                self.decode_cache = DecodedImageCache(
                    decode_cache_dir, len(self.frame_index),
                    fingerprint=dataset_fingerprint(
                        self.base_dir,
                        [r["rgb_path"] for r in self.frame_index]))
            except OSError as e:
                print(f"[data] decode cache disabled ({e})")
        s = str(base_dir)
        if "panda" in s:
            self.label = "panda"
        elif "baxter" in s:
            self.label = "baxter"
        elif "kuka" in s:
            self.label = "kuka"
        else:
            raise NotImplementedError(f"cannot infer robot from {base_dir}")
        self.keypoint_names = C.KEYPOINT_NAMES[self.label]
        self.joint_names = C.JOINT_NAMES[self.label]
        self.synthetic = not ("panda-3cam" in self.ds_name or
                              "panda-orb" in self.ds_name)
        self.scale = 0.01 if "synthetic" in s else 1.0

        cam_path = self.base_dir / "_camera_settings.json"
        if cam_path.exists():
            cam = json.loads(cam_path.read_text())
            if len(cam["camera_settings"]) != 1:
                raise ValueError(f"{cam_path}: one camera expected")
            intr = cam["camera_settings"][0]["intrinsic_settings"]
            self._fx, self._fy = intr["fx"], intr["fy"]
            self._cx, self._cy = intr["cx"], intr["cy"]
        else:
            self._fx = self._fy = 320.0
            self._cx = self._cy = None  # -> w/2, h/2 at read time

    def __len__(self):
        return len(self.frame_index)

    # ------------------------------------------------------------------
    def _make_crop(self, rgb, bbox, K_original, keypoints_3d,
                   bbox_strict_bounded_original, resize_hw, rng,
                   flip=False):
        """Square-pad crop -> resize -> K update -> reprojected keypoints."""
        if resize_hw[0] == resize_hw[1]:
            # one pass from source pixels to the crop (align_corners=False
            # bilinear, the twin of the JAX package's native crop)
            crop = crop_resize_bilinear(
                torch.from_numpy(rgb)[None],
                torch.as_tensor(np.asarray(bbox, np.int64))[None],
                resize_hw[0])[0].numpy()
            wmin, hmin, wmax, hmax = [int(v) for v in bbox]
            sq = int(max(wmax - wmin, hmax - hmin))
            x_off = int((sq - (wmax - wmin)) // 2)
            y_off = int((sq - (hmax - hmin)) // 2)
            K_sq = K_original.copy()
            K_sq[0, 2] -= (wmin - x_off)
            K_sq[1, 2] -= (hmin - y_off)
            K_new = RU.get_K_crop_resize_np(
                K_sq, (0.0, 0.0, float(sq), float(sq)), (sq, sq), resize_hw)
            kp_h = (K_new @ keypoints_3d.T).T
            kp2d = kp_h[:, :2] / kp_h[:, 2:3]
        else:
            kp2d_dummy = np.zeros((len(keypoints_3d), 2), np.float64)
            square, _, K_sq = RU.resize_image(rgb, bbox, kp2d_dummy,
                                              K_original.copy())
            crop, K_new, kp2d = crop_resize_to_aspect(
                square, K_sq, keypoints_3d, resize=resize_hw)
        if self.padding:
            # zoom-out border augmentation: pad the crop by padding_pixel
            # and resize back to the target size, with the matching K
            # update; keypoints are re-projected from 3D through the new K
            p = int(self.padding_pixel)
            S = resize_hw[0]
            canvas = np.zeros((S + 2 * p, S + 2 * p, 3), np.uint8)
            canvas[p:p + S, p:p + S] = crop
            K_pad = K_new.copy()
            K_pad[0, 2] += p
            K_pad[1, 2] += p
            K_new = RU.get_K_crop_resize_np(
                K_pad, (0.0, 0.0, float(S + 2 * p), float(S + 2 * p)),
                (S + 2 * p, S + 2 * p), resize_hw)
            crop = np.asarray(Image.fromarray(canvas).resize(
                (resize_hw[1], resize_hw[0]), Image.BILINEAR))
            kp_h = (K_new @ keypoints_3d.T).T
            kp2d = kp_h[:, :2] / kp_h[:, 2:3]
        if flip and rng.random() <= 0.5:
            pairs = C.FLIP_PAIRS if self.label == "baxter" else None
            crop, kp2d, K_new = flip_image_and_annotations(crop, kp2d,
                                                           K_new, pairs)
        K_original_inv = np.linalg.inv(K_original)
        bsb = RU.bbox_transform(bbox_strict_bounded_original, K_original_inv,
                                K_new, resize_hw=resize_hw)
        bsb = np.array([max(0, bsb[0]), max(0, bsb[1]),
                        min(resize_hw[0], bsb[2]), min(resize_hw[1], bsb[3])])
        gt2d_box = np.concatenate([kp2d.min(axis=0), kp2d.max(axis=0)])
        w_ = gt2d_box[2] - gt2d_box[0]
        h_ = gt2d_box[3] - gt2d_box[1]
        bbox_gt2d_extended = RU.get_extended_bbox(
            gt2d_box, w_ * self.extend_ratio[0], h_ * self.extend_ratio[1],
            w_ * self.extend_ratio[0], h_ * self.extend_ratio[1],
            bounded=True, image_size=resize_hw)
        valid_mask_crop = ((kp2d[:, 0] < resize_hw[0]) & (kp2d[:, 0] >= 0) &
                           (kp2d[:, 1] < resize_hw[1]) & (kp2d[:, 1] >= 0))
        return dict(
            images=np.ascontiguousarray(crop, np.uint8),
            K=K_new.astype(np.float32),
            keypoints_3d=keypoints_3d.astype(np.float32),
            keypoints_2d=kp2d.astype(np.float32),
            valid_mask_crop=valid_mask_crop.astype(np.float32),
            bbox_strict_bounded=bsb.astype(np.float32),
            bbox_gt2d_extended=np.asarray(bbox_gt2d_extended, np.float32),
        )

    # ------------------------------------------------------------------
    def __getitem__(self, key) -> Dict:
        """`key` is an index, or (seed, epoch, index) as the port's
        DataLoader passes it."""
        seed, epoch, idx = key if isinstance(key, tuple) else \
            (DEFAULT_SEED, 0, key)
        return self.get(int(idx), *sample_generators(seed, epoch, int(idx)))

    def get(self, idx: int, rng: random.Random,
            np_rng: np.random.RandomState) -> Dict:
        """Sample `idx`, its random draws from `rng` and `np_rng` in the
        JAX dataset's order."""
        row = self.frame_index[idx]
        rgb_path = Path(row["rgb_path"])
        rgb = self.decode_cache.get(idx) if self.decode_cache else None
        if rgb is None:
            rgb = decode_rgb(rgb_path)
            if self.decode_cache is not None:
                self.decode_cache.put(idx, rgb)
        h, w = rgb.shape[:2]
        ann = json.loads(
            rgb_path.with_suffix("").with_suffix(".json").read_text())

        cx = self._cx if self._cx is not None else w / 2
        cy = self._cy if self._cy is not None else h / 2
        K_original = np.array([[self._fx, 0, cx], [0, self._fy, cy],
                               [0, 0, 1]], np.float64)

        obj = ann["objects"][0]
        translation = np.array(obj["location"], np.float64) * self.scale
        TWO = np.eye(4)
        if "quaternion_xyzw" in obj:
            R = _quat_xyzw_to_rotmat(np.array(obj["quaternion_xyzw"],
                                              np.float64))
            TWO[:3, :3] = R @ R_NORMAL_UE
        TWO[:3, 3] = translation
        TCO = TWO  # TWC is identity in DREAM

        joints_raw = {d["name"].split("/")[-1]: float(d["position"])
                      for d in ann["sim_state"]["joints"]}
        if self.label == "kuka":
            joints_raw = {k.replace("iiwa7_", "iiwa_"): v
                          for k, v in joints_raw.items()}
        jointpose = np.array([joints_raw.get(j, 0.0)
                              for j in self.joint_names], np.float32)

        kp_data = obj["keypoints"]
        kp2d_all = np.unique(np.stack(
            [np.asarray(kp["projected_location"], np.float64)
             for kp in kp_data]), axis=0)
        bbox_gt2d = np.concatenate([kp2d_all.min(axis=0), kp2d_all.max(axis=0)])

        # K_work drives the crops; K_original stays as annotated
        K_work = K_original
        if self.process_truncation:
            # pad the canvas so a truncated robot's crop bbox fits, shifting
            # the working K; keypoints are recomputed from 3D through the
            # adjusted K downstream
            raw = RU.get_bbox_raw(bbox_gt2d)
            d = [max(0, int(-raw[0])), max(0, int(-raw[1])),
                 max(0, int(raw[2] - w)), max(0, int(raw[3] - h))]
            d = [min(m, v) for m, v in zip(self.truncation_padding, d)]
            if any(d):
                dl, dt, dr, db = d
                canvas = np.zeros((h + dt + db, w + dl + dr, 3), np.uint8)
                canvas[dt:dt + h, dl:dl + w] = rgb
                rgb = canvas
                h, w = rgb.shape[:2]
                K_work = K_original.copy()
                K_work[0, 2] += dl
                K_work[1, 2] += dt
                kp2d_all = kp2d_all + np.asarray([dl, dt], np.float64)
                bbox_gt2d = np.concatenate(
                    [kp2d_all.min(axis=0), kp2d_all.max(axis=0)])

        bbox = RU.get_bbox(bbox_gt2d, w, h, strict=self.strict_crop, rng=rng)
        bbox_gt2d_extended_original = RU.get_extended_bbox(
            bbox_gt2d, 20, 20, 20, 20, bounded=True, image_size=(w, h))
        if "bounding_box" in obj:
            bb = obj["bounding_box"]
            strict = np.array([bb["min"][0], bb["min"][1],
                               bb["max"][0], bb["max"][1]])
            bbox_strict_bounded = np.array([max(0, strict[0]),
                                            max(0, strict[1]),
                                            min(w, strict[2]),
                                            min(h, strict[3])])
        else:
            bbox_strict_bounded = bbox_gt2d_extended_original

        kp3d_map = {kp["name"]: np.asarray(kp["location"], np.float64) *
                    self.scale for kp in kp_data}
        keypoints_3d = np.stack([kp3d_map[k] for k in self.keypoint_names])
        kp2d_map = {kp["name"]: np.asarray(kp["projected_location"],
                                           np.float64) for kp in kp_data}
        keypoints_2d_original = np.stack([kp2d_map[k]
                                          for k in self.keypoint_names])
        valid_mask = ((keypoints_2d_original[:, 0] < 640.0) &
                      (keypoints_2d_original[:, 0] >= 0) &
                      (keypoints_2d_original[:, 1] < 480.0) &
                      (keypoints_2d_original[:, 1] >= 0))

        images_original = rgb
        if self.color_jitter:
            rgb = apply_color_jitter(rgb, rng, p=0.4)
        if self.occlusion_augmentation:
            rgb = apply_occlusion(rgb, bbox, self.occlu_p, rng, np_rng)
        if self.rgb_augmentation:
            rgb = apply_pillow_augs(rgb, rng)

        # a C-contiguous, writeable frame, which torch.from_numpy takes
        # without a copy or a warning
        rgb = np.require(rgb, np.uint8, ("C", "W"))
        root = self._make_crop(rgb, bbox, K_work, keypoints_3d,
                               bbox_strict_bounded, self.rootnet_resize_hw,
                               rng, flip=self.flip)
        other = self._make_crop(rgb, bbox, K_work, keypoints_3d,
                                bbox_strict_bounded, self.other_resize_hw,
                                rng)

        out = dict(
            image_id=np.int32(idx),
            scene_id=np.int32(row["scene_id"]),
            TCO=TCO.astype(np.float32),
            K_original=K_original.astype(np.float32),
            jointpose=jointpose,
            keypoints_2d_original=keypoints_2d_original.astype(np.float32),
            keypoints_3d_original=keypoints_3d.astype(np.float32),
            valid_mask=valid_mask.astype(np.float32),
            bbox_strict_bounded_original=np.asarray(bbox_strict_bounded,
                                                    np.float32),
            bbox_gt2d_extended_original=np.asarray(
                bbox_gt2d_extended_original, np.float32),
            root=root,
            other=other,
        )
        if self.return_original_image:
            out["images_original"] = images_original
        return out
