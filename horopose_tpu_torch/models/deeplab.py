"""DeepLabV3-ResNet50 segmentation teacher with the CtRNet keypoint head.

Port of `horopose_tpu/models/deeplab.py`, NCHW: a ResNet-50 of output
stride 8 (layer3 and layer4 dilated 2 and 4, stride 1; the first block of
a dilated stage keeps the previous dilation, as torchvision's
replace_stride_with_dilation does), ASPP (rates 12, 24, 36 and an
image-pooling branch, projected to 256), a 3x3 conv and a 1x1 classifier
to one mask logit; a ConvTranspose read-out to a keypoint heatmap at 1/4
resolution and a spatial soft-argmax. `SegTeacher` is the frozen mask
producer of the sim2real stage (half-scale resize with antialiasing,
ImageNet normalisation, sigmoid); `CtRNetInference` adds the camera-to-robot
pose by PnP of its keypoints against FK.

The ResNet's module names are torchvision's (`conv1`, `layer3.0.conv2`,
`downsample.0`); `tools/jax_weights.py::seg_teacher_state_dict_from_jax`
maps the JAX teacher's variables onto them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from horopose_tpu_torch.models.resnet import batch_norm

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_bn_relu(cin: int, cout: int, k: int = 1, dilation: int = 1):
    return nn.Sequential(
        nn.Conv2d(cin, cout, k, padding=dilation if k == 3 else 0,
                  dilation=dilation, bias=False),
        batch_norm(cout), nn.ReLU(inplace=True))


class DilatedBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 dilation: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = batch_norm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, padding=dilation,
                               dilation=dilation, bias=False)
        self.bn2 = batch_norm(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = batch_norm(filters * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or cin != filters * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, filters * 4, 1, stride, bias=False),
                batch_norm(filters * 4))

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class DilatedResNet50(nn.Module):
    """ResNet-50 trunk of output stride 8: (B, 3, H, W) -> (B, 2048, H/8,
    W/8)."""
    stage_sizes = (3, 4, 6, 3)

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)   # pads with -inf, as flax
        strides, dilations = (1, 2, 1, 1), (1, 1, 2, 4)
        cin, prev_d = 64, 1
        for stage, (n, s, d) in enumerate(zip(self.stage_sizes, strides,
                                              dilations)):
            blocks = []
            for i in range(n):
                blocks.append(DilatedBottleneck(
                    cin, 64 * 2 ** stage, stride=s if i == 0 else 1,
                    dilation=prev_d if i == 0 else d))
                cin = 64 * 2 ** stage * 4
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
            prev_d = d

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


class ASPP(nn.Module):
    """branches.0: 1x1; branches.1-3: 3x3 at the atrous rates; branches.4:
    the image-pooling 1x1; project: 1x1 over their concatenation."""

    def __init__(self, cin: int = 2048, rates=(12, 24, 36),
                 channels: int = 256):
        super().__init__()
        self.branches = nn.ModuleList(
            [_conv_bn_relu(cin, channels)]
            + [_conv_bn_relu(cin, channels, 3, r) for r in rates]
            + [_conv_bn_relu(cin, channels)])
        self.project = _conv_bn_relu(channels * (len(rates) + 2), channels)

    def forward(self, x):
        ys = [b(x) for b in self.branches[:-1]]
        g = self.branches[-1](x.mean(dim=(2, 3), keepdim=True))
        ys.append(g.expand(-1, -1, x.shape[2], x.shape[3]))
        return self.project(torch.cat(ys, dim=1))


class KeypointSegNet(nn.Module):
    """Seg mask logits and 2-D keypoints, as CtRNet's KeyPointSegNet."""

    def __init__(self, num_keypoints: int = 7):
        super().__init__()
        self.backbone = DilatedResNet50()
        self.read_out = nn.ConvTranspose2d(2048, num_keypoints, 4, 2, 1)
        self.aspp = ASPP()
        self.cls_conv = nn.Conv2d(256, 256, 3, padding=1, bias=False)
        self.cls_bn = batch_norm(256)
        self.cls_final = nn.Conv2d(256, 1, 1)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        """x (B, 3, H, W) ImageNet-normalised -> (keypoints (B, K, 2) in
        pixels, seg logits (B, 1, H, W))."""
        B, _, H, W = x.shape
        feat = self.backbone(x)
        hm = self.read_out(feat)                      # (B, K, H/4, W/4)
        Hh, Wh = hm.shape[2], hm.shape[3]
        probs = torch.softmax(hm.float().flatten(2), dim=-1)
        ys = torch.linspace(-1.0, 1.0, Hh, device=x.device)
        xs = torch.linspace(-1.0, 1.0, Wh, device=x.device)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        kp = torch.stack([probs @ gx.reshape(-1), probs @ gy.reshape(-1)],
                         dim=-1)                      # (B, K, 2) in [-1, 1]
        kp = (kp + 1.0) * torch.tensor([W // 2, H // 2], dtype=torch.float32,
                                       device=x.device)
        y = torch.relu(self.cls_bn(self.cls_conv(self.aspp(feat))))
        seg = F.interpolate(self.cls_final(y).float(), size=(H, W),
                            mode="bilinear", align_corners=False)
        return kp, seg


class SegTeacher(nn.Module):
    """Frozen mask producer: uint8 full frames (B, H, W, 3) -> sigmoid
    foreground masks (B, H*scale, W*scale). Always in eval mode."""

    def __init__(self, image_hw=(480, 640), scale: float = 0.5,
                 num_keypoints: int = 7):
        super().__init__()
        self.model = KeypointSegNet(num_keypoints)
        self.out_hw = (int(image_hw[0] * scale), int(image_hw[1] * scale))
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN).reshape(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD).reshape(
            1, 3, 1, 1), persistent=False)
        self.requires_grad_(False)
        self.eval()

    def train(self, mode: bool = True):
        return super().train(False)

    @classmethod
    def init_random(cls, seed: int = 0, image_hw=(480, 640),
                    scale: float = 0.5, num_keypoints: int = 7):
        """A teacher with random weights from a CPU generator (for debug
        runs without the converted CtRNet weights)."""
        from horopose_tpu_torch.pipelines.common import random_state_dict
        teacher = cls(image_hw, scale, num_keypoints)
        teacher.model.load_state_dict(random_state_dict(teacher.model, seed))
        return teacher

    def normalize(self, images_uint8: torch.Tensor) -> torch.Tensor:
        """uint8 (B, H, W, 3) -> the network's input (B, 3, h, w): resized
        to out_hw with antialiasing (as jax.image.resize downsamples), then
        ImageNet-normalised."""
        x = images_uint8.permute(0, 3, 1, 2).float() / 255.0
        x = F.interpolate(x, size=self.out_hw, mode="bilinear",
                          align_corners=False, antialias=True)
        return (x - self.mean) / self.std

    def forward(self, images_uint8: torch.Tensor) -> torch.Tensor:
        _, seg = self.model(self.normalize(images_uint8))
        return torch.sigmoid(seg[:, 0])


class CtRNetInference:
    """CtRNet-style inference: masks, 2-D keypoints, and the camera-to-robot
    pose by PnP against the robot's FK keypoints."""

    def __init__(self, teacher: SegTeacher, robot, scale: float = 0.5):
        self.teacher = teacher
        self.robot = robot
        self.scale = scale

    @torch.no_grad()
    def __call__(self, images_uint8: torch.Tensor, joint_angles: torch.Tensor,
                 K: torch.Tensor):
        """Returns (masks, keypoints_2d in full-resolution pixels, (R, t))."""
        from horopose_tpu_torch.ops.pnp import pnp
        kp, seg = self.teacher.model(self.teacher.normalize(images_uint8))
        kp_full = kp / self.scale
        pts3d = self.robot.get_keypoints_only_fk(joint_angles)
        return torch.sigmoid(seg[:, 0]), kp_full, pnp(kp_full, pts3d, K)
