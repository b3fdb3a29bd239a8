"""HRNet (pose_hrnet w32/w48), NCHW, pose-HRNet naming.

Port of `horopose_tpu/models/hrnet.py`: stem, Bottleneck layer1, three
multi-branch stages with SUM fuse layers, an optional heatmap head
(num_joints*depth_dim channels from the high-resolution branch) and an
optional classification head giving a 2048-d feature. Module names are the
reference checkpoints' keys (`transition1.0.0`, `stage2.0.branches.0.0`,
`stage2.0.fuse_layers.i.j.k.0`, `incre_modules.i.0`, `downsamp_modules.i.0`,
`final_feat_layer.0/1`).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from horopose_tpu_torch.models.resnet import (BasicBlock, Bottleneck,
                                              batch_norm, conv3x3)


def _conv_bn(cin: int, cout: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [conv3x3(cin, cout, stride), batch_norm(cout)]
    if relu:
        layers.append(nn.ReLU(inplace=True))
    return nn.Sequential(*layers)


class HighResolutionModule(nn.Module):
    def __init__(self, num_branches: int, num_blocks: int,
                 channels: Sequence[int], multi_scale_output: bool = True):
        super().__init__()
        self.num_branches = num_branches
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(channels[b], channels[b])
                            for _ in range(num_blocks)])
            for b in range(num_branches))
        out_branches = num_branches if multi_scale_output else 1
        fuse = []
        for i in range(out_branches):
            row = []
            for j in range(num_branches):
                if j > i:
                    # nearest upsample by 2**(j-i) == repeat along H and W
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        batch_norm(channels[i]),
                        nn.Upsample(scale_factor=2 ** (j - i),
                                    mode="nearest")))
                elif j == i:
                    row.append(None)
                else:
                    row.append(nn.Sequential(*[
                        _conv_bn(channels[j],
                                 channels[i] if k == i - j - 1 else channels[j],
                                 2, relu=k != i - j - 1)
                        for k in range(i - j)]))
            fuse.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(fuse)
        self.relu = nn.ReLU(inplace=True)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [self.branches[b](xs[b]) for b in range(self.num_branches)]
        outs = []
        for row in self.fuse_layers:
            acc = None
            for j, layer in enumerate(row):
                y = ys[j] if layer is None else layer(ys[j])
                acc = y if acc is None else acc + y
            outs.append(self.relu(acc))
        return outs


def _transition(prev: Sequence[int], new: Sequence[int]) -> nn.ModuleList:
    """Adapt the previous stage's branch channels, add one deeper branch."""
    layers = []
    for i, ch in enumerate(new):
        if i < len(prev):
            layers.append(_conv_bn(prev[i], ch, 1, relu=True)
                          if ch != prev[i] else None)
        else:
            layers.append(nn.Sequential(*[
                _conv_bn(prev[-1], ch if j == i - len(prev) else prev[-1], 2,
                         relu=True)
                for j in range(i + 1 - len(prev))]))
    return nn.ModuleList(layers)


class HRNet(nn.Module):
    """Pose HRNet. Input (B, 3, H, W). Returns, by flags:
    generate_hm and generate_feat -> (heatmap (B, K*D, H/4, W/4), feat (B, 2048));
    generate_hm only -> heatmap; generate_feat only -> feat."""

    def __init__(self, width: int = 32, num_joints: int = 7,
                 depth_dim: int = 64, generate_hm: bool = True,
                 generate_feat: bool = True):
        super().__init__()
        w = width
        self.generate_hm = generate_hm
        self.generate_feat = generate_feat
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = batch_norm(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.layer1 = nn.Sequential(*[Bottleneck(64 if i == 0 else 256, 64)
                                      for i in range(4)])
        c2, c3, c4 = [w, 2 * w], [w, 2 * w, 4 * w], [w, 2 * w, 4 * w, 8 * w]
        self.transition1 = _transition([256], c2)
        self.stage2 = nn.Sequential(HighResolutionModule(2, 4, c2))
        self.transition2 = _transition(c2, c3)
        self.stage3 = nn.Sequential(*[HighResolutionModule(3, 4, c3)
                                      for _ in range(4)])
        self.transition3 = _transition(c3, c4)
        self.stage4 = nn.Sequential(*[
            HighResolutionModule(4, 4, c4, multi_scale_output=(
                generate_feat or m != 2)) for m in range(3)])
        if generate_hm:
            self.final_layer = nn.Conv2d(w, num_joints * depth_dim, 1)
        if generate_feat:
            head = [32, 64, 128, 256]
            self.incre_modules = nn.ModuleList(
                nn.Sequential(Bottleneck(c4[i], head[i])) for i in range(4))
            self.downsamp_modules = nn.ModuleList(
                nn.Sequential(nn.Conv2d(head[i] * 4, head[i + 1] * 4, 3, 2, 1),
                              batch_norm(head[i + 1] * 4),
                              nn.ReLU(inplace=True))
                for i in range(3))
            self.final_feat_layer = nn.Sequential(
                nn.Conv2d(head[3] * 4, 2048, 1), batch_norm(2048),
                nn.ReLU(inplace=True))

    @staticmethod
    def _run_transition(transition: nn.ModuleList, xs):
        out = []
        for i, layer in enumerate(transition):
            if layer is None:
                out.append(xs[i])
            elif i < len(xs):
                out.append(layer(xs[i]))
            else:
                out.append(layer(xs[-1]))
        return out

    def _run_stage(self, stage: nn.Sequential, xs):
        for module in stage:
            xs = module(xs)
        return xs

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.relu(self.bn2(self.conv2(x)))
        x = self.layer1(x)
        xs = self._run_stage(self.stage2,
                             self._run_transition(self.transition1, [x]))
        xs = self._run_stage(self.stage3,
                             self._run_transition(self.transition2, xs))
        xs = self._run_stage(self.stage4,
                             self._run_transition(self.transition3, xs))
        outputs = ()
        if self.generate_hm:
            outputs += (self.final_layer(xs[0]),)
        if self.generate_feat:
            y = self.incre_modules[0](xs[0])
            for i in range(3):
                y = self.incre_modules[i + 1](xs[i + 1]) + \
                    self.downsamp_modules[i](y)
            y = self.final_feat_layer(y)
            outputs += (y.mean(dim=(2, 3)),)   # global average pool
        return outputs if len(outputs) > 1 else outputs[0]


def get_hrnet(width: int = 32, num_joints: int = 7, depth_dim: int = 64,
              generate_hm: bool = True, generate_feat: bool = True) -> HRNet:
    return HRNet(width=width, num_joints=num_joints, depth_dim=depth_dim,
                 generate_hm=generate_hm, generate_feat=generate_feat)
