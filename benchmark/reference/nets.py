"""The two backbones of the flagship FullNet in plain PyTorch, NCHW.

A frozen copy of the architecture the benchmark's configurations name:
the resnet50 trunk (torchvision's layout, output stride 32, no pooling or
classifier) and the hrnet32 network with its 2048-d classification head
and no heatmap head (the root-depth branch). Module names are the
checkpoint keys both sides of the comparison load, so one state dict
serves the program and this reference. BatchNorm: eps 1e-5, momentum 0.1.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn


def bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), bn(cout))


class BasicBlock(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = conv3x3(cin, filters, stride)
        self.bn1 = bn(filters)
        self.conv2 = conv3x3(filters, filters)
        self.bn2 = bn(filters)
        self.relu = nn.ReLU()
        self.downsample = _downsample(cin, filters, stride)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        return self.relu(self.bn2(self.conv2(y)) + residual)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = bn(filters)
        self.conv2 = conv3x3(filters, filters, stride)
        self.bn2 = bn(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = bn(filters * 4)
        self.relu = nn.ReLU()
        self.downsample = _downsample(cin, filters * 4, stride)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        return self.relu(self.bn3(self.conv3(y)) + residual)


class ResNet50(nn.Module):
    """(B, 3, H, W) -> (B, 2048, H/32, W/32)."""

    feature_channels = 2048

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = bn(64)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for stage, n in enumerate((3, 4, 6, 3)):
            blocks = []
            for i in range(n):
                blocks.append(Bottleneck(cin, 64 * 2 ** stage,
                                         2 if stage > 0 and i == 0 else 1))
                cin = 256 * 2 ** stage
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


def _conv_bn(cin: int, cout: int, stride: int, relu: bool) -> nn.Sequential:
    layers = [conv3x3(cin, cout, stride), bn(cout)]
    if relu:
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


class HighResolutionModule(nn.Module):
    """Parallel branches of 4 basic blocks, fused by sums (every output
    branch kept)."""

    def __init__(self, channels: Sequence[int]):
        super().__init__()
        n = len(channels)
        self.branches = nn.ModuleList(
            nn.Sequential(*[BasicBlock(channels[b], channels[b])
                            for _ in range(4)]) for b in range(n))
        fuse = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:
                    row.append(nn.Sequential(
                        nn.Conv2d(channels[j], channels[i], 1, bias=False),
                        bn(channels[i]),
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
        self.relu = nn.ReLU()

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        outs = []
        for row in self.fuse_layers:
            acc = None
            for j, layer in enumerate(row):
                y = ys[j] if layer is None else layer(ys[j])
                acc = y if acc is None else acc + y
            outs.append(self.relu(acc))
        return outs


def _transition(prev: Sequence[int], new: Sequence[int]) -> nn.ModuleList:
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


class HRNet32Feature(nn.Module):
    """hrnet32 with the classification head: (B, 3, H, W) -> (B, 2048)."""

    def __init__(self):
        super().__init__()
        w = 32
        self.conv1 = nn.Conv2d(3, 64, 3, 2, 1, bias=False)
        self.bn1 = bn(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, 1, bias=False)
        self.bn2 = bn(64)
        self.relu = nn.ReLU()
        self.layer1 = nn.Sequential(*[Bottleneck(64 if i == 0 else 256, 64)
                                      for i in range(4)])
        c2, c3, c4 = [w, 2 * w], [w, 2 * w, 4 * w], [w, 2 * w, 4 * w, 8 * w]
        self.transition1 = _transition([256], c2)
        self.stage2 = nn.Sequential(HighResolutionModule(c2))
        self.transition2 = _transition(c2, c3)
        self.stage3 = nn.Sequential(*[HighResolutionModule(c3)
                                      for _ in range(4)])
        self.transition3 = _transition(c3, c4)
        self.stage4 = nn.Sequential(*[HighResolutionModule(c4)
                                      for _ in range(3)])
        head = [32, 64, 128, 256]
        self.incre_modules = nn.ModuleList(
            nn.Sequential(Bottleneck(c4[i], head[i])) for i in range(4))
        self.downsamp_modules = nn.ModuleList(
            nn.Sequential(nn.Conv2d(head[i] * 4, head[i + 1] * 4, 3, 2, 1),
                          bn(head[i + 1] * 4), nn.ReLU())
            for i in range(3))
        self.final_feat_layer = nn.Sequential(
            nn.Conv2d(head[3] * 4, 2048, 1), bn(2048), nn.ReLU())

    @staticmethod
    def _transit(transition: nn.ModuleList, xs):
        out = []
        for i, layer in enumerate(transition):
            if layer is None:
                out.append(xs[i])
            else:
                out.append(layer(xs[i] if i < len(xs) else xs[-1]))
        return out

    def forward(self, x):
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.layer1(self.relu(self.bn2(self.conv2(x))))
        xs = [x]
        for transition, stage in ((self.transition1, self.stage2),
                                  (self.transition2, self.stage3),
                                  (self.transition3, self.stage4)):
            xs = self._transit(transition, xs)
            for module in stage:
                xs = module(xs)
        y = self.incre_modules[0](xs[0])
        for i in range(3):
            y = self.incre_modules[i + 1](xs[i + 1]) + \
                self.downsamp_modules[i](y)
        return self.final_feat_layer(y).mean(dim=(2, 3))
