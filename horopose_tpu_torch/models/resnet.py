"""ResNet trunk, NCHW, torchvision naming.

Port of `horopose_tpu/models/resnet.py`: ResNet-18/34/50/101/152 without
the avgpool/fc head, output stride 32, returning the final feature map.
Module names follow torchvision (`conv1`, `bn1`, `layer{s}.{i}.conv1`,
`downsample.0/1`), which are the reference checkpoints' keys.
BatchNorm: eps 1e-5, momentum 0.1 (flax momentum 0.9). With `remat`, each
block's forward is recomputed in the backward (`models/common.py::
remat_call`, the JAX package's `cfg.remat`); the state dict is the same.
"""

from __future__ import annotations

from torch import nn

from horopose_tpu_torch.models.common import remat_call

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
    # alias: "resnet" == resnet50
    "resnet": ("bottleneck", (3, 4, 6, 3)),
}


def conv3x3(cin: int, cout: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, stride, 1, bias=False)


def batch_norm(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=1e-5, momentum=0.1)


def _downsample(cin: int, cout: int, stride: int):
    if stride == 1 and cin == cout:
        return None
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False),
                         batch_norm(cout))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = conv3x3(cin, filters, stride)
        self.bn1 = batch_norm(filters)
        self.conv2 = conv3x3(filters, filters)
        self.bn2 = batch_norm(filters)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, filters, stride)

    def forward(self, x):
        return remat_call(self, self._forward, x)

    def _forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return self.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1,
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        self.conv1 = nn.Conv2d(cin, filters, 1, bias=False)
        self.bn1 = batch_norm(filters)
        self.conv2 = conv3x3(filters, filters, stride)
        self.bn2 = batch_norm(filters)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = batch_norm(filters * 4)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = _downsample(cin, filters * 4, stride)

    def forward(self, x):
        return remat_call(self, self._forward, x)

    def _forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return self.relu(y + residual)


class ResNet(nn.Module):
    """Trunk only: input (B, 3, H, W) -> feature map (B, C, H/32, W/32)."""

    def __init__(self, block: str = "bottleneck",
                 stage_sizes=(3, 4, 6, 3), remat: bool = False):
        super().__init__()
        block_cls = Bottleneck if block == "bottleneck" else BasicBlock
        self.feature_channels = 512 * block_cls.expansion
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, 2, 1)   # pads with -inf, as flax
        cin = 64
        for stage, num_blocks in enumerate(stage_sizes):
            blocks = []
            for i in range(num_blocks):
                stride = 2 if stage > 0 and i == 0 else 1
                blocks.append(block_cls(cin, 64 * 2 ** stage, stride,
                                        remat=remat))
                cin = 64 * 2 ** stage * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, x):
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        for stage in range(self.num_stages):
            x = getattr(self, f"layer{stage + 1}")(x)
        return x


def get_resnet(arch: str, remat: bool = False) -> ResNet:
    block, sizes = RESNET_SPECS[arch]
    return ResNet(block=block, stage_sizes=sizes, remat=remat)
