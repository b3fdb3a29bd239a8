"""DepthNet (RootNet): the absolute root depth from a crop, NCHW.

Port of `horopose_tpu/models/depth_net.py`: a backbone, its globally
average-pooled feature, a 1x1 conv `depth_layer` giving a scalar gamma, and
depth = gamma * k_value in millimetres (the pipelines divide by 1000).
Options, as in the JAX model: an xy soft-argmax branch on the resnet
feature map (`pred_xy`), a bottleneck of five fc layers added to the
feature (`add_fc`), and an offset head (`use_offset`).

Module names are the reference checkpoints' keys (`backbone.*`,
`deconv_layers.{0,3,6}` with their BatchNorms at 1/4/7, `xy_layer`,
`depth_fc1..5`, `depth_bn1..4`, `depth_layer` and `offset_layer` as 1x1
convs), so `tools/jax_weights.py::rootnet_state_dict_from_jax` maps the JAX
variables onto `state_dict()` and a stage-1 checkpoint's `backbone.*` and
`depth_layer.*` carry over to FullNet's `rootnet_backbone.*` and
`depth_layer.*` (`pipelines/train_full.py`).

A fresh model draws its weights as the JAX model's initialisers do:
flax's defaults (`models/common.py::init_like_flax_`), then `depth_layer`
and `offset_layer` from normal(0, 0.001) with zero biases.

dtype bfloat16 runs the conv stacks under autocast; the fc bottleneck, the
depth and offset heads and the xy softmax stay float32, as FullNet does.
"""

from __future__ import annotations

import torch
from torch import nn

from horopose_tpu_torch.models.common import init_like_flax_
from horopose_tpu_torch.models.hrnet import get_hrnet
from horopose_tpu_torch.models.resnet import batch_norm, get_resnet

_RESNETS = ("resnet", "resnet34", "resnet50")
_HRNETS = ("hrnet", "hrnet32")


class RootNet(nn.Module):
    def __init__(self, backbone_name: str = "resnet50", pred_xy: bool = False,
                 use_offset: bool = False, add_fc: bool = False,
                 input_size: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"RootNet dtype float32 or bfloat16, not {dtype}")
        if backbone_name in _RESNETS:
            self.backbone = get_resnet(backbone_name)
            inplanes = self.backbone.feature_channels
        elif backbone_name in _HRNETS:
            self.backbone = get_hrnet(32, generate_hm=False, generate_feat=True)
            inplanes = 2048
        else:
            raise NotImplementedError(backbone_name)
        self.is_resnet = backbone_name in _RESNETS
        self.backbone_name = backbone_name
        if pred_xy and not self.is_resnet:
            raise ValueError("pred_xy reads the resnet feature map; the "
                             f"{backbone_name} backbone gives a pooled feature")
        self.pred_xy, self.use_offset, self.add_fc = pred_xy, use_offset, add_fc
        self.input_size = int(input_size)
        self.dtype = dtype

        if pred_xy:
            layers, cin = [], inplanes
            for _ in range(3):
                layers += [nn.ConvTranspose2d(cin, 256, 4, 2, 1, bias=False),
                           batch_norm(256), nn.ReLU(inplace=True)]
                cin = 256
            self.deconv_layers = nn.Sequential(*layers)
            self.xy_layer = nn.Conv2d(256, 1, 1)
        if add_fc:
            widths = [inplanes, inplanes // 2, inplanes // 4, inplanes // 4,
                      inplanes // 2, inplanes]
            for i in range(5):
                setattr(self, f"depth_fc{i + 1}",
                        nn.Linear(widths[i], widths[i + 1]))
                if i < 4:
                    setattr(self, f"depth_bn{i + 1}",
                            nn.BatchNorm1d(widths[i + 1], eps=1e-5,
                                           momentum=0.1))
        # a 1x1 conv on the (1, 1) pooled map
        self.depth_layer = nn.Conv2d(inplanes, 1, 1)
        if use_offset:
            self.offset_layer = nn.Conv2d(inplanes, 1, 1)
        # the JAX model's initialisers: flax's defaults, then its heads'
        init_like_flax_(self)
        for head in ([self.depth_layer]
                     + ([self.offset_layer] if use_offset else [])):
            nn.init.normal_(head.weight, std=0.001)
            nn.init.zeros_(head.bias)

    def _coord_xy(self, hm: torch.Tensor) -> torch.Tensor:
        """(B, 1, H, W) logits -> (B, 2) softmax expectations of (x, y) in
        heatmap pixels."""
        B, _, H, W = hm.shape
        probs = torch.softmax(hm.float().reshape(B, H * W), dim=1)
        probs = probs.reshape(B, H, W)
        f32 = dict(dtype=torch.float32, device=hm.device)
        coord_x = (probs.sum(dim=1) * torch.arange(W, **f32)).sum(-1)
        coord_y = (probs.sum(dim=2) * torch.arange(H, **f32)).sum(-1)
        return torch.stack([coord_x, coord_y], dim=-1)

    def forward(self, x: torch.Tensor, k_value: torch.Tensor) -> torch.Tensor:
        """x (B, 3, S, S) crop in [0, 1]; k_value (B,) or (B, 1).

        Returns depth (B, 1) in mm, or (B, 3) [x, y, depth] with pred_xy."""
        x = x.contiguous()  # NCHW, whatever layout the crop arrives in
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            fm = self.backbone(x)
            img_feat = fm.mean(dim=(2, 3)) if self.is_resnet else fm
            hm = (self.xy_layer(self.deconv_layers(fm)) if self.pred_xy
                  else None)
        img_feat = img_feat.float()

        if self.add_fc:
            f = img_feat
            for i in range(1, 5):
                fc, bn = (getattr(self, f"depth_fc{i}"),
                          getattr(self, f"depth_bn{i}"))
                f = torch.relu(bn(fc(f)))
            img_feat = img_feat + self.depth_fc5(f)

        def head(layer):
            return layer(img_feat[:, :, None, None])[:, :, 0, 0]

        depth = head(self.depth_layer) * k_value.reshape(-1, 1).float()
        if self.use_offset:
            depth = depth + head(self.offset_layer) * 1000.0
        if self.pred_xy:
            return torch.cat([self._coord_xy(hm), depth], dim=-1)
        return depth
