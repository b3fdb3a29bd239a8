from horopose_tpu_torch.models.depth_net import RootNet
from horopose_tpu_torch.models.full_net import FullNet
from horopose_tpu_torch.models.hrnet import HRNet, get_hrnet
from horopose_tpu_torch.models.resnet import RESNET_SPECS, ResNet, get_resnet

__all__ = ["FullNet", "HRNet", "ResNet", "RESNET_SPECS", "RootNet",
           "get_hrnet", "get_resnet"]
