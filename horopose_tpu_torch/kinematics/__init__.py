from horopose_tpu_torch.kinematics.fk import KinematicPlan
from horopose_tpu_torch.kinematics.robot import Robot
from horopose_tpu_torch.kinematics.urdf import URDFModel, parse_urdf

__all__ = ["KinematicPlan", "Robot", "URDFModel", "parse_urdf"]
