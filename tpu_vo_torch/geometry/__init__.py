from tpu_vo_torch.geometry.se3 import Pose
from tpu_vo_torch.geometry import camera, epipolar, se3, triangulation

__all__ = ["Pose", "se3", "camera", "epipolar", "triangulation"]
