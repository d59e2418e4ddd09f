from tpu_vo_torch.estimation import eight_point, five_point, ransac, recover_pose
from tpu_vo_torch.estimation.ransac import find_essential_ransac
from tpu_vo_torch.estimation.recover_pose import decompose_essential, recover_pose_from_essential

__all__ = [
    "eight_point",
    "five_point",
    "ransac",
    "recover_pose",
    "find_essential_ransac",
    "decompose_essential",
    "recover_pose_from_essential",
]
