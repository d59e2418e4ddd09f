from tpu_vo_torch.models import refinement

__all__ = ["refinement"]
