from tpu_vo_torch.image import color, filters, pyramid

__all__ = ["color", "filters", "pyramid"]
