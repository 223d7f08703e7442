"""Neural-network building blocks (torch, NCHW, the reference
checkpoint's module names)."""

from wedetect_tpu_torch.nn.head import WeDetectHead, bn_fold_scale_bias

__all__ = ["WeDetectHead", "bn_fold_scale_bias"]
