"""Neural-network building blocks (torch, NCHW, the reference
checkpoint's module names)."""

from wedetect_tpu_torch.nn.head import WeDetectHead, bn_fold_scale_bias
from wedetect_tpu_torch.nn.layers import ConvBN, Transpose2x
from wedetect_tpu_torch.nn.yolov5_head import YOLOv5HeadModule

__all__ = ["ConvBN", "Transpose2x", "WeDetectHead", "bn_fold_scale_bias",
           "YOLOv5HeadModule"]
