"""Training: the optimizer, the train state, the detector's TAL
assigner, losses, train step and loop, the WeDetect-Ref SFT steps
(stage 3 focal loss, stages 1-2 LM loss), and the legacy YOLOv5 loss."""

from wedetect_tpu_torch.train.yolov5_loss import V5Losses, yolov5_loss

__all__ = ["V5Losses", "yolov5_loss"]
