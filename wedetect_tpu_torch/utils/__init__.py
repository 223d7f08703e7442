"""Utilities: visualization."""

from wedetect_tpu_torch.utils.vis import draw_detections, visualize_batch

__all__ = ["draw_detections", "visualize_batch"]
