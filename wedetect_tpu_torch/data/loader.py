"""Image loading for the detection API and CLIs."""

from __future__ import annotations

import numpy as np


def load_image_rgb(path: str) -> np.ndarray:
    """Read an image file as HWC uint8 RGB (cv2, imported on use)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
