"""Image IO helpers of the port (the twin of ``ldm_tpu/utils/images.py``)."""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


def image_grid(images: np.ndarray, cols: int = 0) -> np.ndarray:
    """Tile a uint8 NHWC batch into a single HWC grid image."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    cols = cols or int(np.ceil(np.sqrt(n)))
    rows = -(-n // cols)
    grid = np.zeros((rows * h, cols * w, c), np.uint8)
    for i in range(n):
        r, col = divmod(i, cols)
        grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = images[i]
    return grid


def _to_pil(arr: np.ndarray):
    from PIL import Image

    if arr.shape[-1] == 1:
        return Image.fromarray(arr[..., 0], mode="L")
    return Image.fromarray(arr)


def save_images(images: Sequence[np.ndarray], paths: Sequence[str]) -> List[str]:
    """Save uint8 HWC images to PNG paths (dirs created as needed)."""
    out = []
    for img, path in zip(images, paths):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _to_pil(np.asarray(img)).save(path)
        out.append(path)
    return out
