"""Image IO helpers of the port (the twin of ``ldm_tpu/utils/images.py``):
the sample grid, PNG writes and the image-folder reader."""

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


def load_image_folder(root: str, image_size: int, grayscale: bool = False):
    """Read a class-per-subdirectory image tree (torchvision's ImageFolder
    layout, as ``python -m ldm_tpu_torch.generate`` and the protocol's
    ``--save-png`` write it) into a Dataset: classes are the sorted
    subdirectories, their ``.png`` / ``.jpg`` / ``.jpeg`` files read in
    sorted order as RGB, then made grayscale when asked and resized."""
    from PIL import Image

    from ldm_tpu_torch.data.datasets import Dataset
    from ldm_tpu_torch.data.transforms import resize_images, to_grayscale

    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    imgs, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for fname in sorted(os.listdir(cdir)):
            if not fname.lower().endswith((".png", ".jpg", ".jpeg")):
                continue
            with Image.open(os.path.join(cdir, fname)) as im:
                imgs.append(np.asarray(im.convert("RGB")))
            labels.append(ci)
    images = np.stack(imgs)
    if grayscale:
        images = to_grayscale(images)
    images = resize_images(images, image_size)
    return Dataset(images, np.asarray(labels, np.int32), list(range(len(classes))), root)
