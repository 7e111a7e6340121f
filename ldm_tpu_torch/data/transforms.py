"""Image transforms of the port (the twin of ``ldm_tpu/data/transforms.py``),
numpy only; images are NHWC throughout.

* forward: ToTensor-style scaling to [0, 1], then ``t*2 - 1`` to [-1, 1]
  (:func:`scale_to_minus_one_one`; :func:`scale_to_zero_one` for the BCE
  autoencoder);
* reverse: ``(t+1)/2``, ``*255``, uint8 (:func:`reverse_transform`);
* :func:`to_grayscale` for synthetic image-folder data;
* :func:`resize_images`, once at dataset load, without JAX:

``ldm_tpu.data.transforms.resize_images`` resizes once at dataset load with
``jax.image.resize(method="bilinear")``, which imports JAX; the machine with
the card has none.  This module computes the same resize in numpy.

``jax.image.resize`` is a separable scale-and-translate: for each spatial
axis a weight matrix (in, out), contracted with the image in float32.  Per
output pixel o, the sample point in input coordinates is the half-pixel
centre ``(o + 0.5) / scale - 0.5``; input pixel i weighs
``max(0, 1 - |s - i| / k)`` with ``k = max(1 / scale, 1)`` (the triangle
kernel, widened by the scale when downsampling: JAX's ``antialias=True``);
each column is divided by its sum (renormalised at the borders, where
``F.interpolate(align_corners=False)`` clamps instead).
"""

from __future__ import annotations

import numpy as np


def bilinear_weights(in_size: int, out_size: int) -> np.ndarray:
    """The (in_size, out_size) float32 weight matrix of one axis, as
    ``jax._src.image.scale.compute_weight_mat`` builds it for the triangle
    kernel with antialiasing and no translation."""
    f32 = np.float32
    scale = f32(out_size) / f32(in_size)
    inv_scale = f32(1.0) / scale
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _contract(x: np.ndarray, w: np.ndarray, axis: int, lanes: int) -> np.ndarray:
    """``x`` contracted with ``w`` (K, M) along ``axis`` in float32: ``lanes``
    accumulators, the j-th a chain of fused multiply-adds over the k = j
    (mod lanes), then summed pairwise in order.  A product of two float32
    values is exact in float64, so each step rounds once, as a fused
    multiply-add does (bar a rare double rounding)."""
    xm = np.moveaxis(x, axis, -1).astype(np.float64)
    w64 = w.astype(np.float64)
    acc = [np.zeros(xm.shape[:-1] + (w.shape[1],), np.float32) for _ in range(lanes)]
    for k in range(w.shape[0]):
        acc[k % lanes] = (xm[..., k, None] * w64[k] + acc[k % lanes]).astype(np.float32)
    while len(acc) > 1:
        acc = [acc[i] + acc[i + 1] for i in range(0, len(acc), 2)]
    return np.moveaxis(acc[0], -1, axis)


# images a resize takes at once: bounds its float64 temporaries
RESIZE_CHUNK = 4096


def resize_images(images: np.ndarray, size: int) -> np.ndarray:
    """Resize an NHWC uint8 batch to (size, size), bilinear, on the host once
    (the same signature and result as ``ldm_tpu.data.transforms.resize_images``).

    The two contractions run in the order XLA's CPU dot runs them inside
    ``jax.image.resize``: over H one chain of fused multiply-adds, over W
    four interleaved chains summed pairwise.  At 32 -> 16 px this is bit for
    bit the JAX package's resize; at other sizes XLA may block its sums or
    round its weights otherwise, and the uint8 results stay within 1."""
    if images.shape[1] == size and images.shape[2] == size:
        return images
    parts = []
    for i in range(0, len(images), RESIZE_CHUNK):
        out = images[i: i + RESIZE_CHUNK].astype(np.float32)
        for axis, lanes in ((1, 1), (2, 4)):
            if out.shape[axis] != size:
                out = _contract(out, bilinear_weights(out.shape[axis], size), axis, lanes)
        parts.append(np.clip(out, 0, 255).astype(np.uint8))
    return np.concatenate(parts)


def scale_to_minus_one_one(images_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [-1,1]."""
    return (images_uint8.astype(np.float32) / 255.0) * 2.0 - 1.0


def scale_to_zero_one(images_uint8: np.ndarray) -> np.ndarray:
    """uint8 [0,255] -> float32 [0,1] (for BCE-based ELBO autoencoder training)."""
    return images_uint8.astype(np.float32) / 255.0


def reverse_transform(images: np.ndarray) -> np.ndarray:
    """float [-1,1] NHWC -> uint8 [0,255] NHWC."""
    images = np.asarray(images)
    images = np.clip((images + 1.0) / 2.0, 0.0, 1.0) * 255.0
    return images.astype(np.uint8)


def to_grayscale(images_uint8: np.ndarray) -> np.ndarray:
    """RGB NHWC uint8 -> single-channel, ITU-R 601 weights like torchvision
    ``Grayscale``."""
    if images_uint8.shape[-1] == 1:
        return images_uint8
    w = np.array([0.299, 0.587, 0.114], np.float32)
    g = (images_uint8.astype(np.float32) @ w)[..., None]
    return np.clip(g, 0, 255).astype(np.uint8)
