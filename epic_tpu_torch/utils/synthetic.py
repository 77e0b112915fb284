"""Deterministic synthetic test images (no image files, no Pillow)."""

from __future__ import annotations

import numpy as np
import torch


def synthetic_image(h: int = 512, w: int = 768, seed: int = 0) -> np.ndarray:
    """[1, h, w, 3] float32 in [0, 1]: smooth waves per channel plus mild
    Gaussian noise drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (3 * xx + k * 0.3))
                    * np.cos(2 * np.pi * (2 * yy - k * 0.2)) for k in range(3)],
                   axis=-1)
    img += 0.05 * rng.standard_normal(img.shape)
    return np.clip(img, 0, 1).astype(np.float32)[None]


def synth_images(n: int, rng: np.random.Generator) -> list:
    """The JAX package's ``bench.py`` synthetic images: n uint8 512x768x3
    arrays, waves whose periods vary with the image index plus N(0, 0.05)
    noise drawn from ``rng`` (``bench.py`` passes ``default_rng(0)``)."""
    out = []
    yy, xx = np.mgrid[0:512, 0:768].astype(np.float32)
    for i in range(n):
        base = np.stack([
            0.5 + 0.5 * np.sin(xx / (31 + 7 * i)) * np.cos(yy / 29),
            0.5 + 0.4 * np.cos(xx / 23 + yy / (37 + 3 * i)),
            (xx + yy) / 1280.0,
        ], -1)
        f = np.clip(base + rng.normal(0, 0.05, base.shape), 0, 1)
        out.append(np.round(f * 255.0).astype(np.uint8))
    return out


def to_f32(u8, device) -> torch.Tensor:
    """uint8 images -> float32 in [0, 1] on ``device``: uploaded as one
    byte a pixel and divided by 255 there (the same IEEE float32 values as
    ``u8.astype(np.float32) / 255.0`` on the host)."""
    return torch.as_tensor(u8, device=device).to(torch.float32) / 255.0


def synth_batch(batch: int = 16, patch: int = 256,
                seed: int = 0) -> np.ndarray:
    """A fixed training batch made on the host with numpy alone, the same
    on every machine: ``batch`` patch x patch crops of ``synth_images(8,
    default_rng(seed))`` at positions drawn from ``default_rng(seed + 1)``,
    as float32 [batch, patch, patch, 3] in [0, 1] (uint8 / 255)."""
    imgs = synth_images(8, np.random.default_rng(seed))
    rng = np.random.default_rng(seed + 1)
    out = np.empty((batch, patch, patch, 3), np.float32)
    for k in range(batch):
        img = imgs[int(rng.integers(len(imgs)))]
        top = int(rng.integers(img.shape[0] - patch + 1))
        left = int(rng.integers(img.shape[1] - patch + 1))
        out[k] = (img[top:top + patch, left:left + patch].astype(np.float32)
                  / np.float32(255.0))
    return out
