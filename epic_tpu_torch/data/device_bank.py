"""Device-resident training data: a packed crop bank and a sampler that
draws batches on the device.

The source images are uploaded once as one padded uint8 array; each batch
is drawn there (image index weighted by usable crop area, crop offsets,
three random flips, /255) from a ``torch.Generator`` on the device, so the
host sends nothing per step. Images marked ``has_val`` keep their right
columns for validation crops (a spatial holdout).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

# the teaser figure of the work this repository reproduces, as its own
# repository keeps it (relative to the root of a checkout of it)
TEASER_PATH = "imgs/teaser.png"

# (y0, y1, x0, x1) of the photographic rectangles inside the teaser figure
# of the work this repository reproduces: "main" is the kodim21 lighthouse
# photo, d0..d3 are detail panels
TEASER_REGIONS = {
    "main": (18, 1002, 898, 2362),
    "d0": (400, 995, 3310, 4105),
    "d1": (1085, 1492, 3310, 4105),
    "d2": (1700, 2112, 3310, 4105),
    "d3": (2310, 2732, 3310, 4105),
}


@dataclasses.dataclass
class CropBank:
    """Packed image bank + per-image train/val crop-offset ranges."""

    bank: np.ndarray        # [K, Hmax, Wmax, 3] uint8 (zero padded)
    hw: np.ndarray          # [K, 2] int32 valid (h, w)
    train_x1: np.ndarray    # [K] int32: train crops use x in [0, train_x1)
    val_x0: np.ndarray      # [K] int32: val crops use x in [val_x0, w); -1 = none

    @property
    def num_images(self) -> int:
        return self.bank.shape[0]


def _lanczos_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] fixed-point (22 fraction bits) weights of Pillow's
    Lanczos-3 resampling along one axis (``Resample.c``:
    ``precompute_coeffs`` and ``normalize_coeffs_8bpc``)."""
    scale = n_in / n_out
    fscale = max(scale, 1.0)
    support = 3.0 * fscale
    out = np.zeros((n_out, n_in), np.float64)
    for xx in range(n_out):
        center = (xx + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), n_in)
        t = (np.arange(lo, hi) - center + 0.5) / fscale
        w = np.sinc(t) * np.sinc(t / 3.0)
        w[(t < -3.0) | (t >= 3.0)] = 0.0
        total = w.sum()
        if total != 0.0:
            w = w / total
        out[xx, lo:hi] = np.where(w < 0, np.trunc(-0.5 + w * 2.0 ** 22),
                                  np.trunc(0.5 + w * 2.0 ** 22))
    return out


def _resample_axis0(img: np.ndarray, weights: np.ndarray) -> np.ndarray:
    """One pass over axis 0 of uint8 [N, ...]: the fixed-point sums (exact
    in float64), rounded and clipped to uint8 as Pillow does."""
    flat = img.reshape(img.shape[0], -1).astype(np.float64)
    acc = weights @ flat + 2.0 ** 21
    out = np.clip(np.floor(acc / 2.0 ** 22), 0, 255).astype(np.uint8)
    return out.reshape((weights.shape[0],) + img.shape[1:])


def resize_lanczos(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """uint8 [H, W, 3] -> [h, w, 3] as Pillow's ``Image.resize((w, h),
    Image.LANCZOS)``: horizontal pass, then vertical, each rounded to
    uint8."""
    if w != img.shape[1]:
        img = _resample_axis0(img.transpose(1, 0, 2), _lanczos_weights(
            img.shape[1], w)).transpose(1, 0, 2)
    if h != img.shape[0]:
        img = _resample_axis0(img, _lanczos_weights(img.shape[0], h))
    return np.ascontiguousarray(img)


def load_teaser_images(path: str = TEASER_PATH,
                       scales: Sequence[float] = (1.0, 0.75, 0.5),
                       exclude: Sequence[str] = (),
                       ) -> Tuple[List[np.ndarray], List[bool]]:
    """(images, has_val): the teaser's photographic regions, the main photo
    at ``scales`` (only its variants carry a validation strip), read with
    ``data/images.py`` and scaled with ``resize_lanczos``. ``exclude`` drops
    whole regions by name. Raises if the teaser image is missing."""
    from .images import read_image

    if not os.path.exists(path):
        raise FileNotFoundError(f"teaser image not found: {path}")
    im = read_image(path)
    images, has_val = [], []
    for name, (y0, y1, x0, x1) in TEASER_REGIONS.items():
        if name in exclude:
            continue
        region = im[y0:y1, x0:x1]
        for s in (scales if name == "main" else (1.0,)):
            images.append(region if s == 1.0 else resize_lanczos(
                region, int(region.shape[1] * s), int(region.shape[0] * s)))
            has_val.append(name == "main")
    return images, has_val


def build_crop_bank(images: Sequence[np.ndarray],
                    has_val: Optional[Sequence[bool]] = None,
                    patch: int = 256,
                    val_strip: Optional[int] = None) -> CropBank:
    """Pack images into one padded uint8 array with train/val x-ranges.
    Images with has_val[i] keep their rightmost ``val_strip`` columns
    (default patch + 16) for validation crops; training crops start left
    of that strip. Images smaller than a patch are dropped."""
    if has_val is None:
        has_val = [False] * len(images)
    if val_strip is None:
        val_strip = patch + 16
    keep, keep_val = [], []
    for img, hv in zip(images, has_val):
        if img.shape[0] >= patch and img.shape[1] >= patch:
            keep.append(np.ascontiguousarray(img, dtype=np.uint8))
            keep_val.append(hv)
    if not keep:
        raise ValueError(f"no source image fits a {patch}px patch")
    hmax = max(i.shape[0] for i in keep)
    wmax = max(i.shape[1] for i in keep)
    bank = np.zeros((len(keep), hmax, wmax, 3), np.uint8)
    hw = np.zeros((len(keep), 2), np.int32)
    train_x1 = np.zeros(len(keep), np.int32)
    val_x0 = np.full(len(keep), -1, np.int32)
    for i, (img, hv) in enumerate(zip(keep, keep_val)):
        h, w, _ = img.shape
        bank[i, :h, :w] = img
        hw[i] = (h, w)
        if hv and w >= patch + val_strip:
            train_x1[i] = w - val_strip
            val_x0[i] = w - val_strip
        else:
            train_x1[i] = w
    return CropBank(bank=bank, hw=hw, train_x1=train_x1, val_x0=val_x0)


def make_device_sampler(cb: CropBank, patch: int, batch: int,
                        device, split: str = "train"
                        ) -> Callable[[torch.Generator], torch.Tensor]:
    """sample(generator) -> [batch, patch, patch, 3] float32 in [0, 1] on
    ``device``, every draw made there from ``generator`` (a generator on
    that device): the image by its usable crop area, the crop offsets,
    flips of x, of y and of the axes, each with probability 1/2."""
    device = torch.device(device)
    bank = torch.as_tensor(cb.bank, device=device)
    if split == "train":
        x_lo = np.zeros(cb.num_images, np.int64)
        x_hi = cb.train_x1.astype(np.int64) - patch + 1
        weights = np.maximum(cb.hw[:, 0] - patch + 1, 0).astype(
            np.float64) * np.maximum(cb.train_x1 - patch + 1, 0)
    else:
        ok = cb.val_x0 >= 0
        if not ok.any():
            raise ValueError("crop bank has no validation strip")
        x_lo = np.where(ok, cb.val_x0, 0).astype(np.int64)
        x_hi = cb.hw[:, 1].astype(np.int64) - patch + 1
        weights = np.where(ok, (cb.hw[:, 0] - patch + 1).astype(np.float64)
                           * np.maximum(cb.hw[:, 1] - cb.val_x0 - patch + 1,
                                        0), 0.0)
    probs = torch.as_tensor(weights / weights.sum(), dtype=torch.float32,
                            device=device)
    y_span = torch.as_tensor(cb.hw[:, 0].astype(np.int64) - patch + 1,
                             device=device)
    x_lo_t = torch.as_tensor(x_lo, device=device)
    x_span = torch.as_tensor(x_hi - x_lo, device=device)
    offs = torch.arange(patch, device=device)

    def sample(generator: torch.Generator) -> torch.Tensor:
        k = torch.multinomial(probs, batch, replacement=True,
                              generator=generator)
        u = torch.rand((3, batch), generator=generator, device=device,
                       dtype=torch.float64)
        oy = (u[0] * y_span[k]).long()
        ox = x_lo_t[k] + (u[1] * x_span[k]).long()
        flips = torch.rand((3, batch), generator=generator,
                           device=device) < 0.5
        rows = (oy[:, None] + offs)[:, :, None]
        cols = (ox[:, None] + offs)[:, None, :]
        crops = bank[k[:, None, None], rows, cols]  # [B, P, P, 3] uint8
        crops = torch.where(flips[0, :, None, None, None], crops.flip(2),
                            crops)
        crops = torch.where(flips[1, :, None, None, None], crops.flip(1),
                            crops)
        crops = torch.where(flips[2, :, None, None, None],
                            crops.transpose(1, 2), crops)
        return crops.to(torch.float32) / 255.0

    return sample


def fixed_val_batches(cb: CropBank, patch: int, batch: int, device,
                      n_batches: int = 2, seed: int = 1234
                      ) -> List[torch.Tensor]:
    """Deterministic validation batches from the validation strips."""
    sampler = make_device_sampler(cb, patch, batch, device, split="val")
    gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
    return [sampler(gen) for _ in range(n_batches)]
