"""Utilities: metrics, padding, RD anchors, plotting, config."""

from .metrics import AverageMeter, compute_msssim, compute_psnr, msssim_db
from .padding import compute_padding, pad_image, unpad_image

__all__ = [
    "compute_psnr", "compute_msssim", "msssim_db", "AverageMeter",
    "compute_padding", "pad_image", "unpad_image",
]
