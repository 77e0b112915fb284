"""Image quality metrics: PSNR and MS-SSIM (and its dB form), as the JAX
package computes them (``epic_tpu/utils/metrics.py``).

MS-SSIM is the standard 5-scale one with the Wang et al. weights: an 11-tap
Gaussian window (sigma 1.5) applied as a separable valid depthwise filter,
SSIM and contrast-structure means per (image, channel), relu per channel,
2x2 average pooling between scales, the weighted product per channel and
the mean over images and channels. It runs in float32 whatever the input
dtype: E[x^2] - mu^2 cancels badly in reduced precision. For the same
reason the filter refuses to run on the GPU with cuDNN's TF32 on
(``device.resolve_device`` turns it off).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def compute_psnr(a, b, data_range: float = 1.0) -> float:
    """PSNR in dB of a against b (float64 mean squared error)."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64, device=a.device)
    mse = float(torch.mean((a - b) ** 2))
    if mse <= 0:
        return float("inf")
    return 10.0 * math.log10(data_range ** 2 / mse)


def _gaussian_kernel(size: int = 11, sigma: float = 1.5,
                     device=None) -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float32, device=device) - \
        (size - 1) / 2.0
    g = torch.exp(-0.5 * (xs / sigma) ** 2)
    return g / g.sum()


def _filter2d(x: torch.Tensor, kernel1d: torch.Tensor) -> torch.Tensor:
    """Separable valid Gaussian filter of NCHW float32 x, per channel."""
    if x.is_cuda and torch.backends.cudnn.allow_tf32:
        raise RuntimeError("MS-SSIM needs float32 filtering: turn cuDNN's "
                           "TF32 off (epic_tpu_torch.device.resolve_device)")
    c, k = x.shape[1], kernel1d.numel()
    x = F.conv2d(x, kernel1d.reshape(1, 1, k, 1).repeat(c, 1, 1, 1),
                 groups=c)
    return F.conv2d(x, kernel1d.reshape(1, 1, 1, k).repeat(c, 1, 1, 1),
                    groups=c)


def _ssim_components(x: torch.Tensor, y: torch.Tensor,
                     data_range: float = 1.0):
    """Spatial means of the SSIM and CS maps, [N, C] each."""
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    w = _gaussian_kernel(device=x.device)
    mu_x, mu_y = _filter2d(x, w), _filter2d(y, w)
    sxx = _filter2d(x * x, w) - mu_x * mu_x
    syy = _filter2d(y * y, w) - mu_y * mu_y
    sxy = _filter2d(x * y, w) - mu_x * mu_y
    cs = (2 * sxy + c2) / (sxx + syy + c2)
    ssim = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs
    return ssim.mean(dim=(2, 3)), cs.mean(dim=(2, 3))


@torch.no_grad()
def ms_ssim(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """MS-SSIM of NHWC images in [0, 1] (H, W >= 176), a 0-d float32
    tensor on their device."""
    x = torch.as_tensor(a).to(torch.float32).permute(0, 3, 1, 2)
    y = torch.as_tensor(b).to(device=x.device,
                              dtype=torch.float32).permute(0, 3, 1, 2)
    weights = torch.tensor(_MSSSIM_WEIGHTS, device=x.device)
    mcs = []
    for i in range(len(_MSSSIM_WEIGHTS)):
        ssim, cs = _ssim_components(x, y)
        if i < len(_MSSSIM_WEIGHTS) - 1:
            mcs.append(torch.relu(cs))
            x, y = F.avg_pool2d(x, 2), F.avg_pool2d(y, 2)
    per_ch = (torch.prod(torch.stack(mcs) ** weights[:-1, None, None], 0)
              * torch.relu(ssim) ** weights[-1])
    return per_ch.mean()


def compute_msssim(a, b) -> float:
    """MS-SSIM over NHWC float images in [0,1]; needs H,W >= 176."""
    return float(ms_ssim(torch.as_tensor(a), torch.as_tensor(b)))


def msssim_db(msssim: float) -> float:
    """-10*log10(1 - msssim)."""
    return -10.0 * math.log10(max(1.0 - msssim, 1e-12))


@torch.no_grad()
def per_level_psnr(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """PSNR in dB of each level of x_hat [L, B, H, W, 3] against x
    [B, H, W, 3], from the batch's mean squared error (float32): [L]."""
    d = x_hat.to(torch.float32) - x.to(torch.float32)[None]
    mse = (d * d).mean(dim=(2, 3, 4)).mean(dim=1)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


@torch.no_grad()
def per_level_msssim(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """MS-SSIM of each level of x_hat [L, B, H, W, 3] against x: [L]."""
    return torch.stack([ms_ssim(level, x) for level in x_hat])


class AverageMeter:
    """Running average."""

    def __init__(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)
