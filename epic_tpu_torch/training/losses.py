"""Rate-distortion losses of the four training stages.

Each criterion takes a forward's output and the target [B,H,W,3] and
returns a dict with "loss", "mse_loss" (per level), "bpp_loss", "bpp_base",
"bpp_scalable" and "bpp_hype". ``output["x_hat"]`` is [L,B,H,W,3] (L
reconstruction levels, base first) or [B,H,W,3].

The hyperprior term is weighted by ``x_hat.shape[0]``, as in the JAX
package and the work it reproduces: the level count for multi-quality
outputs, and the batch size for single-quality ones. ``hyper_weight``
replaces that weight: a data-parallel step passes the global batch size,
so that its ranks' losses average to the global batch's.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

WEIGHT = 255.0 ** 2
DEFAULT_LMBDA_LIST = (0.0055, 0.04)


def _levels_mse(x_hat: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    if x_hat.dim() == target.dim():
        x_hat = x_hat[None]
    diff = x_hat - target[None]
    return (diff * diff).mean(dim=tuple(range(1, diff.dim())))  # [L]


def _rate_terms(output, target, hyper_weight=None
                ) -> Dict[str, torch.Tensor]:
    b, h, w, _ = target.shape
    den = -math.log(2) * b * h * w
    lik = output["likelihoods"]
    out = {"bpp_hype": torch.log(lik["z"]).sum() / den,
           "bpp_base": torch.log(lik["y"]).sum() / den}
    out["bpp_scalable"] = (torch.log(lik["y_prog"]).sum() / den
                           if "y_prog" in lik
                           else torch.zeros((), device=target.device))
    levels = (output["x_hat"].shape[0] if hyper_weight is None
              else hyper_weight)
    out["bpp_loss"] = (out["bpp_scalable"] + out["bpp_base"]
                       + levels * out["bpp_hype"])
    return out


def _as_lmbda(lmbda, device) -> torch.Tensor:
    return torch.atleast_1d(torch.as_tensor(lmbda, dtype=torch.float32,
                                            device=device))


def scalable_rate_distortion_loss(output, target, lmbda=None,
                                  weight: float = WEIGHT, hyper_weight=None):
    """Multi-quality R-D (first_train): lmbda holds one weight per level
    (default (0.0055, 0.04))."""
    if lmbda is None:
        lmbda = DEFAULT_LMBDA_LIST
    out = _rate_terms(output, target, hyper_weight)
    mse = _levels_mse(output["x_hat"], target)
    out["mse_loss"] = mse
    out["loss"] = out["bpp_loss"] + weight * torch.mean(
        _as_lmbda(lmbda, target.device) * mse)
    return out


def rate_distortion_loss(output, target, lmbda, weight: float = WEIGHT,
                         hyper_weight=None):
    """Single-lambda R-D (refine_gs_ga, one lambda per sampled quality)."""
    out = _rate_terms(output, target, hyper_weight)
    mse = _levels_mse(output["x_hat"], target)
    out["mse_loss"] = mse
    out["loss"] = out["bpp_loss"] + weight * torch.mean(
        _as_lmbda(lmbda, target.device) * mse)
    return out


def distortion_loss(output, target, lmbda=1e-2, weight: float = WEIGHT,
                    hyper_weight=None):
    """Distortion only (refine_gs: the decoder's fine-tune); the rate terms
    are bookkeeping."""
    out = _rate_terms(output, target, hyper_weight)
    mse = _levels_mse(output["x_hat"], target)
    out["mse_loss"] = mse
    out["loss"] = weight * torch.mean(_as_lmbda(lmbda, target.device) * mse)
    return out


def rate_loss(output, target, lmbda=None, weight: float = WEIGHT,
              hyper_weight=None):
    """Rate only (rems: REMs can only shrink the rate)."""
    del lmbda, weight
    out = _rate_terms(output, target, hyper_weight)
    out["mse_loss"] = _levels_mse(output["x_hat"], target)
    out["loss"] = out["bpp_loss"]
    return out


CRITERIA = {
    "first_train": scalable_rate_distortion_loss,
    "refine_gs": distortion_loss,
    "refine_gs_ga": rate_distortion_loss,
    "rems": rate_loss,
}
