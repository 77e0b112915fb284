"""WACNN: the window-attention channel-autoregressive single-quality model.

It is the base half of ``VarianceMaskingPIC`` with single branches: one
g_a (M channels out), one g_s, one hyper-synthesis pair (N wide first conv,
M out), ten slices over M = 320 with channel-conditional heads and latent
residual prediction, and no progressive stage. The class pins
``division = (m, m)`` and single branches whatever the caller passes.

Its codec is ``PICCodec``: ``compress(x, 0, buffered=True)`` codes each
image as one y stream over every slice and one z stream.
"""

from __future__ import annotations

import torch

from .pic import VarianceMaskingPIC


class WACNN(VarianceMaskingPIC):
    def __init__(self, n: int = 192, m: int = 320, **kwargs):
        for k in ("division", "multiple_encoder", "multiple_decoder",
                  "multiple_hyperprior"):
            kwargs.pop(k, None)
        super().__init__(n=n, m=m, division=(m, m), multiple_encoder=False,
                         multiple_decoder=False, multiple_hyperprior=False,
                         **kwargs)

    def forward(self, x: torch.Tensor, training: bool = True,
                generator: torch.Generator = None):
        """x [B,H,W,3] -> {"x_hat": [B,H,W,3] (not clipped), "likelihoods":
        {"y", "z"}, "y_base"}: ``multi_quality`` (the base alone here)
        without its level axis. The trainer calls ``multi_quality``, whose
        x_hat keeps the axis (the hyperprior rate is weighted by it)."""
        out = self.multi_quality(x, None, training, generator)
        return {"x_hat": out["x_hat"][0], "likelihoods": out["likelihoods"],
                "y_base": out["y_base"]}
