"""Generalized Divisive Normalization over NHWC tensors.

y[i] = x[i] / sqrt(beta[i] + sum_j gamma[j, i] * x[j]^2)   (inverse: * sqrt)

beta and gamma are stored in the non-negative reparametrised form of
``entropy.ops.nn_param_*``, as in the JAX package. The normalization math
runs in float32 and y comes back in x's type (float32 or bf16), as the JAX
package casts around it (``epic_tpu/ops/gdn.py``), through
``gdn_kernel.gdn_differentiable``: the fused kernel, which reads and writes
bf16 itself, with its closed-form backward when a gradient is asked for.
"""

from __future__ import annotations

import torch
from torch import nn

from ..entropy.ops import nn_param_apply, nn_param_init
from .gdn_kernel import gdn_differentiable

_BETA_MIN = 1e-6
_GAMMA_INIT = 0.1


class GDN(nn.Module):
    def __init__(self, channels: int, inverse: bool = False):
        super().__init__()
        self.inverse = inverse
        self.beta = nn.Parameter(nn_param_init(torch.ones(channels), _BETA_MIN))
        self.gamma = nn.Parameter(
            nn_param_init(_GAMMA_INIT * torch.eye(channels), 0.0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        beta = nn_param_apply(self.beta, _BETA_MIN)
        gamma = nn_param_apply(self.gamma, 0.0)
        return gdn_differentiable(x.contiguous(), gamma, beta, self.inverse)
