"""Factorized-prior entropy bottleneck (Balle et al.).

A learned monotone per-channel CDF built from matrix/bias/factor stacks,
with per-channel quantiles whose middle entry is the median that z is
coded around. In training, uniform noise stands in for rounding, and the
quantiles are fitted by their own loss (``aux_loss``) through which no
gradient reaches the density's parameters. Parameter names and shapes
match the JAX package's module, so weights carry across one to one.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import xla_f32
from .gaussian import CdfTables, quantize_pmf_rows
from .ops import lower_bound, uniform_noise

_TAIL_MASS = 1e-9  # the density mass outside the fitted quantiles


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, filters: Tuple[int, ...] = (3, 3, 3, 3),
                 init_scale: float = 10.0, likelihood_bound: float = 1e-9):
        super().__init__()
        self.channels = channels
        self.n_layers = len(filters) + 1
        self.likelihood_bound = likelihood_bound
        f = (1,) + tuple(filters) + (1,)
        scale = init_scale ** (1 / self.n_layers)
        gen = torch.Generator().manual_seed(0)
        for i in range(self.n_layers):
            init = math.log(math.expm1(1 / scale / f[i + 1]))
            self.register_parameter(f"matrix_{i}", nn.Parameter(
                torch.full((channels, f[i + 1], f[i]), init)))
            self.register_parameter(f"bias_{i}", nn.Parameter(
                torch.rand((channels, f[i + 1], 1), generator=gen) - 0.5))
            if i < len(filters):
                self.register_parameter(f"factor_{i}", nn.Parameter(
                    torch.zeros(channels, f[i + 1], 1)))
        self.quantiles = nn.Parameter(torch.tensor(
            [-init_scale, 0.0, init_scale]).repeat(channels, 1, 1))

    def _logits_cumulative(self, inputs: torch.Tensor,
                           stop_gradient: bool = False) -> torch.Tensor:
        """inputs [C, 1, N] -> logits of the cumulative at each input. With
        ``stop_gradient`` the matrices, biases and factors are detached, so
        a loss on the result trains the inputs alone."""
        def param(name):
            p = getattr(self, name)
            return p.detach() if stop_gradient else p

        logits = inputs
        for i in range(self.n_layers):
            logits = torch.einsum("cof,cfn->con",
                                  F.softplus(param(f"matrix_{i}")), logits)
            logits = logits + param(f"bias_{i}")
            if i < self.n_layers - 1:
                logits = logits + (torch.tanh(param(f"factor_{i}"))
                                   * torch.tanh(logits))
        return logits

    def _pmf(self, samples):
        lower = self._logits_cumulative(samples - 0.5)
        upper = self._logits_cumulative(samples + 0.5)
        sign = -torch.sign(lower + upper)
        pmf = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
        return pmf, lower, upper

    def medians(self) -> torch.Tensor:
        return self.quantiles[:, 0, 1]  # [C]

    def forward(self, x: torch.Tensor, training: bool = False,
                generator: torch.Generator = None):
        """Forward on NHWC x: (outputs, likelihoods), both NHWC. Outputs are
        x rounded around the medians, or in training x plus U(-0.5, 0.5)
        noise drawn from ``generator``."""
        b, h, w, c = x.shape
        values = x.permute(3, 0, 1, 2).reshape(c, 1, -1)
        if training:
            outputs = values + uniform_noise(values, generator)
        else:
            med = self.medians()[:, None, None]
            outputs = torch.round(values - med) + med
        likelihood, _, _ = self._pmf(outputs)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)

        def unshape(t):
            return t.reshape(c, b, h, w).permute(1, 2, 3, 0)

        return unshape(outputs), unshape(likelihood)

    def aux_loss(self) -> torch.Tensor:
        """The quantile-fitting loss: the cumulative's logits at the three
        quantiles of each channel pulled to -t, 0, t, t = log(2 / _TAIL_MASS
        - 1). Only the quantiles receive its gradient."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = math.log(2 / _TAIL_MASS - 1)
        target = torch.tensor([-t, 0.0, t], dtype=torch.float32,
                              device=logits.device)
        return (logits - target).abs().sum()

    @torch.no_grad()
    def cdf_tables(self, precision: int = 16):
        """Quantized CDF tables of every channel plus the float32 medians.
        The pmf grid is evaluated on the host by ``xla_f32.pmf_grid``, which
        rounds every float32 operation as the JAX package's CPU program
        does, so the tables equal the JAX package's bit for bit for any
        weights, on any host and wherever the module lives."""
        params = {k: v.detach().float().cpu().numpy()
                  for k, v in self.named_parameters()}
        quantiles = params["quantiles"][:, 0, :]
        medians = quantiles[:, 1]
        minima = np.clip(np.ceil(medians - quantiles[:, 0]).astype(np.int32),
                         0, None)
        maxima = np.clip(np.ceil(quantiles[:, 2] - medians).astype(np.int32),
                         0, None)
        pmf_start = medians - minima
        pmf_length = (maxima + minima + 1).astype(np.int32)
        pmf, tail = xla_f32.pmf_grid(params, pmf_start, int(pmf_length.max()))
        cdf = quantize_pmf_rows(pmf, tail, pmf_length, precision)
        tables = CdfTables(quantized_cdf=cdf.astype(np.int32),
                           cdf_length=(pmf_length + 2).astype(np.int32),
                           offset=(-minima).astype(np.int32))
        return tables, medians.astype(np.float32)
