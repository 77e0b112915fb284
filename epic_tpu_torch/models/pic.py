"""VarianceMaskingPIC, inference half: the paper's progressive model.

An image is coded as a base latent (the first ``division[0]`` channels,
``ns0`` channel-autoregressive slices with up to ``max_support_slices`` of
support) plus a residual latent (the delta between the enhancement and base
representations, ``ns1 - ns0`` more slices). The progressive entropy
parameters depend only on the decoded base latent (the paper's
``all_scalable`` configuration), so they are computed once for every
quality. Residual elements are transmitted in the order of their predicted
std; untransmitted ones decode to the predicted mean.

Delta coding of the residual and the total-mean support of the progressive
chain (``delta_encode`` / ``total_mu_rep`` in the JAX package) are always on,
as in every configuration the JAX package ships.

The JAX package runs the slice chains as ``lax.scan`` over stacked weights;
here they are loops over the same stacked weights (scan and unrolled are
bitwise equal in the reference). Tensors are NHWC; entropy parameters are
float32 whatever the compute dtype.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from ..entropy.bottleneck import EntropyBottleneck
from ..ops.attention import Dense
from ..ops.conv import Conv, ConvTranspose, init_conv_
from .builder import (AnalysisTransform, HyperAnalysis, HyperSynthesis,
                      StackedParamNet, SynthesisTransform)


class VarianceMaskingPIC(nn.Module):
    def __init__(self, n: int = 192, m: int = 640,
                 division: Sequence[int] = (320, 640), dim_chunk: int = 32,
                 support_progressive_slices: int = 5,
                 max_support_slices: int = 5,
                 param_net_widths: Sequence[int] = (224, 176, 128, 64),
                 compute_dtype: str = "float32", scale_bound: float = 0.11):
        super().__init__()
        self.n, self.m = n, m
        self.division = tuple(division)
        self.dim_chunk = dim_chunk
        self.support_progressive_slices = support_progressive_slices
        self.max_support_slices = max_support_slices
        self.scale_bound = scale_bound
        self.compute_dtype = compute_dtype
        dt = None if compute_dtype == "float32" else getattr(torch,
                                                             compute_dtype)
        self.dt = dt
        d0 = self.division[0]
        for i in range(2):
            setattr(self, f"g_a_{i}", AnalysisTransform(n, d0, dt))
            setattr(self, f"g_s_{i}", SynthesisTransform(n, d0, dt))
        self.h_a = HyperAnalysis(m, n, dt)
        for i in range(2):
            setattr(self, f"h_mean_s_{i}", HyperSynthesis(n, d0, dt))
            setattr(self, f"h_scale_s_{i}", HyperSynthesis(n, d0, dt))
        ns0, nprog, c = self.ns0, self.ns1 - self.ns0, dim_chunk
        pw = tuple(param_net_widths)
        in_b, in_p = self._in_base, self._in_prog
        self.cc_mean = StackedParamNet(ns0, in_b, c, pw, dt)
        self.cc_scale = StackedParamNet(ns0, in_b, c, pw, dt)
        self.lrp = StackedParamNet(ns0, in_b + c, c, pw, dt)
        self.cc_mean_prog = StackedParamNet(nprog, in_p, c, pw, dt)
        self.cc_scale_prog = StackedParamNet(nprog, in_p, c, pw, dt)
        self.lrp_prog = StackedParamNet(ns0, in_p + c, c, pw, dt)
        self.entropy_bottleneck = EntropyBottleneck(n)

    # ---- derived sizes ----
    @property
    def ns0(self) -> int:
        return self.division[0] // self.dim_chunk

    @property
    def ns1(self) -> int:
        return self.division[1] // self.dim_chunk

    @property
    def n_slots_base(self) -> int:
        """Support slots of the base chain (slot j holds decoded slice j)."""
        if self.max_support_slices < 0:
            return max(self.ns0 - 1, 0)
        return min(self.max_support_slices, max(self.ns0 - 1, 0))

    @property
    def n_slots_prog(self) -> int:
        """Support slots of the progressive chain (the newest last)."""
        if self.support_progressive_slices <= 0:
            return 0
        return min(self.support_progressive_slices,
                   max(self.ns1 - self.ns0 - 1, 0))

    @property
    def _in_base(self) -> int:
        return self.division[0] + self.n_slots_base * self.dim_chunk

    @property
    def _in_prog(self) -> int:
        dp = self.division[1] - self.division[0]
        return dp + self.dim_chunk + self.n_slots_prog * self.dim_chunk

    # ---- transforms ----
    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """g_a: [B,H,W,3] -> y [B,h,w,M] (both encoders)."""
        return torch.cat([self.g_a_0(x), self.g_a_1(x)], dim=-1)

    def hyper_analysis(self, y: torch.Tensor) -> torch.Tensor:
        return self.h_a(y)

    def z_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def hyper_synthesis(self, z_hat: torch.Tensor):
        """-> (latent_means, latent_scales), both [B,h,w,M]."""
        means = torch.cat([self.h_mean_s_0(z_hat), self.h_mean_s_1(z_hat)],
                          dim=-1)
        scales = torch.cat([self.h_scale_s_0(z_hat),
                            self.h_scale_s_1(z_hat)], dim=-1)
        return means, scales

    def hyper_synthesis_base(self, z_hat: torch.Tensor):
        """The base branch only, [B,h,w,division[0]] each: all a base-only
        decode needs."""
        return self.h_mean_s_0(z_hat), self.h_scale_s_0(z_hat)

    def synthesize_base(self, y_hat_base: torch.Tensor) -> torch.Tensor:
        return self.g_s_0(y_hat_base)

    def synthesize_prog(self, y_hat_prog: torch.Tensor) -> torch.Tensor:
        return self.g_s_1(y_hat_prog)

    # ---- base chain, one slice at a time ----
    def base_buffer(self, lm_b: torch.Tensor) -> torch.Tensor:
        """Zeroed support buffer [max(n_slots, 1), B, h, w, c]."""
        b, h, w = lm_b.shape[:3]
        return torch.zeros((max(self.n_slots_base, 1), b, h, w,
                            self.dim_chunk), dtype=torch.float32,
                           device=lm_b.device)

    def _support(self, buf: torch.Tensor, n: int) -> torch.Tensor:
        """[n, B, h, w, c] slots -> [B, h, w, n*c] channel block."""
        s, b, h, w, c = buf[:n].shape
        return buf[:n].permute(1, 2, 3, 0, 4).reshape(b, h, w, s * c)

    def base_slice_params(self, lm_b, ls_b, buf, i: int):
        """Entropy params of base slice i from the base hyper outputs and
        the support buffer (unfilled slots are zero). Returns
        (mu, scale, mean_support)."""
        sup = self._support(buf, self.n_slots_base)
        mean_support = torch.cat([lm_b, sup], dim=-1)
        scale_support = torch.cat([ls_b, sup], dim=-1)
        return (self.cc_mean(mean_support, i),
                self.cc_scale(scale_support, i), mean_support)

    def finish_base_slice(self, y_hat_raw, mean_support, buf, i: int):
        """Latent residual prediction on the dequantized slice i, then the
        support-buffer update. Returns (y_hat, buf)."""
        lrp_in = torch.cat([mean_support, y_hat_raw], dim=-1)
        y_hat = y_hat_raw + 0.5 * torch.tanh(self.lrp(lrp_in, i))
        if i < self.n_slots_base:
            buf = buf.clone()
            buf[i] = y_hat
        return y_hat, buf

    # ---- progressive chain ----
    def prog_param_chain(self, base_slices: Sequence[torch.Tensor],
                         lm_e: torch.Tensor, ls_e: torch.Tensor):
        """Quality-independent progressive entropy params. Support = the
        base slice i plus the last ``n_slots_prog`` (mu_total, scale)
        tensors, front-padded with zeros. Returns stacked
        (mus, scales, mean_supports), each [S, ...]."""
        n = self.n_slots_prog
        mut_buf = [torch.zeros_like(base_slices[0])] * n
        std_buf = [torch.zeros_like(base_slices[0])] * n
        mus, scales, msups = [], [], []
        for i in range(self.ns1 - self.ns0):
            base_i = base_slices[i]
            mean_support = torch.cat([lm_e, base_i] + mut_buf, dim=-1)
            scale_support = torch.cat([ls_e, base_i] + std_buf, dim=-1)
            mu = self.cc_mean_prog(mean_support, i)
            scale = self.cc_scale_prog(scale_support, i)
            if n > 0:
                mut_buf = mut_buf[1:] + [mu + base_i]
                std_buf = std_buf[1:] + [scale]
            mus.append(mu)
            scales.append(scale)
            msups.append(mean_support)
        return torch.stack(mus), torch.stack(scales), torch.stack(msups)

    def finish_prog_slice(self, y_hat_raw, mean_support, base_i, i: int):
        """Latent residual prediction, then the merge with base slice i."""
        lrp_in = torch.cat([mean_support, y_hat_raw], dim=-1)
        return (y_hat_raw + 0.5 * torch.tanh(self.lrp_prog(lrp_in, i))
                + base_i)

    # ---- weights ----
    @torch.no_grad()
    def init_weights(self, seed: int) -> "VarianceMaskingPIC":
        """Random weights from a seed, drawn on the host (so every device
        gets the same ones): gain-1 fan-in normal convs and stacked heads,
        lecun-normal dense layers, N(0, 0.02) relative-bias tables, zero
        biases; GDN and the entropy bottleneck keep their constructor
        values."""
        gen = torch.Generator().manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (Conv, ConvTranspose)):
                init_conv_(mod, gen)
            elif isinstance(mod, Dense):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen).to(w.device)
                        / math.sqrt(w.shape[1]))
                mod.bias.zero_()
            elif isinstance(mod, StackedParamNet):
                for k in mod.stacked()[0]:
                    fan_in = k.shape[2] * 9
                    k.copy_(torch.randn(k.shape, generator=gen).to(k.device)
                            / math.sqrt(fan_in))
            elif hasattr(mod, "relative_position_bias_table"):
                t = mod.relative_position_bias_table
                t.copy_(0.02 * torch.randn(t.shape, generator=gen).to(
                    t.device))
        return self


def slices_of(y: torch.Tensor, first: int, last: int,
              c: int) -> List[torch.Tensor]:
    """Channel slices [first, last) of width c, as a list of views."""
    return [y[..., i * c:(i + 1) * c] for i in range(first, last)]
