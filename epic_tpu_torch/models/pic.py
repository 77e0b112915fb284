"""VarianceMaskingPIC: the paper's progressive model.

An image is coded as a base latent (the first ``division[0]`` channels,
``ns0`` channel-autoregressive slices with up to ``max_support_slices`` of
support) plus a residual latent (the delta between the enhancement and base
representations, ``ns1 - ns0`` more slices). Residual elements are
transmitted in the order of their predicted std; untransmitted ones decode
to the predicted mean.

Four options follow the JAX package's fields, each on by default as in
every configuration it ships:

- ``all_scalable``: the progressive entropy parameters depend only on the
  decoded base latent, so they are computed once for every quality. Off,
  slice i's parameters are supported on the decoded progressive slices
  0..i-1 of this quality, so the chain runs once per quality and
  interleaves parameters and reconstruction (``prog_slices_non_scalable``);
- ``delta_encode``: the residual is the enhancement slice minus the base
  slice (off: the enhancement slice itself). The decoded slice adds the
  base slice back either way, as the JAX package's does;
- ``total_mu_rep``: the mean support of the all_scalable chain holds mu
  plus the base slice (off: mu);
- ``mask_policy``: "point-based-std" (the top q*10% by predicted std) or
  "two-levels" (nothing at quality 0, everything above it).

The transforms and the hyperprior are two branches each (``multiple_encoder`` /
``_decoder`` / ``_hyperprior``, default True: ``g_a_0`` / ``g_a_1`` ...) or
one (``g_a``, ``g_s``, ``h_mean_s``, ``h_scale_s``; the single ``g_a`` and
hyper-synthesis output all M channels). With ``division[0] ==
division[1]`` (WACNN) there is no progressive stage and no progressive
heads.

The JAX package runs the slice chains as ``lax.scan`` over stacked weights;
here they are loops over the same stacked weights (scan and unrolled are
bitwise equal in the reference). Tensors are NHWC; entropy parameters are
float32 whatever the compute dtype.

The training forwards (``forward``, multi-quality; ``forward_single_quality``)
reuse the codec's slice functions. With ``training`` the rounding of z and
of the latents is replaced by U(-0.5, 0.5) noise drawn from an explicit
``torch.Generator`` on the model's device, and the reconstructions use
straight-through rounding; without it they round, as the codec does.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
from torch import nn

from ..entropy.bottleneck import EntropyBottleneck
from ..entropy.gaussian import gaussian_likelihood, gaussian_noise_quantize
from ..entropy.ops import quantize_ste, ste_round
from ..ops.attention import Dense
from ..ops.conv import Conv, ConvTranspose, init_conv_
from ..ops.masking import apply_noise_mask, variance_mask
from .builder import (AnalysisTransform, HyperAnalysis, HyperSynthesis,
                      StackedParamNet, SynthesisTransform)


class VarianceMaskingPIC(nn.Module):
    def __init__(self, n: int = 192, m: int = 640,
                 division: Sequence[int] = (320, 640), dim_chunk: int = 32,
                 support_progressive_slices: int = 5,
                 max_support_slices: int = 5,
                 param_net_widths: Sequence[int] = (224, 176, 128, 64),
                 compute_dtype: str = "float32", scale_bound: float = 0.11,
                 multiple_encoder: bool = True, multiple_decoder: bool = True,
                 multiple_hyperprior: bool = True, delta_encode: bool = True,
                 total_mu_rep: bool = True, all_scalable: bool = True,
                 mask_policy: str = "point-based-std"):
        super().__init__()
        self.n, self.m = n, m
        self.division = tuple(division)
        self.dim_chunk = dim_chunk
        self.support_progressive_slices = support_progressive_slices
        self.max_support_slices = max_support_slices
        self.scale_bound = scale_bound
        self.compute_dtype = compute_dtype
        self.multiple_encoder = multiple_encoder
        self.multiple_decoder = multiple_decoder
        self.multiple_hyperprior = multiple_hyperprior
        self.delta_encode = delta_encode
        self.total_mu_rep = total_mu_rep
        self.all_scalable = all_scalable
        self.mask_policy = mask_policy
        dt = None if compute_dtype == "float32" else getattr(torch,
                                                             compute_dtype)
        self.dt = dt
        d0 = self.division[0]
        if multiple_encoder:
            for i in range(2):
                setattr(self, f"g_a_{i}", AnalysisTransform(n, d0, dt))
        else:
            self.g_a = AnalysisTransform(n, m, dt)
        if multiple_decoder:
            for i in range(2):
                setattr(self, f"g_s_{i}", SynthesisTransform(n, d0, dt))
        else:
            self.g_s = SynthesisTransform(n, d0, dt)
        self.h_a = HyperAnalysis(m, n, dt)
        if multiple_hyperprior:
            for i in range(2):
                setattr(self, f"h_mean_s_{i}", HyperSynthesis(n, d0, dt))
                setattr(self, f"h_scale_s_{i}", HyperSynthesis(n, d0, dt))
        else:
            self.h_mean_s = HyperSynthesis(n, m, dt, first_width=n)
            self.h_scale_s = HyperSynthesis(n, m, dt, first_width=n)
        ns0, nprog, c = self.ns0, self.ns1 - self.ns0, dim_chunk
        pw = tuple(param_net_widths)
        in_b, in_p = self._in_base, self._in_prog
        self.cc_mean = StackedParamNet(ns0, in_b, c, pw, dt)
        self.cc_scale = StackedParamNet(ns0, in_b, c, pw, dt)
        self.lrp = StackedParamNet(ns0, in_b + c, c, pw, dt)
        if nprog > 0:
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
    @property
    def progressive(self) -> bool:
        """Whether the model has a progressive stage (WACNN has none)."""
        return self.ns1 > self.ns0

    def latent(self, x: torch.Tensor) -> torch.Tensor:
        """g_a: [B,H,W,3] -> y [B,h,w,M] (both encoders)."""
        if not self.multiple_encoder:
            return self.g_a(x)
        return torch.cat([self.g_a_0(x), self.g_a_1(x)], dim=-1)

    def hyper_analysis(self, y: torch.Tensor) -> torch.Tensor:
        return self.h_a(y)

    def z_medians(self) -> torch.Tensor:
        return self.entropy_bottleneck.medians()

    def hyper_synthesis(self, z_hat: torch.Tensor):
        """-> (latent_means, latent_scales), both [B,h,w,M]."""
        if not self.multiple_hyperprior:
            return self.h_mean_s(z_hat), self.h_scale_s(z_hat)
        means = torch.cat([self.h_mean_s_0(z_hat), self.h_mean_s_1(z_hat)],
                          dim=-1)
        scales = torch.cat([self.h_scale_s_0(z_hat),
                            self.h_scale_s_1(z_hat)], dim=-1)
        return means, scales

    def hyper_synthesis_base(self, z_hat: torch.Tensor):
        """The base branch only, [B,h,w,division[0]] each: all a base-only
        decode needs."""
        if not self.multiple_hyperprior:
            d0 = self.division[0]
            return (self.h_mean_s(z_hat)[..., :d0],
                    self.h_scale_s(z_hat)[..., :d0])
        return self.h_mean_s_0(z_hat), self.h_scale_s_0(z_hat)

    def synthesize_base(self, y_hat_base: torch.Tensor) -> torch.Tensor:
        return (self.g_s_0 if self.multiple_decoder else self.g_s)(y_hat_base)

    def synthesize_prog(self, y_hat_prog: torch.Tensor) -> torch.Tensor:
        return (self.g_s_1 if self.multiple_decoder else self.g_s)(y_hat_prog)

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
    def prog_slice_params(self, lm_e, ls_e, base_i, mu_support, std_support,
                          i: int):
        """Entropy params of progressive slice i from the enhancement hyper
        outputs, base slice i and the last ``min(support, i)`` entries of
        ``mu_support`` / ``std_support``, front-padded with zeros to the
        ``n_slots_prog`` slots (the newest last). Returns (mu, mu_total,
        scale, mean_support); mu_total is mu + base_i with
        ``total_mu_rep``, else mu."""
        sps = self.support_progressive_slices
        k = min(sps, i) if sps > 0 else 0
        n = self.n_slots_prog
        front = [] if k >= n else [base_i.new_zeros(
            base_i.shape[:-1] + ((n - k) * self.dim_chunk,))]
        tail_mu = list(mu_support[len(mu_support) - k:]) if k else []
        tail_std = list(std_support[len(std_support) - k:]) if k else []
        mean_support = torch.cat([lm_e, base_i] + front + tail_mu, dim=-1)
        scale_support = torch.cat([ls_e, base_i] + front + tail_std, dim=-1)
        mu = self.cc_mean_prog(mean_support, i)
        mut = mu + base_i if self.total_mu_rep else mu
        return mu, mut, self.cc_scale_prog(scale_support, i), mean_support

    def prog_param_chain(self, base_slices: Sequence[torch.Tensor],
                         lm_e: torch.Tensor, ls_e: torch.Tensor):
        """Quality-independent progressive entropy params (the all_scalable
        chain): slice i is supported on the earlier slices' (mu_total,
        scale). Returns stacked (mus, scales, mean_supports), each
        [S, ...]."""
        mus, muts, scales, msups = [], [], [], []
        for i in range(self.ns1 - self.ns0):
            mu, mut, scale, msup = self.prog_slice_params(
                lm_e, ls_e, base_slices[i], muts, scales, i)
            for acc, t in zip((mus, muts, scales, msups),
                              (mu, mut, scale, msup)):
                acc.append(t)
        return torch.stack(mus), torch.stack(scales), torch.stack(msups)

    def finish_prog_slice(self, y_hat_raw, mean_support, base_i, i: int):
        """Latent residual prediction, then the merge with base slice i."""
        lrp_in = torch.cat([mean_support, y_hat_raw], dim=-1)
        return (y_hat_raw + 0.5 * torch.tanh(self.lrp_prog(lrp_in, i))
                + base_i)

    def refine_prog_params_all(self, quality, mus, scales, checkpoint_ref,
                               mus_b, scales_b):
        """The REM hook of the progressive params at one quality: the
        identity here (``VarianceMaskingPICREM`` refines)."""
        return mus, scales

    def refine_prog_params(self, i: int, quality, mu, scale, checkpoint_ref,
                           mu_base_i, std_base_i):
        """The REM hook of progressive slice i at one quality (the
        interleaved chain): the identity here."""
        return mu, scale

    def prog_slices_non_scalable(self, r_s, quality: float, base, lm_e, ls_e,
                                 training: bool, generator,
                                 checkpoint_ref=None, mus_b=None,
                                 scales_b=None):
        """The progressive chain of ``all_scalable=False`` at one quality:
        slice i's params are supported on the decoded progressive slices
        0..i-1 of this quality, then (with a checkpoint latent) REM-refined
        for its masking and coding. r_s: the residual slices [S, B, h, w,
        c]. Returns lists (decoded slices, likelihoods, mus, scales)."""
        prog, liks, mus, scales = [], [], [], []
        for i in range(r_s.shape[0]):
            mu, _, scale, msup = self.prog_slice_params(lm_e, ls_e, base[i],
                                                        prog, prog, i)
            if checkpoint_ref is not None:
                mu, scale = self.refine_prog_params(
                    i, quality, mu, scale, checkpoint_ref, mus_b[i],
                    scales_b[i])
            mask = apply_noise_mask(
                variance_mask(scale, quality, self.mask_policy), False)
            y_hat_i, lik = self._masked_slice(r_s[i], mu, scale, mask,
                                              training, generator)
            prog.append(self.finish_prog_slice(y_hat_i, msup, base[i], i))
            for acc, t in zip((liks, mus, scales), (lik, mu, scale)):
                acc.append(t)
        return prog, liks, mus, scales

    # ---- training forwards ----
    def _train_front(self, x, training: bool, generator):
        """g_a -> h_a -> bottleneck -> h_s. Returns (y, z likelihoods,
        latent_means, latent_scales); z_hat is z rounded straight through
        around the medians."""
        y = self.latent(x)
        z = self.h_a(y)
        _, z_lik = self.entropy_bottleneck(z, training, generator)
        z_hat = quantize_ste(z, self.z_medians())
        lm, ls = self.hyper_synthesis(z_hat)
        return y, z_lik, lm, ls

    def _train_base_chain(self, y, lm, ls, training: bool, generator):
        """The base slices with their likelihoods (of noisy slices in
        training, of rounded ones otherwise). y_hat is y rounded straight
        through around mu, then refined by LRP. Returns lists (y_hat, liks,
        mus, scales)."""
        d0 = self.division[0]
        lm_b, ls_b = lm[..., :d0], ls[..., :d0]
        buf = self.base_buffer(lm_b)
        out = ([], [], [], [])
        for i, y_i in enumerate(slices_of(y, 0, self.ns0, self.dim_chunk)):
            mu, scale, msup = self.base_slice_params(lm_b, ls_b, buf, i)
            noisy = (gaussian_noise_quantize(y_i, generator) if training
                     else quantize_ste(y_i, mu))
            lik = gaussian_likelihood(noisy, scale, mu, self.scale_bound)
            y_hat, buf = self.finish_base_slice(quantize_ste(y_i, mu), msup,
                                                buf, i)
            for acc, t in zip(out, (y_hat, lik, mu, scale)):
                acc.append(t)
        return out

    def residuals(self, y: torch.Tensor) -> torch.Tensor:
        """The progressive residual slices [S, B, h, w, c]: enhancement
        slice minus base slice with ``delta_encode``, else the enhancement
        slice."""
        c, ns0, nprog = self.dim_chunk, self.ns0, self.ns1 - self.ns0
        enh = slices_of(y, ns0, ns0 + nprog, c)
        if not self.delta_encode:
            return torch.stack(enh)
        return torch.stack([a - b for a, b in zip(
            enh, slices_of(y, 0, nprog, c))])

    def _masked_slice(self, r_i, mu, scale, mask, training: bool,
                      generator):
        """One progressive slice at the masks ``mask`` (any leading level
        axes broadcast against r_i / mu / scale): (y_hat before LRP,
        likelihoods). Untransmitted elements decode to mu."""
        centered = (r_i - mu) * mask
        noisy = (gaussian_noise_quantize(centered, generator) if training
                 else ste_round(centered))
        lik = gaussian_likelihood(noisy, scale * mask, None,
                                  self.scale_bound)
        return ste_round(r_i - mu) * mask + mu, lik

    @staticmethod
    def _define_quality(quality) -> List[float]:
        if quality is None:
            return [0, 10]
        if isinstance(quality, (list, tuple)):
            return list(quality) if quality[0] == 0 else [0] + list(quality)
        return [quality]

    def multi_quality(self, x: torch.Tensor, quality=None,
                      training: bool = True,
                      generator: torch.Generator = None):
        """Multi-quality training forward (the JAX package's ``__call__``,
        and this model's ``forward``; the trainer calls it by this name,
        which subclasses that define another ``forward`` keep):
        x [B,H,W,3] -> {"x_hat": [1+L, B, H, W, 3] (base first, not
        clipped), "likelihoods": {"y": base [B,h,w,d0], "y_prog": per level
        [L,B,h,w,d1] (base + that level's slices), "z"}, "y_base", "y_prog",
        "prog_scales", "prog_mus"}, for the qualities (0 first) of
        ``quality`` (default [0, 10]). ``generator`` draws the training
        noise. Without ``all_scalable`` the chain runs once per quality,
        "y_prog" is the last quality's latent [B,h,w,d1-d0] and there are
        no "prog_scales" / "prog_mus", as in the JAX package."""
        qualities = self._define_quality(quality)
        y, z_lik, lm, ls = self._train_front(x, training, generator)
        base, base_liks, _, _ = self._train_base_chain(y, lm, ls, training,
                                                       generator)
        y_hat_b = torch.cat(base, dim=-1)
        x_hat_base = self.synthesize_base(y_hat_b)
        y_lik_base = torch.cat(base_liks, dim=-1)
        prog_qs = [q for q in qualities if q != 0] if self.progressive \
            else []
        if not prog_qs:
            return {"x_hat": x_hat_base[None],
                    "likelihoods": {"y": y_lik_base, "z": z_lik},
                    "y_base": y_hat_b}
        d0 = self.division[0]
        r_s = self.residuals(y)
        if not self.all_scalable:
            x_hats, lik_levels = [x_hat_base[None]], []
            for q in prog_qs:
                prog, liks, _, _ = self.prog_slices_non_scalable(
                    r_s, q, base, lm[..., d0:], ls[..., d0:], training,
                    generator)
                y_hat_q = torch.cat(prog, dim=-1)
                x_hats.append(self.synthesize_prog(y_hat_q)[None])
                lik_levels.append(torch.cat([y_lik_base] + liks,
                                            dim=-1)[None])
            return {"x_hat": torch.cat(x_hats, dim=0),
                    "likelihoods": {"y": y_lik_base,
                                    "y_prog": torch.cat(lik_levels, dim=0),
                                    "z": z_lik},
                    "y_base": y_hat_b, "y_prog": y_hat_q}
        mus, scales, msups = self.prog_param_chain(base, lm[..., d0:],
                                                   ls[..., d0:])
        levels, b = len(prog_qs), x.shape[0]

        def fold(t):  # [B, ...] -> [L*B, ...], level-major
            return t.repeat((levels,) + (1,) * (t.dim() - 1))

        prog_slices, prog_liks = [], []
        for i in range(r_s.shape[0]):
            mask = torch.stack([apply_noise_mask(variance_mask(
                scales[i], q, self.mask_policy), False) for q in prog_qs])
            y_hat_i, lik = self._masked_slice(r_s[i][None], mus[i][None],
                                              scales[i][None], mask,
                                              training, generator)
            flat = self.finish_prog_slice(y_hat_i.flatten(0, 1),
                                          fold(msups[i]), fold(base[i]), i)
            prog_slices.append(flat.reshape(y_hat_i.shape))
            prog_liks.append(lik)
        y_hat_prog = torch.cat(prog_slices, dim=-1)  # [L, B, h, w, d1 - d0]
        x_hat_prog = self.synthesize_prog(y_hat_prog.flatten(0, 1))
        x_hat_prog = x_hat_prog.reshape((levels, b) + x_hat_prog.shape[1:])
        y_lik_prog = torch.cat(prog_liks, dim=-1)
        y_lik_levels = torch.cat(
            [y_lik_base[None].expand((levels,) + y_lik_base.shape),
             y_lik_prog], dim=-1)
        return {"x_hat": torch.cat([x_hat_base[None], x_hat_prog], dim=0),
                "likelihoods": {"y": y_lik_base, "y_prog": y_lik_levels,
                                "z": z_lik},
                "y_base": y_hat_b, "y_prog": y_hat_prog,
                "prog_scales": scales, "prog_mus": mus}

    forward = multi_quality

    def forward_single_quality(self, x: torch.Tensor, quality: float,
                               training: bool = False, checkpoint_ref=None,
                               generator: torch.Generator = None):
        """One-quality forward: x [B,H,W,3] -> {"x_hat" clipped to [0, 1],
        "likelihoods": {"y": base and progressive slices, "z"}, "y_hat",
        "y_base", "y_prog", "mu_base", "mu", "std_base", "std"}. Quality 0
        decodes the base alone ("y_hat" is the base latent). With a
        checkpoint latent ``checkpoint_ref`` a ``rem`` model's REMs refine
        the masking and coding params (the support chain stays
        unrefined)."""
        y, z_lik, lm, ls = self._train_front(x, training, generator)
        base, base_liks, mus_b, scales_b = self._train_base_chain(
            y, lm, ls, training, generator)
        y_hat_b = torch.cat(base, dim=-1)
        y_lik_base = torch.cat(base_liks, dim=-1)
        if quality == 0:
            return {"x_hat": torch.clamp(self.synthesize_base(y_hat_b), 0.0,
                                         1.0),
                    "likelihoods": {"y": y_lik_base, "z": z_lik},
                    "y_hat": y_hat_b, "y_base": y_hat_b,
                    "mu": torch.cat(mus_b, dim=-1),
                    "std": torch.cat(scales_b, dim=-1)}
        d0 = self.division[0]
        r_s = self.residuals(y)
        if not self.all_scalable:
            prog_slices, prog_liks, mus, scales = \
                self.prog_slices_non_scalable(
                    r_s, quality, base, lm[..., d0:], ls[..., d0:], training,
                    generator, checkpoint_ref, mus_b, scales_b)
        else:
            mus, scales, msups = self.prog_param_chain(base, lm[..., d0:],
                                                       ls[..., d0:])
            mus, scales = self.refine_prog_params_all(
                quality, mus, scales, checkpoint_ref, torch.stack(mus_b),
                torch.stack(scales_b))
            prog_slices, prog_liks = [], []
            for i in range(r_s.shape[0]):
                mask = apply_noise_mask(variance_mask(
                    scales[i], quality, self.mask_policy), False)
                y_hat_i, lik = self._masked_slice(
                    r_s[i], mus[i], scales[i], mask, training, generator)
                prog_slices.append(self.finish_prog_slice(y_hat_i, msups[i],
                                                          base[i], i))
                prog_liks.append(lik)
        y_hat_p = torch.cat(prog_slices, dim=-1)
        return {"x_hat": torch.clamp(self.synthesize_prog(y_hat_p), 0.0, 1.0),
                "likelihoods": {"y": torch.cat([y_lik_base] + prog_liks,
                                               dim=-1), "z": z_lik},
                "y_hat": y_hat_p, "y_base": y_hat_b, "y_prog": y_hat_p,
                "mu_base": torch.cat(mus_b, dim=-1),
                "mu": torch.cat(list(mus), dim=-1),
                "std_base": torch.cat(scales_b, dim=-1),
                "std": torch.cat(list(scales), dim=-1)}

    def aux_loss(self) -> torch.Tensor:
        """The bottleneck's quantile-fitting loss."""
        return self.entropy_bottleneck.aux_loss()

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
