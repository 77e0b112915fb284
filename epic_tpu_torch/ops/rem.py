"""Rate Enhancement Module blocks, stored stacked over the slices.

A LatentRateReduction refines one slice's progressive entropy parameters
(mu||sigma) from an already-decoded checkpoint latent: three encoders
(checkpoint latent, base entropy params, progressive entropy params) of
LeakyReLU residual blocks, fused by a trunk whose output, gated by the
variance mask, is added to the progressive params.

The JAX package keeps one LatentRateReduction per slice as an ``nn.vmap``
bank whose every leaf has a leading slice axis, and so does the port: each
conv of a bank is one ``StackedConv`` with weight [S, out, in, kh, kw] and
bias [S, out]. ``apply_slice(i, ...)`` runs slice i's weights;
``apply_all(...)`` runs every slice by looping over ``apply_slice``, so the
two give the same bits per slice by construction.

The JAX package builds these convs with ``dtype=None`` and holds float32
params, so they compute in float32 even in a bf16 model; the port does the
same. Submodule names follow the flax tree (``enc_base_rep_0/Conv_1``), so
``convert.from_jax_params`` maps the weights one to one.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .conv import add_bias, to_nchw, to_nhwc

LEAKY_SLOPE = 0.01  # flax's nn.leaky_relu default


class StackedConv(nn.Module):
    """S stride-1 k x k convs with "same" padding, one per slice."""

    def __init__(self, n_slices: int, in_ch: int, out_ch: int,
                 kernel_size: int):
        super().__init__()
        self.padding = kernel_size // 2
        self.weight = nn.Parameter(torch.empty(n_slices, out_ch, in_ch,
                                               kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(n_slices, out_ch))

    def apply_slice(self, i: int, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW float32."""
        y = F.conv2d(x, self.weight[i], None, 1, self.padding)
        return add_bias(y, self.bias[i])

    @torch.no_grad()
    def init_(self, gen: torch.Generator) -> None:
        """Gain-1 fan-in normal weights per slice, zero bias."""
        w = self.weight
        fan_in = w.shape[2] * w.shape[3] * w.shape[4]
        w.copy_(torch.randn(w.shape, generator=gen).to(w.device)
                / math.sqrt(fan_in))
        self.bias.zero_()


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, LEAKY_SLOPE)


class ResidualBlockSmall(nn.Module):
    """x + leaky(conv3x3(x)), with a 1x1 projection of x when the widths
    differ."""

    def __init__(self, n_slices: int, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = StackedConv(n_slices, in_ch, features, 3)
        if in_ch != features:
            self.Conv_1 = StackedConv(n_slices, in_ch, features, 1)

    def apply_slice(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = _leaky(self.Conv_0.apply_slice(i, x))
        if hasattr(self, "Conv_1"):
            x = self.Conv_1.apply_slice(i, x)
        return x + y


class ResidualBlock(nn.Module):
    """x + leaky(conv3x3(leaky(conv3x3(x)))), with a 1x1 projection of x
    (``Conv_2``) when the widths differ."""

    def __init__(self, n_slices: int, in_ch: int, features: int):
        super().__init__()
        self.Conv_0 = StackedConv(n_slices, in_ch, features, 3)
        self.Conv_1 = StackedConv(n_slices, features, features, 3)
        if in_ch != features:
            self.Conv_2 = StackedConv(n_slices, in_ch, features, 1)

    def apply_slice(self, i: int, x: torch.Tensor) -> torch.Tensor:
        y = _leaky(self.Conv_0.apply_slice(i, x))
        y = _leaky(self.Conv_1.apply_slice(i, y))
        if hasattr(self, "Conv_2"):
            x = self.Conv_2.apply_slice(i, x)
        return x + y


class LatentRateReduction(nn.Module):
    """One REM bank: S stacked LatentRateReduction modules.

    Inputs (NHWC, float32): x_base [B,h,w,c] checkpoint latent slice,
    params_base [B,h,w,2c] base mu||sigma, params_prog [B,h,w,2c] (or
    [B,h,w,c] sigma only without ``mu_std``) progressive params, att_mask
    of params_prog's shape. Output: params_prog + fused * att_mask.
    """

    def __init__(self, n_slices: int, dim_chunk: int = 32,
                 mu_std: bool = True, dimension: str = "middle"):
        super().__init__()
        if dimension not in ("middle", "big"):
            raise ValueError(f"unknown REM dimension {dimension!r}")
        c = dim_chunk
        depth = 3 if dimension == "big" else 2
        prog_ch = 2 * c if mu_std else c
        for name, in_ch in (("enc_base_rep", c), ("enc_base_entropy", 2 * c),
                            ("enc_prog_entropy", prog_ch)):
            for i in range(depth):
                setattr(self, f"{name}_{i}",
                        ResidualBlock(n_slices, in_ch if i == 0 else c, c))
        widths = [2 * c] * depth + [prog_ch]
        in_ch = 3 * c
        for i, wd in enumerate(widths):
            setattr(self, f"fuse_{i}", ResidualBlock(n_slices, in_ch, wd))
            in_ch = wd
        self.depth = depth

    def _blocks(self, name: str) -> List[ResidualBlock]:
        n = self.depth + 1 if name == "fuse" else self.depth
        return [getattr(self, f"{name}_{i}") for i in range(n)]

    def apply_slice(self, i: int, x_base: torch.Tensor,
                    params_base: torch.Tensor, params_prog: torch.Tensor,
                    att_mask: torch.Tensor) -> torch.Tensor:
        """Slice i's weights on one slice's tensors (NHWC)."""
        feats = []
        for name, x in (("enc_base_rep", x_base),
                        ("enc_base_entropy", params_base),
                        ("enc_prog_entropy", params_prog)):
            x = to_nchw(x)
            for block in self._blocks(name):
                x = block.apply_slice(i, x)
            feats.append(x)
        fused = torch.cat(feats, dim=1)
        for block in self._blocks("fuse"):
            fused = block.apply_slice(i, fused)
        return params_prog + to_nhwc(fused) * att_mask

    def apply_all(self, x_base: torch.Tensor, params_base: torch.Tensor,
                  params_prog: torch.Tensor,
                  att_mask: torch.Tensor) -> torch.Tensor:
        """Every slice: inputs and output stacked [S, B, h, w, ch]."""
        return torch.stack([
            self.apply_slice(i, x_base[i], params_base[i], params_prog[i],
                             att_mask[i])
            for i in range(x_base.shape[0])])
