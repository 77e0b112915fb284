"""Analysis / synthesis / hyperprior transforms and the stacked per-slice
entropy-parameter heads, over NHWC tensors.

g_a: four stride-2 5x5 convs with GDN and two gated window-attention blocks
(16x down); g_s mirrors it with transposed convs and inverse GDN; h_a / h_s
are the 4x down / up hyper transforms. Submodule and parameter names follow
the JAX package's parameter tree (``Conv_0``, ``GDN_1``, ...), so
``convert.from_jax_params`` maps weights one to one.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import WinNoShiftAttention, gelu
from ..ops.conv import SubpelConv, add_bias, cast, conv, conv3x3, deconv
from ..ops.gdn import GDN


class AnalysisTransform(nn.Module):
    """g_a: image [B,H,W,3] -> latent [B,H/16,W/16,out_dim] (float32)."""

    def __init__(self, n: int, out_dim: int, dtype=None):
        super().__init__()
        self.Conv_0 = conv(3, n, dtype=dtype)
        self.GDN_0 = GDN(n)
        self.Conv_1 = conv(n, n, dtype=dtype)
        self.GDN_1 = GDN(n)
        self.WinNoShiftAttention_0 = WinNoShiftAttention(n, 8, 8, 4, dtype)
        self.Conv_2 = conv(n, n, dtype=dtype)
        self.GDN_2 = GDN(n)
        self.Conv_3 = conv(n, out_dim, dtype=dtype)
        self.WinNoShiftAttention_1 = WinNoShiftAttention(out_dim, 8, 4, 2,
                                                         dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.GDN_0(self.Conv_0(x))
        x = self.GDN_1(self.Conv_1(x))
        x = self.WinNoShiftAttention_0(x)
        x = self.GDN_2(self.Conv_2(x))
        x = self.WinNoShiftAttention_1(self.Conv_3(x))
        return x.float()


class SynthesisTransform(nn.Module):
    """g_s: latent [B,h,w,in_dim] -> image [B,16h,16w,3] (float32)."""

    def __init__(self, n: int, in_dim: int, dtype=None):
        super().__init__()
        self.WinNoShiftAttention_0 = WinNoShiftAttention(in_dim, 8, 4, 2,
                                                         dtype)
        self.ConvTranspose_0 = deconv(in_dim, n, dtype)
        self.GDN_0 = GDN(n, inverse=True)
        self.ConvTranspose_1 = deconv(n, n, dtype)
        self.GDN_1 = GDN(n, inverse=True)
        self.WinNoShiftAttention_1 = WinNoShiftAttention(n, 8, 8, 4, dtype)
        self.ConvTranspose_2 = deconv(n, n, dtype)
        self.GDN_2 = GDN(n, inverse=True)
        self.ConvTranspose_3 = deconv(n, 3, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.WinNoShiftAttention_0(x)
        x = self.GDN_0(self.ConvTranspose_0(x))
        x = self.GDN_1(self.ConvTranspose_1(x))
        x = self.WinNoShiftAttention_1(x)
        x = self.GDN_2(self.ConvTranspose_2(x))
        return self.ConvTranspose_3(x).float()


class HyperAnalysis(nn.Module):
    """h_a: y [B,h,w,M] -> z [B,h/4,w/4,N]."""

    def __init__(self, m: int, n: int, dtype=None):
        super().__init__()
        self.Conv_0 = conv3x3(m, 320, dtype=dtype)
        self.Conv_1 = conv3x3(320, 288, dtype=dtype)
        self.Conv_2 = conv3x3(288, 256, stride=2, dtype=dtype)
        self.Conv_3 = conv3x3(256, 224, dtype=dtype)
        self.Conv_4 = conv3x3(224, n, stride=2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = gelu(getattr(self, f"Conv_{i}")(x))
        return self.Conv_4(x).float()


class HyperSynthesis(nn.Module):
    """One h_s branch: z_hat [B,h/4,w/4,N] -> params [B,h,w,out_dim]."""

    def __init__(self, n: int, out_dim: int, dtype=None,
                 first_width: int = 192):
        super().__init__()
        self.Conv_0 = conv3x3(n, first_width, dtype=dtype)
        self.SubpelConv_0 = SubpelConv(first_width, 224, 2, dtype)
        self.Conv_1 = conv3x3(224, 256, dtype=dtype)
        self.SubpelConv_1 = SubpelConv(256, 288, 2, dtype)
        self.Conv_2 = conv3x3(288, out_dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.Conv_0(x))
        x = gelu(self.SubpelConv_0(x))
        x = gelu(self.Conv_1(x))
        x = gelu(self.SubpelConv_1(x))
        return self.Conv_2(x).float()


def paramnet_apply(kernels, biases, x: torch.Tensor, i: int,
                   dtype=None) -> torch.Tensor:
    """Apply slice i of a stacked ParamNet weight set: 3x3 convs with GELU
    between them, float32 out. kernels: [S, out, in, 3, 3]; biases [S, out].
    """
    n_layers = len(kernels)
    x = x.permute(0, 3, 1, 2)
    for layer in range(n_layers):
        x, k, b = cast(dtype, x, kernels[layer][i], biases[layer][i])
        x = add_bias(F.conv2d(x, k, None, 1, 1), b)
        if layer < n_layers - 1:
            x = gelu(x)
    return x.permute(0, 2, 3, 1).float()


class StackedParamNet(nn.Module):
    """All S per-slice heads of one kind as one stacked weight set
    (``Conv_{l}_kernel`` [S, out, in, 3, 3], ``Conv_{l}_bias`` [S, out]).
    Ragged first-layer input widths are zero-padded to ``in_width``; the
    callers feed zero channels there, which contribute exactly zero."""

    def __init__(self, n_slices: int, in_width: int, out_dim: int = 32,
                 widths: Sequence[int] = (224, 176, 128, 64), dtype=None):
        super().__init__()
        self.dtype = dtype
        dims = (in_width,) + tuple(widths) + (out_dim,)
        self.n_layers = len(dims) - 1
        for layer in range(self.n_layers):
            self.register_parameter(f"Conv_{layer}_kernel", nn.Parameter(
                torch.empty(n_slices, dims[layer + 1], dims[layer], 3, 3)))
            self.register_parameter(f"Conv_{layer}_bias", nn.Parameter(
                torch.zeros(n_slices, dims[layer + 1])))

    def stacked(self):
        return (tuple(getattr(self, f"Conv_{l}_kernel")
                      for l in range(self.n_layers)),
                tuple(getattr(self, f"Conv_{l}_bias")
                      for l in range(self.n_layers)))

    def forward(self, x: torch.Tensor, i: int) -> torch.Tensor:
        kernels, biases = self.stacked()
        return paramnet_apply(kernels, biases, x, i, self.dtype)
