"""Convolutions over NHWC tensors.

Inputs and outputs are NHWC, as in the JAX package. Inside, an NHWC tensor
is handed to cuDNN as the NCHW view ``x.permute(0, 3, 1, 2)``, which is the
channels-last memory format, so no copy is made.

Weights are stored in PyTorch's layouts (``conv2d``: [out, in, kh, kw];
``conv_transpose2d``: [in, out, kh, kw]) and kept in float32; a module with
a compute ``dtype`` casts its input and weights to it at the call, as flax
does.

Stride-2 k=5 convolutions halve the spatial dims exactly; transposed ones
double them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def cast(dtype, *tensors):
    """Cast every tensor to the compute dtype (None keeps them as they are)."""
    if dtype is None:
        return tensors
    return tuple(t.to(dtype) for t in tensors)


def add_bias(y: torch.Tensor, b: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """y + b along ``dim``, as flax does: the product is rounded to the
    compute dtype before the bias is added. A conv or matmul with the bias
    fused in rounds once, and in bf16 about a quarter of the outputs then
    differ from the JAX package's by one unit."""
    shape = [1] * y.dim()
    shape[dim] = -1
    return y + b.reshape(shape)


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class Conv(nn.Module):
    """k x k conv with p = k//2 padding on both sides (out = ceil(in/s))."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 2, dtype=None):
        super().__init__()
        self.stride = stride
        self.padding = kernel_size // 2
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = cast(self.dtype, x, self.weight, self.bias)
        y = F.conv2d(to_nchw(x), w, None, self.stride, self.padding)
        return to_nhwc(add_bias(y, b))


def conv(in_ch: int, out_ch: int, dtype=None) -> Conv:
    """The stride-2 5x5 conv of g_a."""
    return Conv(in_ch, out_ch, 5, 2, dtype)


def conv1x1(in_ch: int, out_ch: int, dtype=None) -> Conv:
    return Conv(in_ch, out_ch, 1, 1, dtype)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1, dtype=None) -> Conv:
    return Conv(in_ch, out_ch, 3, stride, dtype)


class ConvTranspose(nn.Module):
    """Transposed conv that multiplies the spatial dims by ``stride``, with
    flax ``ConvTranspose(padding="SAME")`` semantics: for k=5, s=2 the
    stride-dilated input is padded (3, 2) and correlated with the kernel as
    it is, not flipped.

    ``conv_transpose2d`` correlates the dilated input, padded k - 1 - p on
    both sides, with the spatially flipped weight. So the weight holds the
    flax kernel flipped, p = 1 pads (3, 3), and cropping the one trailing
    row and column leaves exactly flax's (3, 2) window.
    """

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 5,
                 stride: int = 2, dtype=None):
        super().__init__()
        if (kernel_size, stride) != (5, 2):
            raise ValueError("only the k=5, s=2 transposed conv is used")
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, kernel_size,
                                               kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = cast(self.dtype, x, self.weight, self.bias)
        y = F.conv_transpose2d(to_nchw(x), w, None, self.stride, padding=1)
        return to_nhwc(add_bias(y[:, :, :-1, :-1], b))


def deconv(in_ch: int, out_ch: int, dtype=None) -> ConvTranspose:
    return ConvTranspose(in_ch, out_ch, 5, 2, dtype)


class SubpelConv(nn.Module):
    """3x3 conv to features*r^2 channels, then depth-to-space with the JAX
    package's channel order (channel = (ry*r + rx)*features + f, which is
    not ``pixel_shuffle``'s)."""

    def __init__(self, in_ch: int, features: int, r: int = 2, dtype=None):
        super().__init__()
        self.features = features
        self.r = r
        self.Conv_0 = conv3x3(in_ch, features * r * r, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        r, f = self.r, self.features
        y = self.Conv_0(x).reshape(b, h, w, r, r, f)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(b, h * r, w * r, f)


@torch.no_grad()
def init_conv_(module: nn.Module, gen: torch.Generator) -> None:
    """Gain-1 fan-in normal init of a conv's weight (fan-in = in*kh*kw, the
    JAX package's DEFAULT_INIT), zero bias."""
    w = module.weight
    if isinstance(module, ConvTranspose):
        fan_in = w.shape[0] * w.shape[2] * w.shape[3]
    else:
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
    w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(fan_in))
    module.bias.zero_()
