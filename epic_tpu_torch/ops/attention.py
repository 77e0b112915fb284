"""Swin-style windowed attention blocks over NHWC tensors.

W-MSA / SW-MSA with a relative position bias, cyclic shift and a static
shift mask, and the STF gate: a trunk of residual units gated by the sigmoid
of a windowed-attention branch. Windows are 8x8 (shift 4) after the second
stride-2 conv of g_a / before the last two of g_s, and 4x4 (shift 2) at the
latent.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .conv import add_bias, cast, conv1x1, conv3x3


def gelu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu's default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B,H,W,C] -> [B*nW, window*window, C]"""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def window_reverse(windows: torch.Tensor, window: int, h: int,
                   w: int) -> torch.Tensor:
    """[B*nW, window*window, C] -> [B,H,W,C]"""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // window // window)
    x = windows.reshape(b, h // window, w // window, window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def relative_position_index(window: int) -> np.ndarray:
    """Static [window^2, window^2] index into the (2w-1)^2 bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window),
                                  indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """Static SW-MSA mask [nW, n, n] of 0 / -100 between the regions that the
    cyclic shift brings into one window."""
    img = np.zeros((1, h, w, 1), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img[:, hs, ws, :] = cnt
            cnt += 1
    mw = img.reshape(1, h // window, window, w // window, window, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    diff = mw[:, None, :] - mw[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class Dense(nn.Module):
    """x @ weight.T + bias in the compute dtype (weight [out, in])."""

    def __init__(self, in_f: int, out_f: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_f, in_f))
        self.bias = nn.Parameter(torch.zeros(out_f))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, w, b = cast(self.dtype, x, self.weight, self.bias)
        return add_bias(F.linear(x, w), b, -1)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside one window with a relative bias."""

    def __init__(self, dim: int, window: int, num_heads: int = 8, dtype=None):
        super().__init__()
        self.window = window
        self.num_heads = num_heads
        self.qkv = Dense(dim, 3 * dim, dtype)
        self.proj = Dense(dim, dim, dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer(
            "rel_index",
            torch.from_numpy(relative_position_index(window).reshape(-1)),
            persistent=False)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x [B_, n, C] with n = window^2; mask [nW, n, n] or None."""
        b_, n, c = x.shape
        heads = self.num_heads
        hd = c // heads
        qkv = self.qkv(x).reshape(b_, n, 3, heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]              # [B_, heads, n, hd]
        attn = torch.matmul(q * hd ** -0.5, k.transpose(-2, -1))
        bias = self.relative_position_bias_table[self.rel_index]
        attn = attn + bias.reshape(n, n, heads).permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.reshape(b_ // nw, nw, heads, n, n) + mask[None, :, None]
            attn = attn.reshape(b_, heads, n, n)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b_, n, c)
        return self.proj(out)


class WinBasedAttention(nn.Module):
    """One W-MSA (shift 0) or SW-MSA block with its residual."""

    def __init__(self, dim: int, num_heads: int = 8, window: int = 8,
                 shift: int = 0, dtype=None):
        super().__init__()
        self.window = window
        self.shift = shift
        self.attn = WindowAttention(dim, window, num_heads, dtype)
        self._masks = {}

    def _mask(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(
                shift_attn_mask(h, w, self.window, self.shift)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        shortcut = x
        mask = None
        if self.shift > 0:
            mask = self._mask(h, w, x.device)
            x = torch.roll(x, (-self.shift, -self.shift), dims=(1, 2))
        xw = self.attn(window_partition(x, self.window), mask)
        x = window_reverse(xw, self.window, h, w)
        if self.shift > 0:
            x = torch.roll(x, (self.shift, self.shift), dims=(1, 2))
        return shortcut + x


class ResidualUnit(nn.Module):
    """1x1 -> GELU -> 3x3 -> GELU -> 1x1 bottleneck, residual, GELU."""

    def __init__(self, n: int, dtype=None):
        super().__init__()
        self.Conv_0 = conv1x1(n, n // 2, dtype)
        self.Conv_1 = conv3x3(n // 2, n // 2, dtype=dtype)
        self.Conv_2 = conv1x1(n // 2, n, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(self.Conv_0(x))
        y = gelu(self.Conv_1(y))
        return gelu(x + self.Conv_2(y))


class WinNoShiftAttention(nn.Module):
    """STF gate: x + trunk(x) * sigmoid(branch(attention(x)))."""

    def __init__(self, dim: int, num_heads: int = 8, window: int = 8,
                 shift: int = 0, dtype=None):
        super().__init__()
        for i in range(3):
            setattr(self, f"trunk_{i}", ResidualUnit(dim, dtype))
        self.attn_block = WinBasedAttention(dim, num_heads, window, shift,
                                            dtype)
        for i in range(3):
            setattr(self, f"branch_{i}", ResidualUnit(dim, dtype))
        self.Conv_0 = conv1x1(dim, dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = x
        for i in range(3):
            a = getattr(self, f"trunk_{i}")(a)
        b = self.attn_block(x)
        for i in range(3):
            b = getattr(self, f"branch_{i}")(b)
        return x + a * torch.sigmoid(self.Conv_0(b))
