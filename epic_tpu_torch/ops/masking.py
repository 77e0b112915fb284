"""Variance-aware masking: keep the top q*10% of a slice's elements ranked
by their predicted std, per sample.

The mask is never transmitted: the decoder derives it from the same
decoded std fields, so these functions must give the same bits on both
sides. The threshold is the JAX package's ``jnp.quantile`` (linear
interpolation at 1 - q/10 over each sample's sorted values), written out as
a sort and an explicit float32 lerp, and ``>=`` keeps ties.

Two policies, as in the JAX package: "point-based-std" (the above, the
default) and "two-levels" (nothing at quality 0, everything above it).
Any other raises NotImplementedError.
"""

from __future__ import annotations

import torch

from ..entropy.ops import ste_round


def quantile_thresholds(sorted_rows: torch.Tensor,
                        p_keep: float) -> torch.Tensor:
    """Linear-interpolation quantile at 1 - p_keep of each row of an
    ascending-sorted [R, N] float32 tensor, as jnp.quantile computes it in
    float32. Returns [R]."""
    n = sorted_rows.shape[1]
    q = torch.tensor(1.0 - p_keep, dtype=torch.float32)
    pos = q * torch.tensor(n - 1, dtype=torch.float32)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    lo = int(min(max(low.item(), 0), n - 1))
    hi = int(min(max(high.item(), 0), n - 1))
    return (sorted_rows[:, lo] * low_w.to(sorted_rows.device)
            + sorted_rows[:, hi] * high_w.to(sorted_rows.device))


def _quantile_mask(scale: torch.Tensor, p_keep: float) -> torch.Tensor:
    b = scale.shape[0]
    flat = scale.reshape(b, -1)
    thr = quantile_thresholds(torch.sort(flat, dim=1).values, p_keep)
    return (flat >= thr[:, None]).to(scale.dtype).reshape(scale.shape)


def variance_mask(scale: torch.Tensor, pr: float,
                  policy: str = "point-based-std") -> torch.Tensor:
    """Binary mask of the top pr*10% highest-std elements of each sample
    of scale [B, ...]; pr in [0, 10]. q <= 0 and q >= 10 short-cut to all
    zeros / all ones. The "two-levels" policy gives all zeros at quality 0
    and all ones at any other."""
    if policy == "two-levels":
        return torch.zeros_like(scale) if pr == 0 else torch.ones_like(scale)
    if policy != "point-based-std":
        raise NotImplementedError(f"mask policy {policy!r}")
    if pr >= 10:
        return torch.ones_like(scale)
    if pr <= 0:
        return torch.zeros_like(scale)
    return _quantile_mask(scale, pr * 0.1)


def prog_mask(scales: torch.Tensor, pr: float,
              policy: str = "point-based-std") -> torch.Tensor:
    """variance_mask per (slice, sample) of stacked scales [S, B, ...]."""
    s, b = scales.shape[:2]
    return variance_mask(scales.reshape(s * b, *scales.shape[2:]),
                         pr, policy).reshape(scales.shape)


def delta_shell_mask(scales: torch.Tensor, q_init: float,
                     q_end: float) -> torch.Tensor:
    """Elements transmitted at q_end but not at q_init."""
    return prog_mask(scales, q_end) - prog_mask(scales, q_init)


def shell_ids(scales: torch.Tensor, q_list) -> torch.Tensor:
    """Per-element shell id [S, B, ...] int8: the index of the first
    quality of q_list whose prog_mask admits the element, len(q_list) if
    none does (q_list ascending, so the masks are nested). Equal to
    counting prog_mask over q_list, with one sort per (slice, sample)."""
    s, b = scales.shape[:2]
    flat = scales.reshape(s * b, -1)
    sorted_rows = torch.sort(flat, dim=1).values
    admitted = torch.zeros(flat.shape, dtype=torch.int32,
                           device=scales.device)
    for q in q_list:
        if q >= 10:
            admitted += 1
        elif q > 0:
            thr = quantile_thresholds(sorted_rows, q * 0.1)
            admitted += (flat >= thr[:, None]).to(torch.int32)
    return (len(q_list) - admitted).to(torch.int8).reshape(scales.shape)


def apply_noise_mask(mask: torch.Tensor, training: bool) -> torch.Tensor:
    """Round a mask, straight through in training. A no-op on the binary
    point-based-std masks; kept for learnable mask policies."""
    return ste_round(mask) if training else torch.round(mask)
