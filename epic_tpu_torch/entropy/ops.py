"""Small differentiable primitives used by the entropy models.

- ``lower_bound``: clamp from below whose gradient passes where x >= bound
  or where the gradient would push x back up (compressai's LowerBound).
- ``ste_round`` / ``quantize_ste``: straight-through rounding.
- ``uniform_noise``: the additive U(-0.5, 0.5) noise that stands in for
  rounding in training, drawn from an explicit ``torch.Generator``.
- ``nn_param_init`` / ``nn_param_apply``: the offset/sqrt reparametrisation
  that keeps GDN's beta and gamma non-negative.
"""

from __future__ import annotations

import torch


class _LowerBound(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bound):
        bound = torch.as_tensor(bound, dtype=x.dtype, device=x.device)
        ctx.save_for_backward(x, bound)
        return torch.maximum(x, bound)

    @staticmethod
    def backward(ctx, g):
        x, bound = ctx.saved_tensors
        pass_through = (x >= bound) | (g < 0)
        return torch.where(pass_through, g, torch.zeros_like(g)), None


def lower_bound(x: torch.Tensor, bound) -> torch.Tensor:
    return _LowerBound.apply(x, bound)


def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) forward, identity gradient backward (round half to even, as
    ``jnp.round``)."""
    return x + (torch.round(x) - x).detach()


def quantize_ste(x: torch.Tensor, means=None) -> torch.Tensor:
    """STE quantization around optional means: ste_round(x - mu) + mu."""
    if means is None:
        return ste_round(x)
    return ste_round(x - means) + means


def uniform_noise(like: torch.Tensor,
                  generator: torch.Generator) -> torch.Tensor:
    """U(-0.5, 0.5) noise of ``like``'s shape, dtype and device, drawn from
    ``generator`` (which must live on that device)."""
    return torch.rand(like.shape, generator=generator, device=like.device,
                      dtype=like.dtype) - 0.5


# value = reparam**2 - pedestal, trained in sqrt space so the underlying
# quantity stays >= minimum.
_REPARAM_OFFSET = 2.0 ** -18
_PEDESTAL = _REPARAM_OFFSET ** 2


def nn_param_init(value: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Map an initial non-negative value to its reparametrised form."""
    del minimum  # signature symmetry with nn_param_apply
    return torch.sqrt(torch.clamp(value + _PEDESTAL, min=_PEDESTAL))


def nn_param_apply(reparam: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    """Recover the non-negative value from its reparametrised form."""
    bound = (minimum + _PEDESTAL) ** 0.5
    return lower_bound(reparam, bound) ** 2 - _PEDESTAL
