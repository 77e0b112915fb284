"""Training state: the model's parameters with the main and aux optimizers.

The main optimizer is Adam (lr 1e-4) over the parameters the stage trains,
after a clip of every gradient to global norm 1.0; the aux optimizer is
Adam (lr 1e-3) over the bottleneck quantiles. Both are held to what the
JAX package builds with optax:

- the global norm covers every gradient, of frozen parameters and of the
  quantiles too, and is applied as ``(g / norm) * max_norm`` with no
  epsilon, only when ``norm >= max_norm`` (``optax.clip_by_global_norm``);
- frozen parameters get no optimizer state and are never written, so they
  stay bitwise unchanged (``multi_transform`` with ``set_to_zero``);
- a step whose gradients are not all finite leaves parameters and moments
  as they are, and counts one more consecutive error; after
  ``MAX_CONSECUTIVE_ERRORS`` of them the next non-finite update is applied
  (``optax.apply_if_finite``);
- the learning rate can be changed while keeping the moments
  (``inject_hyperparams``).

Updates are in place, with PyTorch's multi-tensor (``_foreach``) kernels.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn

from .stages import quantiles_mask, trainable_mask


# optax.adam's defaults, as the JAX package's optimizers use them
B1, B2, EPS = 0.9, 0.999, 1e-8
MAX_CONSECUTIVE_ERRORS = 20


class Adam:
    """``optax.adam`` over a list of tensors, updated in place: mu, nu
    moving averages (B1, B2), bias correction, update -lr * mu_hat /
    (sqrt(nu_hat) + EPS). The hyperparameters enter in float32, as
    ``optax.inject_hyperparams`` holds them for the JAX package's main
    optimizer: 1 - B2 is float32(1) - float32(0.999), 1.3e-5 below 0.001.
    (Its aux optimizer, plain ``optax.adam``, forms 1 - b in double.)"""

    def __init__(self, params: Sequence[torch.Tensor], lr: float):
        self.params = list(params)
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor]) -> None:
        if not self.params:
            return
        grads = list(grads)
        self.count += 1
        one, b1, b2 = np.float32(1), np.float32(B1), np.float32(B2)
        torch._foreach_mul_(self.mu, float(b1))
        torch._foreach_add_(self.mu, grads, alpha=float(one - b1))
        torch._foreach_mul_(self.nu, float(b2))
        torch._foreach_addcmul_(self.nu, grads, grads, value=float(one - b2))
        bc1 = float(one - b1 ** np.float32(self.count))
        bc2 = float(one - b2 ** np.float32(self.count))
        denom = torch._foreach_div(self.nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, EPS)
        step = torch._foreach_div(self.mu, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_mul_(step, -self.lr)
        torch._foreach_add_(self.params, step)


def _all_finite(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.isfinite(t).all() for t in tensors]).all()


class FiniteGuard:
    """``optax.apply_if_finite``'s bookkeeping: ``admit(finite)`` says
    whether to apply an update."""

    def __init__(self):
        self.notfinite_count = 0

    def admit(self, finite: bool) -> bool:
        if finite:
            self.notfinite_count = 0
            return True
        self.notfinite_count += 1
        return self.notfinite_count > MAX_CONSECUTIVE_ERRORS


class TrainState:
    """The model (its parameters are the state's), the main optimizer over
    what ``stage`` trains and the aux optimizer over the quantiles.
    ``names`` / ``params`` list every parameter in ``named_parameters()``
    order; gradients are passed in that order."""

    def __init__(self, model: nn.Module, stage: str = "first_train",
                 learning_rate: float = 1e-4,
                 aux_learning_rate: float = 1e-3, clip_norm: float = 1.0,
                 unfreeze_lrp: bool = False):
        self.model = model
        named = list(model.named_parameters())
        self.names: List[str] = [n for n, _ in named]
        self.params: List[torch.Tensor] = [p for _, p in named]
        mask = trainable_mask(self.names, stage, unfreeze_lrp,
                              model.multiple_decoder,
                              model.multiple_encoder)
        self.trainable: List[bool] = [mask[n] for n in self.names]
        self.main = Adam([p for p, t in zip(self.params, self.trainable)
                          if t], learning_rate)
        qmask = quantiles_mask(self.names)
        self.aux_names = [n for n in self.names if qmask[n]]
        self.aux_params = [p for n, p in named if qmask[n]]
        self.aux = Adam(self.aux_params, aux_learning_rate)
        self.clip_norm = clip_norm
        self.main_guard = FiniteGuard()
        self.aux_guard = FiniteGuard()
        self.step = 0

    @property
    def trainable_names(self) -> List[str]:
        return [n for n, t in zip(self.names, self.trainable) if t]

    @torch.no_grad()
    def apply_main(self, grads: Sequence[torch.Tensor]) -> Dict[str, float]:
        """One main update from the gradients of every parameter: finite
        check, global-norm clip, Adam on the trainable ones. Returns
        {"finite", "grad_norm", "clip_scale", "applied"}."""
        grads = list(grads)
        norm = torch.sqrt(torch.stack([(g * g).sum() for g in grads]).sum())
        finite, norm_v = torch.stack(
            [_all_finite(grads).float(), norm]).tolist()
        finite = bool(finite)
        self.step += 1
        applied = self.main_guard.admit(finite)
        scale = 1.0
        if applied:
            if not norm_v < self.clip_norm:
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, self.clip_norm)
                scale = self.clip_norm / norm_v
            self.main.update([g for g, t in zip(grads, self.trainable) if t])
        return {"finite": finite, "grad_norm": norm_v, "clip_scale": scale,
                "applied": applied}

    @torch.no_grad()
    def apply_aux(self, grads: Sequence[torch.Tensor]) -> bool:
        """One aux update from the quantiles' gradients (``aux_params``
        order); returns whether it was applied."""
        grads = list(grads)
        applied = self.aux_guard.admit(bool(_all_finite(grads)))
        if applied:
            self.aux.update(grads)
        return applied


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """Replace the main learning rate, keeping the Adam moments (the
    plateau drop)."""
    state.main.lr = lr
    return state


def get_learning_rate(state: TrainState) -> float:
    return state.main.lr
