"""Training and validation steps.

One step (``TrainStep``), in the JAX package's order: the stage
criterion's loss and the gradients of every parameter; the main update
(clip, freeze, skip-if-non-finite, Adam); the aux loss's gradients at the
updated parameters; the aux update; the aux loss as a metric. The
first_train stage trains every level of the multi-quality forward at once;
the sampling stages train one quality (and lambda) per batch, given by the
caller, with REM training conditioned on a checkpoint latent that
``make_ckpt_extractor`` computes without gradients.

Validation estimates rate from the likelihoods (no entropy coding), per
quality: ``make_eval_step``, ``make_valid_loss_step``, ``valid_epoch``,
``test_epoch``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .losses import CRITERIA
from .stages import StagePlan
from .state import TrainState


class TrainStep:
    """``step(state, batch, generator, quality, lmbda, checkpoint_ref) ->
    metrics``. Multi-quality stages ignore quality and lmbda (the plan's
    qualities and lambdas are baked in). ``training=False`` rounds instead
    of adding noise (no generator needed): the reference's deterministic
    forward, against which the step is held."""

    def __init__(self, model, plan: StagePlan, training: bool = True):
        self.model, self.plan, self.training = model, plan, training
        self.criterion = CRITERIA[plan.criterion]

    def loss(self, batch: torch.Tensor, generator=None, quality=None,
             lmbda=None, checkpoint_ref=None,
             hyper_weight=None) -> Dict[str, torch.Tensor]:
        """The stage criterion's outputs ("loss", "mse_loss", "bpp_*") of
        one forward (``hyper_weight``: see ``losses``)."""
        if not self.plan.sampling:
            out = self.model.multi_quality(
                batch, list(self.plan.list_quality), self.training,
                generator)
            return self.criterion(out, batch, self.plan.lmbda_list,
                                  hyper_weight=hyper_weight)
        out = self.model.forward_single_quality(
            batch, quality, self.training, checkpoint_ref, generator)
        return self.criterion(out, batch, lmbda, hyper_weight=hyper_weight)

    @staticmethod
    def gradients(state: TrainState,
                  loss: torch.Tensor) -> List[torch.Tensor]:
        """The loss's gradients of every parameter (``state.params`` order;
        zeros where it does not depend on one)."""
        grads = torch.autograd.grad(loss, state.params, allow_unused=True)
        return [torch.zeros_like(p) if g is None else g
                for g, p in zip(grads, state.params)]

    def apply(self, state: TrainState, loss: torch.Tensor) -> Dict:
        """The updates from one loss: its gradients of every parameter,
        the main update, the aux loss's gradients at the updated
        parameters, the aux update. Returns ``state.apply_main``'s info
        with the gradients (before the clip) under "grads"."""
        grads = self.gradients(state, loss)
        info = state.apply_main(grads)
        aux_grads = torch.autograd.grad(self.model.aux_loss(),
                                        state.aux_params)
        info["aux_applied"] = state.apply_aux(aux_grads)
        info["grads"] = grads
        return info

    def __call__(self, state: TrainState, batch: torch.Tensor,
                 generator=None, quality=None, lmbda=None,
                 checkpoint_ref=None) -> Dict[str, torch.Tensor]:
        metrics = self.loss(batch, generator, quality, lmbda, checkpoint_ref)
        info = self.apply(state, metrics["loss"])
        out = {k: v.detach() for k, v in metrics.items()}
        with torch.no_grad():
            out["aux_loss"] = self.model.aux_loss()
        out["grad_norm"] = torch.tensor(info["grad_norm"])
        return out


def make_train_step(model, plan: StagePlan,
                    training: bool = True) -> TrainStep:
    return TrainStep(model, plan, training)


def make_ckpt_extractor(model, check_levels: Sequence[float]) -> Callable:
    """extract(batch, quality) -> what the REMs are conditioned on in REM
    training at a sampled quality: the decoded latent (deterministic
    forward, no gradient) at the check level that brackets it from below;
    None at or below the first check level, where the REMs do not
    apply."""
    @torch.no_grad()
    def extract(batch: torch.Tensor, quality: float):
        if quality <= check_levels[0]:
            return None
        return model.forward_single_quality(
            batch, extract_quality_ref(quality, check_levels), False)["y_hat"]

    return extract


def extract_quality_ref(quality: float,
                        check_levels: Sequence[float]) -> float:
    """The checkpoint level that brackets a sampled quality from below (0
    at or below the first)."""
    c = list(check_levels)
    if quality <= c[0]:
        return 0.0
    for j in range(len(c) - 1):
        if c[j] < quality <= c[j + 1]:
            return c[j]
    return c[-1]


def make_eval_step(model, static_quality: Optional[float] = None
                   ) -> Callable:
    """evaluate(batch, quality) -> (x_hat, bits per pixel estimated from
    the likelihoods, per-image mse [B]). ``static_quality`` pins the
    forward to that quality whatever the caller passes (0 for WACNN, which
    has one quality)."""
    @torch.no_grad()
    def evaluate(batch: torch.Tensor, quality: float):
        q = quality if static_quality is None else float(static_quality)
        out = model.forward_single_quality(batch, q, False)
        b, h, w, _ = batch.shape
        bits = sum(-torch.log2(lik).sum()
                   for lik in out["likelihoods"].values())
        mse = ((out["x_hat"] - batch) ** 2).mean(dim=(1, 2, 3))
        return out["x_hat"], bits / (b * h * w), mse

    return evaluate


def make_valid_loss_step(model, plan: StagePlan,
                         static_quality: Optional[float] = None
                         ) -> Callable:
    """valid(batch, quality) -> the stage criterion's loss at the plan's
    last lambda: what the plateau schedule steps on. ``static_quality``
    as in ``make_eval_step``."""
    criterion = CRITERIA[plan.criterion]
    lmbda = float(plan.lmbda_list[-1])

    @torch.no_grad()
    def valid(batch: torch.Tensor, quality: float) -> torch.Tensor:
        q = quality if static_quality is None else float(static_quality)
        out = model.forward_single_quality(batch, q, False)
        return criterion(out, batch, lmbda)["loss"]

    return valid


def _psnr(mse: np.ndarray) -> np.ndarray:
    return -10.0 * np.log10(np.maximum(mse, 1e-12))


def valid_epoch(eval_step, batches,
                pr_list: Sequence[float] = (0.76, 1, 1.25, 2, 3, 5, 10),
                loss_step: Optional[Callable] = None) -> Dict:
    """Rate and PSNR per quality of pr_list, averaged over the batches;
    with a ``loss_step``, the mean stage-criterion loss under "loss"."""
    bpp = np.zeros(len(pr_list))
    psnr = np.zeros(len(pr_list))
    losses = []
    n = 0
    for batch in batches:
        for k, q in enumerate(pr_list):
            _, b, mse = eval_step(batch, float(q))
            bpp[k] += float(b)
            psnr[k] += float(_psnr(mse.cpu().numpy()).mean())
            if loss_step is not None:
                losses.append(float(loss_step(batch, float(q))))
        n += 1
    n = max(n, 1)
    out = {"bpp": (bpp / n).tolist(), "psnr": (psnr / n).tolist(),
           "pr_list": list(pr_list)}
    if losses:
        out["loss"] = float(np.mean(losses))
    return out


# the 15-level grid of the test sweep
TEST_PR_LIST = (0, 0.05, 0.1, 0.25, 0.5, 0.6, 0.75, 1, 1.25, 2, 2.5, 3,
                3.5, 5, 10)


def test_epoch(eval_step, batches, pr_list: Sequence[float] = TEST_PR_LIST
               ) -> Dict:
    """Rate (estimated from the likelihoods) and PSNR over the 15-level
    grid: ``valid_epoch`` at ``TEST_PR_LIST``."""
    return valid_epoch(eval_step, batches, pr_list)
