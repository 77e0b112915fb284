"""The four-stage training curriculum and which parameters each trains.

first_train -> refine_gs -> refine_gs_ga -> rems, each with its criterion,
quality grid and lambda schedule. Freezing is a mask over the model's
``named_parameters()`` (their names follow the JAX package's parameter
tree, so the prefixes carry over): every gradient is still computed, and
the frozen ones are zeroed after the global-norm clip (``state.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

STAGES = ("first_train", "refine_gs", "refine_gs_ga", "rems")


@dataclasses.dataclass
class StagePlan:
    name: str
    criterion: str                       # key into losses.CRITERIA
    list_quality: List[float]
    sampling: bool                       # one random quality per batch
    lmbda_schedule: Optional[np.ndarray]  # per-quality lambda (refine_gs_ga)
    lmbda_list: Sequence[float]
    rems: Optional[Sequence[float]]      # checkpoint levels when training REMs
    unfreeze_lrp: bool = False


def _refine_quality_grid() -> List[float]:
    """~250 qualities: dense in [0.015, 1.5], sparse up to 10."""
    part1 = list(np.arange(0.015, 1.5, (1.5 - 0.025) / 200)) + [1.5]
    part2 = list(np.arange(1.6, 10, (10 - 1.6) / 50)) + [10]
    return [float(q) for q in part1 + part2]


def _rems_quality_grid(check_levels: Sequence[float],
                       check_levels_np: Sequence[int]) -> List[float]:
    """One grid per bracket between checkpoint levels (and 10)."""
    qs: List[float] = []
    levels = list(check_levels) + [10]
    for i in range(len(levels) - 1):
        cur, nxt = levels[i], levels[i + 1]
        start = cur + 0.01 if i == 0 else cur
        step = (nxt - cur) / check_levels_np[i]
        qs.extend(np.arange(start, nxt, step))
    qs = [round(float(x), 4) for x in qs]
    if 10 not in qs:
        qs.append(10.0)
    return qs


def make_stage(training_type: str,
               lmbda_list: Sequence[float] = (0.0055, 0.04),
               check_levels: Sequence[float] = (0.75,),
               check_levels_np: Sequence[int] = (24,),
               unfreeze_lrp: bool = False) -> StagePlan:
    if training_type == "first_train":
        return StagePlan("first_train", "first_train", [0, 10], False,
                         None, lmbda_list, None)
    if training_type == "refine_gs":
        return StagePlan("refine_gs", "refine_gs", _refine_quality_grid(),
                         True, None, lmbda_list, None,
                         unfreeze_lrp=unfreeze_lrp)
    if training_type == "refine_gs_ga":
        qs = _refine_quality_grid()
        sched = np.logspace(np.log10(lmbda_list[0]), np.log10(lmbda_list[-1]),
                            len(qs) + 1)[1:]
        return StagePlan("refine_gs_ga", "refine_gs_ga", qs, True, sched,
                         lmbda_list, None)
    if training_type == "rems":
        qs = _rems_quality_grid(check_levels, check_levels_np)
        return StagePlan("rems", "rems", qs, True, None, lmbda_list,
                         list(check_levels))
    raise ValueError(f"unknown training_type {training_type!r}")


def draw_quality(plan: StagePlan, rng: np.random.Generator):
    """One quality of a sampling stage's grid, drawn from ``rng``, and its
    lambda: (quality, lambda)."""
    qi = int(rng.integers(len(plan.list_quality)))
    lmbda = (plan.lmbda_schedule[qi] if plan.lmbda_schedule is not None
             else plan.lmbda_list[-1])
    return float(plan.list_quality[qi]), float(lmbda)


def _trains(name: str, stage: str, unfreeze_lrp: bool, dec: str,
            enc: str) -> bool:
    if "quantiles" in name:
        return False
    if stage == "first_train":
        return True
    if stage == "refine_gs":
        return name.startswith(dec) or (unfreeze_lrp
                                        and name.startswith("lrp_prog"))
    if stage == "refine_gs_ga":
        return name.startswith(dec) or name.startswith(enc)
    if stage == "rems":
        return name.startswith("post_latent")
    raise ValueError(stage)


def trainable_mask(names: Iterable[str], stage: str,
                   unfreeze_lrp: bool = False, multiple_decoder: bool = True,
                   multiple_encoder: bool = True) -> Dict[str, bool]:
    """{parameter name: whether the main optimizer updates it}.
    first_train: all but the bottleneck quantiles (the aux optimizer's);
    refine_gs: the enhancement decoder, g_s_1 (g_s in a single-branch
    model; + lrp_prog with ``unfreeze_lrp``); refine_gs_ga: that decoder
    and the enhancement encoder, g_a_1 (g_a); rems: the REM banks
    (post_latent_*)."""
    dec = "g_s_1" if multiple_decoder else "g_s"
    enc = "g_a_1" if multiple_encoder else "g_a"
    return {n: _trains(n, stage, unfreeze_lrp, dec, enc) for n in names}


def quantiles_mask(names: Iterable[str]) -> Dict[str, bool]:
    """{parameter name: whether the aux optimizer updates it}: the
    bottleneck quantiles only."""
    return {n: "quantiles" in n for n in names}
