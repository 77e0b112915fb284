"""Checkpoints of the port's training: ``config.json`` + ``last.npz`` (and
``best.npz``), the layout of the JAX package's ``save_artifact``.

The npz holds the JAX package's parameter tree (``convert.to_jax_params``)
flattened to "a/b/c" keys, in float32, so ``epic_tpu_torch.load_checkpoint``
and the JAX package's ``load_checkpoint`` both read it. (The JAX trainer
writes Orbax checkpoints; the port has no Orbax.) The arrays are stored
uncompressed: a flagship ``rem`` checkpoint is 653,787,546 bytes (written
by chip_smoke.py's training phase), which zlib would take many seconds to
compress.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict

import numpy as np
import torch

from ..convert import to_jax_params


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def save_checkpoint(directory: str, model: torch.nn.Module,
                    config: Dict[str, Any], step: int = 0,
                    is_best: bool = False) -> None:
    """Write ``{directory}/config.json`` and ``last.npz`` (and
    ``best.npz`` when is_best). ``config`` holds the model's constructor
    arguments and its registry name under "model"."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"config": config, "step": step, "dtype": "float32"}, f,
                  indent=2)
    last = os.path.join(directory, "last.npz")
    tmp = last + ".tmp.npz"
    np.savez(tmp, **_flatten(to_jax_params(model)))
    os.replace(tmp, last)
    if is_best:
        shutil.copyfile(last, os.path.join(directory, "best.npz"))


def merge_params(template: Dict[str, torch.Tensor],
                 partial: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """``template`` (a fresh model's state_dict) with every entry of
    ``partial`` whose name and shape match laid over it: how a parent
    stage's weights enter a model with more parameters (fresh REM banks on
    a trained ``pic``)."""
    out = dict(template)
    for k, v in partial.items():
        if k in out and out[k].shape == v.shape:
            out[k] = v
    return out
