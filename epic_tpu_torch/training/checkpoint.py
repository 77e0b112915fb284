"""Checkpoints of the port's training: ``config.json`` + ``last.npz`` (and
``best.npz``), the layout of the JAX package's ``save_artifact``.

``save_checkpoint`` writes the JAX package's parameter tree
(``convert.to_jax_params``) flattened to "a/b/c" keys, in float32, so
``epic_tpu_torch.load_checkpoint`` and the JAX package's ``load_checkpoint``
both read it. (The JAX trainer writes Orbax checkpoints, which the port
reads through ``training/orbax.py`` and does not write.) The arrays are
stored uncompressed, since zlib takes tens of
seconds on a flagship tree: a flagship ``rem`` checkpoint is 653,787,546
bytes (written by chip_smoke.py's training phase).

``save_artifact`` writes the compact format of the committed artifacts, as
the JAX package's: the stacked heads' dead rows zeroed
(``zero_dead_rows``), the arrays cast to bfloat16 and compressed.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict

import numpy as np
import torch

from ..convert import _stacked_dead_blocks, to_jax_params


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


def remap_single_to_multi(single_params: Dict[str, Any],
                          enhanced_params: Dict[str, Any] = None
                          ) -> Dict[str, Any]:
    """A single-branch parameter tree's subtrees under the two-branch names,
    as the JAX package's (the reference's
    ``initialize_model_from_pretrained``): g_a -> g_a_0, g_s -> g_s_0,
    h_mean_s -> h_mean_s_0, h_scale_s -> h_scale_s_0; h_a dropped (it is
    retrained); the rest kept; an enhanced tree's g_s -> g_s_1. Trees are
    the JAX layout (``convert.to_jax_params``); the result is a partial
    tree to merge into a fresh two-branch model."""
    renamed = {"g_a": "g_a_0", "g_s": "g_s_0", "h_mean_s": "h_mean_s_0",
               "h_scale_s": "h_scale_s_0"}
    out = {renamed.get(k, k): v for k, v in single_params.items()
           if k != "h_a"}
    if enhanced_params is not None and "g_s" in enhanced_params:
        out["g_s_1"] = enhanced_params["g_s"]
    return out


def zero_dead_rows(params: Dict[str, Any], model) -> Dict[str, Any]:
    """The JAX-layout tree (``convert.to_jax_params``) of ``model`` with the
    stacked first-layer kernel rows that only ever meet the zero-padded
    support slots set to zero (``convert._stacked_dead_blocks``), as the
    JAX package's ``zero_dead_rows``. It changes no output (those rows
    multiply zeros and get zero gradient); it takes the random init out of
    the padding, so that a compressed artifact carries none of it."""
    p = dict(params)
    for name, count, slots in _stacked_dead_blocks(model):
        if name not in p or "Conv_0_kernel" not in p[name]:
            continue
        kern = np.array(p[name]["Conv_0_kernel"])  # [S, 3, 3, in, out]
        for i in range(count):
            pos, pad = slots(i)
            if pad:
                kern[i, :, :, pos:pos + pad, :] = 0
        p[name] = dict(p[name], Conv_0_kernel=kern)
    return p


def bfloat16_bits(a: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 as 2-byte void (``|V2``), as ``ml_dtypes``
    stores it: rounded to nearest, ties to even; a NaN becomes the quiet
    NaN of its sign."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32)
    out = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1)))
           >> 16).astype(np.uint16)
    nan = np.isnan(a)
    out[nan] = ((u[nan] >> 16) & np.uint32(0x8000)
                | np.uint32(0x7FC0)).astype(np.uint16)
    return out.view(np.dtype("V2"))


def save_artifact(directory: str, model: torch.nn.Module,
                  config: Dict[str, Any], step: int = 0,
                  which: str = "last", dtype: str = "bfloat16") -> str:
    """Write the compact artifact: ``{directory}/config.json`` (with
    ``"dtype"``) and ``{which}.npz``, the JAX-layout tree with its dead rows
    zeroed, cast to ``dtype`` (bfloat16 by default, the committed
    artifacts' format) and stored with ``np.savez_compressed``. Both
    packages' ``load_checkpoint`` read it. Returns the npz's path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump({"config": config, "step": step, "dtype": dtype}, f,
                  indent=2)
    flat = _flatten(zero_dead_rows(to_jax_params(model), model))
    cast = bfloat16_bits if dtype == "bfloat16" else \
        (lambda a: np.asarray(a).astype(np.dtype(dtype)))
    out = os.path.join(directory, which + ".npz")
    np.savez_compressed(out, **{k: cast(v) for k, v in flat.items()})
    return out
