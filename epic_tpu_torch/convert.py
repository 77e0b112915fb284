"""Weights carried across from the JAX package.

``load_checkpoint(directory)`` reads a committed checkpoint (``config.json``
and ``last.npz``, as the JAX package's ``save_artifact`` writes them) with
numpy alone and returns the port's model with its weights.

``from_jax_params(params, model)`` takes the JAX package's parameter tree
(nested dicts of numpy arrays, as ``jax.device_get`` or a ``last.npz``
gives them) and returns the port model's ``state_dict``. The port's module
and parameter names follow the flax tree, so each leaf maps by its path:

- conv kernels HWIO -> OIHW;
- transposed-conv kernels HWIO -> spatially flipped [in, out, kh, kw]
  (see ``ops.conv.ConvTranspose``);
- dense kernels [in, out] -> [out, in];
- stacked per-slice heads [S, 3, 3, in, out] -> [S, out, in, 3, 3];
- stacked REM bank kernels [S, kh, kw, in, out] -> [S, out, in, kh, kw];
- everything else (GDN's reparametrised beta/gamma, relative-bias tables,
  the entropy bottleneck's matrices, biases, factors and quantiles) as is.

bfloat16 arrays that numpy surfaces as opaque ``|V2`` go through uint16.
Any array left over or missing, or of the wrong shape, raises.

``to_jax_params(model)`` is the inverse: the port's parameters as the JAX
package's tree of float32 numpy arrays, so that checkpoints the port writes
load in either package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.itemsize == 2 and a.dtype.kind == "V":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).float()
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _flatten(tree: Dict[str, Any], prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _convert_leaf(path, t: torch.Tensor):
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    key = ".".join(path[:-1])
    if name == "kernel" and t.ndim == 4:
        if parent.startswith("ConvTranspose"):
            t = torch.flip(t, (0, 1)).permute(2, 3, 0, 1)
        else:
            t = t.permute(3, 2, 0, 1)
        name = "weight"
    elif name == "kernel" and t.ndim == 5:
        t, name = t.permute(0, 4, 3, 1, 2), "weight"
    elif name == "kernel" and t.ndim == 2:
        t, name = t.t(), "weight"
    elif name.startswith("Conv_") and name.endswith("_kernel"):
        t = t.permute(0, 4, 3, 1, 2)
    return (f"{key}.{name}" if key else name), t.contiguous()


def from_jax_params(params: Dict[str, Any], model: nn.Module
                    ) -> Dict[str, torch.Tensor]:
    """The JAX parameter tree of ``model``'s configuration -> its state_dict
    (float32). Raises ValueError on leftover, missing or misshapen arrays."""
    if set(params) == {"params"}:
        params = params["params"]
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for path, a in _flatten(params):
        key, t = _convert_leaf(path, _to_tensor(a))
        if key not in want:
            leftover.append("/".join(path))
            continue
        if t.shape != want[key].shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)} "
                             f"does not fit {key} {tuple(want[key].shape)}")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if leftover or missing:
        raise ValueError(f"arrays left over: {leftover}; "
                         f"parameters missing: {missing}")
    return out


def _jax_leaf(key: str, t: torch.Tensor):
    """The inverse of ``_convert_leaf``: a state_dict entry -> (flax path,
    array)."""
    path = key.split(".")
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "weight" and t.ndim == 4:
        if parent.startswith("ConvTranspose"):
            t = torch.flip(t.permute(2, 3, 0, 1), (0, 1))
        else:
            t = t.permute(2, 3, 1, 0)
        name = "kernel"
    elif name == "weight" and t.ndim == 5:
        t, name = t.permute(0, 3, 4, 2, 1), "kernel"
    elif name == "weight" and t.ndim == 2:
        t, name = t.t(), "kernel"
    elif name.startswith("Conv_") and name.endswith("_kernel"):
        t = t.permute(0, 3, 4, 2, 1)
    return tuple(path[:-1]) + (name,), t


def to_jax_params(model: nn.Module) -> Dict[str, Any]:
    """A model -> the JAX package's parameter tree of float32 numpy arrays.
    ``from_jax_params`` of the result gives the state_dict back bitwise."""
    tree: Dict[str, Any] = {}
    for key, t in model.state_dict().items():
        path, t = _jax_leaf(key, t.detach().float().cpu())
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(t.numpy())
    return tree


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"a/b/c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    root: Dict[str, Any] = {}
    for key, v in flat.items():
        node = root
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return root


def load_checkpoint(directory: str,
                    config_overrides: Optional[Dict[str, Any]] = None,
                    disable_rems_if_missing: bool = False):
    """A committed checkpoint -> (model, config, step): the model named by
    ``config.json`` (with ``config_overrides`` applied, e.g.
    ``{"compute_dtype": "float32"}``) on the CPU, with every array of
    ``last.npz`` loaded. Raises on the pre-stacking per-slice layout
    (``cc_mean_0``, ``post_latent_0_0``), which the port does not convert.
    A ``rem`` config whose checkpoint has no REM banks raises too, unless
    ``disable_rems_if_missing`` asks for the plain ``pic`` model instead
    (the JAX loader's default)."""
    from .models import get_model

    with open(os.path.join(directory, "config.json")) as f:
        meta = json.load(f)
    config = dict(meta["config"])
    config.update(config_overrides or {})
    name = config.pop("model", "pic")
    with np.load(os.path.join(directory, "last.npz")) as z:
        params = _unflatten({k: z[k] for k in z.files})
    if "cc_mean_0" in params or "post_latent_0_0" in params:
        raise ValueError(f"{directory}: per-slice (pre-stacking) parameter "
                         "layout; the port loads only stacked checkpoints")
    if name == "rem" and "post_latent_0" not in params:
        if not disable_rems_if_missing:
            raise ValueError(f"{directory}: a 'rem' config without REM "
                             "banks (post_latent_*); pass "
                             "disable_rems_if_missing=True to load it as "
                             "'pic'")
        name = "pic"
        for k in ("check_levels", "mu_std", "rem_dimension"):
            config.pop(k, None)
    model = get_model(name, **{k: tuple(v) if isinstance(v, list) else v
                               for k, v in config.items()})
    model.load_state_dict(from_jax_params(params, model))
    config["model"] = name
    return model, config, meta.get("step", 0)
